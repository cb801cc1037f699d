// Chase lab: the parts of the batch-1 backtrace step, one chain at a time.
//
// Replaces the TPU lab builder scripts/chase_lab.py::_build. Each variant
// runs `frames` dependent steps, last frame first (f = frames - 1 .. 0,
// k = f mod 128), from index 7, and writes the final index. In natural
// state order, with S states, M = ceil(S / 128), row = trans[idx] and
// v = trans[idx, c] + post[f, c]:
//   scalar_only      idx = (5 idx + k) mod S               the integer chain
//   scalar_nomod     idx = (5 idx + k) & 1023
//   v2s_floor        idx = (floormod(int(trans[idx, 0]), S) + k) mod S
//   v2s_nomod        idx = ((int(trans[idx, 0]) & 1023) + k) & 1023
//                                           a dependent L2 load per step
//   tree1            idx = lowest argmax of v over c < min(128, S)
//                                           plus one warp reduction
//   tree12           idx = lowest argmax of v over every state, fused
//                    (value, index) pairs
//   two_trees        idx = (s // M) * M mod S, s the lowest argmax of v,
//                    by two sequential reductions (max, then the lowest
//                    index among the maximal entries)
//   two_trees_nomod  two_trees with & 1023 in place of mod S
// where int() truncates toward zero. Each is bitwise its plain version
// (torbi_tpu_torch/scripts/chase_lab.py::chase_reference).
//
// The steps split K5's and K6's (csrc/backtrace_batch1.cu) chase step:
// the chain alone, the dependent load of the transition row, the warp
// reduction, and the full row by one warp (K3's and K6's shape, THREADS
// 32) or by a CTA of 192 threads with a __syncthreads per reduction (K5's
// shape). Every step's index is a data dependence of the step before, so
// the compiler can neither hoist nor overlap the steps.
//
// Bound: none that throughput sees; a step is latency. At 10,240 steps x
// 1440 states the rows read are 118 MB, ~0.035 ms at 3.35 TB/s.
#include "common.cuh"

namespace {

enum Variant : int {
  kScalarOnly = 0,
  kScalarNomod = 1,
  kV2sFloor = 2,
  kV2sNomod = 3,
  kTree1 = 4,
  kTree12 = 5,
  kTwoTrees = 6,
  kTwoTreesNomod = 7,
};

constexpr int kSeed = 7;
constexpr int kMaxStates = 2048;  // two_trees keeps its values in registers

__device__ __forceinline__ void take(float& best, int& best_i, float v,
                                     int i) {
  if (v > best || (v == best && i < best_i)) {
    best = v;
    best_i = i;
  }
}

__device__ __forceinline__ void warp_pair(float& best, int& best_i) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    const float v = __shfl_xor_sync(0xffffffffu, best, offset);
    const int i = __shfl_xor_sync(0xffffffffu, best_i, offset);
    take(best, best_i, v, i);
  }
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, offset));
  return v;
}

// One thread: the integer chain and the dependent load
template <int V>
__global__ void chase_scalar_kernel(const float* __restrict__ trans,
                                    int* __restrict__ out, int frames,
                                    int states) {
  int idx = kSeed;
  for (int f = frames - 1; f >= 0; --f) {
    const int k = f & 127;
    if constexpr (V == kScalarOnly) {
      idx = (idx * 5 + k) % states;
    } else if constexpr (V == kScalarNomod) {
      idx = (idx * 5 + k) & 1023;
    } else {
      const int x = static_cast<int>(
          __ldg(trans + static_cast<size_t>(idx) * states));
      if constexpr (V == kV2sFloor) {
        int n = x % states;
        if (n < 0) n += states;
        idx = (n + k) % states;
      } else {
        idx = ((x & 1023) + k) & 1023;
      }
    }
  }
  out[0] = idx;
}

// THREADS threads (32: one warp; a multiple of 32: one CTA) over the row
template <int V, int THREADS>
__global__ void __launch_bounds__(THREADS) chase_row_kernel(
    const float* __restrict__ trans, const float* __restrict__ post,
    int* __restrict__ out, int frames, int states) {
  constexpr int kWarps = THREADS / 32;
  constexpr int kPer = (kMaxStates + THREADS - 1) / THREADS;
  __shared__ float table_v[2][kWarps];
  __shared__ int table_i[2][kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = V == kTree1 ? min(128, states) : states;
  const int m = (states + 127) / 128;
  int idx = kSeed;
  for (int f = frames - 1, step = 0; f >= 0; --f, ++step) {
    const float* row = trans + static_cast<size_t>(idx) * states;
    const float* col = post + static_cast<size_t>(f) * states;
    const int p = step & 1;
    if constexpr (V == kTree1 || V == kTree12) {
      // Fused (value, index) pairs; indices rise along a thread's values
      float best = torbi::neg_inf();
      int best_i = INT_MAX;
      for (int c = tid; c < n; c += THREADS)
        take(best, best_i, __ldg(row + c) + col[c], c);
      warp_pair(best, best_i);
      if (kWarps > 1) {
        if (lane == 0) {
          table_v[p][warp] = best;
          table_i[p][warp] = best_i;
        }
        __syncthreads();
        best = torbi::neg_inf();
        best_i = INT_MAX;
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
          take(best, best_i, table_v[p][w], table_i[p][w]);
      }
      idx = best_i;
    } else {
      // Two sequential reductions over values kept in registers
      float v[kPer];
      float mx = torbi::neg_inf();
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int c = tid + i * THREADS;
        v[i] = c < n ? __ldg(row + c) + col[c] : torbi::neg_inf();
        mx = fmaxf(mx, v[i]);
      }
      mx = torbi::warp_max(mx);
      if (kWarps > 1) {
        if (lane == 0) table_v[p][warp] = mx;
        __syncthreads();
        mx = torbi::neg_inf();
#pragma unroll
        for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, table_v[p][w]);
      }
      // The lowest maximal index: (c // M) * M rises with c, so its
      // minimum over the maximal entries is that of the lowest one
      int pred = INT_MAX;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int c = tid + i * THREADS;
        if (c < n && v[i] == mx) pred = min(pred, c);
      }
      pred = warp_min(pred);
      if (kWarps > 1) {
        if (lane == 0) table_i[p][warp] = pred;
        __syncthreads();
        pred = INT_MAX;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) pred = min(pred, table_i[p][w]);
      }
      pred = pred / m * m;
      idx = V == kTwoTrees ? pred % states : pred & 1023;
    }
  }
  if (tid == 0) out[0] = idx;
}

template <int V, int THREADS>
int launch_row(const float* trans, const float* post, int* out, int frames,
               int states, cudaStream_t stream) {
  chase_row_kernel<V, THREADS><<<1, THREADS, 0, stream>>>(trans, post, out,
                                                          frames, states);
  return cudaGetLastError();
}

template <int V>
int by_threads(int threads, const float* trans, const float* post, int* out,
               int frames, int states, cudaStream_t s) {
  if (threads == 32) return launch_row<V, 32>(trans, post, out, frames,
                                              states, s);
  if (threads == 192) return launch_row<V, 192>(trans, post, out, frames,
                                                states, s);
  return cudaErrorInvalidValue;
}

template <int V>
int launch_scalar(const float* trans, int* out, int frames, int states,
                  cudaStream_t stream) {
  chase_scalar_kernel<V><<<1, 1, 0, stream>>>(trans, out, frames, states);
  return cudaGetLastError();
}

}  // namespace

// trans: (states, states) float32; post: (frames, states) float32; out:
// (1,) int32. threads: 1 for the scalar and v2s variants, 32 for tree1, 32
// or 192 for tree12 and the two_trees variants (at most 2048 states);
// v2s_nomod and two_trees_nomod need at least 1024 states.
// Returns a cudaError_t code.
extern "C" int lab_chase(const float* trans, const float* post, int* out,
                         int variant, int threads, int frames, int states,
                         void* stream) {
  if (frames <= 0 || states <= 0) return cudaErrorInvalidValue;
  // These two load rows up to index 1023
  if ((variant == kV2sNomod || variant == kTwoTreesNomod) && states < 1024)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kScalarOnly:
    case kScalarNomod:
    case kV2sFloor:
    case kV2sNomod:
      if (threads != 1) return cudaErrorInvalidValue;
      switch (variant) {
        case kScalarOnly:
          return launch_scalar<kScalarOnly>(trans, out, frames, states, s);
        case kScalarNomod:
          return launch_scalar<kScalarNomod>(trans, out, frames, states, s);
        case kV2sFloor:
          return launch_scalar<kV2sFloor>(trans, out, frames, states, s);
        default:
          return launch_scalar<kV2sNomod>(trans, out, frames, states, s);
      }
    case kTree1:
      if (threads != 32) return cudaErrorInvalidValue;
      return launch_row<kTree1, 32>(trans, post, out, frames, states, s);
    case kTree12:
      return by_threads<kTree12>(threads, trans, post, out, frames, states, s);
    case kTwoTrees:
    case kTwoTreesNomod:
      if (states > kMaxStates) return cudaErrorInvalidValue;
      return variant == kTwoTrees
                 ? by_threads<kTwoTrees>(threads, trans, post, out, frames,
                                         states, s)
                 : by_threads<kTwoTreesNomod>(threads, trans, post, out,
                                              frames, states, s);
    default:
      return cudaErrorInvalidValue;
  }
}
