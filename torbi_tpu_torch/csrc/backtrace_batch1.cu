// K5 and K6: the backtrace of one sequence (batch 1).
//
// K5 (backtrace_fused1) replaces the TPU kernel
// torbi_tpu/ops/backtrace.py::_backtrace12_fused1_kernel (built by
// _build_backtrace12_fused1), the batch-1 chase over every state. K6
// (backtrace_window) replaces _backtrace_window_kernel (built by
// _build_backtrace_window), the batch-1 chase over the band window only.
// Both compute what K3 (csrc/backtrace.cu) computes at batch 1, and what
// the plain version torbi_tpu_torch/ops/backtrace.py::backtrace_reference
// computes:
//   seed = lowest-index argmax of posterior; out[T-1] = seed
//   for t = T-1 .. 1: if t <= batch_frames[0] - 1,
//       idx = lowest-index argmax_i (post_seq[t-1, i] + transition[idx, i])
//     out[t-1] = idx
// with ties compared as (v > best || (v == best && i < best_i)) and a row
// of -inf giving index 0.
//
// K6 takes the argmax over the sources [idx + lo, idx + lo + width) cut to
// [0, states) only. That is exact for a band with a -inf exterior: every
// candidate outside the window is -inf, so the window holds the maximum
// whenever it is finite, and when every candidate is -inf the answer is 0.
// With a finite floor a path can leave the window (ROADMAP.md B6), so the
// wrapper and the dispatcher take K6 for a pure -inf band only.
//
// Bound on the H100 at 1 x 10,240 frames x 1440 states: K5 reads 10,239
// stream rows and as many transition rows, 118 MB, 0.035 ms at 3.35 TB/s;
// its 3.0e7 operations are nothing. K6 reads 175 of each row's 1440
// values. Neither bound is the limit: each step needs the index the step
// before found, so the chase is a chain of 10,239 dependent steps, each an
// L2 round trip for the transition row and a reduction.
//
// K5 design: one CTA, 8 states per thread (192 threads at 1440 states).
// The stream rows do not depend on the chase index, so each thread stages
// its own 8 values of the rows kStages steps ahead with cp.async into a
// ring in shared memory; only the transition row, which depends on the
// index, is loaded on the chain (8 independent loads a thread, from L2:
// the 8.3 MB matrix stays there). Each step is a per-thread argmax, a warp
// reduction of (value, index) pairs, and one __syncthreads over a
// double-buffered table of warp results that every thread then reduces.
//
// K6 design: one warp, no barrier. The window (175 states at the pitch
// shape) is 6 values a lane; the stream rows are prefetched into L2
// kPrefetch steps ahead, so both loads of a step come from L2.
#include "chase.cuh"

namespace {

using torbi::block_argmax;
using torbi::settle;
using torbi::take;
using torbi::warp_reduce;

constexpr int kEpt = 8;        // states per thread in K5
constexpr int kStages = 4;     // K5 stream rows staged ahead
constexpr int kPrefetch = 8;   // K6 stream rows prefetched ahead

__global__ void __launch_bounds__(1024) backtrace_fused1_kernel(
    const float* __restrict__ post_seq, const float* __restrict__ posterior,
    const float* __restrict__ transition,
    const int* __restrict__ batch_frames, int* __restrict__ out, int frames,
    int states) {
  extern __shared__ float ring[];  // [kStages][kEpt][blockDim]
  __shared__ float table_v[2][32];
  __shared__ int table_i[2][32];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;

  int idx = block_argmax(posterior, states, table_v[1], table_i[1]);
  // The chase starts at t_top; positions from there on hold the seed
  const int t_top = min(batch_frames[0] - 1, frames - 1);
  for (int p = max(t_top, 0) + tid; p < frames; p += nthreads) out[p] = idx;

  // Step s chases t = t_top - s through stream row t_top - 1 - s; stage
  // this thread's values of that row into ring stage s % kStages
  auto stage = [&](int s) {
    const int r = t_top - 1 - s;
    if (r >= 0) {
      const float* src = post_seq + static_cast<size_t>(r) * states;
      float* dst = ring + (s % kStages) * kEpt * nthreads + tid;
#pragma unroll
      for (int k = 0; k < kEpt; ++k) {
        const int i = k * nthreads + tid;
        if (i < states) torbi::cp_async4(dst + k * nthreads, src + i);
      }
    }
    torbi::cp_async_commit();
  };
  for (int s = 0; s < kStages; ++s) stage(s);

  for (int s = 0, t = t_top; t >= 1; ++s, --t) {
    const float* trans = transition + static_cast<size_t>(idx) * states;
    float tv[kEpt];
#pragma unroll
    for (int k = 0; k < kEpt; ++k) {
      const int i = k * nthreads + tid;
      tv[k] = i < states ? __ldg(trans + i) : 0.f;
    }
    torbi::cp_async_wait<kStages - 1>();
    const float* cell = ring + (s % kStages) * kEpt * nthreads + tid;
    float best = torbi::neg_inf();
    int best_i = INT_MAX;
    // Indices rise with k: only a strictly greater value replaces the
    // first one taken
#pragma unroll
    for (int k = 0; k < kEpt; ++k) {
      const int i = k * nthreads + tid;
      if (i < states) {
        const float v = cell[k * nthreads] + tv[k];
        if (best_i == INT_MAX || v > best) {
          best = v;
          best_i = i;
        }
      }
    }
    warp_reduce(best, best_i);
    const int p = s & 1;
    if ((tid & 31) == 0) {
      table_v[p][tid >> 5] = best;
      table_i[p][tid >> 5] = best_i;
    }
    // The stage just read is refilled with the row of step s + kStages
    stage(s + kStages);
    __syncthreads();
    best = torbi::neg_inf();
    best_i = INT_MAX;
    for (int w = 0; w < nwarps; ++w) take(best, best_i, table_v[p][w],
                                          table_i[p][w]);
    idx = settle(best, best_i);
    if (tid == 0) out[t - 1] = idx;
  }
  torbi::cp_async_wait_all();
}

__device__ __forceinline__ void prefetch_row(const float* row, int states,
                                             int lane) {
  // One prefetch per 128-byte line
  for (int i = lane * 32; i < states; i += 32 * 32)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(row + i));
}

__global__ void __launch_bounds__(32) backtrace_window_kernel(
    const float* __restrict__ post_seq, const float* __restrict__ posterior,
    const float* __restrict__ transition,
    const int* __restrict__ batch_frames, int* __restrict__ out, int frames,
    int states, int lo, int width) {
  const int lane = threadIdx.x;
  float best = torbi::neg_inf();
  int best_i = INT_MAX;
  for (int i = lane; i < states; i += 32) take(best, best_i, posterior[i], i);
  warp_reduce(best, best_i);
  int idx = settle(best, best_i);
  const int t_top = min(batch_frames[0] - 1, frames - 1);
  for (int p = max(t_top, 0) + lane; p < frames; p += 32) out[p] = idx;

  for (int r = t_top - 1; r >= 0 && r >= t_top - kPrefetch; --r)
    prefetch_row(post_seq + static_cast<size_t>(r) * states, states, lane);
  for (int t = t_top; t >= 1; --t) {
    if (t - 1 - kPrefetch >= 0)
      prefetch_row(post_seq + static_cast<size_t>(t - 1 - kPrefetch) * states,
                   states, lane);
    const float* row = post_seq + static_cast<size_t>(t - 1) * states;
    const float* trans = transition + static_cast<size_t>(idx) * states;
    const int begin = max(0, idx + lo);
    const int end = min(states, idx + lo + width);
    best = torbi::neg_inf();
    best_i = INT_MAX;
#pragma unroll 8
    for (int i = begin + lane; i < end; i += 32) {
      const float v = row[i] + __ldg(trans + i);
      if (best_i == INT_MAX || v > best) {
        best = v;
        best_i = i;
      }
    }
    warp_reduce(best, best_i);
    idx = settle(best, best_i);
    if (lane == 0) out[t - 1] = idx;
  }
}

}  // namespace

// post_seq: (1, frames, states) float32; posterior: (1, states) float32;
// transition: (states, states) float32, row = destination; batch_frames:
// (1,) int32; out: (1, frames) int32. Returns a cudaError_t code.
extern "C" int backtrace_fused1(const float* post_seq, const float* posterior,
                                const float* transition,
                                const int* batch_frames, int* out,
                                int frames, int states, void* stream) {
  if (frames <= 0 || states <= 0) return cudaErrorInvalidValue;
  const int threads = ((states + kEpt - 1) / kEpt + 31) / 32 * 32;
  if (threads > 1024) return cudaErrorInvalidValue;
  const size_t smem =
      static_cast<size_t>(kStages) * kEpt * threads * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      backtrace_fused1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  backtrace_fused1_kernel<<<1, threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      post_seq, posterior, transition, batch_frames, out, frames, states);
  return cudaGetLastError();
}

// As backtrace_fused1, plus the band's lo and width (> 0); the band must
// have a -inf exterior. Returns a cudaError_t code.
extern "C" int backtrace_window(const float* post_seq, const float* posterior,
                                const float* transition,
                                const int* batch_frames, int* out,
                                int frames, int states, int lo, int width,
                                void* stream) {
  if (frames <= 0 || states <= 0 || width <= 0) return cudaErrorInvalidValue;
  backtrace_window_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      post_seq, posterior, transition, batch_frames, out, frames, states, lo,
      width);
  return cudaGetLastError();
}
