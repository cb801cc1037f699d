// K9: the sparse (in-list) forward pass.
//
// Replaces no TPU kernel: torbi_tpu decodes every transition no band holds
// with its dense kernel (torbi_tpu/ops/pallas.py::_forward_kernel), over
// all S^2 pairs a frame, as K2 does here. This kernel visits each
// destination's in-list alone, so for a transition whose positive pairs
// are a small share of S^2 (madmom's bar-pointer HMM: 8,934 of 31.55M at
// 5617 states) the work falls by that share.
//
// Per sequence b, with p = conv(obs[b, 0]) + initial and last =
// min(batch_frames[b], frames):
//   for t = 1 .. last - 1, for each destination j, over its in-list
//   (sources i ascending, log values v):
//     best = max_i (p[i] + v); ptr = the lowest i holding it (0 where best
//     is -inf); p'[j] = conv(obs[b, t, j]) + best; pointers[b, t, j] = ptr
//   posterior[b] = p after frame last - 1 (K2's stream freezes there)
// Every candidate outside an in-list is -inf, so the values are K2's
// bitwise (one fp32 add a candidate, the max exact) and the pointer is the
// backpointer K3 recovers from the dense row (ties to the lowest source).
// Rows 0 and from last on of the pointers are not written.
//
// Bound on the H100 (the dbnbeat-b16-tracks cell: 16 tracks a call,
// 1,053,064 frames a cycle at 5617 states): the observation read once,
// 23.7 GB a cycle, 7.1 ms at 3.35 TB/s; the pairs' operations (an add and
// a max for each of 8,934 a frame) 0.56 ms. But each sequence is a chain
// of dependent frames, so one frame's latency on one SM decides.
//
// Design: one CTA of up to 1024 threads a sequence. The posterior is
// double-buffered in shared memory (2 x S floats), and the in-lists stay
// resident beside it where they fit (values, offsets, int16 sources), else
// they are read from global memory. Thread t owns destinations t, t + T,
// ...: it stages their observation kStages - 1 frames ahead into a ring in
// shared memory with 4-byte cp.async copies (its own elements only, so its
// own wait makes them visible: no barrier; never a frame past the row's
// length), where the ring fits (STAGED; else it loads them on the frame).
// A frame runs in two passes. In the first each thread converts its
// destinations' values as K1 does (torbi::convert_obs, the same logf and
// expf as PyTorch's ops) and reduces the in-lists of at most kLight sources
// alone, its destinations independent of each other; a longer in-list's
// converted value waits in the next posterior. In the second each warp
// reduces its owners' longer in-lists (madmom's 82 first states, 16-58
// sources) together: the lanes stride the list, two redux instructions
// over order-preserving keys take the lowest-index maximum, and the owner
// adds it. One barrier a frame. At 1024 threads a thread holds at most 64
// registers: nothing of a frame stays in registers across it.
#include "chase.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kStages = 3;  // observation frames in the ring (2 ahead)
constexpr int kLight = 8;   // in-lists this long or shorter: one thread

struct Lists {
  const int* offsets;
  const short* sources;
  const float* values;
};

// The lowest-index maximum of the warp's (best, best_i) pairs, each lane's
// best_i the lowest of its own maxima (INT_MAX: it saw none); every lane
// gets it, the value copied from a lane that holds it
__device__ __forceinline__ void warp_best(float& best, int& best_i) {
  const unsigned own = best_i == INT_MAX ? 0u : torbi::order_key(best);
  unsigned key = own;
  int index = best_i;
  torbi::warp_argmax_key(key, index);
  const unsigned holder =
      __ballot_sync(0xffffffffu, own == key && best_i == index);
  best = __shfl_sync(0xffffffffu, best, __ffs(holder) - 1);
  best_i = index;
}

template <int CONV, bool STAGED>
__global__ void __launch_bounds__(kMaxThreads, 1) sparse_forward_kernel(
    const float* __restrict__ obs, const int* __restrict__ batch_frames,
    const float* __restrict__ initial, const int* __restrict__ offsets,
    const short* __restrict__ sources, const float* __restrict__ values,
    short* __restrict__ pointers, float* __restrict__ posterior, int frames,
    int states, int pairs, int resident) {
  extern __shared__ __align__(16) float smem[];
  float* post = smem;                     // [2][states]
  float* ring = post + 2 * states;        // [kStages][states] when STAGED
  float* tail = STAGED ? ring + kStages * states : ring;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int nthreads = blockDim.x;
  const int b = blockIdx.x;
  Lists lists{offsets, sources, values};
  if (resident) {
    float* s_values = tail;
    int* s_offsets = reinterpret_cast<int*>(s_values + pairs);
    short* s_sources = reinterpret_cast<short*>(s_offsets + states + 1);
    for (int e = tid; e < pairs; e += nthreads) {
      s_values[e] = values[e];
      s_sources[e] = sources[e];
    }
    for (int j = tid; j <= states; j += nthreads) s_offsets[j] = offsets[j];
    lists = Lists{s_offsets, s_sources, s_values};
  }
  const size_t plane = static_cast<size_t>(states);
  const float* seq = obs + static_cast<size_t>(b) * frames * plane;
  short* seq_ptr = pointers + static_cast<size_t>(b) * frames * plane;
  const int last = max(1, min(batch_frames[b], frames));
  const int per = (states + nthreads - 1) / nthreads;

  // This thread's values of frame f into the ring; a group either way
  auto stage = [&](int f) {
    if (f < last) {
      const float* src = seq + f * plane;
      float* dst = ring + (f % kStages) * states;
      for (int j = tid; j < states; j += nthreads)
        torbi::cp_async4(dst + j, src + j);
    }
    torbi::cp_async_commit();
  };

  for (int j = tid; j < states; j += nthreads)
    post[j] = torbi::convert_obs<CONV>(seq[j]) + initial[j];
  if constexpr (STAGED)
    for (int f = 1; f < kStages; ++f) stage(f);
  __syncthreads();

  for (int t = 1; t < last; ++t) {
    const float* cur = post + ((t - 1) & 1) * states;
    float* nxt = post + (t & 1) * states;
    const float* row;
    if constexpr (STAGED) {
      stage(t + kStages - 1);
      torbi::cp_async_wait<kStages - 1>();
      row = ring + (t % kStages) * states;
    } else {
      row = seq + t * plane;
    }
    short* prow = seq_ptr + t * plane;
    // Pass 1: this thread's destinations, each on its own
    unsigned heavy = 0;
#pragma unroll 2
    for (int k = 0; k < per; ++k) {
      const int j = tid + k * nthreads;
      if (j < states) {
        const int lo = lists.offsets[j];
        const int hi = lists.offsets[j + 1];
        const float x = torbi::convert_obs<CONV>(STAGED ? row[j]
                                                        : __ldcs(row + j));
        if (hi - lo > kLight) {
          nxt[j] = x;
          heavy |= 1u << k;
        } else {
          float best = torbi::neg_inf();
          int best_i = INT_MAX;
          // Sources rise along the list: only a strictly greater value
          // replaces the first one taken
          for (int e = lo; e < hi; ++e) {
            const int i = lists.sources[e];
            const float v = cur[i] + lists.values[e];
            if (best_i == INT_MAX || v > best) {
              best = v;
              best_i = i;
            }
          }
          nxt[j] = x + best;
          prow[j] = static_cast<short>(torbi::settle(best, best_i));
        }
      }
    }
    // Pass 2: the warp's longer in-lists, together
    unsigned rounds = __reduce_or_sync(0xffffffffu, heavy);
    while (rounds) {
      const int k = __ffs(rounds) - 1;
      rounds &= rounds - 1;
      unsigned mask = __ballot_sync(0xffffffffu, (heavy >> k) & 1u);
      while (mask) {
        const int owner = __ffs(mask) - 1;
        mask &= mask - 1;
        const int j = (tid - lane + owner) + k * nthreads;
        const int lo = lists.offsets[j];
        const int hi = lists.offsets[j + 1];
        float best = torbi::neg_inf();
        int best_i = INT_MAX;
        for (int e = lo + lane; e < hi; e += 32) {
          const int i = lists.sources[e];
          const float v = cur[i] + lists.values[e];
          if (best_i == INT_MAX || v > best) {
            best = v;
            best_i = i;
          }
        }
        warp_best(best, best_i);
        if (lane == owner) {
          nxt[j] = nxt[j] + best;
          prow[j] = static_cast<short>(torbi::settle(best, best_i));
        }
      }
    }
    __syncthreads();
  }
  if constexpr (STAGED) torbi::cp_async_wait_all();
  const float* fin = post + ((last - 1) & 1) * states;
  float* out = posterior + static_cast<size_t>(b) * states;
  for (int j = tid; j < states; j += nthreads) out[j] = fin[j];
}

template <int CONV, bool STAGED>
cudaError_t launch(const float* obs, const int* batch_frames,
                   const float* initial, const int* offsets,
                   const short* sources, const float* values, short* pointers,
                   float* posterior, int batch, int frames, int states,
                   int pairs, int threads, int resident, size_t smem,
                   cudaStream_t stream) {
  auto kernel = sparse_forward_kernel<CONV, STAGED>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<batch, threads, smem, stream>>>(
      obs, batch_frames, initial, offsets, sources, values, pointers,
      posterior, frames, states, pairs, resident);
  return cudaGetLastError();
}

template <int CONV>
cudaError_t launch_conv(bool staged, const float* obs,
                        const int* batch_frames, const float* initial,
                        const int* offsets, const short* sources,
                        const float* values, short* pointers,
                        float* posterior, int batch, int frames, int states,
                        int pairs, int threads, int resident, size_t smem,
                        cudaStream_t stream) {
  return staged ? launch<CONV, true>(obs, batch_frames, initial, offsets,
                                     sources, values, pointers, posterior,
                                     batch, frames, states, pairs, threads,
                                     resident, smem, stream)
                : launch<CONV, false>(obs, batch_frames, initial, offsets,
                                      sources, values, pointers, posterior,
                                      batch, frames, states, pairs, threads,
                                      resident, smem, stream);
}

}  // namespace

// obs: (batch, frames, states) float32, converted as it is loaded
// (torbi::conversion(log_input, apply_epsilon)); batch_frames: (batch,)
// int32; initial: (states,) float32; offsets: (states + 1,) int32, sources:
// (pairs,) int16 ascending within each destination, values: (pairs,)
// float32 (the in-lists); pointers: (batch, frames, states) int16;
// posterior: (batch, states) float32. threads: a multiple of 32, at most
// 1024, at least states / 32 (a thread owns at most 32 destinations);
// staged: the observation ring in shared memory; resident: the in-lists
// there too (the wrapper's layout, ops/sparse.py::forward_layout). One CTA
// a sequence. Returns a cudaError_t code.
extern "C" int sparse_forward(const float* obs, const int* batch_frames,
                              const float* initial, const int* offsets,
                              const short* sources, const float* values,
                              short* pointers, float* posterior, int batch,
                              int frames, int states, int pairs,
                              int log_input, int apply_epsilon, int threads,
                              int staged, int resident, void* stream) {
  if (batch <= 0 || frames <= 0 || states <= 0 || states > 32767 ||
      pairs < 0 || threads <= 0 || threads > kMaxThreads || threads % 32 ||
      (states + threads - 1) / threads > 32)
    return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (2 + (staged ? kStages : 0)) *
          static_cast<size_t>(states) +
      (resident ? (sizeof(float) + sizeof(short)) * static_cast<size_t>(pairs) +
                      sizeof(int) * (static_cast<size_t>(states) + 1)
                : 0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (torbi::conversion(log_input, apply_epsilon)) {
    case 0:
      return launch_conv<0>(staged, obs, batch_frames, initial, offsets,
                            sources, values, pointers, posterior, batch,
                            frames, states, pairs, threads, resident, smem, s);
    case 1:
      return launch_conv<1>(staged, obs, batch_frames, initial, offsets,
                            sources, values, pointers, posterior, batch,
                            frames, states, pairs, threads, resident, smem, s);
    case 2:
      return launch_conv<2>(staged, obs, batch_frames, initial, offsets,
                            sources, values, pointers, posterior, batch,
                            frames, states, pairs, threads, resident, smem, s);
    default:
      return launch_conv<3>(staged, obs, batch_frames, initial, offsets,
                            sources, values, pointers, posterior, batch,
                            frames, states, pairs, threads, resident, smem, s);
  }
}
