// K3: backtrace over the stored posterior stream.
//
// Replaces the TPU kernel torbi_tpu/ops/backtrace.py::_backtrace12_kernel_loop
// (built by _build_backtrace12, the chase of the stitched banded path) and
// its natural-layout twins _backtrace_kernel and _backtrace_kernel_loop
// (built by _build_backtrace, the chase after the dense forward). Here
// there is one kernel, in the natural (batch, frames, states) layout.
//
// Per sequence b, with T frames and last = batch_frames[b] - 1:
//   seed = lowest-index argmax of posterior[b]; out[b, T-1] = seed
//   for t = T-1 .. 1: if t <= last,
//       idx = lowest-index argmax_i (post_seq[b, t-1, i] + transition[idx, i])
//     out[b, t-1] = idx
// so positions at or past last hold the seed. This is the backpointer the
// dense recursion would have recorded, with the lowest source index
// winning ties, recovered only along the chosen path. Ties compare as
// (v > best || (v == best && i < best_i)); the rule "the lower lane wins"
// is wrong on ties, because lane order is not index order after the
// first stride. A row of -inf gives index 0, as argmax does.
//
// Bound on the H100 at the headline shape (512 x 512 x 1440): the stream
// rows the chase reads, 512 * 511 * 1440 * 4 B = 1.5 GB, take ~0.45 ms at
// 3.35 TB/s; the operations (one add and one compare per element, 7.5e8)
// are negligible. So bytes bound it, but each sequence is a serial chain
// of 511 dependent steps, each a transition-row load from L2 and a
// reduction over the row, so latency per step decides the time.
//
// Design (K5's, csrc/backtrace_batch1.cu, at batch): one CTA per sequence,
// 8 states per thread (192 threads at 1440 states), several CTAs per SM.
// The stream rows do not depend on the chase index, so each thread stages
// its own values of the rows kStages steps ahead with cp.async into a ring
// in shared memory (24 KB at 1440 states); only the transition row, which
// depends on the index, is loaded on the chain: independent loads from L2
// (the 8.3 MB matrix stays there), all issued before any is used. Each
// step takes a per-thread lowest-index argmax, then per warp two redux
// instructions over order-preserving keys (the largest key, then the
// lowest index holding it), a double-buffered table of warp results, one
// __syncthreads, and the same two reduxes over the table. Rows of more
// than 8 x 1024 states are chased without staging: each thread loops over
// the row, both loads from memory.
#include "chase.cuh"

namespace {

constexpr int kEpt = 8;     // states per thread staged
constexpr int kStages = 4;  // stream rows staged ahead

template <bool STAGED>
__global__ void __launch_bounds__(1024) backtrace_kernel(
    const float* __restrict__ post_seq, const float* __restrict__ posterior,
    long long posterior_stride, const float* __restrict__ transition,
    const int* __restrict__ batch_frames, int* __restrict__ out, int frames,
    int states) {
  extern __shared__ float ring[];  // [kStages][kEpt][blockDim] when STAGED
  __shared__ float seed_v[32];
  __shared__ int seed_i[32];
  __shared__ unsigned table_k[2][32];
  __shared__ int table_i[2][32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const float* seq = post_seq + static_cast<size_t>(b) * frames * states;
  int* row_out = out + static_cast<size_t>(b) * frames;

  int idx = torbi::block_argmax(posterior + b * posterior_stride, states,
                                seed_v, seed_i);
  // The chase starts at t_top; positions from there on hold the seed
  const int t_top = min(batch_frames[b] - 1, frames - 1);
  for (int p = max(t_top, 0) + tid; p < frames; p += nthreads)
    row_out[p] = idx;

  // Step s chases t = t_top - s through stream row t_top - 1 - s; stage
  // this thread's values of that row into ring stage s % kStages
  auto stage = [&](int s) {
    const int r = t_top - 1 - s;
    if (r >= 0) {
      const float* src = seq + static_cast<size_t>(r) * states;
      float* dst = ring + (s % kStages) * kEpt * nthreads + tid;
#pragma unroll
      for (int k = 0; k < kEpt; ++k) {
        const int i = k * nthreads + tid;
        if (i < states) torbi::cp_async4(dst + k * nthreads, src + i);
      }
    }
    torbi::cp_async_commit();
  };
  if constexpr (STAGED)
    for (int s = 0; s < kStages; ++s) stage(s);

  for (int s = 0, t = t_top; t >= 1; ++s, --t) {
    const float* trans = transition + static_cast<size_t>(idx) * states;
    float best = torbi::neg_inf();
    int best_i = INT_MAX;
    // Indices rise along a thread's loop: only a strictly greater value
    // replaces the first one taken
    if constexpr (STAGED) {
      float tv[kEpt];
#pragma unroll
      for (int k = 0; k < kEpt; ++k) {
        const int i = k * nthreads + tid;
        tv[k] = i < states ? __ldg(trans + i) : 0.f;
      }
      torbi::cp_async_wait<kStages - 1>();
      const float* cell = ring + (s % kStages) * kEpt * nthreads + tid;
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
    } else {
      const float* row = seq + static_cast<size_t>(t - 1) * states;
      for (int i = tid; i < states; i += nthreads) {
        const float v = row[i] + __ldg(trans + i);
        if (best_i == INT_MAX || v > best) {
          best = v;
          best_i = i;
        }
      }
    }
    // A thread that saw no element offers key 0, below every float's
    unsigned key = best_i == INT_MAX ? 0u : torbi::order_key(best);
    torbi::warp_argmax_key(key, best_i);
    const int p = s & 1;
    if (lane == 0) {
      table_k[p][tid >> 5] = key;
      table_i[p][tid >> 5] = best_i;
    }
    // The stage just read is refilled with the row of step s + kStages
    if constexpr (STAGED) stage(s + kStages);
    __syncthreads();
    key = lane < nwarps ? table_k[p][lane] : 0u;
    best_i = lane < nwarps ? table_i[p][lane] : INT_MAX;
    torbi::warp_argmax_key(key, best_i);
    idx = best_i;
    if (tid == 0) row_out[t - 1] = idx;
  }
  if constexpr (STAGED) torbi::cp_async_wait_all();
}

}  // namespace

// post_seq: (batch, frames, states) float32; posterior: (batch, states)
// float32 rows posterior_stride elements apart; transition: (states,
// states) float32, row = destination; batch_frames: (batch,) int32; out:
// (batch, frames) int32. One CTA per sequence. Returns a cudaError_t code.
extern "C" int backtrace(const float* post_seq, const float* posterior,
                         long long posterior_stride, const float* transition,
                         const int* batch_frames, int* out, int batch,
                         int frames, int states, void* stream) {
  if (batch <= 0 || frames <= 0 || states <= 0) return cudaErrorInvalidValue;
  const int wanted = ((states + kEpt - 1) / kEpt + 31) / 32 * 32;
  const int threads = wanted < 1024 ? wanted : 1024;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (states > kEpt * threads) {
    backtrace_kernel<false><<<batch, threads, 0, s>>>(
        post_seq, posterior, posterior_stride, transition, batch_frames, out,
        frames, states);
    return cudaGetLastError();
  }
  const size_t smem =
      static_cast<size_t>(kStages) * kEpt * threads * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      backtrace_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  backtrace_kernel<true><<<batch, threads, smem, s>>>(
      post_seq, posterior, posterior_stride, transition, batch_frames, out,
      frames, states);
  return cudaGetLastError();
}
