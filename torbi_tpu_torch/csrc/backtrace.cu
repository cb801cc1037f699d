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
// of 511 dependent steps, each a row load and a warp reduction, so
// latency decides the time in practice.
//
// Design: one warp per sequence, four sequences per CTA. A step reads the
// rows post_seq[b, t-1] and transition[idx] with the lanes striding over
// the states (coalesced; the transition rows come from L2), keeps each
// lane's first maximum, and combines (value, index) pairs with xor
// shuffles. Past batch_frames the chase holds the seed and reads nothing.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

// Lowest-index argmax over i in [0, states) of row[i] (+ add[i]); every
// lane gets the result
__device__ __forceinline__ int warp_argmax(const float* __restrict__ row,
                                           const float* __restrict__ add,
                                           int states, int lane) {
  float best = torbi::neg_inf();
  int best_i = INT_MAX;
  for (int i = lane; i < states; i += 32) {
    const float v = add != nullptr ? row[i] + add[i] : row[i];
    // A lane visits its indices in increasing order: only a strictly
    // greater value may replace the first one taken
    if (best_i == INT_MAX || v > best) {
      best = v;
      best_i = i;
    }
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    const float other = __shfl_xor_sync(0xffffffffu, best, offset);
    const int other_i = __shfl_xor_sync(0xffffffffu, best_i, offset);
    if (other > best || (other == best && other_i < best_i)) {
      best = other;
      best_i = other_i;
    }
  }
  return best_i;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32) backtrace_kernel(
    const float* __restrict__ post_seq, const float* __restrict__ posterior,
    long long posterior_stride, const float* __restrict__ transition,
    const int* __restrict__ batch_frames, int* __restrict__ out, int batch,
    int frames, int states) {
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= batch) return;
  const int lane = threadIdx.x & 31;
  const float* seq = post_seq + static_cast<size_t>(b) * frames * states;
  int* row_out = out + static_cast<size_t>(b) * frames;

  int idx = warp_argmax(posterior + b * posterior_stride, nullptr, states,
                        lane);
  if (lane == 0) row_out[frames - 1] = idx;
  const int last = batch_frames[b] - 1;
  for (int t = frames - 1; t >= 1; --t) {
    if (t <= last)
      idx = warp_argmax(seq + static_cast<size_t>(t - 1) * states,
                        transition + static_cast<size_t>(idx) * states,
                        states, lane);
    if (lane == 0) row_out[t - 1] = idx;
  }
}

}  // namespace

// post_seq: (batch, frames, states) float32; posterior: (batch, states)
// float32 rows posterior_stride elements apart; transition: (states,
// states) float32, row = destination; batch_frames: (batch,) int32; out:
// (batch, frames) int32. Returns a cudaError_t code.
extern "C" int backtrace(const float* post_seq, const float* posterior,
                         long long posterior_stride, const float* transition,
                         const int* batch_frames, int* out, int batch,
                         int frames, int states, void* stream) {
  if (batch <= 0 || frames <= 0 || states <= 0) return cudaErrorInvalidValue;
  const dim3 grid((batch + kWarpsPerBlock - 1) / kWarpsPerBlock);
  backtrace_kernel<<<grid, kWarpsPerBlock * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      post_seq, posterior, posterior_stride, transition, batch_frames, out,
      batch, frames, states);
  return cudaGetLastError();
}
