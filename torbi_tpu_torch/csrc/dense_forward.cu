// K2: dense Viterbi forward pass.
//
// Replaces the TPU kernel torbi_tpu/ops/pallas.py::_forward_kernel (built
// by _build_forward), in the natural (batch, frames, states) layout and
// without the TPU's state padding.
//
// Per sequence b and frame t >= 1, with post the posterior after frame t-1:
//   score[j] = max_i (post[i] + transition[j, i])
//   post'[j] = t < batch_frames[b] ? obs[b, t, j] + score[j] : post[j]
// and at t = 0, post = obs[b, 0] + initial. Every output is written to
// post_seq[b, t]. Each candidate is one fp32 add and fmaxf does not depend
// on order, so the stream is bitwise that of the plain version
// (torbi_tpu_torch/ops/dense.py::dense_forward_reference).
//
// Bound on the H100: batch * (frames - 1) * states^2 candidates at one add
// and one max each over 33.5e12 FP32 operations per second (132 SMs x 128
// lanes x 1.98 GHz); at 1440 states that is 0.12 us per sequence-frame,
// against 3.4 ns for its 11.5 KB of observation in and posterior out at
// 3.35 TB/s. So operations bound it.
//
// Design: the frame loop of the banded kernel (one CTA holds NB sequences
// with their posteriors double-buffered in shared memory, one
// __syncthreads per frame). A warp takes one destination j at a time: its
// lanes stride over the sources i, so the row transition[j] (8.3 MB for
// all rows at 1440 states, resident in the 50 MB L2) is read coalesced
// and once for all NB sequences, and the source reads from shared memory
// are conflict-free. A warp max ends each destination; lane n writes
// sequence n's value.
#include "common.cuh"

namespace {

template <int NB>
__global__ void __launch_bounds__(512) dense_forward_kernel(
    const float* __restrict__ obs, const int* __restrict__ batch_frames,
    const float* __restrict__ initial, const float* __restrict__ transition,
    float* __restrict__ post_seq, int batch, int frames, int states) {
  extern __shared__ float smem[];
  float* post = smem;  // [2][NB][states]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int b0 = blockIdx.x * NB;

  int bf[NB];
  bool live[NB];
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    live[n] = b0 + n < batch;
    bf[n] = live[n] ? batch_frames[b0 + n] : 0;
  }

  for (int j = tid; j < states; j += blockDim.x) {
    const float init_j = initial[j];
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      float v = torbi::neg_inf();
      if (live[n]) {
        const size_t off = static_cast<size_t>(b0 + n) * frames * states + j;
        v = obs[off] + init_j;
        post_seq[off] = v;
      }
      post[n * states + j] = v;
    }
  }
  __syncthreads();

  int cur = 0;
  for (int t = 1; t < frames; ++t) {
    const float* pc = post + cur * NB * states;
    float* pn = post + (cur ^ 1) * NB * states;

    bool valid[NB];
    bool any = false;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      valid[n] = t < bf[n];
      any = any || valid[n];
    }

    for (int j = warp; j < states; j += nwarps) {
      float acc[NB];
#pragma unroll
      for (int n = 0; n < NB; ++n) acc[n] = torbi::neg_inf();
      if (any) {
        const float* row = transition + static_cast<size_t>(j) * states;
#pragma unroll 4
        for (int i = lane; i < states; i += 32) {
          const float tv = __ldg(row + i);
#pragma unroll
          for (int n = 0; n < NB; ++n)
            acc[n] = fmaxf(acc[n], pc[n * states + i] + tv);
        }
#pragma unroll
        for (int n = 0; n < NB; ++n) acc[n] = torbi::warp_max(acc[n]);
      }
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        if (lane == n) {
          float v = pc[n * states + j];
          if (live[n]) {
            const size_t off =
                (static_cast<size_t>(b0 + n) * frames + t) * states + j;
            if (valid[n]) v = obs[off] + acc[n];
            post_seq[off] = v;
          }
          pn[n * states + j] = v;
        }
      }
    }
    __syncthreads();
    cur ^= 1;
  }
}

template <int NB>
int launch(const float* obs, const int* batch_frames, const float* initial,
           const float* transition, float* post_seq, int batch, int frames,
           int states, cudaStream_t stream) {
  // The per-warp scratch of the banded kernel is not used here, but the
  // shared size rule is kept so both kernels take the same NB
  const size_t smem = torbi::forward_smem_bytes(NB, states);
  cudaError_t err = cudaFuncSetAttribute(
      dense_forward_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((batch + NB - 1) / NB);
  dense_forward_kernel<NB><<<grid, torbi::forward_threads(states), smem,
                             stream>>>(obs, batch_frames, initial,
                                       transition, post_seq, batch, frames,
                                       states);
  return cudaGetLastError();
}

}  // namespace

// obs, post_seq: (batch, frames, states) float32; batch_frames: (batch,)
// int32; initial: (states,) float32; transition: (states, states) float32,
// row = destination. Returns a cudaError_t code.
extern "C" int dense_forward(const float* obs, const int* batch_frames,
                             const float* initial, const float* transition,
                             float* post_seq, int batch, int frames,
                             int states, void* stream) {
  if (batch <= 0 || frames <= 0 || states <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (torbi::forward_sequences_per_cta(batch, states)) {
    case 4:
      return launch<4>(obs, batch_frames, initial, transition, post_seq,
                       batch, frames, states, s);
    case 2:
      return launch<2>(obs, batch_frames, initial, transition, post_seq,
                       batch, frames, states, s);
    case 1:
      return launch<1>(obs, batch_frames, initial, transition, post_seq,
                       batch, frames, states, s);
    default:
      return cudaErrorInvalidValue;
  }
}
