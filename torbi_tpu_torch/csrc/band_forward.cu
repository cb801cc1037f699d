// K1: banded Viterbi forward pass, with an optional constant floor.
//
// Replaces the TPU kernel torbi_tpu/ops/band.py::_band_kernel_stitched
// (built by _build_band_forward_stitched), and with it the natural-layout
// kernels _band_kernel and _band_kernel_tilted that compute the same
// values. The stitched mod-M layout only works around the TPU's lane
// permute unit; here the layout is the natural (batch, frames, states).
//
// Per sequence b and frame t >= 1, with post the posterior after frame t-1:
//   score[j] = max_d (post[j + d + lo] + band[d, j]),  d in [0, width),
//              sources outside [0, states) skipped (their band entry is -inf)
//   score[j] = max(score[j], floor + max_i post[i])    when has_floor
//   post'[j] = t < batch_frames[b] ? obs[b, t, j] + score[j] : post[j]
// and at t = 0, post = obs[b, 0] + initial. Every output is written to
// post_seq[b, t]. Each candidate is one fp32 add and fmaxf does not depend
// on order, so the stream is bitwise that of the plain version
// (torbi_tpu_torch/ops/band.py::band_forward_reference).
//
// Bound on the H100 at the headline shape (512 sequences x 512 frames x
// 1440 states, band width 175): 512 * 511 * 1440 * 175 = 6.6e10 candidates
// at one add and one max each is 1.3e11 FP32 operations, ~3.9 ms at the
// 33.5e12 per second of 132 SMs x 128 lanes x 1.98 GHz; the 3.0 GB that
// must move (observation in, posterior stream out) take ~0.9 ms at
// 3.35 TB/s. So operations bound it.
//
// Design: one CTA holds NB sequences with their posteriors double-buffered
// in shared memory (2 * NB * states * 4 bytes: 46 KB at NB = 4 and 1440
// states), so each candidate's source is a shared-memory load. Each band
// value is loaded once (the 1 MB band matrix streams through L2 every
// frame) and used for all NB sequences, which divides that L2 traffic by
// NB. Each thread owns destinations j = tid, tid + blockDim, ...; its
// offset loop is clipped to the sources in range, so no candidate is spent
// on the -inf edges. The floor term needs the max of the previous
// posterior: each thread folds what it writes into a running max, warps
// reduce it into a double-buffered scratch, and one __syncthreads per
// frame publishes both the new posterior and its max. The operation bound
// is not reached: each candidate also costs a shared-memory load, whose
// rate (32 words per SM and clock) is a quarter of the ALU rate.
#include "common.cuh"

namespace {

template <int NB>
__global__ void __launch_bounds__(512) band_forward_kernel(
    const float* __restrict__ obs, const int* __restrict__ batch_frames,
    const float* __restrict__ initial, const float* __restrict__ band,
    float* __restrict__ post_seq, int batch, int frames, int states, int lo,
    int width, float floor_value, int has_floor) {
  extern __shared__ float smem[];
  float* post = smem;                   // [2][NB][states]
  float* red = smem + 2 * NB * states;  // [2][NB][32] per-warp maxima
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int b0 = blockIdx.x * NB;

  // Rows past the batch get 0 frames: never valid, never written
  int bf[NB];
  bool live[NB];
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    live[n] = b0 + n < batch;
    bf[n] = live[n] ? batch_frames[b0 + n] : 0;
  }

  float lmax[NB];
#pragma unroll
  for (int n = 0; n < NB; ++n) lmax[n] = torbi::neg_inf();
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
      lmax[n] = fmaxf(lmax[n], v);
    }
  }
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    const float m = torbi::warp_max(lmax[n]);
    if (lane == 0) red[n * 32 + warp] = m;
  }
  __syncthreads();

  int cur = 0;
  for (int t = 1; t < frames; ++t) {
    const float* pc = post + cur * NB * states;
    float* pn = post + (cur ^ 1) * NB * states;
    const float* rc = red + cur * NB * 32;
    float* rn = red + (cur ^ 1) * NB * 32;

    bool valid[NB];
    bool any = false;
    float base[NB];
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      valid[n] = t < bf[n];
      any = any || valid[n];
      float g = torbi::neg_inf();
      if (has_floor) {
        for (int w = 0; w < nwarps; ++w) g = fmaxf(g, rc[n * 32 + w]);
        g = g + floor_value;
      }
      base[n] = g;
      lmax[n] = torbi::neg_inf();
    }

    for (int j = tid; j < states; j += blockDim.x) {
      float acc[NB];
#pragma unroll
      for (int n = 0; n < NB; ++n) acc[n] = base[n];
      if (any) {
        const int d_begin = max(0, -lo - j);
        const int d_end = min(width, states - lo - j);
        const float* col = band + j;
        const int src = j + lo;
#pragma unroll 4
        for (int d = d_begin; d < d_end; ++d) {
          const float bv = __ldg(col + static_cast<size_t>(d) * states);
#pragma unroll
          for (int n = 0; n < NB; ++n)
            acc[n] = fmaxf(acc[n], pc[n * states + src + d] + bv);
        }
      }
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        float v = pc[n * states + j];
        if (live[n]) {
          const size_t off =
              (static_cast<size_t>(b0 + n) * frames + t) * states + j;
          if (valid[n]) v = obs[off] + acc[n];
          post_seq[off] = v;
        }
        pn[n * states + j] = v;
        lmax[n] = fmaxf(lmax[n], v);
      }
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const float m = torbi::warp_max(lmax[n]);
      if (lane == 0) rn[n * 32 + warp] = m;
    }
    __syncthreads();
    cur ^= 1;
  }
}

template <int NB>
int launch(const float* obs, const int* batch_frames, const float* initial,
           const float* band, float* post_seq, int batch, int frames,
           int states, int lo, int width, float floor_value, int has_floor,
           cudaStream_t stream) {
  const size_t smem = torbi::forward_smem_bytes(NB, states);
  cudaError_t err = cudaFuncSetAttribute(
      band_forward_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((batch + NB - 1) / NB);
  band_forward_kernel<NB><<<grid, torbi::forward_threads(states), smem,
                            stream>>>(obs, batch_frames, initial, band,
                                      post_seq, batch, frames, states, lo,
                                      width, floor_value, has_floor);
  return cudaGetLastError();
}

}  // namespace

// obs, post_seq: (batch, frames, states) float32; batch_frames: (batch,)
// int32; initial: (states,) float32; band: (width, states) float32 with
// band[d, j] = transition[j, j + d + lo]. Returns a cudaError_t code.
extern "C" int band_forward(const float* obs, const int* batch_frames,
                            const float* initial, const float* band,
                            float* post_seq, int batch, int frames,
                            int states, int lo, int width, float floor_value,
                            int has_floor, void* stream) {
  if (batch <= 0 || frames <= 0 || states <= 0 || width < 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (torbi::forward_sequences_per_cta(batch, states)) {
    case 4:
      return launch<4>(obs, batch_frames, initial, band, post_seq, batch,
                       frames, states, lo, width, floor_value, has_floor, s);
    case 2:
      return launch<2>(obs, batch_frames, initial, band, post_seq, batch,
                       frames, states, lo, width, floor_value, has_floor, s);
    case 1:
      return launch<1>(obs, batch_frames, initial, band, post_seq, batch,
                       frames, states, lo, width, floor_value, has_floor, s);
    default:
      return cudaErrorInvalidValue;
  }
}
