// K4: banded Viterbi forward pass of one sequence, spread over a cluster.
//
// Replaces the TPU kernel torbi_tpu/ops/band.py::_band_kernel_spread (built
// by _build_band_forward_spread), the batch-1 banded forward pass. On the
// TPU it fills the 8 sublane slots that idle at batch 1 with band-offset-
// shifted replicas of the one sequence and emits 8 replicas of the stream
// for the 8-row chase tile. Here it emits the one natural row: the same
// values as K1 (csrc/band_forward.cu) at batch 1, and as the plain version
// torbi_tpu_torch/ops/band.py::band_spread_reference.
//
// Per frame t >= 1, with post the posterior after frame t-1:
//   score[j] = max_d (post[j + d + lo] + band[d, j]),  d in [0, width),
//              sources outside [0, states) skipped
//   score[j] = max(score[j], floor + max_i post[i])    when has_floor
//   post'[j] = t < batch_frames[0] ? obs[t, j] + score[j] : post[j]
// and post = obs[0] + initial at t = 0. Each candidate is one fp32 add and
// fmaxf does not depend on order, so any order of the maxima is exact. The
// observation may arrive unconverted, as the TPU kernel takes it
// (_band_kernel_spread's obs_col, torbi_tpu/ops/band.py:882-884): each
// value takes the log of a probability (log_input = 0) and the epsilon step
// (apply_epsilon = 1) once it has landed in the staging ring, never in the
// copy (common.cuh, convert_obs): each thread converts its own cells of a
// frame in place while the barrier before that frame completes. Only
// frames before batch_frames are staged and converted.
//
// Bound on the H100 at 1 x 10,240 frames x 1440 pitch states (band width
// 175): 10,239 frames x 244,344 in-band candidates at an add and a max each
// is 5.0e9 FP32 operations, 0.075 ms at 67 TFLOP/s; the 118 MB that must
// move (observation in, stream out) take 0.035 ms at 3.35 TB/s. Neither is
// the real limit: the frames form a chain of 10,239 dependent steps, each a
// round of candidates and a barrier, so latency per frame decides the time.
//
// Why not K1: K1 gives a sequence to one CTA, so at batch 1 it runs on one
// SM of 132. Design: a cluster of 8 CTAs on 8 SMs. CTA r owns destinations
// [r * per_cta, (r + 1) * per_cta) and keeps its slice of the band matrix
// resident in its shared memory (175 x 200 floats, 140 KB at the pitch
// shape), so the matrix is read from device memory once; a band too wide
// for the 227 KB opt-in (at 1440 states, wider than 259) is refused, and
// dispatch sends it to K1. Every CTA keeps a
// full, double-buffered copy of the posterior; each new value is written
// into all 8 copies through distributed shared memory, and each warp's
// maximum (for the floor term) into all 8 CTAs' tables of warp maxima. One
// cluster barrier per frame publishes both. Inside a CTA, 4 neighbouring
// lanes share a destination, take every 4th band offset each, and combine
// with two xor shuffles; 8 destinations per warp. The observation rows are
// staged kStages frames ahead with cp.async into a per-thread ring. The
// cluster barrier of each frame is split (arrive, then wait), with the
// next frame's observation converted in between.
#include <cooperative_groups.h>

#include "cluster.cuh"
#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;           // CTAs per cluster (portable maximum)
constexpr int kGroups = 4;            // lanes sharing one destination
constexpr int kDestsPerWarp = 32 / kGroups;
constexpr int kStages = 4;            // observation frames staged ahead

struct Layout {
  int per_cta;      // destinations per CTA
  int warps;        // warps per CTA
  int slots;        // destinations per group of 4 lanes
  int band_stride;  // row stride of the resident band slice
};

__host__ __device__ inline Layout make_layout(int states) {
  Layout l;
  l.per_cta = (states + kCluster - 1) / kCluster;
  const int dest_warps = (l.per_cta + kDestsPerWarp - 1) / kDestsPerWarp;
  l.warps = dest_warps < 32 ? dest_warps : 32;
  l.slots = (l.per_cta + l.warps * kDestsPerWarp - 1) /
            (l.warps * kDestsPerWarp);
  // 8 (mod 32): the 4 lane groups of a warp read 4 band rows at once, and
  // this stride puts their 32 words in 32 different banks
  const int over = l.per_cta > 8 ? l.per_cta - 8 : 0;
  l.band_stride = (over + 31) / 32 * 32 + 8;
  return l;
}

// Floats of shared memory: the double-buffered posterior, the
// double-buffered table of warp maxima, the observation ring, then the band
// slice. torbi_tpu_torch/ops/band.py::spread_smem_bytes computes the same
// size, so that dispatch sends a band that does not fit to K1
__host__ __device__ inline size_t smem_floats(const Layout& l, int states,
                                             int width) {
  return 2 * static_cast<size_t>(states) + 2 * kCluster * l.warps +
         static_cast<size_t>(kStages) * l.slots * l.warps * 32 +
         static_cast<size_t>(width) * l.band_stride;
}

template <int CONV>
__global__ void __launch_bounds__(1024) band_spread_kernel(
    const float* __restrict__ obs, const int* __restrict__ batch_frames,
    const float* __restrict__ initial, const float* __restrict__ band,
    float* __restrict__ post_seq, int frames, int states, int lo, int width,
    float floor_value, int has_floor) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Layout l = make_layout(states);
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane & (kGroups - 1);
  const int dl = lane / kGroups;
  const int nthreads = l.warps * 32;
  const int table = kCluster * l.warps;  // warp maxima per buffer

  float* post = smem;                  // [2][states]
  float* red = post + 2 * states;      // [2][table]
  float* ring = red + 2 * table;       // [kStages][slots][nthreads]
  float* band_s = ring + kStages * l.slots * nthreads;  // [width][stride]

  const int j0 = rank * l.per_cta;
  const int count = max(0, min(l.per_cta, states - j0));
  const int t_end = min(max(batch_frames[0], 1), frames);

  for (int e = tid; e < width * count; e += nthreads) {
    const int d = e / count;
    const int jl = e - d * count;
    band_s[d * l.band_stride + jl] =
        band[static_cast<size_t>(d) * states + j0 + jl];
  }
  // The 4 lanes of a destination write its value into CTAs g and g + 4;
  // lanes 0-7 write the warp's maximum into CTA `lane`
  float* post_a = cluster.map_shared_rank(post, g);
  float* post_b = cluster.map_shared_rank(post, g + kGroups);
  float* red_r = cluster.map_shared_rank(red, lane & (kCluster - 1));

  // Stage the observation of frame t, slot by slot, into ring stage t
  auto stage = [&](int t) {
    if (t < t_end) {
      float* cell = ring + (t % kStages) * l.slots * nthreads + tid;
      for (int s = 0; s < l.slots; ++s) {
        const int jl = (s * l.warps + warp) * kDestsPerWarp + dl;
        if (jl < count)
          torbi::cp_async4(cell + s * nthreads,
                           obs + static_cast<size_t>(t) * states + j0 + jl);
      }
    }
    torbi::cp_async_commit();
  };
  for (int t = 1; t <= kStages; ++t) stage(t);
  // Frame t's staged values, once landed, converted in place (each thread
  // reads only its own cells); run while the barrier before frame t
  // completes, so the conversion waits in no frame's chain
  auto ready = [&](int t) {
    torbi::cp_async_wait<kStages - 1>();
    if constexpr (CONV != 0) {
      if (t < t_end) {
        float* cell = ring + (t % kStages) * l.slots * nthreads + tid;
        for (int s = 0; s < l.slots; ++s) {
          const int jl = (s * l.warps + warp) * kDestsPerWarp + dl;
          if (jl < count)
            cell[s * nthreads] = torbi::convert_obs<CONV>(cell[s * nthreads]);
        }
      }
    }
  };

  // Every CTA of the cluster runs before any remote store
  cluster.sync();

  // Frame 0: post = obs[0] + initial
  float wmax = torbi::neg_inf();
  for (int s = 0; s < l.slots; ++s) {
    const int jl = (s * l.warps + warp) * kDestsPerWarp + dl;
    if (jl < count) {
      const int j = j0 + jl;
      const float v = torbi::convert_obs<CONV>(obs[j]) + initial[j];
      if (g == 0) post_seq[j] = v;
      post_a[j] = v;
      post_b[j] = v;
      wmax = fmaxf(wmax, v);
    }
  }
  wmax = torbi::warp_max(wmax);
  if (lane < kCluster) red_r[rank * l.warps + warp] = wmax;
  torbi::cluster_arrive();
  ready(1);
  torbi::cluster_wait();

  for (int t = 1; t < t_end; ++t) {
    const int cur = (t - 1) & 1;
    const float* pc = post + cur * states;
    float base = torbi::neg_inf();
    if (has_floor) {
      float m = torbi::neg_inf();
      for (int e = lane; e < table; e += 32) m = fmaxf(m, red[cur * table + e]);
      base = torbi::warp_max(m) + floor_value;
    }
    const float* cell = ring + (t % kStages) * l.slots * nthreads + tid;
    const int nxt = (cur ^ 1) * states;
    wmax = torbi::neg_inf();
    for (int s = 0; s < l.slots; ++s) {
      const int jl = (s * l.warps + warp) * kDestsPerWarp + dl;
      const bool live = jl < count;
      float acc = base;
      if (live) {
        const int j = j0 + jl;
        const int d_begin = max(0, -lo - j);
        const int d_end = min(width, states - lo - j);
        const float* src = pc + j + lo;
        // This lane takes the offsets d = g (mod 4)
#pragma unroll 4
        for (int d = d_begin + ((g - d_begin) & (kGroups - 1)); d < d_end;
             d += kGroups) {
          acc = fmaxf(acc, src[d] + band_s[d * l.band_stride + jl]);
        }
      }
      acc = fmaxf(acc, __shfl_xor_sync(0xffffffffu, acc, 1));
      acc = fmaxf(acc, __shfl_xor_sync(0xffffffffu, acc, 2));
      if (live) {
        const int j = j0 + jl;
        const float v = cell[s * nthreads] + acc;
        if (g == 0) post_seq[static_cast<size_t>(t) * states + j] = v;
        post_a[nxt + j] = v;
        post_b[nxt + j] = v;
        wmax = fmaxf(wmax, v);
      }
    }
    wmax = torbi::warp_max(wmax);
    if (lane < kCluster) red_r[(cur ^ 1) * table + rank * l.warps + warp] = wmax;
    // The ring stage just read is refilled with frame t + kStages
    stage(t + kStages);
    torbi::cluster_arrive();
    ready(t + 1);
    torbi::cluster_wait();
  }
  torbi::cp_async_wait_all();

  // Frames past the valid length hold the last posterior
  const float* last = post + ((t_end - 1) & 1) * states;
  for (int t = t_end; t < frames; ++t)
    for (int jl = tid; jl < count; jl += nthreads)
      post_seq[static_cast<size_t>(t) * states + j0 + jl] = last[j0 + jl];
}

}  // namespace

// obs, post_seq: (1, frames, states) float32; batch_frames: (1,) int32;
// initial: (states,) float32; band: (width, states) float32 with
// band[d, j] = transition[j, j + d + lo]. The observation is log-space
// when log_input is set, else probabilities; apply_epsilon applies the
// epsilon step. Launches one cluster of 8 CTAs, each with its band slice in
// shared memory. Returns a cudaError_t code: cudaErrorInvalidValue when
// that slice does not fit the card's opt-in shared memory per block.
extern "C" int band_spread(const float* obs, const int* batch_frames,
                           const float* initial, const float* band,
                           float* post_seq, int frames, int states, int lo,
                           int width, float floor_value, int has_floor,
                           int log_input, int apply_epsilon, void* stream) {
  if (frames <= 0 || states <= 0 || width < 0) return cudaErrorInvalidValue;
  size_t optin = 0;
  const cudaError_t err = torbi::optin_smem(&optin);
  if (err != cudaSuccess) return err;
  const Layout l = make_layout(states);
  const size_t smem = smem_floats(l, states, width) * sizeof(float);
  if (smem > optin) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TORBI_CONV_CASE(CONV)                                                \
  case CONV:                                                                 \
    return torbi::launch_cluster(                                            \
        band_spread_kernel<CONV>, kCluster, dim3(kCluster),                  \
        dim3(l.warps * 32), smem, s, obs, batch_frames, initial, band,       \
        post_seq, frames, states, lo, width, floor_value, has_floor);
  switch (torbi::conversion(log_input, apply_epsilon)) {
    TORBI_CONV_CASE(0)
    TORBI_CONV_CASE(1)
    TORBI_CONV_CASE(2)
    TORBI_CONV_CASE(3)
    default:
      return cudaErrorInvalidValue;
  }
#undef TORBI_CONV_CASE
}
