// Spread lab: K4's design on the lab's recursion, and its barrier skeleton.
//
// Replaces the TPU lab builder scripts/kernel_lab.py::build_kernel_spread
// (the batch-1 replicated-offsets kernel). It computes the final posterior
// of one sequence under the lab's floorless circular recursion
//   post = obs[0]
//   post'[j] = obs[t, j] + max_d (post[(j + lo + d) mod S] + band[d, j]),
//   d in [0, width), lo = -(width / 2)
// the `full` variant of csrc/lab_forward.cu on one sequence. The probe
// `spread_sync` keeps the layout, the remote stores and the cluster barrier
// and drops the candidates: post'[j] = obs[t, j] + post[j] (the `max`
// variant's function). Both are bitwise their plain versions
// (torbi_tpu_torch/scripts/kernel_lab.py::spread_reference).
//
// Bound on the H100 at 1 x 10,240 frames x 1440 states, width 175: 2.6e9
// candidates at two instructions each is ~0.15 ms at 128 lanes x 132 SMs x
// 1.98 GHz, and the 59 MB observation ~0.018 ms at 3.35 TB/s. Neither is
// the limit: the frames are a chain of 10,239 dependent steps, each a round
// of candidates, remote stores and a cluster barrier. The two variants
// split K4's (csrc/band_spread.cu) time per frame into those parts.
//
// Design (K4's): a cluster of C CTAs (8, the portable maximum, or 16 where
// the card allows a non-portable size). CTA r owns destinations
// [r * per_cta, (r + 1) * per_cta) and keeps its (width, per_cta) slice of
// the band resident in shared memory. Every CTA holds a double-buffered
// copy of the whole posterior as its circular extension
// ext[k] = post[(k + lo) mod S], k in [0, S + width - 1), so a source is
// ext[j + d]. 4 lanes share a destination and take every 4th offset; each
// new value goes into the C copies through distributed shared memory, each
// lane into C / 4 of them. One cluster barrier per frame. The observation
// of the next frame is loaded into registers while the frame computes.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kGroups = 4;                      // lanes per destination
constexpr int kDestsPerWarp = 32 / kGroups;
constexpr int kMaxSlots = 4;                    // destinations per lane group

struct Layout {
  int per_cta;      // destinations per CTA
  int warps;        // warps per CTA
  int slots;        // destinations per group of 4 lanes
  int band_stride;  // row stride of the resident band slice
};

__host__ __device__ inline Layout make_layout(int states, int cluster) {
  Layout l;
  l.per_cta = (states + cluster - 1) / cluster;
  const int dest_warps = (l.per_cta + kDestsPerWarp - 1) / kDestsPerWarp;
  l.warps = dest_warps < 32 ? dest_warps : 32;
  l.slots = (l.per_cta + l.warps * kDestsPerWarp - 1) /
            (l.warps * kDestsPerWarp);
  // 8 (mod 32), as K4's: the 4 lane groups of a warp read 4 band rows at
  // once, and this stride puts their 32 words in 32 different banks
  const int over = l.per_cta > 8 ? l.per_cta - 8 : 0;
  l.band_stride = (over + 31) / 32 * 32 + 8;
  return l;
}

// Floats of shared memory: two ext buffers, then the band slice
inline size_t smem_floats(const Layout& l, int states, int width,
                          bool sync_only) {
  return 2 * static_cast<size_t>(states + width - 1) +
         (sync_only ? 0 : static_cast<size_t>(width) * l.band_stride);
}

template <int CLUSTER, bool SYNC_ONLY>
__global__ void __launch_bounds__(1024) lab_spread_kernel(
    const float* __restrict__ obs, const float* __restrict__ band,
    float* __restrict__ out, int frames, int states, int width) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Layout l = make_layout(states, CLUSTER);
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane & (kGroups - 1);
  const int dl = lane / kGroups;
  const int nthreads = l.warps * 32;
  const int lo = -(width / 2);
  const int ext = states + width - 1;

  float* post = smem;               // [2][ext]
  float* band_s = post + 2 * ext;   // [width][band_stride]

  const int j0 = rank * l.per_cta;
  const int count = max(0, min(l.per_cta, states - j0));
  if (!SYNC_ONLY)
    for (int e = tid; e < width * count; e += nthreads) {
      const int d = e / count;
      const int jl = e - d * count;
      band_s[d * l.band_stride + jl] =
          band[static_cast<size_t>(d) * states + j0 + jl];
    }
  // Lane g writes into the copies of CTAs g, g + 4, ...
  float* remote[CLUSTER / kGroups];
#pragma unroll
  for (int c = 0; c < CLUSTER / kGroups; ++c)
    remote[c] = cluster.map_shared_rank(post, g + c * kGroups);

  // A new value of destination j into buffer `buf` of every copy: at
  // ext[j - lo] and its wrapped positions
  auto publish = [&](int buf, int j, float v) {
    const int k = j - lo;
#pragma unroll
    for (int c = 0; c < CLUSTER / kGroups; ++c) {
      float* e = remote[c] + buf * ext;
      e[k] = v;
      if (k >= states) e[k - states] = v;
      if (k + states < ext) e[k + states] = v;
    }
  };

  int jd[kMaxSlots];
  bool live[kMaxSlots];
#pragma unroll
  for (int s = 0; s < kMaxSlots; ++s) {
    const int jl = (s * l.warps + warp) * kDestsPerWarp + dl;
    live[s] = s < l.slots && jl < count;
    jd[s] = j0 + jl;
  }
  float nobs[kMaxSlots];
#pragma unroll
  for (int s = 0; s < kMaxSlots; ++s)
    nobs[s] = live[s] && frames > 1 ? __ldg(obs + states + jd[s]) : 0.f;

  // Every CTA of the cluster runs before any remote store
  cluster.sync();
#pragma unroll
  for (int s = 0; s < kMaxSlots; ++s)
    if (live[s]) publish(0, jd[s], obs[jd[s]]);
  cluster.sync();

  for (int t = 1; t < frames; ++t) {
    const float* pc = post + ((t - 1) & 1) * ext;
    float cur[kMaxSlots];
#pragma unroll
    for (int s = 0; s < kMaxSlots; ++s) {
      cur[s] = nobs[s];
      nobs[s] = live[s] && t + 1 < frames
                    ? __ldg(obs + static_cast<size_t>(t + 1) * states + jd[s])
                    : 0.f;
    }
#pragma unroll
    for (int s = 0; s < kMaxSlots; ++s) {
      if (s >= l.slots) break;
      float acc = torbi::neg_inf();
      if (SYNC_ONLY) {
        if (live[s]) acc = pc[jd[s] - lo];
      } else {
        if (live[s]) {
          const float* src = pc + jd[s];
          const float* col = band_s + (jd[s] - j0);
          // This lane takes the offsets d = g (mod 4)
#pragma unroll 4
          for (int d = g; d < width; d += kGroups)
            acc = fmaxf(acc, src[d] + col[d * l.band_stride]);
        }
        acc = fmaxf(acc, __shfl_xor_sync(0xffffffffu, acc, 1));
        acc = fmaxf(acc, __shfl_xor_sync(0xffffffffu, acc, 2));
      }
      if (live[s]) publish(t & 1, jd[s], cur[s] + acc);
    }
    cluster.sync();
  }

  const float* last = post + ((frames - 1) & 1) * ext;
  for (int jl = tid; jl < count; jl += nthreads)
    out[j0 + jl] = last[j0 + jl - lo];
}

template <int CLUSTER, bool SYNC_ONLY>
int launch(const float* obs, const float* band, float* out, int frames,
           int states, int width, cudaStream_t stream) {
  auto kernel = lab_spread_kernel<CLUSTER, SYNC_ONLY>;
  const Layout l = make_layout(states, CLUSTER);
  if (l.slots > kMaxSlots) return cudaErrorInvalidValue;
  const size_t smem =
      smem_floats(l, states, width, SYNC_ONLY) * sizeof(float);
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (CLUSTER > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = CLUSTER;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(CLUSTER);
  config.blockDim = dim3(l.warps * 32);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attribute;
  config.numAttrs = 1;
  // A cluster the card cannot place is refused here, not at the launch
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&config, kernel, obs, band, out, frames, states,
                           width);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// obs: (frames, states) float32, one sequence; band: (>= width, states)
// float32, rows d < width read (none with sync_only); out: (states,)
// float32. cluster: 8 or 16 CTAs; sync_only: the spread_sync probe. Needs
// 1 <= width <= states. Returns a cudaError_t code:
// cudaErrorInvalidConfiguration when the card cannot place the cluster.
extern "C" int lab_spread(const float* obs, const float* band, float* out,
                          int frames, int states, int width, int cluster,
                          int sync_only, void* stream) {
  if (frames <= 0 || states <= 0 || width < 1 || width > states)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster == 8)
    return sync_only ? launch<8, true>(obs, band, out, frames, states, width, s)
                     : launch<8, false>(obs, band, out, frames, states, width,
                                        s);
  if (cluster == 16)
    return sync_only
               ? launch<16, true>(obs, band, out, frames, states, width, s)
               : launch<16, false>(obs, band, out, frames, states, width, s);
  return cudaErrorInvalidValue;
}
