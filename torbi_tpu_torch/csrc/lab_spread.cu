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

#include "cluster.cuh"
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

// per_cta is a multiple of `multiple` (1; 4 for the probe's bulk copies)
__host__ __device__ inline Layout make_layout(int states, int cluster,
                                             int multiple = 1) {
  Layout l;
  l.per_cta = ((states + cluster - 1) / cluster + multiple - 1) / multiple *
              multiple;
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

// Whether CTA r's circular window [r P + lo, r P + lo + P + width - 1)
// holds part of slice q, [q P, min(q P + P, states))
__device__ inline bool window_holds(int r, int q, int per_cta, int states,
                                    int lo, int width) {
  const int q0 = q * per_cta;
  const int q1 = min(q0 + per_cta, states);
  if (q0 >= q1) return false;
  const int a = r * per_cta + lo;
  const int len = per_cta + width - 1;
  if (len >= states) return true;
  for (int m = -1; m <= 1; ++m)
    if (q0 + m * states < a + len && a < q1 + m * states) return true;
  return false;
}

// The window slot of slice q in CTA r: the slices it holds, in order
__device__ inline int window_slot(int r, int q, int per_cta, int states,
                                  int lo, int width) {
  int slot = 0;
  for (int p = 0; p < q; ++p)
    slot += window_holds(r, p, per_cta, states, lo, width);
  return slot;
}

// Floats of the probe's shared memory: two mbarriers, the two windows (at
// most CLUSTER slices each), the two outgoing slices, the two tables of
// CTA maxima, the two tables of warp maxima
inline size_t async_floats(const Layout& l, int cluster) {
  return 4 + 2 * static_cast<size_t>(cluster) * l.per_cta + 2 * l.per_cta +
         (2 * cluster + 3) / 4 * 4 + (2 * l.warps + 3) / 4 * 4;
}

template <int CLUSTER>
__global__ void __launch_bounds__(1024) lab_spread_async_kernel(
    const float* __restrict__ obs, float* __restrict__ out, int frames,
    int states, int width) {
  extern __shared__ __align__(16) float async_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Layout l = make_layout(states, CLUSTER, 4);
  const int P = l.per_cta;
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int dl = lane / kGroups;
  const int nthreads = l.warps * 32;
  const int lo = -(width / 2);
  const unsigned bars = torbi::smem_address(async_smem);
  float* win = async_smem + 4;                           // [2][CLUSTER * P]
  float* outgoing = win + 2 * CLUSTER * P;         // [2][P]
  float* maxima = outgoing + 2 * P;                // [2][CLUSTER]
  float* part = maxima + (2 * CLUSTER + 3) / 4 * 4;  // [2][warps]
  const int j0 = rank * P;
  const int count = max(0, min(P, states - j0));

  // The bytes this CTA expects per frame: its window's slices and the
  // CLUSTER maxima; its own slice's slot in its window
  int held = 0;
  for (int q = 0; q < CLUSTER; ++q)
    held += window_holds(rank, q, P, states, lo, width);
  const int expected = (held * P + CLUSTER) * 4;
  const int own = window_slot(rank, rank, P, states, lo, width);
  // Lane r of warp 0 sends to CTA r, when its window holds this slice
  bool sends = false;
  int slot = 0;
  if (warp == 0 && lane < CLUSTER) {
    sends = window_holds(lane, rank, P, states, lo, width);
    slot = window_slot(lane, rank, P, states, lo, width);
  }
  if (tid == 0) {
    torbi::mbarrier_init(bars, 1);
    torbi::mbarrier_init(bars + 8, 1);
    torbi::mbarrier_init_fence();
    torbi::mbarrier_expect(bars, expected);
  }
  int jl[kMaxSlots];
  bool live[kMaxSlots];
#pragma unroll
  for (int s = 0; s < kMaxSlots; ++s) {
    jl[s] = (s * l.warps + warp) * kDestsPerWarp + dl;
    live[s] = s < l.slots && jl[s] < count && (lane & (kGroups - 1)) == 0;
  }
  float nobs[kMaxSlots];
#pragma unroll
  for (int s = 0; s < kMaxSlots; ++s)
    nobs[s] = live[s] && frames > 1 ? __ldg(obs + states + j0 + jl[s]) : 0.f;

  auto send = [&](int buf, float value) {
    const float m = torbi::warp_max(value);
    if (lane == 0) part[buf * l.warps + warp] = m;
    torbi::fence_async_shared();
    __syncthreads();
    if (warp == 0) {
      float v = torbi::neg_inf();
      for (int w = lane; w < l.warps; w += 32)
        v = fmaxf(v, part[buf * l.warps + w]);
      v = torbi::warp_max(v);
      if (lane < CLUSTER) {
        const unsigned bar = torbi::remote_address(bars + 8 * buf, lane);
        torbi::store_async(
            torbi::remote_address(
                torbi::smem_address(maxima + buf * CLUSTER + rank), lane),
            v, bar);
        if (sends)
          torbi::bulk_copy(
              torbi::remote_address(
                  torbi::smem_address(win + buf * CLUSTER * P + slot * P),
                  lane),
              torbi::smem_address(outgoing + buf * P), P * 4, bar);
      }
    }
  };

  for (int e = tid; e < 2 * P; e += nthreads) outgoing[e] = torbi::neg_inf();
  cluster.sync();
  float wmax = torbi::neg_inf();
#pragma unroll
  for (int s = 0; s < kMaxSlots; ++s)
    if (live[s]) {
      const float v = obs[j0 + jl[s]];
      outgoing[jl[s]] = v;
      wmax = fmaxf(wmax, v);
    }
  send(0, wmax);

  for (int t = 1; t < frames; ++t) {
    const int cur = (t - 1) & 1;
    torbi::mbarrier_wait(bars + 8 * cur, ((t - 1) >> 1) & 1);
    if (tid == 0) torbi::mbarrier_expect(bars + 8 * (t & 1), expected);
    const float* pc = win + cur * CLUSTER * P + own * P;
    wmax = torbi::neg_inf();
#pragma unroll
    for (int s = 0; s < kMaxSlots; ++s) {
      const float o = nobs[s];
      nobs[s] = live[s] && t + 1 < frames
                    ? __ldg(obs + static_cast<size_t>(t + 1) * states + j0 +
                            jl[s])
                    : 0.f;
      if (live[s]) {
        const float v = o + pc[jl[s]];
        outgoing[(t & 1) * P + jl[s]] = v;
        wmax = fmaxf(wmax, v);
      }
    }
    send(t & 1, wmax);
  }
  const int last = frames - 1;
  torbi::mbarrier_wait(bars + 8 * (last & 1), (last >> 1) & 1);
  cluster.sync();
  for (int e = tid; e < count; e += nthreads)
    out[j0 + e] = outgoing[(last & 1) * P + e];
}

template <int CLUSTER>
int launch_async(const float* obs, float* out, int frames, int states,
                 int width, cudaStream_t stream) {
  auto kernel = lab_spread_async_kernel<CLUSTER>;
  const Layout l = make_layout(states, CLUSTER, 4);
  if (l.slots > kMaxSlots) return cudaErrorInvalidValue;
  const size_t smem = async_floats(l, CLUSTER) * sizeof(float);
  size_t optin = 0;
  cudaError_t err = torbi::optin_smem(&optin);
  if (err != cudaSuccess) return err;
  if (smem > optin) return cudaErrorInvalidValue;
  if (CLUSTER > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  int clusters = 0;
  err = torbi::max_active_clusters(kernel, CLUSTER, dim3(l.warps * 32), smem,
                                   &clusters);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  return torbi::launch_cluster(kernel, CLUSTER, dim3(CLUSTER),
                               dim3(l.warps * 32), smem, stream, 0, obs, out,
                               frames, states, width);
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

// The exchange probe spread_async: spread_sync's function (obs: (frames,
// states) float32, one sequence; out: (states,) float32) with K4's
// mbarrier exchange over a cluster of 8 or 16 CTAs. Needs 1 <= width <=
// states. Returns a cudaError_t code: cudaErrorInvalidConfiguration when
// the card cannot place the cluster.
extern "C" int lab_spread_async(const float* obs, float* out, int frames,
                                int states, int width, int cluster,
                                void* stream) {
  if (frames <= 0 || states <= 0 || width < 1 || width > states)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster == 8) return launch_async<8>(obs, out, frames, states, width, s);
  if (cluster == 16)
    return launch_async<16>(obs, out, frames, states, width, s);
  return cudaErrorInvalidValue;
}
