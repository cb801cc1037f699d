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
// The observation may arrive unconverted, as the TPU kernels take it
// (their obs_col, torbi_tpu/ops/band.py:549-556): log_input = 0 takes the
// log of a probability, apply_epsilon = 1 the reference's epsilon step
// log(exp(x) + tiny), each value converted in registers as it is loaded
// (common.cuh, convert_obs), so the plain route's full-size copy and its
// elementwise passes before the kernel go away. Only loaded values pass
// through it: lanes past the states or the batch, and frames at or past
// batch_frames, load nothing. Frame 0 converts for every sequence, as the
// plain route converts every frame.
//
// Bound on the H100 at the headline shape (512 sequences x 512 frames x
// 1440 states, band width 175): 512 * 511 * 244,344 in-range candidates
// at an add and a max each; the max alone, at 64 per SM and clock, takes
// 3.9 ms on 132 SMs at 1.98 GHz, while the 3.0 GB that must move
// (observation in, posterior stream out) take 0.9 ms at 3.35 TB/s. So
// operations bound it. Each candidate also needs its source value; one
// shared-memory load per candidate at 32 words per SM and clock would take
// 7.6 ms, so a thread must reuse what it loads.
//
// Two designs, chosen by shape (ops/band.py::forward_kernel mirrors the
// layout arithmetic below, so dispatch knows which one runs): the cluster
// design here, and for the bands whose slice no cluster layout holds the
// wide-band design (csrc/band_wide.cu: one persistent CTA per SM).
//
// band_forward, the cluster design. A design that reads the whole band
// from L2 every frame in every CTA (one CTA per 4 sequences: 128 CTAs x
// 511 frames x 244,344 values x 4 B, 64 GB per headline call) runs one
// sequence per SM at small batch. Here a cluster of 8 CTAs holds NB
// sequences, and CTA r owns destinations [r P, (r + 1) P), P =
// ceil(states / 8) rounded to the thread tile. Its slice of the band lives in shared memory for the
// whole launch (175 x 180 floats at the pitch shape), read from L2 once.
// For each sequence it keeps a double-buffered window of the posterior:
// the sources its destinations read, [r P + lo, r P + lo + P + width - 1),
// -inf outside [0, states) (354 values at the pitch shape, not the 1440 of
// a full copy). Each new value goes into the window of every CTA whose
// range holds it, through distributed shared memory (the receivers follow
// from lo and width: for a wide band or a narrow slice, more than one
// neighbour). Each CTA's maximum of its new slice goes into every CTA's
// (NB, 8) table, so after the barrier a max over 8 entries is the row's
// maximum for the floor term (max does not depend on order: exact). One
// cluster barrier per frame, split: arrive after the stores, then the next
// frame's observation (loaded a frame ahead) converts in registers, then
// wait.
//   Inside a CTA a thread computes NBT sequences x R consecutive
// destinations. The band slice is stored skewed, band_s[m][jl] =
// band[m - jl % R][j0 + jl], so at step m the thread's R band values are
// one vector load and its NBT sources (window row dg R + m, the sequences
// interleaved) another: a candidate costs 1/NBT of a band load, 1/R of a
// source load, an add and a max. The skew's padding entries are -inf, as
// are the window's out-of-range sources, so the loop runs without guards
// (a -inf candidate leaves the max unchanged). NB = 1 (the auto-chunk
// rows at batch 8) takes K4's thread shape instead: 4 lanes share a
// destination, each takes every 4th offset, two xor shuffles combine them.
// A window row holds the NB sequences' values of one source, so a
// quarter-warp's vector loads fall in distinct banks.
#include <cooperative_groups.h>

#include "cluster.cuh"
#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;  // CTAs per cluster

// The cluster design's thread tile for NB sequences per cluster: a thread
// computes NBT sequences x R consecutive destinations, G lanes share them
// and split the band offsets, NACC accumulators per value; at most
// MAX_THREADS per CTA. The launch plan (ops/band.py::cluster_plan) takes 1
// sequence per cluster for the auto-chunk rows, 32 for whole waves of a
// large batch and 4 for its rest
template <int NB>
struct Tile;
template <>
struct Tile<1> {
  static constexpr int NBT = 1, R = 1, G = 4, NACC = 2, MAX_THREADS = 1024;
};
template <>
struct Tile<4> {
  static constexpr int NBT = 4, R = 1, G = 1, NACC = 1, MAX_THREADS = 512;
};
template <>
struct Tile<32> {
  static constexpr int NBT = 4, R = 4, G = 1, NACC = 1, MAX_THREADS = 512;
};

struct ClusterLayout {
  int per_cta;      // destinations per CTA (P), a multiple of R
  int groups;       // destination groups of R per CTA
  int threads;      // per CTA, a warp multiple
  int band_stride;  // row stride of the band slice
  int band_rows;    // width + R - 1 skewed rows
  int window;       // window rows: P + width - 1 sources
  int win_off, red_off, part_off, floats;  // shared-memory sections
};

// The layout ops/band.py::cluster_layout mirrors, section by section: the
// skewed band slice, the double-buffered windows, the double-buffered
// (NB, 8) tables of CTA maxima, the (warps, NB) table of warp maxima
template <int NB>
__host__ __device__ inline ClusterLayout cluster_layout(int states,
                                                        int width) {
  using T = Tile<NB>;
  ClusterLayout l;
  const int slice = (states + kCluster - 1) / kCluster;
  l.per_cta = (slice + T::R - 1) / T::R * T::R;
  l.groups = l.per_cta / T::R;
  l.threads = (l.groups * (NB / T::NBT) * T::G + 31) / 32 * 32;
  if (T::G > 1) {
    // 8 (mod 32): the 4 lanes of a destination read 4 band rows at once,
    // and this stride puts a warp's 32 words in 32 banks
    const int over = l.per_cta > 8 ? l.per_cta - 8 : 0;
    l.band_stride = (over + 31) / 32 * 32 + 8;
  } else {
    l.band_stride = (l.per_cta + 3) / 4 * 4;
  }
  l.band_rows = width + T::R - 1;
  l.window = l.per_cta + width - 1;
  l.win_off = l.band_rows * l.band_stride;
  l.red_off = l.win_off + (2 * l.window * NB + 3) / 4 * 4;
  l.part_off = l.red_off + 2 * NB * kCluster;
  l.floats = l.part_off + l.threads / 32 * NB;
  return l;
}

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((b - 1 - a) / b);
}

// R consecutive floats from shared memory, as one vector load
template <int R>
__device__ __forceinline__ void load_row(float (&v)[R], const float* p) {
  if constexpr (R == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else if constexpr (R == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  } else {
    static_assert(R == 1, "rows of 1, 2 or 4 floats");
    v[0] = p[0];
  }
}

template <int NB, int CONV>
__global__ void __launch_bounds__(Tile<NB>::MAX_THREADS)
    band_cluster_kernel(const float* __restrict__ obs,
                        const int* __restrict__ batch_frames,
                        const float* __restrict__ initial,
                        const float* __restrict__ band,
                        float* __restrict__ post_seq, int batch, int frames,
                        int states, int lo, int width, float floor_value,
                        int has_floor) {
  using T = Tile<NB>;
  constexpr int NBT = T::NBT, R = T::R, G = T::G, NACC = T::NACC;
  constexpr int SG = NB / NBT;    // sequence groups
  constexpr int LANES = G * SG;   // lanes per destination group
  static_assert(NBT == 1 || NBT == 4, "1 or 4 sequences per thread");
  static_assert(32 % LANES == 0, "a warp holds whole destination groups");
  extern __shared__ __align__(16) float cluster_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const ClusterLayout l = cluster_layout<NB>(states, width);
  float* band_s = cluster_smem;                 // [band_rows][band_stride]
  float* win = cluster_smem + l.win_off;        // [2][window][NB]
  float* red = cluster_smem + l.red_off;        // [2][NB][kCluster]
  float* part = cluster_smem + l.part_off;      // [warps][NB]
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = tid % G;
  const int sg = (tid / G) % SG;
  const int dg = tid / LANES;
  const int j0 = rank * l.per_cta;
  const int count = max(0, min(l.per_cta, states - j0));
  const int b0 = static_cast<int>(blockIdx.x / kCluster) * NB;
  const int wsize = l.window * NB;

  // This thread's sequences (rows past the batch get 0 frames: never
  // valid, never written) and destinations
  int bf[NBT];
  bool live[NBT];
#pragma unroll
  for (int q = 0; q < NBT; ++q) {
    const int n = b0 + sg * NBT + q;
    live[q] = n < batch;
    bf[q] = live[q] ? batch_frames[n] : 0;
  }
  bool dest[R];
#pragma unroll
  for (int i = 0; i < R; ++i) dest[i] = dg * R + i < count;
  // Frames in which some sequence of the cluster advances
  int t_end = 1;
  for (int n = b0; n < min(b0 + NB, batch); ++n)
    t_end = max(t_end, min(batch_frames[n], frames));

  for (int e = tid; e < 2 * wsize; e += blockDim.x) win[e] = torbi::neg_inf();
  for (int e = tid; e < l.band_rows * l.band_stride; e += blockDim.x) {
    const int m = e / l.band_stride;
    const int jl = e - m * l.band_stride;
    const int d = m - jl % R;
    band_s[e] = jl < count && d >= 0 && d < width
                    ? band[static_cast<size_t>(d) * states + j0 + jl]
                    : torbi::neg_inf();
  }
  // Every CTA of the cluster is set up before any remote store
  cluster.sync();

  auto offset = [&](int q, int i, int t) {
    return (static_cast<size_t>(b0 + sg * NBT + q) * frames + t) * states +
           j0 + dg * R + i;
  };
  float prev[NBT][R];  // the posterior at this thread's values

  // Publish prev (frame t's posterior) into window buffer `buf` of every
  // CTA whose window holds it, and its maxima into their tables
  auto publish = [&](int buf) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (!dest[i]) continue;
      const int j = j0 + dg * R + i;
      // CTA r's window holds the sources [r P + lo, r P + lo + window)
      const int r_lo = max(0, floor_div(j - lo - l.window, l.per_cta) + 1);
      const int r_hi = min(kCluster - 1, floor_div(j - lo, l.per_cta));
      for (int r = r_lo + g; r <= r_hi; r += G) {
        float* dst = cluster.map_shared_rank(win, r) + buf * wsize +
                     (j - r * l.per_cta - lo) * NB + sg * NBT;
        if constexpr (NBT == 4) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(prev[0][i], prev[1][i], prev[2][i], prev[3][i]);
        } else {
          dst[0] = prev[0][i];
        }
      }
    }
    float m[NBT];
#pragma unroll
    for (int q = 0; q < NBT; ++q) {
      m[q] = torbi::neg_inf();
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (dest[i]) m[q] = fmaxf(m[q], prev[q][i]);
#pragma unroll
      for (int off = LANES; off < 32; off <<= 1)
        m[q] = fmaxf(m[q], __shfl_xor_sync(0xffffffffu, m[q], off));
      if (lane < LANES && g == 0) part[warp * NB + sg * NBT + q] = m[q];
    }
    __syncthreads();
    for (int e = tid; e < NB * kCluster; e += blockDim.x) {
      const int n = e / kCluster;
      float mm = torbi::neg_inf();
      for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w)
        mm = fmaxf(mm, part[w * NB + n]);
      cluster.map_shared_rank(red, e % kCluster)[
          (buf * NB + n) * kCluster + rank] = mm;
    }
  };

  // The observation streams a frame ahead: the raw values of frame t + 1
  // load before frame t's candidates (they land meanwhile) and convert
  // after frame t's arrive, while the barrier completes, so neither the
  // load's latency nor the conversion waits in the chain of frames
  float raw[NBT][R];  // frame t + 1, as loaded
  float ob[NBT][R];   // frame t, converted
  auto load = [&](int t) {
#pragma unroll
    for (int q = 0; q < NBT; ++q)
#pragma unroll
      for (int i = 0; i < R; ++i)
        raw[q][i] = live[q] && dest[i] && t < bf[q] ? obs[offset(q, i, t)]
                                                     : 0.f;
  };
  auto convert = [&](int t) {
#pragma unroll
    for (int q = 0; q < NBT; ++q)
#pragma unroll
      for (int i = 0; i < R; ++i) {
        ob[q][i] = 0.f;
        if (live[q] && dest[i] && t < bf[q])
          ob[q][i] = torbi::convert_obs<CONV>(raw[q][i]);
      }
  };
  if (t_end > 1) load(1);

  // Frame 0: post = obs[0] + initial
#pragma unroll
  for (int q = 0; q < NBT; ++q)
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float v = torbi::neg_inf();
      if (live[q] && dest[i]) {
        v = torbi::convert_obs<CONV>(obs[offset(q, i, 0)]) +
            initial[j0 + dg * R + i];
        if (g == 0) post_seq[offset(q, i, 0)] = v;
      }
      prev[q][i] = v;
    }
  publish(0);
  torbi::cluster_arrive();
  if (t_end > 1) convert(1);

  for (int t = 1; t < t_end; ++t) {
    if (t + 1 < t_end) load(t + 1);
    torbi::cluster_wait();
    const int cur = (t - 1) & 1;
    const float* rc = red + cur * NB * kCluster;
    bool valid[NBT];
    bool any = false;
    float acc[NACC][NBT][R];
#pragma unroll
    for (int q = 0; q < NBT; ++q) {
      valid[q] = t < bf[q];
      any = any || valid[q];
      float base = torbi::neg_inf();
      if (has_floor) {
        const float* row = rc + (sg * NBT + q) * kCluster;
#pragma unroll
        for (int r = 0; r < kCluster; ++r) base = fmaxf(base, row[r]);
        base = base + floor_value;
      }
#pragma unroll
      for (int a = 0; a < NACC; ++a)
#pragma unroll
        for (int i = 0; i < R; ++i) acc[a][q][i] = base;
    }
    if (any && dg < l.groups) {
      const float* bcol = band_s + dg * R;
      const float* src = win + cur * wsize + dg * R * NB + sg * NBT;
      auto step = [&](float (&a)[NBT][R], int m) {
        float bv[R];
        float sv[NBT];
        load_row<R>(bv, bcol + m * l.band_stride);
        load_row<NBT>(sv, src + m * NB);
#pragma unroll
        for (int q = 0; q < NBT; ++q)
#pragma unroll
          for (int i = 0; i < R; ++i) a[q][i] = fmaxf(a[q][i], sv[q] + bv[i]);
      };
      int m = g;
#pragma unroll 4
      for (; m + (NACC - 1) * G < l.band_rows; m += NACC * G)
#pragma unroll
        for (int a = 0; a < NACC; ++a) step(acc[a], m + a * G);
      for (; m < l.band_rows; m += G) step(acc[0], m);
    }
#pragma unroll
    for (int q = 0; q < NBT; ++q)
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float s = acc[0][q][i];
#pragma unroll
        for (int a = 1; a < NACC; ++a) s = fmaxf(s, acc[a][q][i]);
#pragma unroll
        for (int off = 1; off < G; off <<= 1)
          s = fmaxf(s, __shfl_xor_sync(0xffffffffu, s, off));
        const float v = valid[q] ? ob[q][i] + s : prev[q][i];
        if (live[q] && dest[i] && g == 0) post_seq[offset(q, i, t)] = v;
        prev[q][i] = v;
      }
    publish(t & 1);
    torbi::cluster_arrive();
    if (t + 1 < t_end) convert(t + 1);
  }
  // Every remote store has landed before any CTA leaves
  torbi::cluster_wait();

  // Frames in which the whole cluster is frozen hold the last posterior
  for (int t = t_end; t < frames; ++t)
#pragma unroll
    for (int q = 0; q < NBT; ++q)
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (live[q] && dest[i] && g == 0)
          post_seq[offset(q, i, t)] = prev[q][i];
}

template <int NB, int CONV>
int launch_cluster_design(const float* obs, const int* batch_frames,
                          const float* initial, const float* band,
                          float* post_seq, int batch, int frames, int states,
                          int lo, int width, float floor_value, int has_floor,
                          cudaStream_t stream) {
  size_t optin = 0;
  const cudaError_t err = torbi::optin_smem(&optin);
  if (err != cudaSuccess) return err;
  const ClusterLayout l = cluster_layout<NB>(states, width);
  const size_t smem = static_cast<size_t>(l.floats) * sizeof(float);
  if (width < 1 || l.threads > Tile<NB>::MAX_THREADS || smem > optin)
    return cudaErrorInvalidValue;
  const int clusters = (batch + NB - 1) / NB;
  return torbi::launch_cluster(
      band_cluster_kernel<NB, CONV>, kCluster, dim3(clusters * kCluster),
      dim3(l.threads), smem, stream, obs, batch_frames, initial, band,
      post_seq, batch, frames, states, lo, width, floor_value, has_floor);
}

// The conversion's instances share the layout and the launch bounds (one
// CTA per SM either way), so the card holds as many clusters of each
template <int NB>
int count_clusters(int states, int width, int* clusters) {
  const ClusterLayout l = cluster_layout<NB>(states, width);
  if (width < 1 || l.threads > Tile<NB>::MAX_THREADS)
    return cudaErrorInvalidValue;
  return torbi::max_active_clusters(
      band_cluster_kernel<NB, 0>, kCluster, dim3(l.threads),
      static_cast<size_t>(l.floats) * sizeof(float), clusters);
}

// The cluster design at NB sequences per cluster, by conversion
template <int NB>
int cluster_by_conversion(int conv, const float* obs, const int* batch_frames,
                          const float* initial, const float* band,
                          float* post_seq, int batch, int frames, int states,
                          int lo, int width, float floor_value, int has_floor,
                          cudaStream_t stream) {
#define TORBI_CONV_CASE(CONV)                                                \
  case CONV:                                                                 \
    return launch_cluster_design<NB, CONV>(                                  \
        obs, batch_frames, initial, band, post_seq, batch, frames, states,   \
        lo, width, floor_value, has_floor, stream);
  switch (conv) {
    TORBI_CONV_CASE(0)
    TORBI_CONV_CASE(1)
    TORBI_CONV_CASE(2)
    TORBI_CONV_CASE(3)
    default:
      return cudaErrorInvalidValue;
  }
#undef TORBI_CONV_CASE
}

}  // namespace

// obs, post_seq: (batch, frames, states) float32; batch_frames: (batch,)
// int32; initial: (states,) float32; band: (width, states) float32 with
// band[d, j] = transition[j, j + d + lo]. The observation is log-space
// when log_input is set, else probabilities; apply_epsilon applies the
// epsilon step (common.cuh, convert_obs). The cluster design with
// `sequences` (1, 4 or 32) per cluster of 8 CTAs. Returns a
// cudaError_t code: cudaErrorInvalidValue when width < 1, or when the
// layout needs more threads or shared memory than a CTA may have
// (ops/band.py::cluster_layout computes the same).
extern "C" int band_forward(const float* obs, const int* batch_frames,
                            const float* initial, const float* band,
                            float* post_seq, int batch, int frames,
                            int states, int lo, int width, float floor_value,
                            int has_floor, int log_input, int apply_epsilon,
                            int sequences, void* stream) {
  if (batch <= 0 || frames <= 0 || states <= 0 || width < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int conv = torbi::conversion(log_input, apply_epsilon);
#define TORBI_CLUSTER_CASE(NB)                                               \
  case NB:                                                                   \
    return cluster_by_conversion<NB>(conv, obs, batch_frames, initial, band, \
                                     post_seq, batch, frames, states, lo,    \
                                     width, floor_value, has_floor, s);
  switch (sequences) {
    TORBI_CLUSTER_CASE(1)
    TORBI_CLUSTER_CASE(4)
    TORBI_CLUSTER_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef TORBI_CLUSTER_CASE
}

// The clusters of the cluster design with `sequences` per cluster that
// the card holds at once at this shape, into *clusters: the waves of
// ops/band.py::cluster_plan. Returns a cudaError_t code.
extern "C" int band_forward_clusters(int states, int width, int sequences,
                                     int* clusters) {
  if (states <= 0) return cudaErrorInvalidValue;
  switch (sequences) {
    case 1:
      return count_clusters<1>(states, width, clusters);
    case 4:
      return count_clusters<4>(states, width, clusters);
    case 32:
      return count_clusters<32>(states, width, clusters);
    default:
      return cudaErrorInvalidValue;
  }
}
