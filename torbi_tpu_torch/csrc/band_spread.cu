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
// copy (common.cuh, convert_obs). Only frames before batch_frames are
// staged and converted.
//
// Bound on the H100 at 1 x 10,240 frames x 1440 pitch states (band width
// 175): 10,239 frames x 244,344 in-band candidates at an add and a max each
// is 5.0e9 FP32 instructions, 0.15 ms at 128 per SM and clock (1.98 GHz)
// on all 132 SMs, but 1.23 ms on the 16 SMs of the cluster; the 118 MB
// that must move (observation in, stream out) take 0.035 ms at 3.35 TB/s.
// The frames form a chain of 10,239 dependent steps, each a round of
// candidates and an exchange between the CTAs, so latency per frame
// decides the time.
//
// Design: a cluster of C = 16 CTAs on 16 SMs (ops/band.py::SPREAD_CLUSTER,
// a non-portable size): the exchange below costs less per frame in 16 than
// in 8, the portable size (the spread lab's probe times both), the
// candidates per CTA halve, and 16 holds every band 8 would. CTA r owns
// destinations [r P, (r + 1) P), P = ceil(states / C) rounded up to a
// multiple of 4.
//
// The band lives in registers. A thread owns R = 4 consecutive
// destinations and a run of D = ceil(width / 8) consecutive band offsets
// (8 lanes share the 4 destinations); its 4 x D band values never change,
// so they are loaded once, into a register tile of 4 x DMAX (DMAX the
// tile's offsets per lane: 8, 16, 24 or 32; the entries past D are -inf).
// Per frame a lane loads DMAX + 3 sources, each feeding up to 4 candidates
// of its run, into 2 x 4 accumulators; three xor shuffles combine the 8
// lanes. A band wider than 8 x 32 = 256 offsets, or a shape whose threads
// exceed the tile's register budget (Tile::MAX_THREADS), is refused and
// dispatch sends it to K1 (ops/band.py::spread_layout mirrors this
// layout).
//
// Each CTA keeps a double-buffered window of the posterior, not a full
// copy: the slices q in [r + a, r + a + slices) whole, a = floor(lo / P),
// which hold every source its destinations read, [r P + lo, r P + lo + P +
// width - 1); slices outside [0, C) and values past the states stay -inf.
// The exchange, per frame: every thread writes its new values into the
// CTA's outgoing slice in its own shared memory and each warp its maximum;
// one __syncthreads; then warp 0 sends the slice (P floats, one bulk copy,
// cp.async.bulk ... mbarrier::complete_tx) into the window of every CTA
// that holds it, and the slice's maximum (st.async ... complete_tx) into
// every CTA's table of maxima. Each CTA waits on its own mbarrier (one per
// buffer) until the bytes it expects have landed: its window's slices and
// C maxima. No cluster barrier runs per frame.
//
// Why the double buffers are safe without one: a CTA computes frame t + 1
// only after it has the maxima of frame t from every CTA (the floor term
// needs them, and with no floor they are exchanged all the same), and a CTA
// sends its frame-t maximum only after every one of its threads has read
// its frame t - 1 window and its own barrier's frame t - 2 phase has
// completed. So when a CTA writes frame t + 1 into buffer (t + 1) & 1 of
// another, that CTA has finished frame t, and with it every read of frame
// t - 1's values in that buffer; and that buffer's barrier has completed
// the phase of frame t - 1, so the new bytes count toward frame t + 1's
// phase (bytes may arrive before the receiver arms that phase with the
// bytes it expects: the phase completes once both are in). The same holds
// whatever the band's shape: an asymmetric band (lo >= 0), whose windows
// do not reach back, is kept in step by the maxima. The outgoing slice is
// double-buffered for the same reason: frame t + 2 rewrites it only after
// every receiver has taken frame t's copy.
//
// The observation rows are staged kStages frames ahead with cp.async into a
// per-thread ring. Each writer thread converts its own value of frame t + 1
// in place once it has landed (ready(t + 1)), right after it sends frame
// t and before it waits for frame t's maxima, so the conversion overlaps
// the exchange.
#include <cooperative_groups.h>

#include "cluster.cuh"
#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kR = 4;         // consecutive destinations per thread
constexpr int kLanes = 8;     // lanes sharing them, each a run of offsets
constexpr int kNacc = 2;      // accumulators per destination
constexpr int kStages = 4;    // observation frames staged ahead
constexpr int kCluster = 16;  // CTAs in the cluster (SPREAD_CLUSTER)

// The register tile: DMAX band offsets per lane (4 x DMAX registers), and
// the most threads per CTA that leave each thread room for them
template <int DMAX>
struct Tile;
template <>
struct Tile<8> {
  static constexpr int MAX_THREADS = 512;
};
template <>
struct Tile<16> {
  static constexpr int MAX_THREADS = 512;
};
template <>
struct Tile<24> {
  static constexpr int MAX_THREADS = 384;
};
template <>
struct Tile<32> {
  static constexpr int MAX_THREADS = 256;
};

// The tile for a run of offsets per lane; 0 when none holds it
__host__ __device__ inline int tile_of(int run) {
  return run <= 8 ? 8 : run <= 16 ? 16 : run <= 24 ? 24 : run <= 32 ? 32 : 0;
}

__host__ __device__ inline int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((b - 1 - a) / b);
}

struct Layout {
  int per_cta;  // P, destinations per CTA, a multiple of 4
  int groups;   // P / 4 destination groups
  int threads;  // per CTA, a warp multiple
  int run;      // D, band offsets per lane
  int dmax;     // the tile's offsets per lane
  int a;        // the window's first slice, relative to the CTA's own
  int slices;   // slices in the window at this lo
  int offset;   // window index of destination 0's source at offset 0
  int window;   // floats per window buffer, for any lo
  int win_off, out_off, max_off, part_off, ring_off, floats;  // sections
};

// The layout ops/band.py::spread_layout mirrors, section by section: two
// mbarriers (16 bytes), the two window buffers, the two outgoing slices,
// the two tables of CTA maxima, the two tables of warp maxima, the ring
__host__ __device__ inline Layout make_layout(int states, int width,
                                             int lo) {
  Layout l;
  const int slice = (states + kCluster - 1) / kCluster;
  l.per_cta = (slice + kR - 1) / kR * kR;
  l.groups = l.per_cta / kR;
  l.threads = (l.groups * kLanes + 31) / 32 * 32;
  l.run = (width + kLanes - 1) / kLanes;
  l.dmax = tile_of(l.run);
  l.a = floor_div(lo, l.per_cta);
  l.slices = floor_div(l.per_cta + lo + width - 2, l.per_cta) - l.a + 1;
  l.offset = lo - l.a * l.per_cta;
  // The most slices a window spans at any lo, and slack for the reads of
  // the tile's padding offsets (their band entries are -inf)
  const int most = (2 * l.per_cta + width - 3) / l.per_cta + 1;
  l.window = most * l.per_cta + kLanes * l.dmax;
  l.win_off = 4;
  l.out_off = l.win_off + 2 * l.window;
  l.max_off = l.out_off + 2 * l.per_cta;
  l.part_off = l.max_off + (2 * kCluster + 3) / 4 * 4;
  l.ring_off = l.part_off + (2 * (l.threads / 32) + 3) / 4 * 4;
  l.floats = l.ring_off + kStages * l.threads;
  return l;
}

template <int DMAX, int CONV>
__global__ void __launch_bounds__(Tile<DMAX>::MAX_THREADS, 1)
    band_spread_kernel(const float* __restrict__ obs,
                       const int* __restrict__ batch_frames,
                       const float* __restrict__ initial,
                       const float* __restrict__ band,
                       float* __restrict__ post_seq, int frames, int states,
                       int lo, int width, float floor_value, int has_floor) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Layout l = make_layout(states, width, lo);
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = l.threads >> 5;
  const int g = tid & (kLanes - 1);
  const int dg = tid / kLanes;
  const int P = l.per_cta;
  const int j0 = rank * P;
  const int count = max(0, min(P, states - j0));
  const int t_end = min(max(batch_frames[0], 1), frames);

  const unsigned bars = torbi::smem_address(smem);  // [2] mbarriers
  float* win = smem + l.win_off;     // [2][window]
  float* out = smem + l.out_off;     // [2][P]
  float* maxima = smem + l.max_off;  // [2][kCluster]
  float* part = smem + l.part_off;   // [2][warps]
  float* ring = smem + l.ring_off;   // [kStages][threads]

  // Lane g < 4 of a group writes destination 4 dg + g
  const int jl_out = dg * kR + g;
  const bool writer = g < kR && dg < l.groups && jl_out < count;
  const int j_out = j0 + jl_out;
  // This CTA's slice goes to the CTAs r whose window holds it; it expects
  // its window's slices inside [0, C) and C maxima per frame
  const int r_first = max(0, rank - l.a - l.slices + 1);
  const int r_last = min(kCluster - 1, rank - l.a);
  const int q_first = max(0, rank + l.a);
  const int q_last = min(kCluster - 1, rank + l.a + l.slices - 1);
  const int expected = (max(0, q_last - q_first + 1) * P + kCluster) * 4;

  for (int e = tid; e < 2 * l.window; e += blockDim.x)
    win[e] = torbi::neg_inf();
  for (int e = tid; e < 2 * P; e += blockDim.x) out[e] = torbi::neg_inf();
  if (tid == 0) {
    torbi::mbarrier_init(bars, 1);
    torbi::mbarrier_init(bars + 8, 1);
    torbi::mbarrier_init_fence();
    torbi::mbarrier_expect(bars, expected);  // frame 0's phase
  }
  // The band tile: offsets [g D, g D + D) of destinations 4 dg .. 4 dg + 3
  float band_r[DMAX][kR];
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    const int d = g * l.run + k;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int jl = dg * kR + i;
      band_r[k][i] = k < l.run && d < width && dg < l.groups && jl < count
                         ? band[static_cast<size_t>(d) * states + j0 + jl]
                         : torbi::neg_inf();
    }
  }
  // Window index of this lane's first source
  const int first = dg < l.groups ? dg * kR + g * l.run + l.offset : 0;

  // Stage the observation of frame t into ring stage t % kStages
  auto stage = [&](int t) {
    if (t < t_end && writer)
      torbi::cp_async4(ring + (t % kStages) * l.threads + tid,
                       obs + static_cast<size_t>(t) * states + j_out);
    torbi::cp_async_commit();
  };
  for (int t = 1; t <= kStages; ++t) stage(t);
  // Frame t's staged value, once landed, converted in place
  auto ready = [&](int t) {
    torbi::cp_async_wait<kStages - 1>();
    if constexpr (CONV != 0) {
      if (t < t_end && writer) {
        float* cell = ring + (t % kStages) * l.threads + tid;
        *cell = torbi::convert_obs<CONV>(*cell);
      }
    }
  };

  // Send buffer `buf` (this CTA's values of one frame, already in out[buf])
  // to the windows that hold it, and its maximum to every CTA
  auto send = [&](int buf, float value) {
    const float m = torbi::warp_max(value);
    if (lane == 0) part[buf * warps + warp] = m;
    torbi::fence_async_shared();
    __syncthreads();
    if (warp == 0) {
      float s = torbi::neg_inf();
      for (int w = lane; w < warps; w += 32)
        s = fmaxf(s, part[buf * warps + w]);
      s = torbi::warp_max(s);
      const unsigned bar = bars + 8 * buf;
      if (lane < kCluster)
        torbi::store_async(
            torbi::remote_address(
                torbi::smem_address(maxima + buf * kCluster + rank), lane),
            s, torbi::remote_address(bar, lane));
      const unsigned src = torbi::smem_address(out + buf * P);
      for (int r = r_first + lane; r <= r_last; r += 32)
        torbi::bulk_copy(
            torbi::remote_address(
                torbi::smem_address(win + buf * l.window +
                                    (rank - r - l.a) * P),
                r),
            src, P * 4, torbi::remote_address(bar, r));
    }
  };

  // Every barrier of the cluster is set up before any remote operation
  cluster.sync();

  // Frame 0: post = obs[0] + initial
  float mine = torbi::neg_inf();
  if (writer) {
    mine = torbi::convert_obs<CONV>(obs[j_out]) + initial[j_out];
    post_seq[j_out] = mine;
    out[jl_out] = mine;
  }
  send(0, mine);
  ready(1);

  for (int t = 1; t < t_end; ++t) {
    const int cur = (t - 1) & 1;
    torbi::mbarrier_wait(bars + 8 * cur, ((t - 1) >> 1) & 1);
    if (tid == 0) torbi::mbarrier_expect(bars + 8 * (t & 1), expected);
    float base = torbi::neg_inf();
    if (has_floor) {
      const float m =
          lane < kCluster ? maxima[cur * kCluster + lane] : torbi::neg_inf();
      base = torbi::warp_max(m) + floor_value;
    }
    float acc[kNacc][kR];
#pragma unroll
    for (int n = 0; n < kNacc; ++n)
#pragma unroll
      for (int i = 0; i < kR; ++i) acc[n][i] = torbi::neg_inf();
    // Source m of the run feeds offset k = m - i of destination i
    const float* src = win + cur * l.window + first;
#pragma unroll
    for (int m = 0; m < DMAX + kR - 1; ++m) {
      const float s = src[m];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int k = m - i;
        if (k >= 0 && k < DMAX)
          acc[k & 1][i] = fmaxf(acc[k & 1][i], s + band_r[k][i]);
      }
    }
    float pick = torbi::neg_inf();
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      float v = acc[0][i];
#pragma unroll
      for (int n = 1; n < kNacc; ++n) v = fmaxf(v, acc[n][i]);
#pragma unroll
      for (int off = 1; off < kLanes; off <<= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (g == i) pick = v;
    }
    if (writer) {
      mine = ring[(t % kStages) * l.threads + tid] + fmaxf(pick, base);
      post_seq[static_cast<size_t>(t) * states + j_out] = mine;
      out[(t & 1) * P + jl_out] = mine;
    }
    send(t & 1, writer ? mine : torbi::neg_inf());
    // The ring stage just read is refilled with frame t + kStages
    stage(t + kStages);
    ready(t + 1);
  }
  torbi::cp_async_wait_all();
  // Every copy into this CTA has landed, then no CTA leaves before the
  // copies out of its memory have landed too
  const int last = t_end - 1;
  torbi::mbarrier_wait(bars + 8 * (last & 1), (last >> 1) & 1);
  cluster.sync();

  // Frames past the valid length hold the last posterior
  if (writer)
    for (int t = t_end; t < frames; ++t)
      post_seq[static_cast<size_t>(t) * states + j_out] = mine;
}

template <int DMAX, int CONV>
int launch(const float* obs, const int* batch_frames, const float* initial,
           const float* band, float* post_seq, int frames, int states, int lo,
           int width, float floor_value, int has_floor, cudaStream_t stream) {
  size_t optin = 0;
  const cudaError_t err = torbi::optin_smem(&optin);
  if (err != cudaSuccess) return err;
  const Layout l = make_layout(states, width, lo);
  const size_t smem = static_cast<size_t>(l.floats) * sizeof(float);
  if (l.threads > Tile<DMAX>::MAX_THREADS || smem > optin)
    return cudaErrorInvalidValue;
  return torbi::launch_cluster(
      band_spread_kernel<DMAX, CONV>, kCluster, dim3(kCluster),
      dim3(l.threads), smem, stream, 0, obs, batch_frames, initial, band,
      post_seq, frames, states, lo, width, floor_value, has_floor);
}

template <int DMAX>
int launch_conv(int conv, const float* obs, const int* batch_frames,
                const float* initial, const float* band, float* post_seq,
                int frames, int states, int lo, int width, float floor_value,
                int has_floor, cudaStream_t stream) {
#define TORBI_CONV_CASE(CONV)                                               \
  case CONV:                                                                \
    return launch<DMAX, CONV>(obs, batch_frames, initial, band, post_seq,   \
                              frames, states, lo, width, floor_value,       \
                              has_floor, stream);
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

int launch_tile(int conv, const float* obs, const int* batch_frames,
                const float* initial, const float* band, float* post_seq,
                int frames, int states, int lo, int width, float floor_value,
                int has_floor, cudaStream_t stream) {
#define TORBI_TILE_CASE(DMAX)                                               \
  case DMAX:                                                                \
    return launch_conv<DMAX>(conv, obs, batch_frames, initial, band,        \
                             post_seq, frames, states, lo, width,           \
                             floor_value, has_floor, stream);
  switch (tile_of((width + kLanes - 1) / kLanes)) {
    TORBI_TILE_CASE(8)
    TORBI_TILE_CASE(16)
    TORBI_TILE_CASE(24)
    TORBI_TILE_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef TORBI_TILE_CASE
}

}  // namespace

// obs, post_seq: (1, frames, states) float32; batch_frames: (1,) int32;
// initial: (states,) float32; band: (width, states) float32 with
// band[d, j] = transition[j, j + d + lo]. The observation is log-space
// when log_input is set, else probabilities; apply_epsilon applies the
// epsilon step. Launches one cluster of 16 CTAs. Returns a cudaError_t
// code: cudaErrorInvalidValue for a band wider than 256, or a layout that
// exceeds the tile's threads or the card's opt-in shared memory
// (ops/band.py::spread_layout says which).
extern "C" int band_spread(const float* obs, const int* batch_frames,
                           const float* initial, const float* band,
                           float* post_seq, int frames, int states, int lo,
                           int width, float floor_value, int has_floor,
                           int log_input, int apply_epsilon, void* stream) {
  if (frames <= 0 || states <= 0 || width < 1) return cudaErrorInvalidValue;
  return launch_tile(torbi::conversion(log_input, apply_epsilon), obs,
                     batch_frames, initial, band, post_seq, frames, states,
                     lo, width, floor_value, has_floor,
                     static_cast<cudaStream_t>(stream));
}
