// K1, the wide-band design: the banded Viterbi forward pass on every SM,
// for the bands no layout of K1's cluster design (csrc/band_forward.cu)
// holds: wider than 301 at 1440 states, or any width at about 2,600
// states or more.
//
// Replaces the TPU kernel torbi_tpu/ops/band.py::_band_kernel_stitched
// (built by _build_band_forward_stitched) at those shapes, as the cluster
// design does at the others; the natural (batch, frames, states) layout.
// The same function as band_forward_reference (ops/band.py):
//   score[j] = max_d (post[j + d + lo] + band[d, j]),  d in [0, width),
//              sources outside [0, states) skipped (their band entry is -inf)
//   score[j] = max(score[j], floor + max_i post[i])    when has_floor
//   post'[j] = t < batch_frames[b] ? obs[b, t, j] + score[j] : post[j]
// and at t = 0, post = obs[b, 0] + initial, with the observation converted
// as it is loaded (log_input, apply_epsilon: common.cuh, convert_obs).
// Each candidate is one fp32 add and fmaxf does not depend on order, so
// the stream is bitwise the plain version's.
//
// Bound on the H100: at 512 x 512 x 1440 and width 347 (the pitch band at
// a 20 ms hop), 512 * 511 * 469,578 in-range candidates at an add and a
// max each, 7.4 ms at 128 FP32 instructions per SM and clock, against 3.0
// GB of observation in and stream out, 0.9 ms at 3.35 TB/s: operations
// bound it. At batch 1 the frames' chain bounds it: frame t needs every
// value of frame t - 1. The design it replaces (one CTA per 1-4
// sequences) read the whole band from L2 in every CTA and frame, 2.31 MB
// at width 401, and was bound by one SM's L2 read rate at batch 1.
//
// Design: K2's persistent plan (csrc/dense_forward.cu, csrc/persistent.cuh)
// restricted to the band. One CTA per SM in a cooperative launch; the CTAs
// form `groups` sequence groups of `dest_groups` CTAs, CTA (g, d) owns
// sequences [g bc, g bc + bc) and destinations [d jc, d jc + jc), and a
// group's CTAs meet at an atomic-counter barrier after every frame, then
// read the last frame's stream rows back through L2. A CTA reads only its
// source window, [d jc + lo, d jc + jc + lo + width - 1) widened to 4
// floats at both ends and cut to [0, states rounded up to 4): at 1440
// states and width 401, 416 sources a sequence, not the 2.31 MB band. Its
// band slice, stored as K2's transition slice restricted to the window,
// slice[jl][i - a] = band[i - j - lo][j] for j = d jc + jl (-inf where
// i - j - lo is outside [0, width)), stays in shared memory for the launch
// (12 x 420 floats at 1440 states and width 401), so every candidate is an
// add and a max with no guards, in K2's 4 x 4 register tile. Where no
// resident slice fits (very large states), each CTA writes its slice rows
// once into device memory (`slices`) and streams them in the chunks beside
// the posterior, as K2's streamed mode streams its transition rows.
// ops/band.py::wide_plan picks the plan (ops/dense.py::dense_plans with
// the band's width: the cost model counts the window's sources where K2
// counts the states).
//
// The floor term without whole rows: after a frame each CTA folds the
// maximum of the values it wrote for each sequence into its group's entry
// of `maxima` (an atomic max of the float's order-preserving unsigned
// key), and after the barrier each CTA reads one entry per sequence
// (ld.cg): max does not depend on order, so the row maximum is exact. The
// entries of frame t sit in slot t % 3; CTA 0 of a group clears slot
// t + 1 during frame t, after every CTA has read that slot's last use
// (frame t - 2's, read at the start of frame t - 1) and before any CTA
// writes it (after the barrier that ends frame t). The out-of-band
// entries inside a window stay -inf in the slice; the floor term covers
// them (every exterior entry equals the floor, the global minimum, so an
// in-band source counted again at floor + post[i] is dominated).
//
// The frame's latency sets the time at a small batch. So each frame first
// puts its observation loads in flight (converted only at the outputs),
// then its first chunk, then the floor's one load per sequence, and
// prefetches the next frame's observation into L2; the CTA's batch_frames
// sit in shared memory.
#include "persistent.cuh"

namespace {

using torbi::kTile;
constexpr int kMaxThreads = 512;
constexpr int kOut = kTile * kTile;

// The launch plan of ops/band.py::wide_plan, in its field order
struct Plan {
  int bc;           // sequences per CTA, a multiple of bp
  int bp;           // sequences per pass, a multiple of 4
  int jc;           // destinations per CTA, a multiple of 4
  int groups;       // sequence groups
  int dest_groups;  // CTAs per group
  int split;        // lanes sharing one cell of the tile
  int chunk;        // sources per chunk, a multiple of max(8, 4 split)
  int resident;     // the whole slice in shared memory
  int vec;          // states a multiple of 4: 16-byte asynchronous copies
  int threads;
  int window;       // the most sources of a CTA's window
};

__host__ __device__ inline int floor4(int x) {
  return x >= 0 ? x / 4 * 4 : -((3 - x) / 4) * 4;
}

// The most sources of one CTA's window at this shape (ops/dense.py,
// band_window): jc + width - 1, widened to 4 floats at both ends, within
// the states rounded up to 4; none for a width-0 band
__host__ __device__ inline int max_window(int jc, int states, int width) {
  if (width == 0) return 0;
  const int rounded = floor4(states + 3);
  const int widest = floor4(jc + width + 2 + 3);
  return rounded < widest ? rounded : widest;
}

// Row strides in shared memory, in floats: a multiple of 4 whose quarter
// is odd, as K2's
__host__ __device__ inline int chunk_stride(const Plan& p) {
  return p.chunk + 4;
}
__host__ __device__ inline int slice_stride(const Plan& p) {
  return p.resident ? (p.window + 7) / 8 * 8 + 4 : chunk_stride(p);
}

// Words of shared memory: the band slice (the whole window, or two
// chunks), two chunks of the pass's posterior rows, the (bp, jc / 4)
// table of the threads' row maxima, the bc floor terms and the bc
// sequences' batch_frames
inline size_t smem_floats(const Plan& p) {
  const size_t slice = static_cast<size_t>(p.jc) * slice_stride(p);
  return (p.resident ? slice : 2 * slice) +
         2 * static_cast<size_t>(p.bp) * chunk_stride(p) +
         static_cast<size_t>(p.bp) * (p.jc / kTile) + 2 * p.bc;
}

// A float's unsigned key in the same order (for any value but NaN), so
// that an atomic max of keys is a max of floats; key 0 lies below every
// float's
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned bits = __float_as_uint(v);
  return (bits & 0x80000000u) ? ~bits : bits | 0x80000000u;
}
__device__ __forceinline__ float from_key(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? key & 0x7fffffffu : ~key);
}

__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// v[i] for a run-time i, by selects: no local memory, little code
template <typename T, int N>
__device__ __forceinline__ T pick(const T (&v)[N], int i) {
  T x = v[0];
#pragma unroll
  for (int n = 1; n < N; ++n) x = i == n ? v[n] : x;
  return x;
}

// The observation conversion of `conv` (common.cuh, conversion)
__device__ __forceinline__ float convert(int conv, float x) {
  switch (conv) {
    case 1:
      return torbi::convert_obs<1>(x);
    case 2:
      return torbi::convert_obs<2>(x);
    case 3:
      return torbi::convert_obs<3>(x);
    default:
      return x;
  }
}

// Copy rows [0, live) of sources [i0, i0 + count) from `src` (row r at
// src + r * src_stride) into `dst` (row r at dst + r * dst_stride), by
// the whole CTA: 16-byte asynchronous copies, committed by the caller
// (VEC: count, i0 and the stride multiples of 4), or loads through L2 and
// stores, -inf past `limit` sources. Each thread's (row, source) steps by
// the CTA's size, with no division per element (K2 keeps its own staging,
// which divides)
template <bool VEC>
__device__ __forceinline__ void stage_rows(float* dst, int dst_stride,
                                           const float* src,
                                           size_t src_stride, int live,
                                           int i0, int count, int limit) {
  const int per_row = VEC ? count / 4 : count;
  if (per_row <= 0) return;
  const int rows_step = blockDim.x / per_row;
  const int col_step = blockDim.x - rows_step * per_row;
  int r = threadIdx.x / per_row;
  int c = threadIdx.x - r * per_row;
  while (r < live) {
    if constexpr (VEC) {
      torbi::cp_async16(dst + r * dst_stride + 4 * c,
                        src + r * src_stride + i0 + 4 * c);
    } else {
      dst[r * dst_stride + c] = i0 + c < limit
                                    ? __ldcg(src + r * src_stride + i0 + c)
                                    : torbi::neg_inf();
    }
    r += rows_step;
    c += col_step;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

// Every value of a thread's tile converted in one straight run of code
template <int CONV>
__device__ __forceinline__ void convert_each(float (&v)[kOut]) {
#pragma unroll
  for (int o = 0; o < kOut; ++o) v[o] = torbi::convert_obs<CONV>(v[o]);
}
__device__ __forceinline__ void convert_tile(int conv, float (&v)[kOut]) {
  switch (conv) {
    case 1:
      convert_each<1>(v);
      break;
    case 2:
      convert_each<2>(v);
      break;
    case 3:
      convert_each<3>(v);
      break;
    default:
      break;
  }
}

template <bool RESIDENT, bool VEC>
__global__ void __launch_bounds__(kMaxThreads, 1) band_wide_kernel(
    const float* __restrict__ obs, const int* __restrict__ batch_frames,
    const float* __restrict__ initial, const float* __restrict__ band,
    float* __restrict__ post_seq, unsigned* __restrict__ counters,
    unsigned* __restrict__ maxima, float* __restrict__ slices, int batch,
    int frames, int states, int lo, int width, float floor_value,
    int has_floor, int conv, Plan p) {
  extern __shared__ __align__(16) float smem[];
  const int cs = chunk_stride(p);
  const int ss = slice_stride(p);
  // slice_s: [jc][ss] (resident) or [2][jc][cs]; post_s: [2][bp][cs];
  // part_s: [bp][jc / 4]; base_s: [bc]; bf_s: [bc]
  float* slice_s = smem;
  float* post_s = smem + static_cast<size_t>(RESIDENT ? 1 : 2) * p.jc * ss;
  float* part_s = post_s + 2 * static_cast<size_t>(p.bp) * cs;
  float* base_s = part_s + static_cast<size_t>(p.bp) * (p.jc / kTile);
  int* bf_s = reinterpret_cast<int*>(base_s + p.bc);
  __shared__ int group_end;
  const int g = static_cast<int>(blockIdx.x) / p.dest_groups;
  const int d = static_cast<int>(blockIdx.x) % p.dest_groups;
  const int b0 = g * p.bc;
  const int j0 = d * p.jc;
  const int tid = threadIdx.x;
  const int k = tid % p.split;
  const int cell = tid / p.split;
  const int tx_n = p.jc / kTile;
  const int ty_n = p.bp / kTile;
  const int tx = cell % tx_n;
  const int ty = cell / tx_n;
  const bool active = ty < ty_n;
  const int passes = p.bc / p.bp;
  const size_t seq_stride = static_cast<size_t>(frames) * states;
  const int jlive = min(p.jc, states - j0);
  // This CTA's window: sources [a, a + count), a multiple of 4 each
  const int a = max(0, floor4(j0 + lo));
  const int count =
      width == 0
          ? 0
          : max(0, min(floor4(states + 3),
                       floor4(j0 + p.jc + lo + width - 1 + 3)) - a);
  const int chunks = (count + p.chunk - 1) / p.chunk;
  // The streamed slice's rows in device memory: [jc][window] a CTA
  float* slice_g =
      slices + static_cast<size_t>(blockIdx.x) * p.jc * p.window;

  // In pass s this thread's outputs o = 4 q + r are sequence b0 + s bp +
  // ty + q ty_n and destination j0 + tx + r tx_n; the split lane k with
  // o % split == k writes them (K2's tile)
  auto seq_of = [&](int s, int q) {
    return b0 + s * p.bp + ty + q * ty_n;
  };
  auto owns = [&](int s, int o) {
    return (o % p.split) == k && active && tx + (o % kTile) * tx_n < jlive &&
           seq_of(s, o / kTile) < batch;
  };
  auto out_index = [&](int s, int o, int t) {
    return static_cast<size_t>(seq_of(s, o / kTile)) * seq_stride +
           static_cast<size_t>(t) * states + j0 + tx + (o % kTile) * tx_n;
  };

  // The frames this group computes: up to its longest sequence; the
  // sequences' batch_frames (0 past the batch) into shared memory
  if (tid == 0) group_end = 1;
  __syncthreads();
  for (int bl = tid; bl < p.bc; bl += blockDim.x) {
    const int frames_b = b0 + bl < batch ? batch_frames[b0 + bl] : 0;
    bf_s[bl] = frames_b;
    atomicMax(&group_end, min(frames_b, frames));
  }
  __syncthreads();
  const int t_end = group_end;

  // The band slice over the window: slice[jl][u] = band[a + u - j - lo][j]
  // for j = j0 + jl, -inf outside the band, the window and the states
  auto slice_value = [&](int jl, int u) {
    const int j = j0 + jl;
    const int i = a + u;
    const int off = i - j - lo;
    return jl < jlive && u < count && i < states && off >= 0 && off < width
               ? band[static_cast<size_t>(off) * states + j]
               : torbi::neg_inf();
  };
  if constexpr (RESIDENT) {
    for (int e = tid; e < p.jc * ss; e += blockDim.x)
      slice_s[e] = slice_value(e / ss, e % ss);
  } else {
    // Read back by this CTA's own copies, after the barrier that ends
    // frame 0 (or not at all)
    for (int e = tid; e < p.jc * p.window; e += blockDim.x)
      slice_g[e] = slice_value(e / p.window, e % p.window);
    __threadfence();
  }

  // Chunk c of pass s in frame t into buffer c & 1: the pass's posterior
  // rows of frame t - 1 over the window, and a streamed slice
  auto issue = [&](int t, int s, int c) {
    const int i0 = c * p.chunk;
    const int n = min(p.chunk, count - i0);
    const int rows = min(p.bp, batch - (b0 + s * p.bp));
    stage_rows<VEC>(
        post_s + static_cast<size_t>(c & 1) * p.bp * cs, cs,
        post_seq + static_cast<size_t>(b0 + s * p.bp) * seq_stride +
            static_cast<size_t>(t - 1) * states + a,
        seq_stride, rows, i0, VEC ? n : p.chunk, states - a);
    if constexpr (!RESIDENT)
      stage_rows<VEC>(
          slice_s + static_cast<size_t>(c & 1) * p.jc * cs, cs, slice_g,
          p.window, jlive, i0, VEC ? n : p.chunk, count);
    torbi::cp_async_commit();
  };

  // The maxima m[q] of this thread's values of pass s (rows ty + q ty_n)
  // folded into the group's entries of frame t, one atomic max a sequence
  auto publish = [&](int s, int t, float (&m)[kTile]) {
    for (int off = 1; off < p.split; off <<= 1)
#pragma unroll
      for (int q = 0; q < kTile; ++q)
        m[q] = fmaxf(m[q], __shfl_xor_sync(0xffffffffu, m[q], off));
    if (active && k == 0)
#pragma unroll
      for (int q = 0; q < kTile; ++q)
        part_s[(ty + q * ty_n) * tx_n + tx] = m[q];
    __syncthreads();
    unsigned* out =
        maxima + (static_cast<size_t>(t % 3) * p.groups + g) * p.bc +
        s * p.bp;
    for (int row = tid; row < min(p.bp, batch - (b0 + s * p.bp));
         row += blockDim.x) {
      float mx = torbi::neg_inf();
      for (int x = 0; x < tx_n; ++x) mx = fmaxf(mx, part_s[row * tx_n + x]);
      atomicMax(out + row, order_key(mx));
    }
    // part_s is written again by the next pass
    if (s + 1 < passes) __syncthreads();
  };

  // CTA 0 of the group clears the entries of frame t + 1
  auto clear_next = [&](int t) {
    if (d == 0)
      for (int bl = tid; bl < p.bc; bl += blockDim.x)
        maxima[(static_cast<size_t>((t + 1) % 3) * p.groups + g) * p.bc +
               bl] = 0u;
  };

  // The floor terms of frame t: base_s[b] = floor + the max of frame t -
  // 1's posterior, the group's entry (read by the next barrier of the CTA)
  auto load_floor = [&](int t) {
    const unsigned* in =
        maxima + (static_cast<size_t>((t - 1) % 3) * p.groups + g) * p.bc;
    for (int bl = tid; bl < p.bc; bl += blockDim.x)
      base_s[bl] = from_key(__ldcg(in + bl)) + floor_value;
  };

  // Frame 0: post = obs[0] + initial
  if (has_floor) clear_next(0);
  for (int s = 0; s < passes; ++s) {
    float m[kTile];
#pragma unroll
    for (int q = 0; q < kTile; ++q) m[q] = torbi::neg_inf();
#pragma unroll 1
    for (int o = k; o < kOut; o += p.split)
      if (owns(s, o)) {
        const size_t at = out_index(s, o, 0);
        const float v = convert(conv, obs[at]) +
                        initial[j0 + tx + (o % kTile) * tx_n];
        post_seq[at] = v;
#pragma unroll
        for (int q = 0; q < kTile; ++q)
          if (q == o / kTile) m[q] = fmaxf(m[q], v);
      }
    if (has_floor && t_end > 1) publish(s, 0, m);
  }
  if (t_end > 1) torbi::group_sync(counters + g, p.dest_groups, 1);

  for (int t = 1; t < t_end; ++t) {
    if (has_floor) clear_next(t);
    for (int s = 0; s < passes; ++s) {
      // This frame's observations of the live outputs first (converted
      // at the outputs), then the first chunk, then the floor terms: all
      // in flight together
      int bfq[kTile];
#pragma unroll
      for (int q = 0; q < kTile; ++q)
        bfq[q] = active ? bf_s[s * p.bp + ty + q * ty_n] : 0;
      float ob[kOut];
#pragma unroll
      for (int o = 0; o < kOut; ++o)
        ob[o] = owns(s, o) && t < bfq[o / kTile]
                    ? __ldg(obs + out_index(s, o, t))
                    : 0.0f;
      if (chunks > 0) issue(t, s, 0);
      if (has_floor && s == 0) load_floor(t);
      // The floor terms are read after a barrier: the chunks' or this one
      if (chunks == 0) __syncthreads();
      float acc[kTile][kTile];
#pragma unroll
      for (int q = 0; q < kTile; ++q)
#pragma unroll
        for (int r = 0; r < kTile; ++r) acc[q][r] = torbi::neg_inf();

      for (int c = 0; c < chunks; ++c) {
        // Chunk c + 1 goes in flight while chunk c is computed (K2's
        // double buffers)
        if (c + 1 < chunks) {
          issue(t, s, c + 1);
          torbi::cp_async_wait<1>();
        } else {
          torbi::cp_async_wait<0>();
        }
        __syncthreads();
        if (active) {
          const int quads = (min(p.chunk, count - c * p.chunk) + 3) / 4;
          const float* ps = post_s + static_cast<size_t>(c & 1) * p.bp * cs +
                            static_cast<size_t>(ty) * cs;
          const float* ts =
              RESIDENT ? slice_s + static_cast<size_t>(tx) * ss + c * p.chunk
                       : slice_s + static_cast<size_t>(c & 1) * p.jc * cs +
                             static_cast<size_t>(tx) * cs;
          const size_t prow = static_cast<size_t>(ty_n) * cs;
          const size_t trow = static_cast<size_t>(tx_n) * ss;
          torbi::tile_max_plus(acc, ps, prow, ts, trow, k, quads, p.split);
        }
        __syncthreads();
      }
      torbi::combine_split(acc, p.split);
      float base[kTile];
#pragma unroll
      for (int q = 0; q < kTile; ++q)
        base[q] = has_floor && active ? base_s[s * p.bp + ty + q * ty_n]
                                      : torbi::neg_inf();
      // A stopped sequence keeps the value this thread wrote last frame;
      // the next frame's observation goes into L2 while the group meets
      float sc[kOut];
#pragma unroll
      for (int o = 0; o < kOut; ++o)
        sc[o] = fmaxf(acc[o / kTile][o % kTile], base[o / kTile]);
      float m[kTile];
#pragma unroll
      for (int q = 0; q < kTile; ++q) m[q] = torbi::neg_inf();
      if (p.split >= 4) {
        // Four outputs a lane or fewer, o = k, k + split, ...: a loop
        // with one copy of the conversion's code, the values picked out
        // of the registers (sixteen unrolled copies of it cost a frame at
        // a small batch more in instruction fetch than the loop costs)
#pragma unroll 1
        for (int o = k; o < kOut; o += p.split)
          if (owns(s, o)) {
            const int frames_q = pick(bfq, o / kTile);
            const size_t at = out_index(s, o, t);
            const float v =
                t < frames_q ? convert(conv, pick(ob, o)) + pick(sc, o)
                             : __ldcg(post_seq + out_index(s, o, t - 1));
            post_seq[at] = v;
#pragma unroll
            for (int q = 0; q < kTile; ++q)
              if (q == o / kTile) m[q] = fmaxf(m[q], v);
            if (t + 1 < frames_q) prefetch_l2(obs + out_index(s, o, t + 1));
          }
      } else {
        // Up to sixteen outputs a lane: the conversion of the whole tile
        // in one straight run (the values of outputs it does not own are
        // placeholders, converted and left unused), then the outputs
        // unrolled
        convert_tile(conv, ob);
#pragma unroll
        for (int o = 0; o < kOut; ++o)
          if (owns(s, o)) {
            const int q = o / kTile;
            const size_t at = out_index(s, o, t);
            const float v = t < bfq[q]
                                ? ob[o] + sc[o]
                                : __ldcg(post_seq + out_index(s, o, t - 1));
            post_seq[at] = v;
            m[q] = fmaxf(m[q], v);
            if (t + 1 < bfq[q]) prefetch_l2(obs + out_index(s, o, t + 1));
          }
      }
      if (has_floor && t + 1 < t_end) publish(s, t, m);
    }
    if (t + 1 < t_end) torbi::group_sync(counters + g, p.dest_groups, t + 1);
  }
  // Frames past the group's longest sequence hold the last posterior
  if (t_end < frames)
    for (int s = 0; s < passes; ++s)
#pragma unroll
      for (int o = 0; o < kOut; ++o)
        if (owns(s, o)) {
          const float v = __ldcg(post_seq + out_index(s, o, t_end - 1));
          for (int t = t_end; t < frames; ++t)
            post_seq[out_index(s, o, t)] = v;
        }
}

bool valid(const Plan& p, int batch, int states, int width, size_t optin) {
  const int cells = (p.bp / kTile) * (p.jc / kTile);
  const int step = 4 * p.split > 8 ? 4 * p.split : 8;
  return p.bp >= kTile && p.bp % kTile == 0 && p.bc >= p.bp &&
         p.bc % p.bp == 0 && p.jc >= kTile && p.jc % kTile == 0 &&
         p.groups >= 1 && p.dest_groups >= 1 &&
         static_cast<long long>(p.groups) * p.bc >= batch &&
         static_cast<long long>(p.dest_groups) * p.jc >= states &&
         (p.groups - 1) * p.bc < batch &&
         (p.dest_groups - 1) * p.jc < states && p.split >= 1 &&
         p.split <= 32 && (p.split & (p.split - 1)) == 0 &&
         p.threads % 32 == 0 && p.threads <= kMaxThreads &&
         p.threads >= cells * p.split && p.chunk >= step &&
         p.chunk % step == 0 && (!p.vec || states % 4 == 0) &&
         p.window == max_window(p.jc, states, width) &&
         smem_floats(p) * sizeof(float) <= optin;
}

template <bool RESIDENT, bool VEC>
int launch(const float* obs, const int* batch_frames, const float* initial,
           const float* band, float* post_seq, unsigned* counters,
           unsigned* maxima, float* slices, int batch, int frames, int states,
           int lo, int width, float floor_value, int has_floor, int conv,
           const Plan& p, cudaStream_t stream) {
  Plan plan = p;
  void* args[] = {&obs,     &batch_frames, &initial, &band,   &post_seq,
                  &counters, &maxima,      &slices,  &batch,  &frames,
                  &states,   &lo,          &width,   &floor_value,
                  &has_floor, &conv,       &plan};
  return torbi::launch_persistent(band_wide_kernel<RESIDENT, VEC>,
                                  p.groups * p.dest_groups, p.threads,
                                  smem_floats(p) * sizeof(float), args,
                                  stream);
}

}  // namespace

// obs, post_seq: (batch, frames, states) float32; batch_frames: (batch,)
// int32; initial: (states,) float32; band: (width, states) float32 with
// band[d, j] = transition[j, j + d + lo] (not read when width is 0). The
// observation is log-space when log_input is set, else probabilities;
// apply_epsilon applies the epsilon step (common.cuh, convert_obs).
// counters: (groups,) uint32 zeros, the group barriers; maxima: (3,
// groups, bc) uint32 zeros, the keys of the row maxima; slices: (groups *
// dest_groups, jc, window) float32 scratch when the slice streams (not
// read otherwise). The plan's fields as
// ops/band.py::wide_plan gives them. A width-0 band needs the floor.
// Returns a cudaError_t code: cudaErrorInvalidValue for a plan that does
// not own every output once, whose window is not this shape's, or that
// does not fit the card.
extern "C" int band_forward_wide(
    const float* obs, const int* batch_frames, const float* initial,
    const float* band, float* post_seq, unsigned* counters,
    unsigned* maxima, float* slices, int batch, int frames, int states,
    int lo, int width, float floor_value, int has_floor, int log_input,
    int apply_epsilon,
    int bc, int bp, int jc, int groups, int dest_groups, int split,
    int chunk, int resident, int vec, int threads, int window,
    void* stream) {
  if (batch <= 0 || frames <= 0 || states <= 0 || width < 0 ||
      (width == 0 && !has_floor))
    return cudaErrorInvalidValue;
  const Plan p = {bc,    bp,    jc,       groups, dest_groups, split,
                  chunk, resident, vec,   threads, window};
  size_t optin = 0;
  cudaError_t err = torbi::optin_smem(&optin);
  if (err != cudaSuccess) return err;
  if (!valid(p, batch, states, width, optin)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int conv = torbi::conversion(log_input, apply_epsilon);
#define TORBI_WIDE_CASE(R, V)                                              \
  if (static_cast<bool>(resident) == R && static_cast<bool>(vec) == V)     \
    return launch<R, V>(obs, batch_frames, initial, band, post_seq,        \
                        counters, maxima, slices, batch, frames, states,   \
                        lo, width, floor_value, has_floor, conv, p, s);
  TORBI_WIDE_CASE(true, true)
  TORBI_WIDE_CASE(true, false)
  TORBI_WIDE_CASE(false, true)
  TORBI_WIDE_CASE(false, false)
#undef TORBI_WIDE_CASE
  return cudaErrorInvalidValue;
}
