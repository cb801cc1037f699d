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
// on order, so any split of the sources over threads, and any order of the
// maxima, gives the stream of the plain version
// (torbi_tpu_torch/ops/dense.py::dense_forward_reference) bitwise.
//
// Bound on the H100: a frame is a max-plus product (batch x states) (x)
// (states x states), batch * (frames - 1) * states^2 candidates at an add
// and a max each; at 512 x 512 x 1280 that is 4.3e11 candidates, about
// 26 ms at 128 FP32 instructions per SM and clock (132 SMs, 1.98 GHz),
// against 0.8 ms for the observation in and the stream out at 3.35 TB/s.
// So operations bound it; chip_smoke.py counts the instructions per
// candidate in this kernel's SASS. The frames form a chain: frame t needs
// every destination of frame t - 1.
//
// Design: one persistent CTA per SM, in a cooperative launch, for the
// whole recursion. The CTAs form `groups` sequence groups of `dest_groups`
// CTAs each; CTA (g, d) owns sequences [g bc, g bc + bc) and destinations
// [d jc, d jc + jc) in every frame, so every (sequence, destination) has
// one owner (ops/dense.py::dense_plan picks bc, jc and the rest for the
// shape and checks that), and its transition rows serve all bc sequences.
// Frame t - 1's values are the stream rows post_seq[b, t - 1], which
// every CTA writes to device memory anyway; after a group's CTAs have
// written a frame, they meet at a barrier of their group (an atomic
// counter in device memory) and read the rows they need back through L2
// (L1 is not coherent, and a line of row t - 1 can hold the start of row
// t, so no read goes through L1). Groups never wait for each other.
//
// Per frame a CTA reads its sequences' rows in chunks of `chunk` sources,
// double-buffered in shared memory: chunk c + 1 is in flight while chunk c
// is computed, as 16-byte cp.async.cg copies (cp.async of 4 or 8 bytes
// exists only as .ca, through L1). So every staged row starts on 16
// bytes: the sources run over the states rounded up to 4 (`sources`),
// and the transition comes with that row stride. Where the states are
// not a multiple of 4, the rows of post_seq are off 16 bytes, and the
// posterior is read from a padded exchange instead, (batch, 2, sources):
// every output of frame t also goes to exchange[b, t & 1], its pad
// columns -inf (written at frame 0, never again); frame t + 1 overwrites
// the parity frame t read only after the group's barrier that ends frame
// t. The -inf pads of both operands add only -inf candidates, so the
// outputs are those of the unpadded recursion bitwise. The transition
// slice stays in shared memory for the launch
// (`resident`), or streams in the same chunks beside the posterior. The
// plan weighs both at every group count and takes the cheaper by its cost
// model: a resident slice saves reading it from L2 every frame and wins
// where it leaves room for long chunks (1.43x at 8 x 1440, 1.88x at 1 x
// 2048, at one group count); at 512 x 1280 it leaves room for chunks of 16 sources, where a
// streamed one takes 168-192, and streaming wins (1.26x at 4 groups).
// Both operands keep their natural [row][source] order, row strides a
// multiple of 4 floats whose quarter is odd. A thread owns a register tile
// of 4 sequences x 4 destinations, its rows spread over the CTA's (row
// ty + q bp / 4, destination tx + r jc / 4), so that the lanes of a warp
// load 16 bytes from consecutive rows, 8 rows on the 32 banks: per 4
// sources it loads 4 + 4 float4 for 64 candidates, half a shared-memory
// word per candidate, less where lanes share a load. When a CTA's tile
// has fewer than 512 / 32 cells (a small batch), `split` lanes (a power of
// two up to 32, adjacent in the warp) share a cell, each taking every
// split-th group of 4 sources, and xor shuffles combine them. A CTA with
// more cells than 512 threads takes its sequences in passes of `bp`, each
// pass reading its own rows. A sequence past its batch_frames keeps the
// value its thread wrote last frame; a group whose sequences have all
// stopped computes no more and meets at no more barriers.
#include <cstdint>

#include "persistent.cuh"

namespace {

using torbi::kTile;
constexpr int kMaxThreads = 512;
constexpr int kOut = kTile * kTile;

// The launch plan of ops/dense.py::dense_plan
struct Plan {
  int bc;           // sequences per CTA, a multiple of bp
  int bp;           // sequences per pass, a multiple of 4
  int jc;           // destinations per CTA, a multiple of 4
  int groups;       // sequence groups
  int dest_groups;  // CTAs per group
  int split;        // lanes sharing one cell of the tile
  int chunk;        // sources per chunk, a multiple of max(8, 4 split)
  int resident;     // the whole slice in shared memory
  int threads;
};

// The sources a row is staged over: the states rounded up to 4
__host__ __device__ inline int sources_of(int states) {
  return (states + 3) / 4 * 4;
}

// Where frame t's posterior row of sequence b lies for the next frame to
// read: rows + b seq_stride + (t & frame_mask) frame_stride. The stream
// (post_seq, frame_mask all ones) or the exchange (its two parities,
// frame_mask 1); set at the launch, so that the chunk loop reads it from
// the kernel's parameters
struct Source {
  const float* rows;
  size_t seq_stride;
  int frame_stride;
  int frame_mask;
};

// Row strides in shared memory, in floats: a multiple of 4 whose quarter
// is odd, so that 16-byte loads of 8 consecutive rows hit 32 banks once
__host__ __device__ inline int chunk_stride(const Plan& p) {
  return p.chunk + 4;
}
__host__ __device__ inline int slice_stride(const Plan& p, int states) {
  return p.resident ? (states + 7) / 8 * 8 + 4 : chunk_stride(p);
}

// Floats of shared memory: the transition slice (whole, or two chunks)
// and two chunks of the pass's posterior rows
inline size_t smem_floats(const Plan& p, int states) {
  const size_t slice = static_cast<size_t>(p.jc) * slice_stride(p, states);
  return (p.resident ? slice : 2 * slice) +
         2 * static_cast<size_t>(p.bp) * chunk_stride(p);
}

// Copy `rows` rows of sources [i0, i0 + count) from `src` (row r at
// src + r * src_stride) into `dst` (row r at dst + r * dst_stride), by
// the whole CTA in 16-byte asynchronous copies, committed by the caller
// (count, i0, the strides and both rows' starts multiples of 4 floats).
// Rows at or past `live` are left as they are. (csrc/band_wide.cu's
// stage_rows steps its indices instead of dividing; moving K2 onto it is
// a change of K2 of its own, PERF.md §7)
__device__ __forceinline__ void stage(float* dst, int dst_stride,
                                      const float* src, size_t src_stride,
                                      int rows, int live, int i0,
                                      int count) {
  const int quads = count / 4;
  for (int e = threadIdx.x; e < rows * quads; e += blockDim.x) {
    const int r = e / quads;
    const int q = e - r * quads;
    if (r < live)
      torbi::cp_async16(dst + r * dst_stride + 4 * q,
                        src + r * src_stride + i0 + 4 * q);
  }
}

template <bool RESIDENT>
__global__ void __launch_bounds__(kMaxThreads, 1) dense_forward_kernel(
    const float* __restrict__ obs, const int* __restrict__ batch_frames,
    const float* __restrict__ initial, const float* __restrict__ transition,
    float* __restrict__ post_seq, float* __restrict__ exchange,
    const Source prev, unsigned* __restrict__ counters, int batch,
    int frames, int states, Plan p) {
  extern __shared__ __align__(16) float smem[];
  const int cs = chunk_stride(p);
  const int ss = slice_stride(p, states);
  // trans_s: [jc][ss] (resident) or [2][jc][cs]; post_s: [2][bp][cs]
  float* trans_s = smem;
  float* post_s =
      smem + static_cast<size_t>(RESIDENT ? 1 : 2) * p.jc * ss;
  __shared__ int group_end;
  const int g = static_cast<int>(blockIdx.x) / p.dest_groups;
  const int b0 = g * p.bc;
  const int j0 = (static_cast<int>(blockIdx.x) % p.dest_groups) * p.jc;
  const int tid = threadIdx.x;
  const int k = tid % p.split;
  const int cell = tid / p.split;
  const int tx_n = p.jc / kTile;
  const int ty_n = p.bp / kTile;
  const int tx = cell % tx_n;
  const int ty = cell / tx_n;
  const bool active = ty < ty_n;
  const int passes = p.bc / p.bp;
  const int sources = sources_of(states);
  const int chunks = (sources + p.chunk - 1) / p.chunk;
  const size_t seq_stride = static_cast<size_t>(frames) * states;
  const int jlive = min(p.jc, states - j0);

  // In pass s this thread's outputs o = 4 q + r are sequence b0 + s bp +
  // ty + q ty_n and destination j0 + tx + r tx_n (rows of a tile spread
  // over the CTA's rows, so that a warp's 16-byte loads fall on
  // consecutive rows); the split lane k with o % split == k writes them
  bool dst_ok[kTile];
#pragma unroll
  for (int r = 0; r < kTile; ++r) dst_ok[r] = active && tx + r * tx_n < jlive;
  auto seq_of = [&](int s, int q) {
    return b0 + s * p.bp + ty + q * ty_n;
  };
  auto owns = [&](int s, int o) {
    return (o % p.split) == k && dst_ok[o % kTile] &&
           seq_of(s, o / kTile) < batch;
  };
  auto out_index = [&](int s, int o, int t) {
    return static_cast<size_t>(seq_of(s, o / kTile)) * seq_stride +
           static_cast<size_t>(t) * states + j0 + tx + (o % kTile) * tx_n;
  };
  // Output o of frame t into the stream and, given one, the exchange
  auto put = [&](int s, int o, int t, float v) {
    post_seq[out_index(s, o, t)] = v;
    if (exchange)
      exchange[static_cast<size_t>(seq_of(s, o / kTile)) * prev.seq_stride +
               (t & prev.frame_mask) * prev.frame_stride + j0 + tx +
               (o % kTile) * tx_n] = v;
  };

  // The frames this group computes: up to its longest sequence
  if (tid == 0) group_end = 1;
  __syncthreads();
  for (int b = b0 + tid; b < min(b0 + p.bc, batch); b += blockDim.x)
    atomicMax(&group_end, min(batch_frames[b], frames));
  __syncthreads();
  const int t_end = group_end;

  if constexpr (RESIDENT) {
    // trans_s[j][i] = transition[j0 + j, i]; -inf past the states and in
    // the rows past them
    for (int e = tid; e < p.jc * ss; e += blockDim.x) {
      const int j = e / ss;
      const int i = e - j * ss;
      trans_s[e] = j < jlive && i < states
                       ? transition[static_cast<size_t>(j0 + j) * sources + i]
                       : torbi::neg_inf();
    }
  }

  // Chunk c of pass s in frame t into buffer c & 1: the pass's posterior
  // rows of frame t - 1 (a stopped sequence's row holds its kept value:
  // read all the same, its candidates go unused) and a streamed slice
  auto issue = [&](int t, int s, int c) {
    const int i0 = c * p.chunk;
    const int count = min(p.chunk, sources - i0);
    const int rows = min(p.bp, batch - (b0 + s * p.bp));
    stage(post_s + static_cast<size_t>(c & 1) * p.bp * cs, cs,
          prev.rows + static_cast<size_t>(b0 + s * p.bp) * prev.seq_stride +
              static_cast<size_t>((t - 1) & prev.frame_mask) *
                  prev.frame_stride,
          prev.seq_stride, p.bp, rows, i0, count);
    if constexpr (!RESIDENT)
      stage(trans_s + static_cast<size_t>(c & 1) * p.jc * cs, cs,
            transition + static_cast<size_t>(j0) * sources, sources, p.jc,
            jlive, i0, count);
    torbi::cp_async_commit();
  };

  // Frame 0: post = obs[0] + initial; the last slice's CTA writes the
  // exchange's pad columns of its group's sequences, in both parities
  for (int s = 0; s < passes; ++s)
#pragma unroll
    for (int o = 0; o < kOut; ++o)
      if (owns(s, o))
        put(s, o, 0,
            obs[out_index(s, o, 0)] + initial[j0 + tx + (o % kTile) * tx_n]);
  if (exchange && j0 + p.jc >= states) {
    const int pads = sources - states;
    const int rows = 2 * (min(b0 + p.bc, batch) - b0);
    for (int e = tid; e < rows * pads; e += blockDim.x)
      exchange[static_cast<size_t>(b0 + e / pads / 2) * prev.seq_stride +
               (e / pads % 2) * prev.frame_stride + states + e % pads] =
          torbi::neg_inf();
  }
  if (t_end > 1) torbi::group_sync(counters + g, p.dest_groups, 1);

  for (int t = 1; t < t_end; ++t) {
    for (int s = 0; s < passes; ++s) {
      int bfq[kTile];
#pragma unroll
      for (int q = 0; q < kTile; ++q)
        bfq[q] = active && seq_of(s, q) < batch ? batch_frames[seq_of(s, q)]
                                                : 0;
      // This frame's observations of the live outputs, ahead of their use
      float ob[kOut];
#pragma unroll
      for (int o = 0; o < kOut; ++o)
        ob[o] = owns(s, o) && t < bfq[o / kTile]
                    ? __ldg(obs + out_index(s, o, t))
                    : 0.0f;
      float acc[kTile][kTile];
#pragma unroll
      for (int q = 0; q < kTile; ++q)
#pragma unroll
        for (int r = 0; r < kTile; ++r) acc[q][r] = torbi::neg_inf();

      issue(t, s, 0);
      for (int c = 0; c < chunks; ++c) {
        // Chunk c + 1 goes in flight while chunk c is computed: buffer
        // (c + 1) & 1 was last read by chunk c - 1, which every thread
        // finished before the barrier that ended it
        if (c + 1 < chunks) {
          issue(t, s, c + 1);
          torbi::cp_async_wait<1>();
        } else {
          torbi::cp_async_wait<0>();
        }
        __syncthreads();
        if (active) {
          const int quads = min(p.chunk, sources - c * p.chunk) / 4;
          const float* ps = post_s + static_cast<size_t>(c & 1) * p.bp * cs +
                            static_cast<size_t>(ty) * cs;
          const float* ts =
              RESIDENT ? trans_s + static_cast<size_t>(tx) * ss + c * p.chunk
                       : trans_s + static_cast<size_t>(c & 1) * p.jc * cs +
                             static_cast<size_t>(tx) * cs;
          const size_t prow = static_cast<size_t>(ty_n) * cs;
          const size_t trow = static_cast<size_t>(tx_n) * ss;
          torbi::tile_max_plus(acc, ps, prow, ts, trow, k, quads, p.split);
        }
        __syncthreads();
      }
      // Combine the split lanes (adjacent, so within one warp)
      torbi::combine_split(acc, p.split);
      // A stopped sequence keeps the value this thread wrote last frame
#pragma unroll
      for (int o = 0; o < kOut; ++o)
        if (owns(s, o))
          put(s, o, t,
              t < bfq[o / kTile] ? ob[o] + acc[o / kTile][o % kTile]
                                 : __ldcg(post_seq + out_index(s, o, t - 1)));
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

template <bool RESIDENT>
int launch(const float* obs, const int* batch_frames, const float* initial,
           const float* transition, float* post_seq, float* exchange,
           unsigned* counters, int batch, int frames, int states,
           const Plan& p, cudaStream_t stream) {
  const size_t smem = smem_floats(p, states) * sizeof(float);
  Plan plan = p;
  const int sources = sources_of(states);
  Source prev = {post_seq, static_cast<size_t>(frames) * states, states,
                 -1};
  if (exchange)
    prev = {exchange, 2 * static_cast<size_t>(sources), sources, 1};
  void* args[] = {&obs,      &batch_frames, &initial,  &transition,
                  &post_seq, &exchange,     &prev,     &counters,
                  &batch,    &frames,       &states,   &plan};
  return torbi::launch_persistent(dense_forward_kernel<RESIDENT>,
                                  p.groups * p.dest_groups, p.threads, smem,
                                  args, stream);
}

bool aligned16(const void* pointer) {
  return reinterpret_cast<uintptr_t>(pointer) % 16 == 0;
}

bool valid(const Plan& p, int batch, int states, size_t optin) {
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
         p.chunk % step == 0 &&
         smem_floats(p, states) * sizeof(float) <= optin;
}

}  // namespace

// obs, post_seq: (batch, frames, states) float32; batch_frames: (batch,)
// int32; initial: (states,) float32; transition: (states, sources)
// float32, row = destination, sources the states rounded up to 4, its pad
// columns -inf; exchange: (batch, 2, sources) float32 scratch where the
// states are not a multiple of 4, else null (the posterior is then read
// from post_seq); counters: (groups,) uint32 zeros, the group barriers.
// The staged tensors start on 16 bytes. The plan's fields as
// ops/dense.py::dense_plan gives them. Returns a cudaError_t code:
// cudaErrorInvalidValue for a plan that does not own every output once or
// does not fit the card, or a staged tensor off 16 bytes or missing.
extern "C" int dense_forward(const float* obs, const int* batch_frames,
                             const float* initial, const float* transition,
                             float* post_seq, float* exchange,
                             unsigned* counters, int batch, int frames,
                             int states, int bc, int bp, int jc, int groups,
                             int dest_groups, int split, int chunk,
                             int resident, int threads, void* stream) {
  if (batch <= 0 || frames <= 0 || states <= 0) return cudaErrorInvalidValue;
  if (!aligned16(transition) ||
      (exchange ? !aligned16(exchange)
                : states % 4 != 0 || !aligned16(post_seq)))
    return cudaErrorInvalidValue;
  const Plan p = {bc,    bp,    jc,       groups, dest_groups,
                  split, chunk, resident, threads};
  size_t optin = 0;
  cudaError_t err = torbi::optin_smem(&optin);
  if (err != cudaSuccess) return err;
  if (!valid(p, batch, states, optin)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return resident ? launch<true>(obs, batch_frames, initial, transition,
                                 post_seq, exchange, counters, batch, frames,
                                 states, p, s)
                  : launch<false>(obs, batch_frames, initial, transition,
                                  post_seq, exchange, counters, batch, frames,
                                  states, p, s);
}
