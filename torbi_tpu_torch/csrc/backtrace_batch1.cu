// K5 and K6: the backtrace of one sequence (batch 1).
//
// K5 (backtrace_pointers, then chase_pointers) replaces the TPU kernel
// torbi_tpu/ops/backtrace.py::_backtrace12_fused1_kernel (built by
// _build_backtrace12_fused1), the batch-1 chase over every state. K6
// (backtrace_window) replaces _backtrace_window_kernel (built by
// _build_backtrace_window), the batch-1 chase over the band window only.
// Both compute what K3 (csrc/backtrace.cu) computes at batch 1, and what
// the plain version torbi_tpu_torch/ops/backtrace.py::backtrace_reference
// computes:
//   seed = lowest-index argmax of posterior; out[T-1] = seed
//   for t = T-1 .. 1: if t <= batch_frames[0] - 1,
//       idx = lowest-index argmax_i (post_seq[t-1, i] + transition[idx, i])
//     out[t-1] = idx
// with ties compared as (v > best || (v == best && i < best_i)) and a row
// of -inf giving index 0.
//
// K5 design: the chase is a chain of up to 10,239 dependent steps (1 x
// 10,240 frames), and a step that reduces a whole row on one CTA costs
// about 1.4 us (a reduction and its barriers), so the chain itself is
// what has to go. Two phases:
//
// 1. Backpointers, on the whole card, in parallel over (t, j):
//      bp[t, j] = lowest-index argmax_i (post_seq[t-1, i] + transition[j, i])
//    for 1 <= t <= t_top = min(batch_frames[0], frames) - 1 (int16; other
//    rows 0), from the gated band (ops/band.py::detect_band): the in-band
//    candidates post[t-1, j + d + lo] + band[d, j] give the in-band winner
//    (M, i_in); with a floor, the row's lowest-index argmax g of
//    fl(post[t-1, i] + floor), with its value F, is one more candidate
//    (floor_argmax_kernel). That is exact because the floor is the
//    transition's global minimum and every entry outside the band equals
//    it: a source inside the window scores at least its floor candidate
//    (fl is monotonic), so the row's maximum is max(M, F), and the lowest
//    index reaching it is i_in when M > F, g when M < F, and the lower of
//    the two when they tie; a row whose maximum is -inf gives 0. A dense
//    transition passes as a band over every offset with no floor.
//    A CTA takes 64 destinations x 32 rows at a time: a thread 4
//    destinations x 4 rows, the band tile and the rows' source windows in
//    shared memory, the sources carried in registers across offsets, so a
//    candidate costs an eighth of a shared-memory word, an add, a compare
//    and two selects.
// 2. A blocked chase of bp, blocks of B frames (B rows of bp fit a CTA's
//    shared memory): chase_blocks_kernel chases every state at each
//    block's top to the block's bottom, all blocks at once, with the
//    block's rows in shared memory; chase_bounds_kernel (one warp) takes
//    the seed and chases the block boundaries, t_top / B dependent steps;
//    chase_write_kernel then walks each block from its top state and
//    writes its frames.
//
// Bound on the H100 at 1 x 10,240 frames x 1440 states, band width 175:
// phase 1's 10,239 x 244,344 in-band candidates at four instructions each
// (chip_smoke.py counts them in this kernel's SASS) is about 1e10 FP32
// issue slots, 0.3 ms at 128 per SM and clock on 132 SMs; the 59 MB stream
// in and 29 MB table out take 0.026 ms at 3.35 TB/s. Phase 2 moves the
// table once more and runs chains of B and t_top / B dependent loads.
//
// K6 design: K5's two phases on a pure -inf band, without the floor pass:
// phase 1 is pointers_kernel with no floor term (backtrace_window below),
// phase 2 the same blocked chase (chase_pointers), so no chain of one
// dependent step a frame remains.
//
// K6 takes the argmax over the sources [idx + lo, idx + lo + width) cut to
// [0, states) only. That is exact for a band with a -inf exterior: every
// candidate outside the window is -inf, so the window holds the maximum
// whenever it is finite, and when every candidate is -inf the answer is 0.
// With a finite floor a path can leave the window (ROADMAP.md, C), so the
// wrapper and the dispatcher take K6 for a pure -inf band only.
#include <cstdint>

#include "chase.cuh"

namespace {

using torbi::settle;
using torbi::take;
using torbi::warp_reduce;

// Phase 1's tile: 64 destinations (16 groups of 4) x 32 rows (8 groups of
// 4) per pass, offsets in chunks of kChunk
constexpr int kGroupsX = 16;
constexpr int kGroupsY = 8;
constexpr int kR = 4;           // destinations per thread
constexpr int kRows = 4;        // rows per thread
constexpr int kTileJ = kGroupsX * kR;
constexpr int kTileT = kGroupsY * kRows;
constexpr int kPasses = 4;      // passes of kTileT rows per CTA
constexpr int kChunk = 192;     // band offsets in shared memory at a time
constexpr int kSrcStride = kTileJ + kChunk + 4;
constexpr int kChaseThreads = 1024;
constexpr int kMaxChains = 8;   // states per thread in chase_blocks_kernel

__device__ __forceinline__ int top_frame(const int* batch_frames,
                                         int frames) {
  return min(batch_frames[0] - 1, frames - 1);
}

// Each warp one row t in [1, t_top]: the lowest-index argmax g of
// fl(post_seq[t-1, i] + floor) and its value F
__global__ void __launch_bounds__(256) floor_argmax_kernel(
    const float* __restrict__ post_seq, const int* __restrict__ batch_frames,
    float* __restrict__ floor_val, int* __restrict__ floor_idx, int frames,
    int states, float floor_value) {
  const int lane = threadIdx.x & 31;
  const int t = 1 + static_cast<int>(blockIdx.x) * (blockDim.x >> 5) +
                (threadIdx.x >> 5);
  if (t > top_frame(batch_frames, frames)) return;
  const float* row = post_seq + static_cast<size_t>(t - 1) * states;
  float best = torbi::neg_inf();
  int best_i = INT_MAX;
  for (int i = lane; i < states; i += 32)
    take(best, best_i, row[i] + floor_value, i);
  warp_reduce(best, best_i);
  if (lane == 0) {
    floor_val[t] = best;
    floor_idx[t] = settle(best, best_i);
  }
}

// Phase 1: the table of backpointers. Block (x, y) takes destinations
// [64 x, 64 x + 64) and rows [y kPasses kTileT, ...); row 0 and rows past
// t_top get 0. HAS_FLOOR adds the floor candidate of floor_argmax_kernel;
// without it (a pure -inf band: K6, or K5 on such a band) the in-band
// winner is the answer
template <bool HAS_FLOOR>
__global__ void __launch_bounds__(kGroupsX * kGroupsY) pointers_kernel(
    const float* __restrict__ post_seq, const float* __restrict__ band,
    const int* __restrict__ batch_frames,
    const float* __restrict__ floor_val, const int* __restrict__ floor_idx,
    int16_t* __restrict__ bp, int frames, int states, int lo, int width) {
  extern __shared__ __align__(16) float psmem[];
  float* band_s = psmem;                       // [kChunk][kTileJ]
  float* src_s = psmem + kChunk * kTileJ;      // [kTileT][kSrcStride]
  const int tx = threadIdx.x % kGroupsX;
  const int ty = threadIdx.x / kGroupsX;
  const int nthreads = kGroupsX * kGroupsY;
  const int j0 = static_cast<int>(blockIdx.x) * kTileJ;
  const int t_top = top_frame(batch_frames, frames);
  const int chunks = (width + kChunk - 1) / kChunk;

  auto load_band = [&](int c) {
    for (int e = threadIdx.x; e < kChunk * kTileJ; e += nthreads) {
      const int d = c * kChunk + e / kTileJ;
      const int j = j0 + e % kTileJ;
      band_s[e] = d < width && j < states
                      ? band[static_cast<size_t>(d) * states + j]
                      : torbi::neg_inf();
    }
  };
  if (chunks == 1) load_band(0);

  for (int pass = 0; pass < kPasses; ++pass) {
    const int t0 = (static_cast<int>(blockIdx.y) * kPasses + pass) * kTileT;
    if (t0 >= frames) break;
    float best[kRows][kR];
    int arg[kRows][kR];
#pragma unroll
    for (int q = 0; q < kRows; ++q)
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        best[q][i] = torbi::neg_inf();
        arg[q][i] = 0;
      }
    for (int c = 0; c < chunks; ++c) {
      __syncthreads();
      if (chunks > 1) load_band(c);
      // Source window of each row: src_s[row][k] = post[t - 1][j0 + lo +
      // c kChunk + k], -inf outside the states and the valid rows
      for (int e = threadIdx.x; e < kTileT * kSrcStride; e += nthreads) {
        const int row = e / kSrcStride;
        const int k = e - row * kSrcStride;
        const int t = t0 + row;
        const int s = j0 + lo + c * kChunk + k;
        src_s[e] = t >= 1 && t <= t_top && s >= 0 && s < states
                       ? post_seq[static_cast<size_t>(t - 1) * states + s]
                       : torbi::neg_inf();
      }
      __syncthreads();
      const int dend = min(kChunk, width - c * kChunk);
      // sv[q][0..7]: sources 4 tx + d .. 4 tx + d + 7 of row 4 ty + q
      float sv[kRows][8];
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const float4 x = *reinterpret_cast<const float4*>(
            src_s + (ty * kRows + q) * kSrcStride + tx * kR);
        sv[q][0] = x.x;
        sv[q][1] = x.y;
        sv[q][2] = x.z;
        sv[q][3] = x.w;
      }
      for (int d = 0; d < dend; d += 4) {
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const float4 x = *reinterpret_cast<const float4*>(
              src_s + (ty * kRows + q) * kSrcStride + tx * kR + d + 4);
          sv[q][4] = x.x;
          sv[q][5] = x.y;
          sv[q][6] = x.z;
          sv[q][7] = x.w;
        }
#pragma unroll
        for (int dd = 0; dd < 4; ++dd) {
          const float4 b = *reinterpret_cast<const float4*>(
              band_s + (d + dd) * kTileJ + tx * kR);
          const float bv[kR] = {b.x, b.y, b.z, b.w};
          const int off = c * kChunk + d + dd;
          // Offsets rise: only a strictly greater value replaces
#pragma unroll
          for (int q = 0; q < kRows; ++q)
#pragma unroll
            for (int i = 0; i < kR; ++i) {
              const float v = sv[q][i + dd] + bv[i];
              if (v > best[q][i]) {
                best[q][i] = v;
                arg[q][i] = off;
              }
            }
        }
#pragma unroll
        for (int q = 0; q < kRows; ++q)
#pragma unroll
          for (int m = 0; m < 4; ++m) sv[q][m] = sv[q][m + 4];
      }
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int t = t0 + ty * kRows + q;
      if (t >= frames) continue;
      const bool live = t >= 1 && t <= t_top;
      float fv = torbi::neg_inf();
      int fi = 0;
      if (HAS_FLOOR && live) {
        fv = floor_val[t];
        fi = floor_idx[t];
      }
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int j = j0 + tx * kR + i;
        if (j >= states) continue;
        const float m = best[q][i];
        const int inside = j + lo + arg[q][i];
        int index = inside;
        if constexpr (HAS_FLOOR) {
          if (m < fv) index = fi;
          else if (m == fv) index = min(inside, fi);
        }
        if (!live || fmaxf(m, fv) == torbi::neg_inf()) index = 0;
        bp[static_cast<size_t>(t) * states + j] = static_cast<int16_t>(index);
      }
    }
  }
}

// Phase 2, per block k of B frames (rows [k B + 1, min((k + 1) B, t_top)]
// of bp): every state at the block's top chased to its bottom
__global__ void __launch_bounds__(kChaseThreads) chase_blocks_kernel(
    const int16_t* __restrict__ bp, const int* __restrict__ batch_frames,
    int16_t* __restrict__ ends, int frames, int states, int block) {
  extern __shared__ __align__(16) int16_t rows[];  // [B][states]
  const int t_top = top_frame(batch_frames, frames);
  const int t_lo = static_cast<int>(blockIdx.x) * block + 1;
  const int t_hi = min(t_lo + block - 1, t_top);
  if (t_lo > t_hi) return;
  const int n = (t_hi - t_lo + 1) * states;
  const int16_t* src = bp + static_cast<size_t>(t_lo) * states;
  for (int e = threadIdx.x; e < n; e += blockDim.x) rows[e] = src[e];
  __syncthreads();
  int x[kMaxChains];
#pragma unroll
  for (int c = 0; c < kMaxChains; ++c) x[c] = threadIdx.x + c * blockDim.x;
  for (int t = t_hi; t >= t_lo; --t) {
    const int16_t* row = rows + (t - t_lo) * states;
#pragma unroll
    for (int c = 0; c < kMaxChains; ++c)
      if (threadIdx.x + c * blockDim.x < states) x[c] = row[x[c]];
  }
  int16_t* end = ends + static_cast<size_t>(blockIdx.x) * states;
#pragma unroll
  for (int c = 0; c < kMaxChains; ++c) {
    const int s = threadIdx.x + c * blockDim.x;
    if (s < states) end[s] = static_cast<int16_t>(x[c]);
  }
}

// Phase 2, one warp: the seed, the positions from t_top on, and the state
// at each block's top, chased down the blocks' end tables
__global__ void __launch_bounds__(32) chase_bounds_kernel(
    const float* __restrict__ posterior, const int* __restrict__ batch_frames,
    const int16_t* __restrict__ ends, int* __restrict__ tops,
    int* __restrict__ out, int frames, int states, int block) {
  const int lane = threadIdx.x;
  float best = torbi::neg_inf();
  int best_i = INT_MAX;
  for (int i = lane; i < states; i += 32) take(best, best_i, posterior[i], i);
  warp_reduce(best, best_i);
  const int seed = settle(best, best_i);
  const int t_top = top_frame(batch_frames, frames);
  for (int p = max(t_top, 0) + lane; p < frames; p += 32) out[p] = seed;
  if (lane == 0 && t_top >= 1) {
    int x = seed;
    for (int k = (t_top - 1) / block; k >= 0; --k) {
      tops[k] = x;
      x = ends[static_cast<size_t>(k) * states + x];
    }
  }
}

// Phase 2, per block: walk from its top state and write its frames
__global__ void __launch_bounds__(32) chase_write_kernel(
    const int16_t* __restrict__ bp, const int* __restrict__ batch_frames,
    const int* __restrict__ tops, int* __restrict__ out, int frames,
    int states, int block) {
  const int t_top = top_frame(batch_frames, frames);
  const int t_lo = static_cast<int>(blockIdx.x) * block + 1;
  const int t_hi = min(t_lo + block - 1, t_top);
  if (threadIdx.x != 0 || t_lo > t_hi) return;
  int x = tops[blockIdx.x];
  for (int t = t_hi; t >= t_lo; --t) {
    x = bp[static_cast<size_t>(t) * states + x];
    out[t - 1] = x;
  }
}

// Phase 1 at one shape: the table's grid and shared memory
template <bool HAS_FLOOR>
int launch_pointers(const float* post_seq, const float* band,
                    const int* batch_frames, const float* floor_val,
                    const int* floor_idx, int16_t* bp, int frames, int states,
                    int lo, int width, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(kChunk) * kTileJ + kTileT * kSrcStride) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      pointers_kernel<HAS_FLOOR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((states + kTileJ - 1) / kTileJ,
                  (frames + kPasses * kTileT - 1) / (kPasses * kTileT));
  pointers_kernel<HAS_FLOOR><<<grid, kGroupsX * kGroupsY, smem, stream>>>(
      post_seq, band, batch_frames, floor_val, floor_idx, bp, frames, states,
      lo, width);
  return cudaGetLastError();
}

}  // namespace

// Phase 1 of K5. post_seq: (1, frames, states) float32; band: (width,
// states) float32 with band[d, j] = transition[j, j + d + lo];
// batch_frames: (1,) int32; floor_val, floor_idx: (frames,) float32 and
// int32 scratch (read only with has_floor); bp: (frames, states) int16,
// the table. Returns a cudaError_t code.
extern "C" int backtrace_pointers(const float* post_seq, const float* band,
                                  const int* batch_frames, float* floor_val,
                                  int* floor_idx, int16_t* bp, int frames,
                                  int states, int lo, int width,
                                  float floor_value, int has_floor,
                                  void* stream) {
  if (frames <= 0 || states <= 0 || states > 32768 || width < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (has_floor && frames > 1) {
    floor_argmax_kernel<<<(frames - 1 + 7) / 8, 256, 0, s>>>(
        post_seq, batch_frames, floor_val, floor_idx, frames, states,
        floor_value);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return has_floor
             ? launch_pointers<true>(post_seq, band, batch_frames, floor_val,
                                     floor_idx, bp, frames, states, lo, width,
                                     s)
             : launch_pointers<false>(post_seq, band, batch_frames, floor_val,
                                      floor_idx, bp, frames, states, lo,
                                      width, s);
}

// Phase 2 of K5. bp: (frames, states) int16 from backtrace_pointers;
// posterior: (states,) float32 (a row of the final posterior); ends:
// (blocks, states) int16 and tops: (blocks,) int32 scratch, blocks =
// ceil((frames - 1) / block); out: (frames,) int32, the path. `block`
// rows of bp must fit the card's opt-in shared memory. Returns a
// cudaError_t code.
extern "C" int chase_pointers(const int16_t* bp, const float* posterior,
                              const int* batch_frames, int16_t* ends,
                              int* tops, int* out, int frames, int states,
                              int block, void* stream) {
  if (frames <= 0 || states <= 0 || block < 1 ||
      states > kChaseThreads * kMaxChains)
    return cudaErrorInvalidValue;
  size_t optin = 0;
  cudaError_t err = torbi::optin_smem(&optin);
  if (err != cudaSuccess) return err;
  const size_t smem = static_cast<size_t>(block) * states * sizeof(int16_t);
  if (smem > optin) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (frames - 1 + block - 1) / block;
  if (blocks > 0) {
    err = cudaFuncSetAttribute(chase_blocks_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    chase_blocks_kernel<<<blocks, kChaseThreads, smem, s>>>(
        bp, batch_frames, ends, frames, states, block);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  chase_bounds_kernel<<<1, 32, 0, s>>>(posterior, batch_frames, ends, tops,
                                       out, frames, states, block);
  err = cudaGetLastError();
  if (err != cudaSuccess || blocks == 0) return err;
  chase_write_kernel<<<blocks, 32, 0, s>>>(bp, batch_frames, tops, out,
                                           frames, states, block);
  return cudaGetLastError();
}

// Phase 1 of K6: backtrace_pointers on a pure -inf band, which launches no
// floor pass. post_seq: (1, frames, states) float32; band: (width, states)
// float32 with band[d, j] = transition[j, j + d + lo] and -inf outside the
// band; batch_frames: (1,) int32; bp: (frames, states) int16, the table.
// Returns a cudaError_t code.
extern "C" int backtrace_window(const float* post_seq, const float* band,
                                const int* batch_frames, int16_t* bp,
                                int frames, int states, int lo, int width,
                                void* stream) {
  if (frames <= 0 || states <= 0 || states > 32768 || width < 1)
    return cudaErrorInvalidValue;
  return launch_pointers<false>(post_seq, band, batch_frames, nullptr,
                                nullptr, bp, frames, states, lo, width,
                                static_cast<cudaStream_t>(stream));
}
