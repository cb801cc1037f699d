// K7: the scalar recurrence of the constant-transition closed form.
//
// Has no Pallas counterpart: it replaces the short scan inside the closed
// form of torbi_tpu/ops/dispatch.py (the pipeline of its constant branch,
// :340-360), which XLA runs as one device program. On a constant
// transition (every candidate is `floor`, such as the uniform default)
// the forward pass collapses to one scalar carry per sequence:
//
//   g = g0[b]                       (the maximum of the first posterior)
//   for t = 1 .. T-1:
//     gm = g + floor;  ms[b, t-1] = gm
//     if (t < batch_frames[b]) g = maxima[b, t] + gm
//
// where maxima[b, t] is the maximum of the observation's frame t. The
// reductions around it (the maxima, the argmax passes) stay torch ops, as
// torbi_tpu computes them in XLA outside any kernel
// (torbi_tpu_torch/ops/constant.py). The two fp32 adds are those of the
// plain version's loop, in the same order on the same values, so the
// result is bitwise its. There is no multiply, so FMA contraction cannot
// change a value.
//
// Bound: a chain of T-1 dependent frames of two adds each (about 8 clocks
// a frame), per sequence; the bytes (maxima in, ms out) are negligible.
// Design: one thread per sequence, 32 sequences per CTA. The CTA stages
// its sequences' maxima in tiles of kTile frames with cp.async, one tile
// ahead, so the chain waits on adds and not on loads; each chain thread
// reads kChunk maxima into registers, then writes each gm over its
// maximum, and the CTA then writes the tile out; both moves of a tile are
// coalesced along the frames.
#include "cluster.cuh"
#include "common.cuh"

namespace {

constexpr int kSeq = 32;        // sequences per CTA, one chain thread each
constexpr int kTile = 128;      // frames per staged tile
constexpr int kRow = kTile + 1; // padded row: chain threads hit 32 banks
constexpr int kThreads = 128;
constexpr int kChunk = 16;      // frames a chain thread loads at once

__global__ void __launch_bounds__(kThreads) constant_kernel(
    const float* __restrict__ maxima, const float* __restrict__ g0,
    const int* __restrict__ batch_frames, float floor_value,
    float* __restrict__ ms, int batch, int frames) {
  __shared__ float tile[2][kSeq * kRow];
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kSeq;
  const int nseq = min(kSeq, batch - b0);
  const int tiles = (frames + kTile - 1) / kTile;

  auto load = [&](int k) {
    if (k < tiles) {
      const int t0 = k * kTile;
      float* buf = tile[k & 1];
      for (int e = tid; e < nseq * kTile; e += kThreads) {
        const int s = e / kTile, j = e % kTile;
        if (t0 + j < frames)
          torbi::cp_async4(
              buf + s * kRow + j,
              maxima + static_cast<size_t>(b0 + s) * frames + t0 + j);
      }
    }
    torbi::cp_async_commit();
  };

  float g = 0.f;
  int last = 0;
  if (tid < nseq) {
    g = g0[b0 + tid];
    last = batch_frames[b0 + tid];
  }
  load(0);
  for (int k = 0; k < tiles; ++k) {
    load(k + 1);
    torbi::cp_async_wait<1>();
    __syncthreads();
    const int t0 = k * kTile;
    const int count = min(kTile, frames - t0);
    float* buf = tile[k & 1];
    if (tid < nseq) {
      float* row = buf + tid * kRow;
      int j = t0 == 0 ? 1 : 0;
      // kChunk maxima into registers before the chunk's stores, so that
      // their loads are not ordered behind the chain
      for (; j + kChunk <= count; j += kChunk) {
        float m[kChunk];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) m[u] = row[j + u];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const float gm = g + floor_value;
          row[j + u] = gm;  // the slot of frame t now holds ms[b, t-1]
          g = t0 + j + u < last ? m[u] + gm : g;
        }
      }
      for (; j < count; ++j) {
        const float gm = g + floor_value;
        const float m = row[j];
        row[j] = gm;
        g = t0 + j < last ? m + gm : g;
      }
    }
    __syncthreads();
    for (int e = tid; e < nseq * kTile; e += kThreads) {
      const int s = e / kTile, j = e % kTile;
      const int t = t0 + j;
      if (t >= 1 && t < frames)
        ms[static_cast<size_t>(b0 + s) * (frames - 1) + t - 1] =
            buf[s * kRow + j];
    }
    // The next iteration's load refills the other buffer; the one after
    // refills this one, which every thread has written out by then
    __syncthreads();
  }
  torbi::cp_async_wait_all();
}

}  // namespace

// maxima: (batch, frames) float32, the maximum of each observation frame;
// g0: (batch,) float32, the maximum of each first posterior; batch_frames:
// (batch,) int32; ms: (batch, frames - 1) float32, the carry m_t of frames
// 1 .. frames-1. frames >= 2. Returns a cudaError_t code.
extern "C" int constant_recurrence(const float* maxima, const float* g0,
                                   const int* batch_frames, float floor_value,
                                   float* ms, int batch, int frames,
                                   void* stream) {
  if (batch <= 0 || frames < 2) return cudaErrorInvalidValue;
  const int blocks = (batch + kSeq - 1) / kSeq;
  constant_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      maxima, g0, batch_frames, floor_value, ms, batch, frames);
  return cudaGetLastError();
}
