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
// Bound: a chain of T-1 dependent frames of two adds each (8 clocks a
// frame at the FP32 add's 4-clock latency), per sequence; the bytes
// (maxima in, ms out) are negligible, so the kernel is latency: the chain,
// plus the first tile's load and the last tile's write-out.
// Design: the chain is split at L = min(batch_frames[b], T): frames below
// L run the two adds and nothing else (no select on the chain); from L on
// the carry is frozen and every gm is the one constant g + floor, written
// four at a time. One chain warp holds a lane per sequence (`sequences` a
// CTA, chosen by the plan ops/constant.py::recurrence_plan so that a small
// batch spreads over every SM) and three copy warps move the tiles: each
// tile of `tile` frames of each sequence's maxima comes into a ring of
// kStages slots in shared memory by cp.async (16-byte copies where the
// row's tile starts on 16 bytes, 4-byte ones elsewhere), the chain writes
// each gm over the maximum it read, and the copy warps write the finished
// slot out (16-byte stores on 16-byte boundaries of ms, whose rows are
// one frame shorter) and refill it with the tile kStages ahead. Chain and
// copy warps meet only at named barriers per slot (full, empty), so the
// chain never waits on a write-out; it reads 16 maxima a step with
// 16-byte shared loads into one of two register sets, the next 16 already
// loaded into the other.
#include "persistent.cuh"

namespace {

constexpr int kStages = 4;       // ring slots per sequence
constexpr int kCopyWarps = 3;
constexpr int kCopyThreads = 32 * kCopyWarps;
constexpr int kThreads = 32 + kCopyThreads;
constexpr int kGroup = 16;       // frames a chain step loads and stores
// Named barriers (0 is __syncthreads): slot s full, slot s empty, copy
// warps among themselves
constexpr int kFull = 1, kEmpty = 1 + kStages, kCopy = 1 + 2 * kStages;

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void load16(float (&m)[kGroup], const float* p) {
#pragma unroll
  for (int u = 0; u < kGroup; u += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + u);
    m[u] = v.x;
    m[u + 1] = v.y;
    m[u + 2] = v.z;
    m[u + 3] = v.w;
  }
}

__device__ __forceinline__ void store16(float* p, const float (&m)[kGroup]) {
#pragma unroll
  for (int u = 0; u < kGroup; u += 4)
    *reinterpret_cast<float4*>(p + u) =
        make_float4(m[u], m[u + 1], m[u + 2], m[u + 3]);
}

// 16 frames of the chain: each maximum m[u] in, its gm out in its place
__device__ __forceinline__ void step16(float (&m)[kGroup], float& g,
                                       float floor_value) {
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const float gm = g + floor_value;
    g = m[u] + gm;
    m[u] = gm;
  }
}

// The chain warp: lane q carries sequence b0 + q through every tile
__device__ void chain(const float* __restrict__ g0,
                      const int* __restrict__ batch_frames, float floor_value,
                      float* ring, int stride, int tile, int tiles, int frames,
                      int b0, int nseq) {
  const int lane = threadIdx.x;
  const bool active = lane < nseq;
  float g = 0.f;
  int last = 0;
  if (active) {
    g = g0[b0 + lane];
    last = min(batch_frames[b0 + lane], frames);
  }
  for (int k = 0; k < tiles; ++k) {
    const int s = k % kStages;
    bar_sync(kFull + s, kThreads);
    if (active) {
      const int t0 = k * tile, t1 = min(t0 + tile, frames);
      // slot[t] holds frame t's maximum, then its gm (ms[b, t-1])
      float* slot = ring + lane * stride + s * tile - t0;
      const int lo = max(t0, 1), hi = max(lo, min(t1, last));
      int t = lo;
      // The chain, frames lo .. hi: to a 16-frame boundary one at a time,
      // then 16 at a time, then the rest
      for (const int head = min(hi, (lo + kGroup - 1) / kGroup * kGroup);
           t < head; ++t) {
        const float m = slot[t];
        const float gm = g + floor_value;
        slot[t] = gm;
        g = m + gm;
      }
      if (t + kGroup <= hi) {
        // Two register sets in turn, so that no step copies registers:
        // while one set's adds run, the other's maxima load
        float x[kGroup], y[kGroup];
        load16(x, slot + t);
        for (; t + 2 * kGroup <= hi; t += 2 * kGroup) {
          load16(y, slot + t + kGroup);
          step16(x, g, floor_value);
          store16(slot + t, x);
          load16(x, slot + (t + 3 * kGroup <= hi ? t + 2 * kGroup : t));
          step16(y, g, floor_value);
          store16(slot + t + kGroup, y);
        }
        if (t + kGroup <= hi) {
          step16(x, g, floor_value);
          store16(slot + t, x);
          t += kGroup;
        }
      }
      for (; t < hi; ++t) {
        const float m = slot[t];
        const float gm = g + floor_value;
        slot[t] = gm;
        g = m + gm;
      }
      // Frozen from hi on (hi = max(lo, last) when last <= t1): one gm
      const float c = g + floor_value;
      for (; t < t1 && t % 4 != 0; ++t) slot[t] = c;
      for (; t + 4 <= t1; t += 4)
        *reinterpret_cast<float4*>(slot + t) = make_float4(c, c, c, c);
      for (; t < t1; ++t) slot[t] = c;
    }
    __syncwarp();
    bar_arrive(kEmpty + s, kThreads);
  }
}

// The copy warps: tiles in ahead of the chain, finished tiles out
__device__ void copy(const float* __restrict__ maxima, float* __restrict__ ms,
                     float* ring, int stride, int tile, int tiles, int frames,
                     int b0, int nseq) {
  const int ct = threadIdx.x - 32;
  const bool vec_in = reinterpret_cast<size_t>(maxima) % 16 == 0;
  const bool vec_out = reinterpret_cast<size_t>(ms) % 16 == 0;
  const int chunks = tile / 4;

  // Tile k of every sequence into its slot
  auto load = [&](int k) {
    const int t0 = k * tile, count = min(tile, frames - t0);
    float* slot = ring + (k % kStages) * tile;
    for (int e = ct; e < nseq * chunks; e += kCopyThreads) {
      const int q = e / chunks, c = 4 * (e % chunks);
      if (c >= count) continue;
      const long long g = static_cast<long long>(b0 + q) * frames + t0 + c;
      float* d = slot + q * stride + c;
      if (vec_in && g % 4 == 0 && c + 4 <= count) {
        torbi::cp_async16(d, maxima + g);
      } else {
        for (int j = 0; j < 4 && c + j < count; ++j)
          torbi::cp_async4(d + j, maxima + g + j);
      }
    }
  };
  // Frames max(t0, 1) .. t1 of tile k out to ms, where frame t is element
  // (b0 + q) * (frames - 1) + t - 1: in 16-byte chunks of ms
  auto write = [&](int k) {
    const int t0 = k * tile, t1 = min(t0 + tile, frames), lo = max(t0, 1);
    if (lo >= t1) return;
    const float* slot = ring + (k % kStages) * tile - t0;
    const int per_row = (t1 - lo + 3) / 4 + 1;
    for (int e = ct; e < nseq * per_row; e += kCopyThreads) {
      const int q = e / per_row;
      // Element base + t holds frame t
      const long long base = static_cast<long long>(b0 + q) * (frames - 1) - 1;
      const long long first = base + lo, end = base + t1;
      const long long c = (first & ~3LL) + 4LL * (e % per_row);
      if (c >= end) continue;
      const float* src = slot + q * stride;
      if (vec_out && c >= first && c + 4 <= end) {
        const int t = static_cast<int>(c - base);
        *reinterpret_cast<float4*>(ms + c) =
            make_float4(src[t], src[t + 1], src[t + 2], src[t + 3]);
      } else {
        for (long long i = c > first ? c : first; i < c + 4 && i < end; ++i)
          ms[i] = src[i - base];
      }
    }
  };

  // The first kStages tiles, each signalled full as it lands
  const int ahead = min(kStages, tiles);
  for (int k = 0; k < ahead; ++k) {
    load(k);
    torbi::cp_async_commit();
  }
  for (int k = 0; k < ahead; ++k) {
    __syncwarp();
    switch (ahead - 1 - k) {
      case 3: torbi::cp_async_wait<3>(); break;
      case 2: torbi::cp_async_wait<2>(); break;
      case 1: torbi::cp_async_wait<1>(); break;
      default: torbi::cp_async_wait<0>(); break;
    }
    bar_arrive(kFull + k, kThreads);
  }
  // Then: wait for the chain to finish tile k, write it out, refill its
  // slot with tile k + kStages, and signal the refill of the step before
  // once it has landed
  int pending = -1;
  for (int k = 0; k < tiles; ++k) {
    __syncwarp();
    bar_sync(kEmpty + k % kStages, kThreads);
    write(k);
    const bool refill = k + kStages < tiles;
    if (refill) {
      __syncwarp();
      bar_sync(kCopy, kCopyThreads);  // every copy thread has read the slot
      load(k + kStages);
    }
    torbi::cp_async_commit();
    if (pending >= 0) {
      torbi::cp_async_wait<1>();
      __syncwarp();
      bar_arrive(kFull + pending % kStages, kThreads);
    }
    pending = refill ? k + kStages : -1;
  }
  torbi::cp_async_wait_all();
}

__global__ void __launch_bounds__(kThreads) constant_kernel(
    const float* __restrict__ maxima, const float* __restrict__ g0,
    const int* __restrict__ batch_frames, float floor_value,
    float* __restrict__ ms, int batch, int frames, int sequences, int tile) {
  extern __shared__ __align__(16) float ring[];  // [sequence][slot][frame]
  const int stride = kStages * tile + 4;
  const int b0 = blockIdx.x * sequences;
  const int nseq = min(sequences, batch - b0);
  const int tiles = (frames + tile - 1) / tile;
  if (threadIdx.x < 32)
    chain(g0, batch_frames, floor_value, ring, stride, tile, tiles, frames,
          b0, nseq);
  else
    copy(maxima, ms, ring, stride, tile, tiles, frames, b0, nseq);
}

}  // namespace

// maxima: (batch, frames) float32, the maximum of each observation frame;
// g0: (batch,) float32, the maximum of each first posterior; batch_frames:
// (batch,) int32; ms: (batch, frames - 1) float32, the carry m_t of frames
// 1 .. frames-1. frames >= 2. The launch plan
// (ops/constant.py::recurrence_plan): `sequences` per CTA (1-32), frames
// a `tile` (a multiple of 16). Returns a cudaError_t code.
extern "C" int constant_recurrence(const float* maxima, const float* g0,
                                   const int* batch_frames, float floor_value,
                                   float* ms, int batch, int frames,
                                   int sequences, int tile, void* stream) {
  if (batch <= 0 || frames < 2 || sequences < 1 || sequences > 32 ||
      tile < kGroup || tile % kGroup != 0)
    return cudaErrorInvalidValue;
  const int smem = sequences * (kStages * tile + 4) * sizeof(float);
  static int allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t code = cudaFuncSetAttribute(
        constant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (code != cudaSuccess) return code;
    allowed = smem;
  }
  const int blocks = (batch + sequences - 1) / sequences;
  constant_kernel<<<blocks, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      maxima, g0, batch_frames, floor_value, ms, batch, frames, sequences,
      tile);
  return cudaGetLastError();
}
