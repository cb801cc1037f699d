// Forward lab, `mxushift` and `hybrid:K`: `full`'s function with the state
// shifts done on the tensor cores.
//
// Replaces the TPU lab function scripts/kernel_lab.py::build_kernel_mxushift,
// which shifts the posterior by one-hot matmuls on the MXU instead of lane
// rotates on the permute unit. Its Hopper counterpart: `full`'s shifted
// shared-memory load (csrc/lab_forward.cuh) becomes mma.sync.m16n8k16 (bf16
// in, fp32 out) against one-hot B fragments. The function is `full`'s, for
// every sequence b:
//   post = obs[b, 0]
//   post'[j] = obs[b, t, j] + max_d post[(j + lo + d) mod S] + band[d, j]
// with lo = -(width / 2), d in [0, width), S a multiple of 128.
//
// Exactness. A posterior value x splits into three bf16 parts, hi = bf16(x),
// mid = bf16(x - hi), lo = bf16(x - hi - mid) (round to nearest even), and
// (hi + mid) + lo == x in fp32 (torbi_tpu_torch/scripts/kernel_lab.py::
// split_bf16x3, pinned by a CPU test). Each part goes through its own mma
// with a zero C: B is one-hot, so every output is one exact product (a part
// times 1.0) plus exact zeros. The parts are added on the CUDA cores, in that
// order; a destination whose source lies in the next 16-state block takes
// its value from that block's mma and +0 from this one's. The lab's inputs
// are finite, so no part is inf or NaN (0 x inf never occurs). So every
// candidate is bitwise `full`'s and fmaxf does not depend on order.
//
// Design. A cluster of 4 CTAs holds 16 sequences, the mma's 16 rows (rows
// past the batch hold 0); every CTA keeps all 16 posteriors in fp32 in its
// shared memory, double-buffered, rows padded by 8 words so that a fragment
// load is free of bank conflicts, computes a quarter of the destinations
// and stores each new value into the next buffer of all 4 CTAs (distributed
// shared memory), one cluster barrier per frame: a batch of 512 so fills
// 128 of the 132 SMs. A warp owns 8-destination tiles j0 .. j0 + 7 and
// walks the offsets d in
// order: the sources (j0 + lo + d + n) mod S lie in the aligned 16-state
// block kb at k = r + n, and past it (r > 8) in the next block. The A
// fragments of the two blocks (split into hi/mid/lo in registers as they
// load) change every 16 offsets; the one-hot B fragments (k == r + n) are
// built from the lane index and the shift. So an offset costs 3 mmas, or 6
// when its sources straddle two blocks (7 of every 16 residues). `hybrid:K`
// gives the tensor cores the offsets of K lane-residue classes (the JAX
// lab's rule, kernel_lab.py::mxu_residues, as per-offset flags); the others
// take `full`'s shifted load from shared memory. n_acc accumulators per
// destination set the fmaxf chains' length.
//
// Bound on the H100 at 512 x 512 x 1536, width 175: `full`'s, two FP32
// instructions per candidate ~4.2 ms (and a shared-memory word per
// candidate ~8.4 ms, which this kernel trades for mmas). The tensor-core
// work, about 4.3 mmas of 4,096 flops per 128 candidates (2.37e9 mmas), is
// ~9.8 ms at the 989 TFLOP/s bf16 peak of all 132 SMs
// (kernel_lab.py::mxu_mma_count counts it exactly).
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 16;       // sequences per cluster: the mma's M
constexpr int kCluster = 4;     // CTAs per cluster, each a quarter of S
constexpr int kRowPad = 8;      // words of padding per posterior row
constexpr int kMaxThreads = 512;
constexpr uint32_t kOne = 0x3F80u;  // bf16 1.0

struct Args {
  const float* obs;
  const float* band;
  const uint8_t* mxu;  // per offset: 1 on the tensor cores, 0 shifted load
  float* out;
  int batch, frames, states, width, lo, pitch;
};

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat16 v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(v));
}

// The three bf16 parts of two fp32 values, packed as an mma operand register
// each (the lower index in the lower half)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t (&p)[3]) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0);
  const __nv_bfloat16 h1 = __float2bfloat16_rn(x1);
  const float r0 = x0 - __bfloat162float(h0);
  const float r1 = x1 - __bfloat162float(h1);
  const __nv_bfloat16 m0 = __float2bfloat16_rn(r0);
  const __nv_bfloat16 m1 = __float2bfloat16_rn(r1);
  const __nv_bfloat16 l0 = __float2bfloat16_rn(r0 - __bfloat162float(m0));
  const __nv_bfloat16 l1 = __float2bfloat16_rn(r1 - __bfloat162float(m1));
  p[0] = bf16_bits(h0) | (bf16_bits(h1) << 16);
  p[1] = bf16_bits(m0) | (bf16_bits(m1) << 16);
  p[2] = bf16_bits(l0) | (bf16_bits(l1) << 16);
}

// A fragments (m16 x k16, row-major) of the 16-state block at kb, for the
// three parts: a[part][0..3] hold (row g, k 2t..2t+1), (row g + 8, k
// 2t..2t+1), (row g, k 2t+8..2t+9), (row g + 8, k 2t+8..2t+9)
__device__ __forceinline__ void load_block(const float* pc, int kb, int pitch,
                                           int g, int t,
                                           uint32_t (&a)[3][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int row = g + 8 * (q & 1);
    const int col = kb + 2 * t + 8 * (q >> 1);
    const float2 x = *reinterpret_cast<const float2*>(pc + row * pitch + col);
    uint32_t p[3];
    split2(x.x, x.y, p);
#pragma unroll
    for (int part = 0; part < 3; ++part) a[part][q] = p[part];
  }
}

// One-hot B fragment (k16 x n8, column-major) with B[k][n] = 1 iff k ==
// shift + n: b[0] holds (k 2t..2t+1, n g), b[1] (k 2t+8..2t+9, n g)
__device__ __forceinline__ void one_hot(int shift, int g, int t,
                                        uint32_t (&b)[2]) {
  const int k = shift + g;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k0 = 2 * t + 8 * h;
    b[h] = (k == k0 ? kOne : 0u) | (k == k0 + 1 ? kOne << 16 : 0u);
  }
}

__device__ __forceinline__ void mma(const uint32_t (&a)[4],
                                    const uint32_t (&b)[2], float (&d)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// The shifted posterior values of one block: (hi + mid) + lo per element
__device__ __forceinline__ void shifted(const uint32_t (&a)[3][4],
                                        const uint32_t (&b)[2],
                                        float (&v)[4]) {
  float hi[4], mid[4], lo[4];
  mma(a[0], b, hi);
  mma(a[1], b, mid);
  mma(a[2], b, lo);
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = (hi[e] + mid[e]) + lo[e];
}

template <int NACC, bool ALL_MXU>
__global__ void __launch_bounds__(kMaxThreads) lab_mxu_kernel(Args a) {
  extern __shared__ float smem[];  // [2][kRows][pitch]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int S = a.states;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b0 = blockIdx.x / kCluster * kRows;
  // This CTA's destinations: a quarter of the states (a multiple of 32)
  const int j_begin = rank * (S / kCluster);
  const int j_end = j_begin + S / kCluster;
  float* copies[kCluster];
#pragma unroll
  for (int c = 0; c < kCluster; ++c)
    copies[c] = cluster.map_shared_rank(smem, c);
  const size_t seq = static_cast<size_t>(a.frames) * S;
  const int lo_mod = ((a.lo % S) + S) % S;

  // Frame 0: post = obs[b, 0]; rows past the batch hold 0
  for (int e = threadIdx.x; e < kRows * S; e += blockDim.x) {
    const int row = e / S, j = e - row * S;
    smem[row * a.pitch + j] =
        b0 + row < a.batch ? a.obs[(b0 + row) * seq + j] : 0.f;
  }
  // Every CTA of the cluster runs, and has its frame 0, before any remote
  // store
  cluster.sync();

  // This thread's two sequences (rows g and g + 8 of the mma)
  const bool live0 = b0 + g < a.batch;
  const bool live1 = b0 + g + 8 < a.batch;
  const float* obs0 = a.obs + (b0 + g) * seq;
  const float* obs1 = a.obs + (b0 + g + 8) * seq;

  for (int f = 1; f < a.frames; ++f) {
    const float* pc = smem + ((f - 1) & 1) * kRows * a.pitch;
    const int next = (f & 1) * kRows * a.pitch;
    for (int j0 = j_begin + warp * 8; j0 < j_end; j0 += nwarps * 8) {
      float acc[NACC][4];
#pragma unroll
      for (int s = 0; s < NACC; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[s][e] = torbi::neg_inf();
      uint32_t cur[3][4], nxt[3][4];
      int kb_cur = -1;
      int base = j0 + lo_mod;  // (j0 + lo + d) mod S
      if (base >= S) base -= S;
      const int col = j0 + 2 * t;
      // Offset d into accumulator `slot` (a register array: the caller
      // unrolls over the slots)
      auto candidate = [&](int d, float (&slot)[4]) {
        const float2 bv = __ldg(reinterpret_cast<const float2*>(
            a.band + static_cast<size_t>(d) * S + col));
        float v[4];
        if (ALL_MXU || __ldg(a.mxu + d)) {
          const int kb = base & ~15;
          const int r = base & 15;
          if (kb != kb_cur) {
            int kb_next = kb + 16;
            if (kb_next >= S) kb_next -= S;
            if (kb_cur >= 0 && kb == (kb_cur + 16 >= S ? kb_cur + 16 - S
                                                        : kb_cur + 16)) {
#pragma unroll
              for (int part = 0; part < 3; ++part)
#pragma unroll
                for (int q = 0; q < 4; ++q) cur[part][q] = nxt[part][q];
            } else {
              load_block(pc, kb, a.pitch, g, t, cur);
            }
            load_block(pc, kb_next, a.pitch, g, t, nxt);
            kb_cur = kb;
          }
          uint32_t b[2];
          one_hot(r, g, t, b);
          shifted(cur, b, v);
          if (r > 8) {
            float v2[4];
            one_hot(r - 16, g, t, b);
            shifted(nxt, b, v2);
#pragma unroll
            for (int e = 0; e < 4; ++e) v[e] += v2[e];
          }
        } else {
          // full's shifted load: sources (col + e + lo + d) mod S
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            int src = base + 2 * t + e;
            if (src >= S) src -= S;
            v[e] = pc[g * a.pitch + src];
            v[e + 2] = pc[(g + 8) * a.pitch + src];
          }
        }
        slot[0] = fmaxf(slot[0], v[0] + bv.x);
        slot[1] = fmaxf(slot[1], v[1] + bv.y);
        slot[2] = fmaxf(slot[2], v[2] + bv.x);
        slot[3] = fmaxf(slot[3], v[3] + bv.y);
        if (++base == S) base = 0;
      };
      // NACC offsets per step with no guard, so that their loads can be in
      // flight together; the remainder into the first accumulator
      int d = 0;
      for (; d + NACC <= a.width; d += NACC) {
#pragma unroll
        for (int s = 0; s < NACC; ++s) candidate(d + s, acc[s]);
      }
      for (; d < a.width; ++d) candidate(d, acc[0]);
      float m[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        m[e] = acc[0][e];
#pragma unroll
        for (int s = 1; s < NACC; ++s) m[e] = fmaxf(m[e], acc[s][e]);
      }
      const size_t row = static_cast<size_t>(f) * S + col;
      const float2 o0 = live0 ? *reinterpret_cast<const float2*>(obs0 + row)
                              : make_float2(0.f, 0.f);
      const float2 o1 = live1 ? *reinterpret_cast<const float2*>(obs1 + row)
                              : make_float2(0.f, 0.f);
      const float2 v0 = make_float2(o0.x + m[0], o0.y + m[1]);
      const float2 v1 = make_float2(o1.x + m[2], o1.y + m[3]);
#pragma unroll
      for (int c = 0; c < kCluster; ++c) {
        float* pn = copies[c] + next;
        *reinterpret_cast<float2*>(pn + g * a.pitch + col) = v0;
        *reinterpret_cast<float2*>(pn + (g + 8) * a.pitch + col) = v1;
      }
    }
    // The frame's stores have landed in every copy, and no CTA reads the
    // buffer the next frame overwrites
    cluster.sync();
  }

  const float* last = smem + ((a.frames - 1) & 1) * kRows * a.pitch;
  const int quarter = S / kCluster;
  for (int e = threadIdx.x; e < kRows * quarter; e += blockDim.x) {
    const int row = e / quarter, j = j_begin + e - row * quarter;
    if (b0 + row < a.batch)
      a.out[static_cast<size_t>(b0 + row) * S + j] = last[row * a.pitch + j];
  }
}

template <int NACC, bool ALL_MXU>
int launch(const Args& a, cudaStream_t stream) {
  void (*kernel)(Args) = lab_mxu_kernel<NACC, ALL_MXU>;
  const size_t smem = 2 * static_cast<size_t>(kRows) * a.pitch * sizeof(float);
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
  // One warp per 8-destination tile of the CTA's quarter, at most 16 warps
  const int tiles = a.states / kCluster / 8;
  const int warps = tiles < kMaxThreads / 32 ? tiles : kMaxThreads / 32;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = kCluster;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((a.batch + kRows - 1) / kRows * kCluster);
  config.blockDim = dim3(32 * warps);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attribute;
  config.numAttrs = 1;
  // A cluster the card cannot place is refused here, not at the launch
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&config, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool ALL_MXU>
int by_nacc(int n_acc, const Args& a, cudaStream_t s) {
  switch (n_acc) {
    case 1: return launch<1, ALL_MXU>(a, s);
    case 2: return launch<2, ALL_MXU>(a, s);
    case 4: return launch<4, ALL_MXU>(a, s);
    case 8: return launch<8, ALL_MXU>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// obs: (batch, frames, states) float32; band: (>= width, states) float32,
// rows d < width read; mxu: (width,) uint8, 1 where offset d shifts on the
// tensor cores, or null for every offset (`mxushift`); out: (batch, states)
// float32. n_acc: accumulators per destination (1, 2, 4, 8). Needs states a
// multiple of 128, 1 <= width <= states, and 2 x 16 posterior rows of states
// + 8 floats within the opt-in shared memory (states <= 1792 on the H100).
// Returns a cudaError_t code.
extern "C" int lab_mxu(const float* obs, const float* band,
                       const uint8_t* mxu, float* out, int n_acc, int batch,
                       int frames, int states, int width, void* stream) {
  if (batch <= 0 || frames <= 0 || states <= 0 || states % 128 ||
      width < 1 || width > states)
    return cudaErrorInvalidValue;
  Args a;
  a.obs = obs;
  a.band = band;
  a.mxu = mxu;
  a.out = out;
  a.batch = batch;
  a.frames = frames;
  a.states = states;
  a.width = width;
  a.lo = -(width / 2);
  a.pitch = states + kRowPad;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mxu ? by_nacc<false>(n_acc, a, s) : by_nacc<true>(n_acc, a, s);
}
