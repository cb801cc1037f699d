// The pieces of the persistent designs, K2 (csrc/dense_forward.cu) and
// K1's wide-band design (csrc/band_wide.cu): one CTA per SM in a
// cooperative launch for the whole recursion, sequence groups meeting at
// an atomic-counter barrier per frame, the last frame's posterior read
// back from the stream through L2 in double-buffered chunks of 16-byte
// copies, and the 4 x 4 register tile of the max-plus product. Each
// kernel's own body, and its staging of the chunks, stays in its own
// source.
#pragma once

#include <cstddef>

#include <cuda_runtime.h>

#include "cluster.cuh"
#include "common.cuh"

namespace torbi {

constexpr int kTile = 4;  // sequences and destinations per thread

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Copy 16 bytes from device memory into shared memory asynchronously,
// through L2 only
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_address(dst)),
               "l"(src)
               : "memory");
}

// The barrier of a sequence group: every CTA adds one to the group's
// counter once its stores are out, then waits until all `ctas` have added
// `phase` times. A wait past 2^35 clocks (about 17 s) traps, so that a
// fault ends the launch with an error instead of hanging it
__device__ __forceinline__ void group_sync(unsigned* counter, int ctas,
                                           int phase) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    const unsigned target = static_cast<unsigned>(phase) * ctas;
    const long long start = clock64();
    while (load_acquire(counter) < target)
      if (clock64() - start > (1LL << 35)) __trap();
  }
  __syncthreads();
}

// The register tile over one staged chunk: acc[q][r] = max(acc[q][r],
// ps[q prow + i] + ts[r trow + i]) for every source i of the quads (groups
// of 4 sources) u = k, k + split, ... below `quads`. One add and one max
// per candidate; 4 + 4 16-byte loads per 64 candidates
__device__ __forceinline__ void tile_max_plus(float (&acc)[kTile][kTile],
                                              const float* ps, size_t prow,
                                              const float* ts, size_t trow,
                                              int k, int quads, int split) {
#pragma unroll 2
  for (int u = k; u < quads; u += split) {
    float4 pv[kTile], tv[kTile];
#pragma unroll
    for (int q = 0; q < kTile; ++q)
      pv[q] = *reinterpret_cast<const float4*>(ps + q * prow + 4 * u);
#pragma unroll
    for (int r = 0; r < kTile; ++r)
      tv[r] = *reinterpret_cast<const float4*>(ts + r * trow + 4 * u);
#pragma unroll
    for (int q = 0; q < kTile; ++q)
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        float a = acc[q][r];
        a = fmaxf(a, pv[q].x + tv[r].x);
        a = fmaxf(a, pv[q].y + tv[r].y);
        a = fmaxf(a, pv[q].z + tv[r].z);
        acc[q][r] = fmaxf(a, pv[q].w + tv[r].w);
      }
  }
}

// Combine the tiles of `split` adjacent lanes (within one warp): each
// lane ends with the max over all of them
__device__ __forceinline__ void combine_split(float (&acc)[kTile][kTile],
                                              int split) {
  for (int off = 1; off < split; off <<= 1)
#pragma unroll
    for (int q = 0; q < kTile; ++q)
#pragma unroll
      for (int r = 0; r < kTile; ++r)
        acc[q][r] =
            fmaxf(acc[q][r], __shfl_xor_sync(0xffffffffu, acc[q][r], off));
}

// Launch `kernel` cooperatively (the card must hold every CTA at once,
// which the group barriers need) with `smem` bytes of dynamic shared
// memory; returns a cudaError_t code
template <typename Kernel>
int launch_persistent(Kernel kernel, int ctas, int threads, size_t smem,
                      void** args, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(ctas), dim3(threads), args, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace torbi
