// Helpers shared by the hand-written kernels of torbi_tpu_torch.
//
// No fast-math anywhere: every kernel of this package must give results
// bitwise equal to its plain PyTorch version, so the only floating-point
// operations used are single fp32 adds and fmaxf/compares, which round (or
// do not round) the same way on every device.
#pragma once

#include <climits>
#include <cstddef>

#include <cuda_runtime.h>

namespace torbi {

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000u);
}

// Max over the 32 lanes of a warp; every lane gets the result
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, offset));
  return v;
}

// Shared memory a forward kernel needs: a double-buffered posterior for nb
// sequences plus a double-buffered (nb, 32) scratch of per-warp maxima
inline size_t forward_smem_bytes(int nb, int states) {
  return (2 * static_cast<size_t>(nb) * states + 2 * 32 * nb) * sizeof(float);
}

// Sequences per CTA of the forward kernels. Several sequences share every
// transition value a CTA reads (the band or dense matrix streams through
// L2 once per frame and CTA), so large batches take 4; small batches take
// fewer to keep more SMs busy. Shrinks until the posteriors fit the opt-in
// shared memory; returns 0 when one sequence does not fit.
inline int forward_sequences_per_cta(int batch, int states) {
  int device = 0, optin = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return 0;
  int nb = batch >= 256 ? 4 : (batch >= 64 ? 2 : 1);
  while (nb > 1 && forward_smem_bytes(nb, states) > static_cast<size_t>(optin))
    nb /= 2;
  return forward_smem_bytes(nb, states) <= static_cast<size_t>(optin) ? nb
                                                                       : 0;
}

// Threads per forward CTA: a warp multiple, at most 512
inline int forward_threads(int states) {
  int threads = ((states + 31) / 32) * 32;
  return threads < 32 ? 32 : (threads > 512 ? 512 : threads);
}

}  // namespace torbi

extern "C" const char* torbi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
