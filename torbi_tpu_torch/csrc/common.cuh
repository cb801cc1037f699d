// Helpers shared by the hand-written kernels of torbi_tpu_torch.
//
// No fast-math anywhere: every kernel of this package must give results
// bitwise equal to its plain PyTorch version, so the floating-point
// operations used are single fp32 adds and fmaxf/compares, which round (or
// do not round) the same way on every device, and in the observation
// conversion the full-precision logf and expf that PyTorch's own CUDA
// kernels call for torch.log and torch.exp on float32 (no __logf/__expf,
// no flush to zero).
#pragma once

#include <cfloat>
#include <climits>
#include <cstddef>

#include <cuda_runtime.h>

namespace torbi {

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000u);
}

// The observation conversion a banded forward kernel folds into its loads,
// by CONV: bit 1 set, the input is a probability and takes logf first
// (log_input false); bit 0 set, the reference's epsilon step
// logf(expf(x) + FLT_MIN) follows (apply_epsilon). The order and the
// functions are those of the plain route's torch ops
// (torbi_tpu_torch/ops/dispatch.py::convert: torch.log, then exp_, add_ of
// the smallest normal float, log_), each rounded to float32 in turn, so the
// result is bitwise theirs. Only a loaded observation value may pass
// through it: log of a placeholder would be NaN.
constexpr int kConvEpsilon = 1;
constexpr int kConvLog = 2;

template <int CONV>
__device__ __forceinline__ float convert_obs(float x) {
  if constexpr ((CONV & kConvLog) != 0) x = logf(x);
  if constexpr ((CONV & kConvEpsilon) != 0) x = logf(expf(x) + FLT_MIN);
  return x;
}

// CONV of (log_input, apply_epsilon)
inline int conversion(int log_input, int apply_epsilon) {
  return (log_input ? 0 : kConvLog) | (apply_epsilon ? kConvEpsilon : 0);
}

// Max over the 32 lanes of a warp; every lane gets the result
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, offset));
  return v;
}

}  // namespace torbi

extern "C" const char* torbi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
