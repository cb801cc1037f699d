// Device helpers of the chases: K3 (csrc/backtrace.cu) and K5, K6
// (csrc/backtrace_batch1.cu). Each finds the lowest-index argmax of a row,
// ties compared as (v > best || (v == best && i < best_i)); a row of -inf
// gives index 0, as argmax does.
#pragma once

#include <climits>

#include "cluster.cuh"
#include "common.cuh"

namespace torbi {

// Keep (v, i) if it beats (best, best_i): greater, or equal and lower index
__device__ __forceinline__ void take(float& best, int& best_i, float v,
                                     int i) {
  if (v > best || (v == best && i < best_i)) {
    best = v;
    best_i = i;
  }
}

__device__ __forceinline__ void warp_reduce(float& best, int& best_i) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    const float v = __shfl_xor_sync(0xffffffffu, best, offset);
    const int i = __shfl_xor_sync(0xffffffffu, best_i, offset);
    take(best, best_i, v, i);
  }
}

// The index a reduction settles on: the lowest argmax, or 0 for a row of
// -inf (whose pairs all hold -inf; the lowest index seen may then be past
// 0, or INT_MAX when no lane saw an element)
__device__ __forceinline__ int settle(float best, int best_i) {
  return best == neg_inf() ? 0 : best_i;
}

// Lowest-index argmax of row[0, n) over the whole CTA, through a (value,
// index) table of one entry per warp
__device__ inline int block_argmax(const float* __restrict__ row, int n,
                                   float* table_v, int* table_i) {
  const int tid = threadIdx.x;
  float best = neg_inf();
  int best_i = INT_MAX;
  for (int i = tid; i < n; i += blockDim.x) take(best, best_i, row[i], i);
  warp_reduce(best, best_i);
  if ((tid & 31) == 0) {
    table_v[tid >> 5] = best;
    table_i[tid >> 5] = best_i;
  }
  __syncthreads();
  best = neg_inf();
  best_i = INT_MAX;
  for (int w = 0; w < (blockDim.x >> 5); ++w)
    take(best, best_i, table_v[w], table_i[w]);
  return settle(best, best_i);
}

// A float as an unsigned key in the same order (-0 and +0 one key, as
// they compare equal); 0 is below every float's key, -inf's included
__device__ __forceinline__ unsigned order_key(float v) {
  unsigned u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Warp-wide lowest-index argmax of the lanes' (key, index) pairs, each
// lane's index the lowest of its own maxima: the largest key, then the
// lowest index holding it. Two redux instructions in place of five rounds
// of shuffles and compares. Every lane gets the result
__device__ __forceinline__ void warp_argmax_key(unsigned& key, int& index) {
  const unsigned top = __reduce_max_sync(0xffffffffu, key);
  index = __reduce_min_sync(0xffffffffu, key == top ? index : INT_MAX);
  key = top;
}

}  // namespace torbi
