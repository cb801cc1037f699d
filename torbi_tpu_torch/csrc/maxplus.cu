// K8: the batched (max, +) matrix product,
//
//   out[z, j, i] = max_k a[z, j, k] + b[z, k, i].
//
// Has no Pallas counterpart: it replaces
// torbi_tpu/ops/associative.py::_maxplus_matmul, the combine of the
// associative max-plus scan and of the time-sharded decode
// (torbi_tpu/parallel/timesharded.py), which XLA fuses from
// jnp.max(a[..., :, :, None] + b[..., None, :, :], axis=-2). Eager
// PyTorch would materialise the M x K x N candidates of every product;
// this kernel keeps them in registers.
//
// Exactness: each candidate is one fp32 add and the maximum of fp32 values
// does not depend on the order it is taken in, so the result is bitwise
// the plain version's whatever the order over k. The maximum is PTX's
// max.NaN (a NaN candidate makes the output NaN, as torch.amax and
// jnp.max do; fmaxf would drop it); -inf stays -inf. There is no multiply,
// so FMA contraction cannot change a value.
//
// Bound: operations. Tensor cores cannot do (max, +), so every candidate
// is two FP32 instructions (an add and a max) at 128 per SM and clock;
// the bytes (each input read once, the output written once) bound only
// the smallest products.
// Design: a simple tiled kernel. Each CTA takes a 64 x 64 output tile of
// one batch entry (a grid-stride loop over the batch past 65,535 entries);
// k runs in tiles of 16: the CTA stages a's 64 x 16 tile (transposed) and
// b's 16 x 64 tile in shared memory, the next tile's values already
// loaded into registers while the current one is used, and each of its
// 256 threads keeps a 4 x 4 register tile of running maxima, reading 4
// values of a and 4 of b (two 16-byte shared loads) for its 16 candidates
// per k. Any strides: a batch stride of 0 broadcasts an operand; the rows
// may be strided, the columns are contiguous. Ragged edges are masked:
// past k both operands read -inf, so the padded candidates are -inf.
#include "common.cuh"

namespace {

constexpr int kTile = 64;           // output rows and columns per CTA
constexpr int kDepth = 16;          // k per staged tile
constexpr int kThreads = 256;       // 16 x 16 threads, 4 x 4 outputs each
constexpr int kLoads = kTile * kDepth / kThreads;  // staged values a thread
constexpr int kPad = kTile + 4;     // a's staged rows stay 16-byte aligned
constexpr int kMaxGridZ = 65535;

__device__ __forceinline__ float max_nan(float x, float y) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(x), "f"(y));
  return d;
}

__global__ void __launch_bounds__(kThreads) maxplus_kernel(
    const float* __restrict__ a, long long a_batch, long long a_row,
    const float* __restrict__ b, long long b_batch, long long b_row,
    float* __restrict__ out, int batch, int m, int k, int n) {
  __shared__ __align__(16) float as[kDepth][kPad];   // as[kk][row]
  __shared__ __align__(16) float bs[kDepth][kTile];  // bs[kk][col]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  const bool vector_store = (n % 4) == 0;

  for (int z = blockIdx.z; z < batch; z += gridDim.z) {
    const float* az = a + static_cast<long long>(z) * a_batch;
    const float* bz = b + static_cast<long long>(z) * b_batch;
    float pa[kLoads], pb[kLoads];
    // The values of the k-tile at k0 this thread stages: a's element e
    // (row e / 16, kk e % 16), b's (kk e / 64, col e % 64), e = tid + 256 u
    auto fetch = [&](int k0) {
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = tid + kThreads * u;
        const int ar = row0 + e / kDepth, ak = k0 + e % kDepth;
        pa[u] = (ar < m && ak < k)
                    ? az[static_cast<long long>(ar) * a_row + ak]
                    : torbi::neg_inf();
        const int bk = k0 + e / kTile, bc = col0 + e % kTile;
        pb[u] = (bk < k && bc < n)
                    ? bz[static_cast<long long>(bk) * b_row + bc]
                    : torbi::neg_inf();
      }
    };

    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = torbi::neg_inf();

    fetch(0);
    for (int k0 = 0; k0 < k; k0 += kDepth) {
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = tid + kThreads * u;
        as[e % kDepth][e / kDepth] = pa[u];
        bs[e / kTile][e % kTile] = pb[u];
      }
      __syncthreads();
      // The next tile's loads are in flight while this one is used
      if (k0 + kDepth < k) fetch(k0 + kDepth);
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[r][c] = max_nan(acc[r][c], ar[r] + br[c]);
      }
      __syncthreads();
    }

    float* oz = out + static_cast<long long>(z) * m * n;
    const int col = col0 + tx * 4;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + ty * 4 + r;
      if (row >= m) break;
      float* o = oz + static_cast<long long>(row) * n + col;
      if (vector_store && col + 3 < n) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (col + c < n) o[c] = acc[r][c];
      }
    }
  }
}

}  // namespace

// a: (batch, m, k) float32 at a + z * a_batch + j * a_row + kk (a_batch 0
// broadcasts one matrix); b likewise (batch, k, n); out: contiguous
// (batch, m, n) float32. batch, m, n >= 1, k >= 1. Returns a cudaError_t
// code.
extern "C" int maxplus_matmul(const float* a, long long a_batch,
                              long long a_row, const float* b,
                              long long b_batch, long long b_row, float* out,
                              int batch, int m, int k, int n, void* stream) {
  if (batch <= 0 || m <= 0 || k <= 0 || n <= 0) return cudaErrorInvalidValue;
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile,
                  batch < kMaxGridZ ? batch : kMaxGridZ);
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  maxplus_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, a_batch, a_row, b, b_batch, b_row, out, batch, m, k, n);
  return cudaGetLastError();
}
