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
// is two FP32 instructions, an add and a max, and the max issues at 64 a
// clock on an SM: 64 candidates per SM and clock. At the scan's first level
// of 1 x 32,768 x 64 (16,383 products of 64^3) the bytes, each operand read
// once and the output written once, bound it almost as tightly (0.240
// against 0.257 ms on an H100), so the loads must hide under the adds.
//
// Design: a persistent grid walks a list of items, an item being one
// output tile of one product; each CTA takes items c, c + grid, ... in
// turn, each item's k in slabs of KD. The slabs pass through a ring of
// STAGES buffers in shared memory, filled by 16-byte cp.async copies into
// padded rows, so that while one slab is computed the next STAGES - 1 are
// in flight: across items too, so that product z + 1's loads overlap
// product z's compute, and z's stores go out from registers while z + 1
// is computed. Each of the TY x TX threads keeps an RI x RJ tile of
// running maxima (rows ty + TY i, columns 4 tx + 4 TX h + j) and for each
// k reads RI values of a (four k's of a row at once, a's rows being
// contiguous in k) and RJ of b in 16-byte shared loads: one byte of shared
// memory a candidate for 8 x 8 maxima, two for 4 x 4. a's staged rows are
// padded to KD + 4 floats, so that the rows a warp reads at once fall in
// distinct banks; b's columns are contiguous. The launch bounds hold a
// thread to REGS registers; ptxas reports no spill. A tile design is (TY,
// TX, RI, RJ, KD, STAGES, REGS); the launch plan
// (torbi_tpu_torch/ops/associative.py::maxplus_plan) picks one, and the
// grid's CTAs an SM, by the time of the busiest SM over its rounds of
// items (a grid of three CTAs an SM that leaves a last round of one CTA
// loses to two CTAs an SM):
// - the associative modes' products (64^3 at 1 x 32,768 x 64, from one
//   product to 32,768): 64 x 64 tiles of 256 threads, 4 x 4 maxima each,
//   the whole 64-deep product one stage of a ring of two (66 KB, three
//   CTAs an SM), the k loop unrolled. On an H100 it matched 8 x 8 maxima
//   at 16,383 products and beat them below (a 64-thread CTA's chain of
//   4,096 candidates a thread sets the time of a few products) and with a
//   broadcast operand;
// - large products (1440^3): 144 x 112 tiles of 252 threads, 8 x 8 maxima
//   each, slabs of 32 through a ring of three, 130 tiles, so that one wave
//   fills the 132 SMs (64 x 64 tiles make 529, two rounds of three CTAs an
//   SM: 1.25x slower).
// A broadcast operand (batch stride 0) whose one tile row or column holds
// the whole product (`resident`) is loaded once per CTA, every slab of
// it, and stays in shared memory: the time-sharded decode's pre[None] and
// suf[None]. What holds it back at the scan's first level: its loads
// alone and its compute alone each take most of its time, and they
// overlap only in part (PERF.md).
//
// Any strides: a batch stride of 0 broadcasts an operand; rows may be
// strided, columns are contiguous. Rows that do not start on 16 bytes
// (5, 33, 65 or 127 states) take 4-byte copies in the same kernel (vec_a,
// vec_b false). Ragged edges are masked: past k both operands hold -inf,
// so the padded candidates are -inf.
#include "persistent.cuh"

namespace {

struct Problem {
  const float* a;
  const float* b;
  float* out;
  long long a_batch, a_row, b_batch, b_row;
  int items;  // batch * tiles_m * tiles_n
  int m, k, n;
  int tiles_m, tiles_n, slabs;
  int vec_a, vec_b;
  int resident;  // 0: none, 1: a, 2: b stays in shared memory
};

__device__ __forceinline__ float max_nan(float x, float y) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(x), "f"(y));
  return d;
}

// Stage rows r0 .. r0 + ROWS of src (row stride src_row), columns c0 ..
// c0 + 4 CHUNKS, into dst (row stride dst_stride): 16-byte copies where a
// chunk lies inside (r_lim, c_lim) and `vec` holds, else 4-byte copies of
// its elements inside and -inf outside
template <int ROWS, int CHUNKS, int THREADS>
__device__ __forceinline__ void load_slab(float* dst, int dst_stride,
                                          const float* src, long long src_row,
                                          int r0, int r_lim, int c0,
                                          int c_lim, bool vec, int tid) {
  for (int e = tid; e < ROWS * CHUNKS; e += THREADS) {
    const int r = e / CHUNKS, c = 4 * (e % CHUNKS);
    const int gr = r0 + r, gc = c0 + c;
    float* d = dst + r * dst_stride + c;
    const float* s = src + static_cast<long long>(gr) * src_row + gc;
    if (vec && gr < r_lim && gc + 3 < c_lim) {
      torbi::cp_async16(d, s);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (gr < r_lim && gc + j < c_lim)
          torbi::cp_async4(d + j, s + j);
        else
          d[j] = torbi::neg_inf();
      }
    }
  }
}

template <int TY, int TX, int RI, int RJ, int KD, int STAGES, int REGS>
struct Tile {
  // TY x TX threads, each holding RI x RJ running maxima
  static constexpr int kTY = TY, kTX = TX, kRI = RI, kRJ = RJ, kDepth = KD;
  static constexpr int kThreads = TY * TX;
  static_assert(KD % 4 == 0 && RJ % 4 == 0, "k and columns four at a time");
  static constexpr int kRows = RI * TY, kCols = RJ * TX;
  static constexpr int kAStride = KD + 4;  // as[row][k], padded
  static constexpr int kBStride = kCols;   // bs[k][col]
  static constexpr int kAFloats = kRows * kAStride;
  static constexpr int kBFloats = KD * kBStride;
  // At most REGS registers a thread
  static constexpr int kMinBlocks =
      65536 / (REGS * ((kThreads + 31) / 32 * 32));
  // 8 x 8 maxima leave no registers to unroll the k loop
  static constexpr bool kUnrolled = RI * RJ < 64;

  // A resident operand's `slabs` slabs, then the ring
  static constexpr long long smem_bytes(int resident, int slabs) {
    const long long stage = (resident == 1 ? 0 : kAFloats) +
                            (resident == 2 ? 0 : kBFloats);
    const long long held = static_cast<long long>(slabs) *
                           (resident == 1   ? kAFloats
                            : resident == 2 ? kBFloats
                                            : 0);
    return 4 * (STAGES * stage + held);
  }
};

// One slab: acc[i][j] = max(acc[i][j], a[row_i][k] + b[k][col_j]) over
// its KD k's, a's values read four k's at a time
template <class T>
__device__ __forceinline__ void compute(const float* as, const float* bs,
                                        float (&acc)[T::kRI][T::kRJ], int ty,
                                        int tx) {
  const float* ap = as + ty * T::kAStride;
  const float* bp = bs + 4 * tx;
  auto step = [&](int kq) {
    float av[T::kRI][4];
#pragma unroll
    for (int i = 0; i < T::kRI; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(
          ap + i * T::kTY * T::kAStride + kq);
      av[i][0] = v.x;
      av[i][1] = v.y;
      av[i][2] = v.z;
      av[i][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* brow = bp + (kq + kk) * T::kBStride;
      float bv[T::kRJ];
#pragma unroll
      for (int h = 0; h < T::kRJ / 4; ++h) {
        const float4 v =
            *reinterpret_cast<const float4*>(brow + 4 * T::kTX * h);
        bv[4 * h] = v.x;
        bv[4 * h + 1] = v.y;
        bv[4 * h + 2] = v.z;
        bv[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < T::kRI; ++i)
#pragma unroll
        for (int j = 0; j < T::kRJ; ++j)
          acc[i][j] = max_nan(acc[i][j], av[i][kk] + bv[j]);
    }
  };
  if constexpr (T::kUnrolled) {
#pragma unroll
    for (int kq = 0; kq < T::kDepth; kq += 4) step(kq);
  } else {
#pragma unroll 1
    for (int kq = 0; kq < T::kDepth; kq += 4) step(kq);
  }
}

template <int TY, int TX, int RI, int RJ, int KD, int STAGES, int REGS>
__global__ void __launch_bounds__(
    TY * TX, (Tile<TY, TX, RI, RJ, KD, STAGES, REGS>::kMinBlocks))
    maxplus_kernel(const Problem p) {
  using T = Tile<TY, TX, RI, RJ, KD, STAGES, REGS>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX;
  const bool res_a = p.resident == 1, res_b = p.resident == 2;
  // A resident operand's slabs first, then the ring of stages
  float* ring = smem + p.slabs * (res_a   ? T::kAFloats
                                  : res_b ? T::kBFloats
                                          : 0);
  const int stage = (res_a ? 0 : T::kAFloats) + (res_b ? 0 : T::kBFloats);
  const int b_offset = res_a ? 0 : T::kAFloats;
  const int per_product = p.tiles_m * p.tiles_n;
  const int cta = blockIdx.x, grid = gridDim.x;
  const int iters = (cta < p.items ? (p.items - 1 - cta) / grid + 1 : 0) *
                    p.slabs;

  // The walk: iteration it is slab it % slabs of item cta + it / slabs *
  // grid, an item being (product z, first row, first column of its tile).
  // Everything follows from `it`, so that little stays live beside the
  // maxima
  auto place = [&](int it, int& z, int& row0, int& col0) {
    const int item = cta + it / p.slabs * grid;
    z = item / per_product;
    const int rest = item - z * per_product;
    row0 = rest / p.tiles_n * T::kRows;
    col0 = rest % p.tiles_n * T::kCols;
  };
  auto load = [&](int it) {
    int z, row0, col0;
    place(it, z, row0, col0);
    const int k0 = it % p.slabs * KD;
    float* buf = ring + it % STAGES * stage;
    if (!res_a)
      load_slab<T::kRows, KD / 4, T::kThreads>(
          buf, T::kAStride, p.a + z * p.a_batch, p.a_row, row0, p.m, k0, p.k,
          p.vec_a, tid);
    if (!res_b)
      load_slab<KD, T::kCols / 4, T::kThreads>(
          buf + b_offset, T::kBStride, p.b + z * p.b_batch, p.b_row, k0, p.k,
          col0, p.n, p.vec_b, tid);
  };

  // The resident operand, every slab of it: one tile row (a) or column
  // (b) holds the whole product and every product reads the same matrix;
  // it joins the first stage's commit group
  for (int s = 0; s < p.slabs && (res_a || res_b); ++s) {
    if (res_a)
      load_slab<T::kRows, KD / 4, T::kThreads>(
          smem + s * T::kAFloats, T::kAStride, p.a, p.a_row, 0, p.m, s * KD,
          p.k, p.vec_a, tid);
    else
      load_slab<KD, T::kCols / 4, T::kThreads>(
          smem + s * T::kBFloats, T::kBStride, p.b, p.b_row, s * KD, p.k, 0,
          p.n, p.vec_b, tid);
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < iters) load(s);
    torbi::cp_async_commit();
  }

  float acc[RI][RJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) acc[i][j] = torbi::neg_inf();

  for (int it = 0; it < iters; ++it) {
    // Slab `it` has landed (this thread's copies; the barrier makes every
    // thread's visible), and every thread is done with slab it - 1, whose
    // buffer the next copies refill
    torbi::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (it + STAGES - 1 < iters) load(it + STAGES - 1);
    torbi::cp_async_commit();

    const int slab = it % p.slabs;
    const float* buf = ring + it % STAGES * stage;
    compute<T>(res_a ? smem + slab * T::kAFloats : buf,
               res_b ? smem + slab * T::kBFloats : buf + b_offset, acc, ty,
               tx);

    if (slab + 1 == p.slabs) {
      int z, row0, col0;
      place(it, z, row0, col0);
      float* oz = p.out + static_cast<long long>(z) * p.m * p.n;
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int row = row0 + ty + TY * i;
        if (row < p.m) {
          float* o = oz + static_cast<long long>(row) * p.n;
#pragma unroll
          for (int h = 0; h < RJ / 4; ++h) {
            const int col = col0 + 4 * tx + 4 * TX * h;
            if (p.n % 4 == 0 && col + 3 < p.n) {
              *reinterpret_cast<float4*>(o + col) =
                  make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                              acc[i][4 * h + 2], acc[i][4 * h + 3]);
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (col + j < p.n) o[col + j] = acc[i][4 * h + j];
            }
          }
        }
#pragma unroll
        for (int j = 0; j < RJ; ++j) acc[i][j] = torbi::neg_inf();
      }
    }
  }
  torbi::cp_async_wait_all();
}

// The tile designs, in the order of ops/associative.py::MAXPLUS_TILES:
// (TY, TX, RI, RJ, KD, STAGES, REGS)
#define TORBI_TILE(...) \
  f(Tile<__VA_ARGS__>{}, maxplus_kernel<__VA_ARGS__>)
template <class F>
cudaError_t with_tile(int tile, F&& f) {
  switch (tile) {
    case 0:
      return TORBI_TILE(16, 16, 4, 4, 64, 2, 80);
    case 1:
      return TORBI_TILE(18, 14, 8, 8, 32, 3, 128);
    default:
      return cudaErrorInvalidValue;
  }
}
#undef TORBI_TILE

// Allow `bytes` of dynamic shared memory for tile design T's kernel (one
// static per design), once per size
template <class T>
cudaError_t allow_smem(void (*kernel)(Problem), int bytes) {
  static int allowed = 48 * 1024;
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t code = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (code == cudaSuccess) allowed = bytes;
  return code;
}

}  // namespace

// a: (batch, m, k) float32 at a + z * a_batch + j * a_row + kk (a_batch 0
// broadcasts one matrix); b likewise (batch, k, n); out: contiguous
// (batch, m, n) float32. batch, m, n >= 1, k >= 1. The launch plan
// (ops/associative.py::maxplus_plan): `tile` the index of the tile design,
// `grid` the CTAs of the persistent grid, `resident` 1 (a) or 2 (b) for an
// operand held in shared memory (its batch stride 0, one tile row or
// column holding its whole product), else 0; vec_a, vec_b whether every
// row of a, b starts on 16 bytes. Returns a cudaError_t code.
extern "C" int maxplus_matmul(const float* a, long long a_batch,
                              long long a_row, const float* b,
                              long long b_batch, long long b_row, float* out,
                              int batch, int m, int k, int n, int tile,
                              int grid, int resident, int vec_a, int vec_b,
                              void* stream) {
  if (batch <= 0 || m <= 0 || k <= 0 || n <= 0 || grid <= 0 || resident < 0 ||
      resident > 2)
    return cudaErrorInvalidValue;
  return with_tile(tile, [&](auto t, auto kernel) -> cudaError_t {
    using T = decltype(t);
    Problem p;
    p.a = a;
    p.b = b;
    p.out = out;
    p.a_batch = a_batch;
    p.a_row = a_row;
    p.b_batch = b_batch;
    p.b_row = b_row;
    p.m = m;
    p.k = k;
    p.n = n;
    p.tiles_m = (m + T::kRows - 1) / T::kRows;
    p.tiles_n = (n + T::kCols - 1) / T::kCols;
    p.slabs = (k + T::kDepth - 1) / T::kDepth;
    const long long items = static_cast<long long>(batch) * p.tiles_m *
                            p.tiles_n;
    if (items > INT_MAX / 2) return cudaErrorInvalidValue;
    p.items = static_cast<int>(items);
    p.vec_a = vec_a;
    p.vec_b = vec_b;
    p.resident = resident;
    // A resident operand must be the same whole matrix for every item
    if ((resident == 1 && (a_batch != 0 || p.tiles_m != 1)) ||
        (resident == 2 && (b_batch != 0 || p.tiles_n != 1)))
      return cudaErrorInvalidValue;
    const long long bytes = T::smem_bytes(resident, p.slabs);
    if (bytes > 232448) return cudaErrorInvalidValue;
    const int smem = static_cast<int>(bytes);
    cudaError_t code = allow_smem<T>(kernel, smem);
    if (code != cudaSuccess) return code;
    const int blocks = grid < p.items ? grid : p.items;
    kernel<<<blocks, T::kThreads, smem,
             static_cast<cudaStream_t>(stream)>>>(p);
    return cudaGetLastError();
  });
}

// The CTAs of tile design `tile` (with `resident` as above, over `slabs`
// slabs) that one SM holds at once, as the card reports it, into *blocks;
// and its dynamic shared memory into *smem. Returns a cudaError_t code.
extern "C" int maxplus_occupancy(int tile, int resident, int slabs,
                                 int* blocks, int* smem) {
  if (resident < 0 || resident > 2 || slabs < 1) return cudaErrorInvalidValue;
  return with_tile(tile, [&](auto t, auto kernel) -> cudaError_t {
    using T = decltype(t);
    if (T::smem_bytes(resident, slabs) > 232448) return cudaErrorInvalidValue;
    *smem = static_cast<int>(T::smem_bytes(resident, slabs));
    cudaError_t code = allow_smem<T>(kernel, *smem);
    if (code != cudaSuccess) return code;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                         T::kThreads, *smem);
  });
}
