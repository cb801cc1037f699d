// Forward lab, `mod12` and `mod12k`: `full`'s function in the mod-M layout
// with a stitched band.
//
// Replaces the TPU lab functions scripts/kernel_lab.py::build_kernel_mod12
// (`mod12`) and build_kernel_mod12k (`mod12k`). With M = S / 128, state
// s = M l + r lives at row r, lane l of an (M, 128) posterior. A candidate
// shift then moves lanes by about width / M distinct rotates alpha plus a
// row rename beta; the plan (torbi_tpu_torch/scripts/kernel_lab.py::
// build_mod12_plan) stitches the band into one (M, 128) matrix per key
// (alpha, beta), -inf where the key owns no candidate, so that
//   post'[r][l] = obs[r][l] + max_i post[(r - beta_i) mod M][(l - alpha_i)
//                 mod 128] + stitched[i][r][l]
// over the P keys covers every (destination, offset) candidate once. Each
// candidate is one fp32 add (-inf + finite = -inf leaves the max alone) and
// fmaxf does not depend on order, so the result is bitwise `full`'s.
//
// `mod12` reads the observation in the mod-M layout of the JAX lab,
// (batch / 8, M * 8, frames, 128) (kernel_lab.py::mod12_obs), and writes the
// final posterior as (batch / 8 * M * 8, 128). `mod12k` reads the natural
// (batch, frames, states) observation: each frame's rows load coalesced and
// scatter into mod-M order in shared memory, at a row pitch chosen so that a
// warp's scattered stores spread over the banks (a pitch of 128 words would
// put a warp's 32 states, which fall on 3 lanes, in 12 ways on 3 banks at
// M = 12). It writes the mod-M posterior and the natural (batch, states)
// one, for the final frame only (the TPU kernel rewrites both every frame
// because its output block stays resident).
//
// Design: a CTA holds NB sequences (1, 2, 4 or 8 of one group of 8), each
// posterior in shared memory as (M, 128), double-buffered, the sequences
// interleaved by up to 4 so that one vector load reads a source cell of 4
// of them; a thread owns cells (r, l) and walks the keys grouped by alpha,
// so a group's lane rotate (l - alpha) mod 128 is computed once (the JAX
// kernel's shared rotates, :559-562), and each key adds its row rename from
// a (P, M) table of row offsets built once per CTA. A warp's 32 cells share
// r, so a rotated source load is free of bank conflicts and a row offset is
// a broadcast. The stitched band, (P, M, 128) float32 (1.1 MB at 1536
// states, width 175: too big for shared memory), streams from L2 as K1's
// band does, one value per cell and key serving NB sequences. n_acc
// accumulators per cell set the fmaxf chains.
//
// Bound on the H100 at 512 x 512 x 1536, width 175: `full`'s function,
// two FP32 instructions per candidate ~4.2 ms, one shared-memory word per
// candidate ~8.4 ms; the stitched plan adds 6% (186 keys for 175 offsets).
#include "common.cuh"

namespace {

constexpr int kGroup = 8;  // sequences per group of the mod-M layout
constexpr int kLanes = 128;
constexpr int kMaxThreads = 512;

struct Args {
  const float* obs;
  const float* stitched;   // (P, M, 128)
  const int* alphas;       // (n_alpha,): the distinct lane rotates
  const int* starts;       // (n_alpha + 1,): each rotate's keys
  const int* betas;        // (P,): each key's row rename
  float* out;              // (batch / 8 * M * 8, 128)
  float* natural;          // mod12k: (batch, states)
  int batch, frames, states, rows, n_alpha, n_keys, obs_pitch;
};

// Sequences of a CTA interleaved in groups of kVec = min(NB, 4), so that
// one vector load from shared memory reads a cell of every sequence of a
// group: element (n, c) of an (NB, cells) posterior at
// ((n / kVec) * cells + c) * kVec + n % kVec
template <int NB>
struct Interleave {
  static constexpr int kVec = NB < 4 ? NB : 4;
  static constexpr int kPlanes = NB / kVec;
  __device__ static int at(int n, int c, int cells) {
    return ((n / kVec) * cells + c) * kVec + n % kVec;
  }
  // The NB values of cell c
  __device__ static void load(const float* p, int c, int cells,
                              float (&v)[NB]) {
#pragma unroll
    for (int q = 0; q < kPlanes; ++q) {
      const float* src = p + (q * cells + c) * kVec;
      if constexpr (kVec == 4) {
        const float4 x = *reinterpret_cast<const float4*>(src);
        v[4 * q] = x.x, v[4 * q + 1] = x.y, v[4 * q + 2] = x.z,
        v[4 * q + 3] = x.w;
      } else if constexpr (kVec == 2) {
        const float2 x = *reinterpret_cast<const float2*>(src);
        v[0] = x.x, v[1] = x.y;
      } else {
        v[0] = *src;
      }
    }
  }
};

template <int NACC, int NB, bool NATURAL>
__global__ void __launch_bounds__(kMaxThreads) lab_mod_kernel(Args a) {
  using IL = Interleave<NB>;
  extern __shared__ float smem[];
  const int M = a.rows;
  const int cells = M * kLanes;
  const int P = a.n_keys;
  float* post = smem;                     // [2][NB][cells], interleaved
  int* rowoff = reinterpret_cast<int*>(smem + 2 * NB * cells);  // [P][M]
  float* staged = smem + 2 * NB * cells + P * M;  // mod12k: [NB][M][pitch]
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int seq0 = blockIdx.x * NB;
  const int T = a.frames;
  const int S = a.states;

  // Element (r, l) of frame f of sequence n, mod-M layout in device memory
  auto mod_obs = [&](int n, int f, int r, int l) {
    const int seq = seq0 + n;
    const size_t row = static_cast<size_t>(seq / kGroup) * M * kGroup +
                       static_cast<size_t>(r) * kGroup + seq % kGroup;
    return a.obs[(row * T + f) * kLanes + l];
  };
  // mod12k: stage frame f's natural rows in mod-M order
  auto stage = [&](int f) {
    for (int e = tid; e < NB * S; e += nthreads) {
      const int n = e / S, j = e - n * S;
      const int l = j / M, r = j - l * M;
      staged[(n * M + r) * a.obs_pitch + l] =
          a.obs[(static_cast<size_t>(seq0 + n) * T + f) * S + j];
    }
  };

  // Key i's source row at output row r, as a word offset: (r - beta_i) mod
  // M, times 128
  for (int e = tid; e < P * M; e += nthreads) {
    const int i = e / M, r = e - i * M;
    int row = r - __ldg(a.betas + i);
    if (row < 0) row += M;
    rowoff[e] = row * kLanes;
  }
  if constexpr (NATURAL) stage(0);
  __syncthreads();
  for (int c = tid; c < cells; c += nthreads) {
    const int r = c >> 7, l = c & (kLanes - 1);
#pragma unroll
    for (int n = 0; n < NB; ++n)
      post[IL::at(n, c, cells)] =
          NATURAL ? staged[(n * M + r) * a.obs_pitch + l]
                  : mod_obs(n, 0, r, l);
  }
  __syncthreads();

  for (int f = 1; f < T; ++f) {
    const float* pc = post + ((f - 1) & 1) * NB * cells;
    float* pn = post + (f & 1) * NB * cells;
    if constexpr (NATURAL) {
      stage(f);  // the previous frame's reads of `staged` ended at a barrier
      __syncthreads();
    }
    for (int c = tid; c < cells; c += nthreads) {
      const int r = c >> 7, l = c & (kLanes - 1);
      float acc[NB][NACC];
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int s = 0; s < NACC; ++s) acc[n][s] = torbi::neg_inf();
      // Key i's stitched value at (r, l), and its row offset at row r
      const float* sk = a.stitched + c;
      const int* ro = rowoff + r;
      for (int g = 0; g < a.n_alpha; ++g) {
        const int lane = (l - __ldg(a.alphas + g)) & (kLanes - 1);
        const int end = __ldg(a.starts + g + 1);
        auto key = [&](int i, int s) {
          const float sv = __ldg(sk + static_cast<size_t>(i) * cells);
          float v[NB];
          IL::load(pc, ro[i * M] + lane, cells, v);
#pragma unroll
          for (int n = 0; n < NB; ++n) acc[n][s] = fmaxf(acc[n][s], v[n] + sv);
        };
        // NACC keys per step with no guard, so that their loads can be in
        // flight together; the remainder into the first accumulator
        int i = __ldg(a.starts + g);
        for (; i + NACC <= end; i += NACC) {
#pragma unroll
          for (int s = 0; s < NACC; ++s) key(i + s, s);
        }
        for (; i < end; ++i) key(i, 0);
      }
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        float m = acc[n][0];
#pragma unroll
        for (int s = 1; s < NACC; ++s) m = fmaxf(m, acc[n][s]);
        const float o = NATURAL ? staged[(n * M + r) * a.obs_pitch + l]
                                : mod_obs(n, f, r, l);
        pn[IL::at(n, c, cells)] = o + m;
      }
    }
    __syncthreads();
  }

  const float* last = post + ((T - 1) & 1) * NB * cells;
  for (int c = tid; c < cells; c += nthreads) {
    const int r = c >> 7, l = c & (kLanes - 1);
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const int seq = seq0 + n;
      const size_t row = static_cast<size_t>(seq / kGroup) * M * kGroup +
                         static_cast<size_t>(r) * kGroup + seq % kGroup;
      a.out[row * kLanes + l] = last[IL::at(n, c, cells)];
    }
  }
  if constexpr (NATURAL) {
    for (int e = tid; e < NB * S; e += nthreads) {
      const int n = e / S, j = e - n * S;
      const int l = j / M, r = j - l * M;
      a.natural[static_cast<size_t>(seq0 + n) * S + j] =
          last[IL::at(n, r * kLanes + l, cells)];
    }
  }
}

// The row pitch (128 + pad words) of mod12k's staged observation at which
// the scattered stores of a warp (32 consecutive states) take the fewest
// shared-memory wavefronts, summed over the warps of a row
int staged_pitch(int rows, int states) {
  int best = kLanes, best_cost = INT_MAX;
  for (int pitch = kLanes; pitch < kLanes + 32; ++pitch) {
    int cost = 0;
    for (int w = 0; w < states; w += 32) {
      int per_bank[32] = {0};
      int worst = 0;
      for (int j = w; j < w + 32 && j < states; ++j) {
        const int word = (j % rows) * pitch + j / rows;
        const int ways = ++per_bank[word % 32];
        if (ways > worst) worst = ways;
      }
      cost += worst;
    }
    if (cost < best_cost) best = pitch, best_cost = cost;
  }
  return best;
}

template <int NACC, int NB, bool NATURAL>
int launch(const Args& a, cudaStream_t stream) {
  void (*kernel)(Args) = lab_mod_kernel<NACC, NB, NATURAL>;
  const size_t cells = static_cast<size_t>(a.rows) * kLanes;
  const size_t smem =
      (2 * NB * cells + static_cast<size_t>(a.n_keys) * a.rows +
       (NATURAL ? static_cast<size_t>(NB) * a.rows * a.obs_pitch : 0)) *
      sizeof(float);
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
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int threads = min(kMaxThreads, attr.maxThreadsPerBlock) / 32 * 32;
  threads = min(threads, static_cast<int>(cells));
  kernel<<<a.batch / NB, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int NACC, bool NATURAL>
int by_nb(int nb, const Args& a, cudaStream_t s) {
  switch (nb) {
    case 1: return launch<NACC, 1, NATURAL>(a, s);
    case 2: return launch<NACC, 2, NATURAL>(a, s);
    case 4: return launch<NACC, 4, NATURAL>(a, s);
    case 8: return launch<NACC, 8, NATURAL>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool NATURAL>
int by_nacc(int n_acc, int nb, const Args& a, cudaStream_t s) {
  switch (n_acc) {
    case 1: return by_nb<1, NATURAL>(nb, a, s);
    case 2: return by_nb<2, NATURAL>(nb, a, s);
    case 4: return by_nb<4, NATURAL>(nb, a, s);
    case 8: return by_nb<8, NATURAL>(nb, a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// obs: the mod-M observation (batch / 8, M * 8, frames, 128) float32, or
// with natural != null the natural (batch, frames, states) one; stitched:
// (P, M, 128) float32; alphas (n_alpha,), starts (n_alpha + 1,) and betas
// (P,) int32: the P = n_keys keys sorted by (alpha, beta), keys starts[g]
// .. starts[g + 1] - 1 rotating by alphas[g]; out: (batch / 8 * M * 8, 128)
// float32; natural: null, or (batch, states) float32. n_acc: accumulators
// per cell (1, 2, 4, 8); nb: sequences per CTA (1, 2, 4, 8). Needs states a
// multiple of 128 and batch a multiple of 8. Returns a cudaError_t code.
extern "C" int lab_mod(const float* obs, const float* stitched,
                       const int* alphas, const int* starts,
                       const int* betas, float* out, float* natural,
                       int n_alpha, int n_keys, int n_acc, int nb, int batch,
                       int frames, int states, void* stream) {
  if (batch <= 0 || batch % kGroup || frames <= 0 || states <= 0 ||
      states % kLanes || n_alpha < 1 || n_keys < n_alpha)
    return cudaErrorInvalidValue;
  Args a;
  a.obs = obs;
  a.stitched = stitched;
  a.alphas = alphas;
  a.starts = starts;
  a.betas = betas;
  a.out = out;
  a.natural = natural;
  a.batch = batch;
  a.frames = frames;
  a.states = states;
  a.rows = states / kLanes;
  a.n_alpha = n_alpha;
  a.n_keys = n_keys;
  a.obs_pitch = natural ? staged_pitch(a.rows, states) : 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return natural ? by_nacc<true>(n_acc, nb, a, s)
                 : by_nacc<false>(n_acc, nb, a, s);
}
