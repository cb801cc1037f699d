// Forward lab: variants of the banded forward recursion's inner loop, the
// templates shared by lab_forward.cu (every body but `pipe`) and lab_pipe.cu
// (the `pipe` bodies, one per group size), which build in parallel.
//
// Replaces the TPU lab functions scripts/kernel_lab.py::build_kernel (every
// variant of the production-shaped body) and build_kernel_tilted (the
// tilted layout and its probes). Each variant computes, for every sequence
// b, the final posterior of the lab's floorless circular recursion
//   post = obs[b, 0]
//   post'[j] = obs[b, t, j] + max_d cand(d, j),  d in [0, width), t >= 1
// with the candidate of each body (lo = -(width / 2), S states):
//   full, rowadd, pipe, tiled   post[(j + lo + d) mod S] + band[d, j]
//   rollmax                     post[(j + lo + d) mod S]
//   addmax                      post[j] + band[d, j]
//   max                         post[j]
//   vregroll                    post[(j - 128 d) mod S] + band[d, j]
//   introt                      post[128 a + (l - r_d) mod L_a]
//                               (j = 128 a + l, L_a the length of block a,
//                               r_d = ((-lo) mod S - d) mod 128)
//   subroll                     post[(j - 128 (d mod ceil(S / 128))) mod S]
//                               + band[d, j]
// Each candidate is at most one fp32 add and fmaxf does not depend on
// order, so every body is bitwise its plain version
// (torbi_tpu_torch/scripts/kernel_lab.py::forward_reference).
//
// The bodies split K1's (csrc/band_forward.cu) per-candidate cost: `full`
// is K1's body (a shifted shared-memory load, an __ldg band value from L2,
// an add and fmaxf); `rollmax` drops the band read and add, `addmax` the
// shifted load, `max` both (the loop and fmaxf alone: the issue floor).
// `rowadd` reads the band from shared memory, staged 8 rows at a time
// behind two __syncthreads, the running maxima waiting in shared memory;
// `pipeG` issues G source loads (G = 2, 4, 8 or 16; `pipe` is 8) before
// their G adds and maxima; `pipeN` does the same for a G given at run time
// (any G >= 1, clamped to the band width and to kMaxPipe, the size of its
// register arrays). `tiled` is
// register tiling: a thread owns R consecutive destinations, loads its
// R + width - 1 sources once per frame and reuses them across offsets
// through a sliding window of registers, so a candidate costs 1/R of a
// shared-memory load. `introt` and `subroll` compute the TPU probes'
// functions with R destinations per thread, each candidate's source loaded
// at its own index (their shifts do not slide with the offset as `tiled`'s
// do).
//
// Bound on the H100 at 512 x 512 x 1440, width 175 (the headline's
// candidate count, 6.6e10): two instructions per candidate at
// 128 lanes x 132 SMs x 1.98 GHz is ~3.9 ms, one shared-memory load per
// candidate at 32 words per SM and clock ~7.9 ms; the observation read and
// the posterior written take ~0.45 ms. So a body with one shifted load per
// candidate is bound by shared memory, and one without by issue.
//
// Design: one CTA holds NB sequences (1, 2, 4 or 8). Each posterior lives
// in shared memory, double-buffered, as its circular extension
// ext[k] = post[(k + lo) mod S], k in [0, S + width - 1), so a circular
// source is the plain shifted load ext[j + d]; a new value is written to
// ext[j - lo] and to its wrapped copies. NACC independent accumulators per
// destination (1, 2, 4 or 8) set the length of the fmaxf chains. The bodies
// of one destination per thread run under K1's launch bound (512 threads,
// at most 128 registers) and unroll at least 4 offsets, as K1 does; the
// tiled bodies take as many threads as their registers allow.
#pragma once

#include "common.cuh"

namespace {

enum Body : int {
  kFull = 0,
  kRollmax = 1,
  kAddmax = 2,
  kMax = 3,
  kVregroll = 4,
  kRowadd = 5,
  kPipe = 6,  // pipe8
  kTiled = 7,
  kIntrot = 8,
  kSubroll = 9,
  kPipe2 = 10,
  kPipe4 = 11,
  kPipe16 = 12,
  kPipeN = 13,  // pipeG, G at run time (Args::group)
};

constexpr int kRowChunk = 8;       // band rows staged at a time by `rowadd`
constexpr int kMaxTile = 8;        // largest R, the ext buffer's padding
constexpr int kMaxPipe = 32;       // largest group of `pipeN`

// Source loads issued ahead by a `pipe` body; 0 for the other bodies
__host__ __device__ constexpr int pipe_group(int body) {
  return body == kPipe2    ? 2
         : body == kPipe4  ? 4
         : body == kPipe   ? 8
         : body == kPipe16 ? 16
                           : 0;
}

__host__ __device__ constexpr bool tiled_body(int body) {
  return body == kTiled || body == kIntrot || body == kSubroll;
}

__host__ __device__ constexpr bool reads_band(int body) {
  return body != kRollmax && body != kMax && body != kIntrot;
}

// fmaxf as an opaque instruction: `max` repeats fmaxf(acc, p) with the same
// p, which the compiler would otherwise fold into one
__device__ __forceinline__ float opaque_max(float a, float b) {
  float r;
  asm("max.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

struct Args {
  const float* obs;
  const float* band;
  float* out;
  int batch, frames, states, width, lo;
  int pitch;     // floats per ext buffer: states + width - 1 + kMaxTile
  int vstep;     // 128 mod states (vregroll's shift step)
  int nblocks;   // ceil(states / 128)
  int rot0;      // ((-lo) mod states) mod 128 (introt's first rotation)
  int group;     // pipeN's G, in [1, min(width, kMaxPipe)]
};

// Write a new posterior value of destination j into an ext buffer
__device__ __forceinline__ void put(float* e, int j, float v, const Args& a) {
  const int k = j - a.lo;
  const int ext = a.states + a.width - 1;
  e[k] = v;
  if (k >= a.states) e[k - a.states] = v;
  if (k + a.states < ext) e[k + a.states] = v;
}

// Candidates of one destination j for NB sequences, bodies with R = 1
template <int BODY, int NACC, int NB>
__device__ __forceinline__ void candidates(const float* pc, const float* band,
                                           const float* band_s, int d0_band,
                                           int d_begin, int d_end, int j,
                                           const Args& a,
                                           float (&acc)[NB][NACC]) {
  const int S = a.states;
  float own[NB];
  if constexpr (BODY == kAddmax || BODY == kMax) {
#pragma unroll
    for (int n = 0; n < NB; ++n) own[n] = pc[n * a.pitch + j - a.lo];
  }
  // vregroll's shift (128 d) mod S at d_begin
  int vsh = 0;
  if constexpr (BODY == kVregroll) vsh = static_cast<int>(
      (static_cast<long long>(d_begin) * a.vstep) % S);

  auto one = [&](int d, int slot) {
    float bv = 0.f;
    if constexpr (BODY == kRowadd) {
      bv = band_s[(d - d0_band) * S + j];
    } else if constexpr (reads_band(BODY)) {
      bv = __ldg(band + static_cast<size_t>(d) * S + j);
    }
    int k;
    if constexpr (BODY == kVregroll) {
      int src = j - vsh;
      if (src < 0) src += S;
      k = src - a.lo;
      vsh += a.vstep;
      if (vsh >= S) vsh -= S;
    } else {
      k = j + d;
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      if constexpr (BODY == kMax) {
        acc[n][slot] = opaque_max(acc[n][slot], own[n]);
      } else if constexpr (BODY == kAddmax) {
        acc[n][slot] = fmaxf(acc[n][slot], own[n] + bv);
      } else if constexpr (BODY == kRollmax) {
        acc[n][slot] = fmaxf(acc[n][slot], pc[n * a.pitch + k]);
      } else {
        acc[n][slot] = fmaxf(acc[n][slot], pc[n * a.pitch + k] + bv);
      }
    }
  };

  int d = d_begin;
  if constexpr (BODY == kPipeN) {
    // The fixed bodies' loop at a G known only at run time: the register
    // arrays take kMaxPipe slots and the unrolled loops leave at slot G,
    // so every index stays static and a group costs its G slots
    const int G = a.group;
    for (; d + G <= d_end; d += G) {
      float src[NB][kMaxPipe], bv[kMaxPipe];
#pragma unroll
      for (int g = 0; g < kMaxPipe; ++g) {
        if (g == G) break;
        bv[g] = __ldg(band + static_cast<size_t>(d + g) * S + j);
#pragma unroll
        for (int n = 0; n < NB; ++n) src[n][g] = pc[n * a.pitch + j + d + g];
      }
#pragma unroll
      for (int g = 0; g < kMaxPipe; ++g) {
        if (g == G) break;
#pragma unroll
        for (int n = 0; n < NB; ++n)
          acc[n][g % NACC] = fmaxf(acc[n][g % NACC], src[n][g] + bv[g]);
      }
    }
  } else if constexpr (pipe_group(BODY) > 0) {
    constexpr int G = pipe_group(BODY);
    for (; d + G <= d_end; d += G) {
      float src[NB][G], bv[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        bv[g] = __ldg(band + static_cast<size_t>(d + g) * S + j);
#pragma unroll
        for (int n = 0; n < NB; ++n) src[n][g] = pc[n * a.pitch + j + d + g];
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int n = 0; n < NB; ++n)
          acc[n][g % NACC] = fmaxf(acc[n][g % NACC], src[n][g] + bv[g]);
    }
  } else {
    // K1 unrolls its one-accumulator loop by 4 offsets
    constexpr int kStep = NACC < 4 ? 4 : 2 * NACC;
    for (; d + kStep <= d_end; d += kStep) {
#pragma unroll
      for (int s = 0; s < kStep; ++s) one(d + s, s % NACC);
    }
  }
  for (; d < d_end; ++d) one(d, 0);
}

// Candidates of R consecutive destinations j0 .. j0 + R - 1 (tiled bodies)
template <int BODY, int NB, int R>
__device__ __forceinline__ void tile_candidates(const float* pc,
                                                const float* band, int j0,
                                                const Args& a,
                                                float (&acc)[NB][R]) {
  const int S = a.states;
  const int W = a.width;
  // Band columns past the last state are never read
  int cols = S - j0;
  if (cols > R) cols = R;
  auto band_row = [&](int d, float (&bv)[R]) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      bv[r] = r < cols ? __ldg(band + static_cast<size_t>(d) * S + j0 + r)
                       : 0.f;
  };
  if constexpr (BODY == kTiled) {
    // win holds ext[j0 + d0 + i] for i in [0, R): the sources of offset d0
    float win[NB][R];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int r = 0; r < R; ++r) win[n][r] = pc[n * a.pitch + j0 + r];
    int d0 = 0;
    for (; d0 + R <= W; d0 += R) {
      float nxt[NB][R];
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int r = 0; r < R; ++r)
          nxt[n][r] = pc[n * a.pitch + j0 + d0 + R + r];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float bv[R];
        band_row(d0 + i, bv);
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float s = r + i < R ? win[n][r + i] : nxt[n][r + i - R];
            acc[n][r] = fmaxf(acc[n][r], s + bv[r]);
          }
      }
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int r = 0; r < R; ++r) win[n][r] = nxt[n][r];
    }
    for (; d0 < W; ++d0) {
      float bv[R];
      band_row(d0, bv);
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[n][r] = fmaxf(acc[n][r], pc[n * a.pitch + j0 + d0 + r] + bv[r]);
    }
  } else if constexpr (BODY == kIntrot) {
    // All R destinations lie in one 128-state block (R divides 128)
    const int blk = j0 & ~127;
    int len = S - blk;
    if (len > 128) len = 128;
    const int l0 = j0 - blk;
    int rot = a.rot0;
    for (int d = 0; d < W; ++d) {
      // Source lane of destination lane l0: (l0 - rot) mod len
      int base = l0 - rot;
      if (len == 128) {
        base &= 127;
      } else {
        base %= len;
        if (base < 0) base += len;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        int lane = base + r;
        if (lane >= len) lane -= len;
        const int k = blk + lane - a.lo;
#pragma unroll
        for (int n = 0; n < NB; ++n)
          acc[n][r] = fmaxf(acc[n][r], pc[n * a.pitch + k]);
      }
      rot = (rot + 127) & 127;
    }
  } else {  // kSubroll
    int sh = 0;
    for (int d = 0; d < W; ++d) {
      float bv[R];
      band_row(d, bv);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        int src = j0 + r - sh;
        if (src < 0) src += S;
        const int k = src - a.lo;
#pragma unroll
        for (int n = 0; n < NB; ++n)
          acc[n][r] = fmaxf(acc[n][r], pc[n * a.pitch + k] + bv[r]);
      }
      sh += 128;
      if (sh >= 128 * a.nblocks) sh = 0;
    }
  }
}

template <int BODY, int NACC, int NB, int R>
__device__ __forceinline__ void lab_forward_body(const Args& a) {
  extern __shared__ float smem[];
  float* post = smem;                          // [2][NB][pitch]
  float* band_s = smem + 2 * NB * a.pitch;  // rowadd: [kRowChunk + NB][states]
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int b0 = blockIdx.x * NB;
  const int S = a.states;
  const size_t seq = static_cast<size_t>(a.frames) * S;

  bool live[NB];
#pragma unroll
  for (int n = 0; n < NB; ++n) live[n] = b0 + n < a.batch;

  // Frame 0: post = obs[b, 0]; rows past the batch hold 0
  for (int j = tid; j < S; j += nthreads)
#pragma unroll
    for (int n = 0; n < NB; ++n)
      put(post + n * a.pitch, j, live[n] ? a.obs[(b0 + n) * seq + j] : 0.f,
          a);
  __syncthreads();

  for (int t = 1; t < a.frames; ++t) {
    const float* pc = post + ((t - 1) & 1) * NB * a.pitch;
    float* pn = post + (t & 1) * NB * a.pitch;
    const size_t row = static_cast<size_t>(t) * S;
    if constexpr (tiled_body(BODY)) {
      for (int g = tid; g * R < S; g += nthreads) {
        const int j0 = g * R;
        float acc[NB][R];
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int r = 0; r < R; ++r) acc[n][r] = torbi::neg_inf();
        tile_candidates<BODY, NB, R>(pc, a.band, j0, a, acc);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int j = j0 + r;
          if (j < S) {
#pragma unroll
            for (int n = 0; n < NB; ++n) {
              const float o = live[n] ? a.obs[(b0 + n) * seq + row + j] : 0.f;
              put(pn + n * a.pitch, j, o + acc[n][r], a);
            }
          }
        }
      }
    } else if constexpr (BODY == kRowadd) {
      // The band streams through shared memory kRowChunk rows at a time;
      // each destination's maximum over the chunks so far waits in `best`,
      // touched by its own thread only
      float* best = band_s + kRowChunk * S;  // [NB][states]
      for (int d0 = 0; d0 < a.width; d0 += kRowChunk) {
        const int rows = min(kRowChunk, a.width - d0);
        __syncthreads();  // the previous chunk has been read
        for (int e = tid; e < rows * S; e += nthreads)
          band_s[e] = a.band[static_cast<size_t>(d0) * S + e];
        __syncthreads();
        for (int j = tid; j < S; j += nthreads) {
          float acc[NB][NACC];
#pragma unroll
          for (int n = 0; n < NB; ++n)
#pragma unroll
            for (int s = 0; s < NACC; ++s) acc[n][s] = torbi::neg_inf();
          candidates<BODY, NACC, NB>(pc, a.band, band_s, d0, d0, d0 + rows,
                                     j, a, acc);
#pragma unroll
          for (int n = 0; n < NB; ++n) {
            float m = d0 ? best[n * S + j] : torbi::neg_inf();
#pragma unroll
            for (int s = 0; s < NACC; ++s) m = fmaxf(m, acc[n][s]);
            best[n * S + j] = m;
          }
        }
      }
      for (int j = tid; j < S; j += nthreads)
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          const float o = live[n] ? a.obs[(b0 + n) * seq + row + j] : 0.f;
          put(pn + n * a.pitch, j, o + best[n * S + j], a);
        }
    } else {
      for (int j = tid; j < S; j += nthreads) {
        float acc[NB][NACC];
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int s = 0; s < NACC; ++s) acc[n][s] = torbi::neg_inf();
        candidates<BODY, NACC, NB>(pc, a.band, nullptr, 0, 0, a.width, j, a,
                                   acc);
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          float m = acc[n][0];
#pragma unroll
          for (int s = 1; s < NACC; ++s) m = fmaxf(m, acc[n][s]);
          const float o = live[n] ? a.obs[(b0 + n) * seq + row + j] : 0.f;
          put(pn + n * a.pitch, j, o + m, a);
        }
      }
    }
    __syncthreads();
  }

  const float* last = post + ((a.frames - 1) & 1) * NB * a.pitch;
  for (int j = tid; j < S; j += nthreads)
#pragma unroll
    for (int n = 0; n < NB; ++n)
      if (live[n])
        a.out[static_cast<size_t>(b0 + n) * S + j] =
            last[n * a.pitch + j - a.lo];
}

// The bodies of one destination per thread take K1's bound of 512 threads
// (at most 128 registers a thread); the tiled bodies take what their
// registers allow
template <int BODY, int NACC, int NB, int R>
__global__ void __launch_bounds__(512) lab_forward_kernel(Args a) {
  lab_forward_body<BODY, NACC, NB, R>(a);
}

template <int BODY, int NB, int R>
__global__ void lab_tiled_kernel(Args a) {
  lab_forward_body<BODY, 1, NB, R>(a);
}

template <int BODY, int NACC, int NB, int R>
int launch(const Args& a, cudaStream_t stream) {
  void (*kernel)(Args);
  if constexpr (R > 1) {
    kernel = lab_tiled_kernel<BODY, NB, R>;
  } else {
    kernel = lab_forward_kernel<BODY, NACC, NB, R>;
  }
  const size_t smem =
      (2 * static_cast<size_t>(NB) * a.pitch +
       (BODY == kRowadd ? static_cast<size_t>(kRowChunk + NB) * a.states
                        : 0)) *
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
  // As many threads as destinations (or tiles of R), at most 512 and at
  // most what the kernel's registers allow
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const int units = (a.states + R - 1) / R;
  int threads = min(512, attr.maxThreadsPerBlock) / 32 * 32;
  threads = min(threads, (units + 31) / 32 * 32);
  if (threads < 32) return cudaErrorInvalidConfiguration;
  kernel<<<(a.batch + NB - 1) / NB, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int BODY, int NACC, int R>
int by_nb(int nb, const Args& a, cudaStream_t s) {
  switch (nb) {
    case 1: return launch<BODY, NACC, 1, R>(a, s);
    case 2: return launch<BODY, NACC, 2, R>(a, s);
    case 4: return launch<BODY, NACC, 4, R>(a, s);
    case 8: return launch<BODY, NACC, 8, R>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int BODY>
int by_nacc(int n_acc, int nb, const Args& a, cudaStream_t s) {
  switch (n_acc) {
    case 1: return by_nb<BODY, 1, 1>(nb, a, s);
    case 2: return by_nb<BODY, 2, 1>(nb, a, s);
    case 4: return by_nb<BODY, 4, 1>(nb, a, s);
    case 8: return by_nb<BODY, 8, 1>(nb, a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int BODY>
int by_tile(int tile, int nb, const Args& a, cudaStream_t s) {
  switch (tile) {
    case 2: return by_nb<BODY, 1, 2>(nb, a, s);
    case 4: return by_nb<BODY, 1, 4>(nb, a, s);
    case 8: return by_nb<BODY, 1, 8>(nb, a, s);
    default: return cudaErrorInvalidValue;
  }
}

// The launch arguments of the C entry points; false when the shape is
// refused. obs: (batch, frames, states) float32; band: (>= width, states)
// float32, rows d < width read; out: (batch, states) float32. Needs
// 1 <= width <= states.
inline bool make_args(const float* obs, const float* band, float* out,
                      int batch, int frames, int states, int width, Args* a) {
  if (batch <= 0 || frames <= 0 || states <= 0 || width < 1 ||
      width > states)
    return false;
  a->obs = obs;
  a->band = band;
  a->out = out;
  a->batch = batch;
  a->frames = frames;
  a->states = states;
  a->width = width;
  a->lo = -(width / 2);
  a->pitch = states + width - 1 + kMaxTile;
  a->vstep = 128 % states;
  a->nblocks = (states + 127) / 128;
  a->rot0 = ((-a->lo) % states) % 128;
  a->group = 1;
  return true;
}

}  // namespace
