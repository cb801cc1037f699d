// K9: the sparse (in-list) forward pass.
//
// Replaces no TPU kernel: torbi_tpu decodes every transition no band holds
// with its dense kernel (torbi_tpu/ops/pallas.py::_forward_kernel), over
// all S^2 pairs a frame, as K2 does here. This kernel visits each
// destination's in-list alone, so for a transition whose positive pairs
// are a small share of S^2 (madmom's bar-pointer HMM: 8,934 of 31.55M at
// 5617 states) the work falls by that share.
//
// Per sequence b, with p = conv(obs[b, 0]) + initial and last =
// min(batch_frames[b], frames):
//   for t = 1 .. last - 1, for each destination j, over its in-list
//   (sources i ascending, log values v):
//     best = max_i (p[i] + v); ptr = the lowest i holding it (0 where best
//     is -inf); p'[j] = conv(obs[b, t, j]) + best; pointers[b, t, j] = ptr
//   posterior[b] = p after frame last - 1 (K2's stream freezes there)
// Every candidate outside an in-list is -inf, so the values are K2's
// bitwise (one fp32 add a candidate, the max exact) and the pointer is the
// backpointer K3 recovers from the dense row (ties to the lowest source).
// Rows 0 and from last on of the pointers are not written.
//
// Bound on the H100 (the dbnbeat-b16-tracks cell: 16 tracks a call,
// 1,053,064 frames a cycle at 5617 states): the observation read once,
// 23.7 GB a cycle, 7.1 ms at 3.35 TB/s; the pairs' operations (an add and
// a max for each of 8,934 a frame) 0.56 ms. But each sequence is a chain
// of dependent frames, so one frame's latency decides: on one SM a track
// (one CTA of 1024 threads) a frame takes 5-6 us, its conversions, pointer
// stores and warp-reduced in-lists all on that SM (PERF.md).
//
// Design: a thread-block cluster of C CTAs a sequence (C in 1, 2, 4, 8,
// 16, from the launch's cluster dimension; ops/sparse.py::forward_plan
// picks the largest whose clusters of a batch the card holds at once).
// CTA r owns destinations [r P, (r + 1) P), P = ceil(states / C) rounded
// up to a multiple of 4 (states at C = 1): it converts their observation,
// reduces their in-lists and writes their pointers. Each CTA keeps a whole
// double-buffered copy of the posterior (2 x C P floats), its slice's
// in-lists where they fit (values, offsets relative to the slice's first,
// int16 sources; else they are read from global memory), and a ring of its
// slice's observation (kStages frames, staged kStages - 1 ahead with 4-byte
// cp.async by the destination's owner thread; never a frame past the row's
// length), where the ring fits (STAGED; else each value is loaded on its
// frame). Thread t owns the slice's destinations t, t + T, ...; the
// in-list of its first one stays in registers where it holds one source,
// and so does the lane's part of its warp's first heavy in-list.
//
// A frame: each thread reduces its light destinations' in-lists (at most
// kLight sources) alone, converting each value as it goes, the conversion
// overlapping the in-list's loads (converting the frame's values ahead of
// the exchange's wait made a frame longer on the card). The heavy in-lists
// (madmom's 82 first states, 16-58 sources) are dealt round-robin to the
// CTA's warps from the list of all heavy destinations (`heavy`, ascending;
// the CTA's part found by binary search), so that no warp reduces more
// than ceil(heavy / warps) a frame (at most 2 at madmom's transition in a
// cluster, 3 in one CTA): the lanes stride the list and convert the value
// together, two redux instructions over order-preserving keys take the
// lowest-index maximum, lane 0 stores. Ties keep the lowest source either
// way. Every thread then waits for its own ring copies of the next frame,
// one __syncthreads makes them and the new slice visible to the CTA, and
// warp 0 sends the slice.
//
// The exchange (C > 1), K4's transport (csrc/band_spread.cu,
// csrc/cluster.cuh): one bulk copy of the slice (P floats, cp.async.bulk
// ... mbarrier::complete_tx) into the same place of every other CTA's
// buffer t & 1, completing on that CTA's mbarrier for the buffer. Each CTA
// waits on its own mbarrier for the (C - 1) P floats it expects a frame.
// Frame 0 is computed whole by every CTA (no exchange). No cluster barrier
// runs per frame.
//
// Why the double buffers are safe without one: every CTA expects a slice
// from every other CTA each frame, so a CTA computes frame t + 1 only
// after all have sent frame t, and a CTA sends frame t only after every
// one of its threads has read its frame t - 1 buffer and its own barrier's
// frame t - 1 phase has completed. So when a CTA writes frame t + 1 into
// buffer (t + 1) & 1 of another, that CTA has finished frame t, and with
// it every read of frame t - 1's values in that buffer; and that buffer's
// barrier has completed the phase of frame t - 1, so the new bytes count
// toward frame t + 1's phase (armed by thread 0 once frame t's phase has
// completed; bytes may arrive before the arming: the phase completes once
// both are in). A CTA rewrites its own slice of buffer t & 1, the source of
// its frame-t copies, at frame t + 2, after every other CTA has sent frame
// t + 1 and so received frame t whole. Before it exits, a CTA waits for
// the last frame's bytes and then at a cluster barrier, so no copy lands
// in, or reads from, a CTA that has left.
#include <cooperative_groups.h>

#include "chase.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kStages = 3;   // observation frames in the ring (2 ahead)
constexpr int kLight = 8;    // in-lists this long or shorter: one thread
constexpr int kMaxCluster = 16;
// Registers a thread, at most: 1024 threads fit an SM, and three CTAs of a
// madmom slice at 16 CTAs a track (352 threads; registers are allocated 8
// a thread) do too, so the H100 holds 21 clusters of 16 and a batch of 16
// tracks starts in one wave (at 64 it held 14; chip_smoke.py prints it)
constexpr int kMaxRegisters = 56;

// Shared memory, in the order ops/sparse.py::forward_layout mirrors: the
// two posterior buffers, the ring, the slice's in-lists (values, offsets,
// sources), the two mbarriers (C > 1)
struct Layout {
  int slice;    // P, destinations a CTA
  int width;    // floats a posterior buffer: C P, or states at C = 1
  int ring;     // float offset of the ring (STAGED)
  int lists;    // float offset of the in-lists (resident)
  int bars;     // byte offset of the mbarriers (C > 1)
  size_t bytes;
};

__host__ __device__ inline Layout make_layout(int states, int cluster,
                                              int pairs, bool staged,
                                              bool resident) {
  Layout l;
  const int share = (states + cluster - 1) / cluster;
  l.slice = cluster == 1 ? states : (share + 3) / 4 * 4;
  l.width = cluster == 1 ? states : cluster * l.slice;
  l.ring = 2 * l.width;
  l.lists = l.ring + (staged ? kStages * l.slice : 0);
  size_t end = sizeof(float) * static_cast<size_t>(l.lists);
  if (resident)
    end += (sizeof(float) + sizeof(short)) * static_cast<size_t>(pairs) +
           sizeof(int) * (static_cast<size_t>(l.slice) + 1);
  end = (end + 7) / 8 * 8;
  l.bars = static_cast<int>(end);
  l.bytes = end + (cluster > 1 ? 16 : 0);
  return l;
}

struct Lists {
  const int* offsets;  // the slice's, indexed by local destination
  const short* sources;
  const float* values;
};

// The lowest-index maximum of the warp's (best, best_i) pairs, each lane's
// best_i the lowest of its own maxima (INT_MAX: it saw none); every lane
// gets it, the value copied from a lane that holds it
__device__ __forceinline__ void warp_best(float& best, int& best_i) {
  const unsigned own = best_i == INT_MAX ? 0u : torbi::order_key(best);
  unsigned key = own;
  int index = best_i;
  torbi::warp_argmax_key(key, index);
  const unsigned holder =
      __ballot_sync(0xffffffffu, own == key && best_i == index);
  best = __shfl_sync(0xffffffffu, best, __ffs(holder) - 1);
  best_i = index;
}

// The first index of heavy[0, count) holding a value at least j
__device__ __forceinline__ int lower_bound(const int* __restrict__ heavy,
                                           int count, int j) {
  int lo = 0, hi = count;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(heavy + mid) < j)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <int CONV, bool STAGED>
__global__ void __maxnreg__(kMaxRegisters) sparse_forward_kernel(
    const float* __restrict__ obs, const int* __restrict__ batch_frames,
    const float* __restrict__ initial, const int* __restrict__ offsets,
    const short* __restrict__ sources, const float* __restrict__ values,
    const int* __restrict__ heavy, int heavy_count,
    short* __restrict__ pointers, float* __restrict__ posterior, int frames,
    int states, int pairs, int resident) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const bool spread = C > 1;
  const Layout l = make_layout(states, C, pairs, STAGED, resident);
  const int P = l.slice;
  const int j0 = rank * P;
  const int count = max(0, min(P, states - j0));
  const int first = min(j0, states);  // j0, or states past the last
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int nthreads = blockDim.x;
  const int b = blockIdx.x / C;
  float* post = smem;                // [2][width]
  float* ring = smem + l.ring;       // [kStages][P] when STAGED
  const unsigned bars =
      torbi::smem_address(reinterpret_cast<char*>(smem) + l.bars);

  // The slice's in-lists, its offsets relative to its first entry
  const int e0 = offsets[first];
  Lists lists{offsets + first, sources, values};
  if (resident) {
    float* s_values = smem + l.lists;
    int* s_offsets = reinterpret_cast<int*>(s_values + pairs);
    short* s_sources = reinterpret_cast<short*>(s_offsets + P + 1);
    const int slice_pairs = offsets[first + count] - e0;
    for (int e = tid; e < slice_pairs; e += nthreads) {
      s_values[e] = values[e0 + e];
      s_sources[e] = sources[e0 + e];
    }
    for (int k = tid; k <= count; k += nthreads)
      s_offsets[k] = offsets[first + k] - e0;
    lists = Lists{s_offsets, s_sources, s_values};
  }
  // The slice's heavy destinations: heavy[h_lo, h_hi)
  const int h_lo = lower_bound(heavy, heavy_count, j0);
  const int h_hi = lower_bound(heavy, heavy_count, j0 + count);
  if (spread && tid == 0) {
    torbi::mbarrier_init(bars, 1);
    torbi::mbarrier_init(bars + 8, 1);
    torbi::mbarrier_init_fence();
  }
  const size_t plane = static_cast<size_t>(states);
  const float* seq = obs + static_cast<size_t>(b) * frames * plane;
  short* seq_ptr = pointers + static_cast<size_t>(b) * frames * plane;
  const int last = max(1, min(batch_frames[b], frames));
  const int per = (count + nthreads - 1) / nthreads;
  const int expected = (C - 1) * P * static_cast<int>(sizeof(float));

  // This thread's values of frame f into the ring; a group either way
  auto stage = [&](int f) {
    if (f < last) {
      const float* src = seq + f * plane + j0;
      float* dst = ring + (f % kStages) * P;
      for (int k = tid; k < count; k += nthreads)
        torbi::cp_async4(dst + k, src + k);
    }
    torbi::cp_async_commit();
  };

  // Frame 0, every state in every CTA
  for (int j = tid; j < states; j += nthreads)
    post[j] = torbi::convert_obs<CONV>(seq[j]) + initial[j];
  if constexpr (STAGED) {
    for (int f = 1; f < kStages; ++f) stage(f);
    torbi::cp_async_wait<kStages - 2>();
  }
  // Every barrier of the cluster is set up before any remote operation
  if (spread)
    cluster.sync();
  else
    __syncthreads();
  // Bit k: this thread's destination tid + k T is light (per <= 32). The
  // in-list of its first one (k = 0) stays in registers where it holds one
  // source (madmom's every state but the 82 first: one smem load a frame)
  unsigned light = 0;
  for (int k = 0; k < per; ++k) {
    const int jl = tid + k * nthreads;
    if (jl < count && lists.offsets[jl + 1] - lists.offsets[jl] <= kLight)
      light |= 1u << k;
  }
  int source0 = -1;
  float value0 = 0.0f;
  if ((light & 1u) && lists.offsets[tid + 1] - lists.offsets[tid] == 1) {
    source0 = lists.sources[lists.offsets[tid]];
    value0 = lists.values[lists.offsets[tid]];
  }
  // The warp's first heavy destination (round 0) and the lane's first two
  // entries of its in-list stay in registers too (-1: none), where the list
  // holds at most 64 sources
  const int h0 = h_lo + warp;
  int heavy0 = -1, sa = -1, sb = -1;
  float va = 0.0f, vb = 0.0f;
  if (h0 < h_hi) {
    const int jl = __ldg(heavy + h0) - j0;
    const int lo = lists.offsets[jl];
    const int hi = lists.offsets[jl + 1];
    if (hi - lo <= 64) {
      heavy0 = jl;
      if (lo + lane < hi) {
        sa = lists.sources[lo + lane];
        va = lists.values[lo + lane];
      }
      if (lo + lane + 32 < hi) {
        sb = lists.sources[lo + lane + 32];
        vb = lists.values[lo + lane + 32];
      }
    }
  }

  for (int t = 1; t < last; ++t) {
    const float* row;
    if constexpr (STAGED) {
      stage(t + kStages - 1);
      row = ring + (t % kStages) * P;
    } else {
      row = seq + t * plane + j0;
    }
    if (spread) {
      if (t >= 2)
        torbi::mbarrier_wait(bars + 8 * ((t - 1) & 1), ((t - 2) >> 1) & 1);
      if (tid == 0) torbi::mbarrier_expect(bars + 8 * (t & 1), expected);
    }
    const float* cur = post + ((t - 1) & 1) * l.width;
    float* nxt = post + (t & 1) * l.width + j0;
    short* prow = seq_ptr + t * plane + j0;
    // This thread's light destinations, each on its own
    if (source0 >= 0) {
      const float x = torbi::convert_obs<CONV>(STAGED ? row[tid]
                                                      : __ldcs(row + tid));
      const float best = cur[source0] + value0;
      nxt[tid] = x + best;
      prow[tid] = static_cast<short>(torbi::settle(best, source0));
    }
#pragma unroll 2
    for (int k = source0 >= 0 ? 1 : 0; k < per; ++k) {
      if ((light >> k) & 1u) {
        const int jl = tid + k * nthreads;
        const int lo = lists.offsets[jl];
        const int hi = lists.offsets[jl + 1];
        const float x = torbi::convert_obs<CONV>(STAGED ? row[jl]
                                                        : __ldcs(row + jl));
        float best = torbi::neg_inf();
        int best_i = INT_MAX;
        // Sources rise along the list: only a strictly greater value
        // replaces the first one taken
        for (int e = lo; e < hi; ++e) {
          const int i = lists.sources[e];
          const float v = cur[i] + lists.values[e];
          if (best_i == INT_MAX || v > best) {
            best = v;
            best_i = i;
          }
        }
        nxt[jl] = x + best;
        prow[jl] = static_cast<short>(torbi::settle(best, best_i));
      }
    }
    // The slice's heavy destinations, round-robin over the warps; every
    // lane converts the value (the same instructions lane 0 alone would
    // issue), so the conversion overlaps the in-list's loads
    for (int h = h_lo + warp; h < h_hi; h += warps) {
      float best = torbi::neg_inf();
      int best_i = INT_MAX;
      int jl;
      if (h == h0 && heavy0 >= 0) {
        jl = heavy0;
        if (sa >= 0) {
          best = cur[sa] + va;
          best_i = sa;
        }
        if (sb >= 0) {
          const float v = cur[sb] + vb;
          if (v > best) {
            best = v;
            best_i = sb;
          }
        }
      } else {
        jl = __ldg(heavy + h) - j0;
        const int lo = lists.offsets[jl];
        const int hi = lists.offsets[jl + 1];
        for (int e = lo + lane; e < hi; e += 32) {
          const int i = lists.sources[e];
          const float v = cur[i] + lists.values[e];
          if (best_i == INT_MAX || v > best) {
            best = v;
            best_i = i;
          }
        }
      }
      const float x = torbi::convert_obs<CONV>(STAGED ? row[jl]
                                                      : __ldcs(row + jl));
      warp_best(best, best_i);
      if (lane == 0) {
        nxt[jl] = x + best;
        prow[jl] = static_cast<short>(torbi::settle(best, best_i));
      }
    }
    // The next frame's ring copies of this thread have landed; the
    // barrier shows them, and the new slice, to the whole CTA
    if constexpr (STAGED) torbi::cp_async_wait<kStages - 2>();
    if (spread) torbi::fence_async_shared();
    __syncthreads();
    if (spread && warp == 0) {
      const unsigned src = torbi::smem_address(nxt);
      const unsigned bar = bars + 8 * (t & 1);
      for (int q = lane; q < C; q += 32)
        if (q != rank)
          torbi::bulk_copy(torbi::remote_address(src, q), src,
                           P * static_cast<int>(sizeof(float)),
                           torbi::remote_address(bar, q));
    }
  }
  if constexpr (STAGED) torbi::cp_async_wait_all();
  if (spread) {
    // Every copy into this CTA has landed, then no CTA leaves before the
    // copies out of its memory have landed too
    if (last >= 2)
      torbi::mbarrier_wait(bars + 8 * ((last - 1) & 1),
                           ((last - 2) >> 1) & 1);
    cluster.sync();
  }
  const float* fin = post + ((last - 1) & 1) * l.width + j0;
  float* out = posterior + static_cast<size_t>(b) * states + j0;
  for (int k = tid; k < count; k += nthreads) out[k] = fin[k];
}

using Kernel = void (*)(const float*, const int*, const float*, const int*,
                        const short*, const float*, const int*, int, short*,
                        float*, int, int, int, int);

template <int CONV>
Kernel kernel_of(bool staged) {
  return staged ? sparse_forward_kernel<CONV, true>
                : sparse_forward_kernel<CONV, false>;
}

Kernel kernel_of(int conv, bool staged) {
  switch (conv) {
    case 0:
      return kernel_of<0>(staged);
    case 1:
      return kernel_of<1>(staged);
    case 2:
      return kernel_of<2>(staged);
    default:
      return kernel_of<3>(staged);
  }
}

// The checks the launch and the residency query share; the layout's bytes
// into *smem
cudaError_t check_layout(int states, int pairs, int threads, int cluster,
                         int staged, int resident, size_t* smem) {
  if (states <= 0 || states > 32767 || pairs < 0 || threads <= 0 ||
      threads > kMaxThreads || threads % 32 || cluster < 1 ||
      cluster > kMaxCluster || (cluster & (cluster - 1)))
    return cudaErrorInvalidValue;
  const Layout l =
      make_layout(states, cluster, pairs, staged != 0, resident != 0);
  if ((l.slice + threads - 1) / threads > 32) return cudaErrorInvalidValue;
  *smem = l.bytes;
  return cudaSuccess;
}

}  // namespace

// obs: (batch, frames, states) float32, converted as it is loaded
// (torbi::conversion(log_input, apply_epsilon)); batch_frames: (batch,)
// int32; initial: (states,) float32; offsets: (states + 1,) int32, sources:
// int16 ascending within each destination, values: float32 (the
// in-lists); heavy: (heavy_count,) int32, ascending, every destination of
// more than 8 sources; pointers: (batch, frames, states) int16; posterior:
// (batch, states) float32. The layout (ops/sparse.py::forward_layout):
// cluster, the CTAs a sequence (1, 2, 4, 8 or 16); threads a CTA, a
// multiple of 32, at most 1024, at least a CTA's destinations / 32; pairs,
// the most in-list entries of any CTA's destinations; staged, the
// observation ring in shared memory; resident, the slice's in-lists there
// too. Launches batch clusters. Returns a cudaError_t code.
extern "C" int sparse_forward(const float* obs, const int* batch_frames,
                              const float* initial, const int* offsets,
                              const short* sources, const float* values,
                              const int* heavy, int heavy_count,
                              short* pointers, float* posterior, int batch,
                              int frames, int states, int pairs,
                              int log_input, int apply_epsilon, int threads,
                              int cluster, int staged, int resident,
                              void* stream) {
  size_t smem = 0;
  cudaError_t err = check_layout(states, pairs, threads, cluster, staged,
                                 resident, &smem);
  if (err != cudaSuccess) return err;
  if (batch <= 0 || frames <= 0 || heavy_count < 0)
    return cudaErrorInvalidValue;
  return torbi::launch_cluster(
      kernel_of(torbi::conversion(log_input, apply_epsilon), staged != 0),
      cluster, dim3(batch * cluster), dim3(threads), smem,
      static_cast<cudaStream_t>(stream), 0, obs, batch_frames, initial,
      offsets, sources, values, heavy, heavy_count, pointers, posterior,
      frames, states, pairs, resident);
}

// The clusters of this layout that the card holds at once
// (cudaOccupancyMaxActiveClusters), into *clusters: the one-wave rule of
// ops/sparse.py::forward_plan. Returns a cudaError_t code.
extern "C" int sparse_forward_clusters(int states, int pairs, int threads,
                                       int cluster, int staged, int resident,
                                       int* clusters) {
  size_t smem = 0;
  const cudaError_t err = check_layout(states, pairs, threads, cluster,
                                       staged, resident, &smem);
  if (err != cudaSuccess) return err;
  return torbi::max_active_clusters(kernel_of(0, staged != 0), cluster,
                                    dim3(threads), smem, clusters);
}
