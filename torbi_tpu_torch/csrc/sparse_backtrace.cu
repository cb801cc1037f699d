// K10: the chase of the sparse (in-list) route.
//
// Replaces K3's use after the dense forward, the TPU's
// torbi_tpu/ops/backtrace.py::_backtrace_kernel_loop (built by
// _build_backtrace), for a transition the in-list route decodes: K3 would
// read a whole transition row (S values) at every step of the chain, and at
// 5617 states the 126 MB matrix does not stay in L2. K9 (sparse_forward.cu)
// already wrote every backpointer as int16, so this chase reads no row.
//
// Per sequence b, with T frames and last = batch_frames[b] - 1:
//   seed = lowest-index argmax of posterior[b] (0 for a row of -inf);
//   out[b, t] = seed for t >= min(last, T - 1); then for t = that .. 1:
//     idx = pointers[b, t, idx]; out[b, t - 1] = idx
// which is K3's path bitwise: K9's pointer is K3's recomputed backpointer.
// Where the seed's value is finite, every state on the path has a finite
// candidate, so the pointer of a state with one source is that source:
// such a step reads the state's in-list (its offset and its one source)
// and not the pointer. Only the states with more sources (madmom's first
// states, one a beat) read their pointer from memory.
//
// Bound on the H100: bytes, the path's in-list entries (2 bytes a step)
// and the indices written (4 bytes a frame), about 6 MB a cycle of the
// dbnbeat-b16-tracks cell; but each sequence is one chain of dependent
// steps, so the time is the chain's latency.
//
// Design: one CTA of 256 threads a sequence: the seed's argmax over the
// CTA (torbi::block_argmax), the tail filled, and the in-lists' offsets and
// sources staged in shared memory (40 KB at 5617 states; read from global
// memory where they do not fit); then one thread chases, each step an
// offset, a source and, at a state of several sources, a pointer.
#include "chase.cuh"

namespace {

__global__ void __launch_bounds__(1024) sparse_backtrace_kernel(
    const short* __restrict__ pointers, const float* __restrict__ posterior,
    const int* __restrict__ batch_frames, const int* __restrict__ offsets,
    const short* __restrict__ sources, int* __restrict__ out, int frames,
    int states, int pairs, int resident) {
  extern __shared__ __align__(16) int smem[];
  __shared__ float seed_v[32];
  __shared__ int seed_i[32];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int b = blockIdx.x;
  const float* last_post = posterior + static_cast<size_t>(b) * states;
  int* row_out = out + static_cast<size_t>(b) * frames;

  int idx = torbi::block_argmax(last_post, states, seed_v, seed_i);
  const float seed_value = last_post[idx];
  const bool finite = seed_value > torbi::neg_inf() &&
                      seed_value < -torbi::neg_inf();
  const int t_top = min(batch_frames[b] - 1, frames - 1);
  for (int p = max(t_top, 0) + tid; p < frames; p += nthreads)
    row_out[p] = idx;

  const int* off = offsets;
  const short* src = sources;
  if (resident) {
    short* s_sources = reinterpret_cast<short*>(smem + states + 1);
    for (int j = tid; j <= states; j += nthreads) smem[j] = offsets[j];
    for (int e = tid; e < pairs; e += nthreads) s_sources[e] = sources[e];
    off = smem;
    src = s_sources;
  }
  __syncthreads();
  if (tid != 0) return;
  const short* seq = pointers + static_cast<size_t>(b) * frames * states;
  for (int t = t_top; t >= 1; --t) {
    const int lo = off[idx];
    if (finite && off[idx + 1] - lo == 1)
      idx = src[lo];
    else
      idx = seq[static_cast<size_t>(t) * states + idx];
    row_out[t - 1] = idx;
  }
}

}  // namespace

// pointers: (batch, frames, states) int16 from sparse_forward; posterior:
// (batch, states) float32; batch_frames: (batch,) int32; offsets: (states +
// 1,) int32 and sources: (pairs,) int16, the in-lists; out: (batch, frames)
// int32. threads: a multiple of 32, at most 1024; resident: stage the
// offsets and sources in shared memory (ops/sparse.py::chase_layout). One
// CTA a sequence. Returns a cudaError_t code.
extern "C" int sparse_backtrace(const short* pointers, const float* posterior,
                                const int* batch_frames, const int* offsets,
                                const short* sources, int* out, int batch,
                                int frames, int states, int pairs,
                                int threads, int resident, void* stream) {
  if (batch <= 0 || frames <= 0 || states <= 0 || pairs < 0 ||
      threads <= 0 || threads > 1024 || threads % 32)
    return cudaErrorInvalidValue;
  const size_t smem =
      resident ? sizeof(int) * (static_cast<size_t>(states) + 1) +
                     sizeof(short) * static_cast<size_t>(pairs)
               : 0;
  const cudaError_t err = cudaFuncSetAttribute(
      sparse_backtrace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  sparse_backtrace_kernel<<<batch, threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      pointers, posterior, batch_frames, offsets, sources, out, frames, states,
      pairs, resident);
  return cudaGetLastError();
}
