// Forward lab, the `pipeG` bodies: `full`'s function with G source loads
// issued before their G adds and maxima: G = 2, 4, 8 (`pipe`) or 16 as
// fixed instances, and any G >= 1 through `pipeN`, whose G is an argument
// (clamped to the band width and to kMaxPipe = 32; fmaxf does not depend on
// order, so the output is `full`'s for every G). Each at every accumulator
// count and 1, 2, 4 or 8 sequences per CTA (80 instances, in a source of
// their own so that they build beside lab_forward.cu's;
// csrc/lab_forward.cuh holds the shared body).
//
// Replaces the `pipe` branch of scripts/kernel_lab.py::build_kernel, which
// takes any G. Bound as `full`'s (a shared-memory load per candidate,
// csrc/lab_forward.cuh); G sets how many loads each thread keeps in
// flight. `pipeN` sizes its register arrays for kMaxPipe loads, so at many
// sequences per CTA it spills where a fixed instance would not.
#include "lab_forward.cuh"

// As lab_forward (csrc/lab_forward.cu), for the Body codes kPipe2, kPipe4,
// kPipe (G = 8) and kPipe16; tile must be 1. Returns a cudaError_t code.
extern "C" int lab_pipe(const float* obs, const float* band, float* out,
                        int body, int n_acc, int tile, int nb, int batch,
                        int frames, int states, int width, void* stream) {
  Args a;
  if (!make_args(obs, band, out, batch, frames, states, width, &a) ||
      tile != 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (body) {
    case kPipe2: return by_nacc<kPipe2>(n_acc, nb, a, s);
    case kPipe4: return by_nacc<kPipe4>(n_acc, nb, a, s);
    case kPipe: return by_nacc<kPipe>(n_acc, nb, a, s);
    case kPipe16: return by_nacc<kPipe16>(n_acc, nb, a, s);
    default: return cudaErrorInvalidValue;
  }
}

// `pipeG` for a G given at run time (the body kPipeN); arguments as
// lab_pipe's, with `group` in place of body and tile. Returns a cudaError_t
// code: cudaErrorInvalidValue when group < 1.
extern "C" int lab_pipe_group(const float* obs, const float* band, float* out,
                              int group, int n_acc, int nb, int batch,
                              int frames, int states, int width,
                              void* stream) {
  Args a;
  if (!make_args(obs, band, out, batch, frames, states, width, &a) ||
      group < 1)
    return cudaErrorInvalidValue;
  a.group = min(group, min(width, kMaxPipe));
  return by_nacc<kPipeN>(n_acc, nb, a, static_cast<cudaStream_t>(stream));
}
