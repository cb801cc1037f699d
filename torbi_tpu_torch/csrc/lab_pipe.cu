// Forward lab, the `pipeG` bodies: `full`'s function with G source loads
// issued before their G adds and maxima, G = 2, 4, 8 (`pipe`) or 16, each
// at every accumulator count and 1, 2, 4 or 8 sequences per CTA (64
// instances, in a source of their own so that they build beside
// lab_forward.cu's; csrc/lab_forward.cuh holds the shared body).
//
// Replaces the `pipe` branch of scripts/kernel_lab.py::build_kernel, which
// takes any G; this lab takes the four groups above. Bound as `full`'s (a
// shared-memory load per candidate, csrc/lab_forward.cuh); G sets how many
// loads each thread keeps in flight.
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
