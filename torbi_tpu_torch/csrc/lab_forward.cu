// Forward lab, every body but `pipe` (csrc/lab_forward.cuh says what each
// body measures and what bounds it; lab_pipe.cu holds the `pipe` bodies).
#include "lab_forward.cuh"

// obs: (batch, frames, states) float32; band: (>= width, states) float32,
// rows d < width read; out: (batch, states) float32. body: the Body code;
// n_acc: accumulators per destination (1, 2, 4, 8; bodies with tile 1);
// tile: destinations per thread (1, or 2, 4, 8 for the tiled bodies); nb:
// sequences per CTA (1, 2, 4, 8). Needs 1 <= width <= states. Returns a
// cudaError_t code.
extern "C" int lab_forward(const float* obs, const float* band, float* out,
                           int body, int n_acc, int tile, int nb, int batch,
                           int frames, int states, int width, void* stream) {
  Args a;
  if (!make_args(obs, band, out, batch, frames, states, width, &a))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiled_body(body) != (tile > 1)) return cudaErrorInvalidValue;
  switch (body) {
    case kFull: return by_nacc<kFull>(n_acc, nb, a, s);
    case kRollmax: return by_nacc<kRollmax>(n_acc, nb, a, s);
    case kAddmax: return by_nacc<kAddmax>(n_acc, nb, a, s);
    case kMax: return by_nacc<kMax>(n_acc, nb, a, s);
    case kVregroll: return by_nacc<kVregroll>(n_acc, nb, a, s);
    case kRowadd: return by_nacc<kRowadd>(n_acc, nb, a, s);
    case kTiled: return by_tile<kTiled>(tile, nb, a, s);
    case kIntrot: return by_tile<kIntrot>(tile, nb, a, s);
    case kSubroll: return by_tile<kSubroll>(tile, nb, a, s);
    default: return cudaErrorInvalidValue;
  }
}
