"""Closed-form decode of a constant transition.

Counterpart of the constant branch of ``torbi_tpu/ops/dispatch.py``
(:340-360). When every candidate is the same ``floor`` (a width-0 band
over a finite floor, such as the uniform default), the Viterbi recursion
needs neither a posterior stream nor a chase:

- forward: post[t][s] = fl(obs[t][s] + m_t) with the scalar per-sequence
  carry m_t = fl(g_{t-1} + floor), g_t = max_s post[t][s]. Rounding is
  monotone, so max_s fl(obs[s] + c) = fl(max_s obs[s] + c), and g follows
  a scalar recurrence over the observation's frame maxima (``recurrence``);
- backtrace: every destination's backpointer is the same first argmax of
  fl(post[t-1] + floor).

The reductions (the frame maxima, the argmax passes) are torch ops, as
torbi_tpu computes them in XLA. The recurrence is the kernel K7
(``csrc/constant.cu``: a chain lane per sequence, copy warps moving the
maxima in and the carry out; launched by the plan ``recurrence_plan``) on
the card and its plain version, a loop over the frames, on the CPU. Every
fp add happens in the order of the JAX package's closed form, so the
result is bitwise the banded recursion's. A parallel scan
(``torch.cumsum``) would add in another order and is not used.
"""
import ctypes

import torch

from ..csrc import build
from .dense import _sms

# K7's ring (csrc/constant.cu, kStages): slots of ``tile`` frames per
# sequence
RECURRENCE_STAGES = 4
RECURRENCE_MAX_SEQUENCES = 32       # the lanes of the chain warp
RECURRENCE_MAX_TILE = 1024
RECURRENCE_SMEM_BYTES = 48 * 1024   # the ring's most, per CTA
RECURRENCE_GROUP = 16               # frames a chain step moves


def recurrence_plan(batch, frames, sms=132):
    """K7's launch plan for ``batch`` sequences of ``frames`` on ``sms``
    SMs: ``sequences`` a CTA, as few as spread the batch over every SM
    (at most the chain warp's 32 lanes); ``tile`` frames a ring slot (a
    multiple of 16), about a quarter of the sequence so that the ring
    holds a short one whole and the chain starts after the first quarter,
    at most RECURRENCE_MAX_TILE and what RECURRENCE_SMEM_BYTES holds for
    ``sequences``. Returns a dict: sequences, blocks, tile, tiles,
    smem_bytes."""
    sequences = min(RECURRENCE_MAX_SEQUENCES, max(1, -(-batch // sms)))
    group = RECURRENCE_GROUP
    fit = ((RECURRENCE_SMEM_BYTES // (4 * sequences) - 4)
           // RECURRENCE_STAGES // group * group)
    quarter = -(-frames // (RECURRENCE_STAGES * group)) * group
    tile = max(group, min(RECURRENCE_MAX_TILE, fit, quarter))
    return {'sequences': sequences, 'blocks': -(-batch // sequences),
            'tile': tile, 'tiles': -(-frames // tile),
            'smem_bytes': 4 * sequences * (RECURRENCE_STAGES * tile + 4)}


def recurrence_reference(maxima, g0, batch_frames, floor):
    """Plain PyTorch version of K7: the carry of frames 1 .. frames-1.

    maxima: (batch, frames) float32, each observation frame's maximum
    g0: (batch,) float32, each first posterior's maximum
    batch_frames: (batch,) int32; a sequence's carry freezes from its
        last valid frame on
    floor: the transition's constant, a Python float

    Returns ms, (batch, frames - 1) float32, ms[b, t-1] = m_t.
    """
    batch, frames = maxima.shape
    device = maxima.device
    floor_t = torch.tensor(floor, dtype=torch.float32, device=device)
    ms = torch.empty(
        (batch, max(frames - 1, 0)), dtype=torch.float32, device=device)
    g = g0
    for t in range(1, frames):
        gm = g + floor_t                                 # m_t
        ms[:, t - 1] = gm
        # Freeze past each sequence's last valid frame
        g = torch.where(t < batch_frames, maxima[:, t] + gm, g)
    return ms


def recurrence(maxima, g0, batch_frames, floor):
    """The carry of the closed form: K7 (csrc/constant.cu, launched by
    ``recurrence_plan``) on CUDA tensors, ``recurrence_reference`` on CPU
    tensors. Arguments and result as there, each tensor contiguous. Counts
    one launch per call on the card (none when there is no frame to
    carry)."""
    device = maxima.device
    if device.type == 'cpu':
        return recurrence_reference(maxima, g0, batch_frames, floor)
    batch, frames = maxima.shape
    build.check('maxima', maxima, (batch, frames), torch.float32, device)
    build.check('g0', g0, (batch,), torch.float32, device)
    build.check('batch_frames', batch_frames, (batch,), torch.int32, device)
    ms = torch.empty(
        (batch, max(frames - 1, 0)), dtype=torch.float32, device=device)
    if batch and frames > 1:
        plan = recurrence_plan(batch, frames, _sms(device))
        lib = _library()
        with torch.cuda.device(device):
            code = lib.constant_recurrence(
                build.pointer(maxima), build.pointer(g0),
                build.pointer(batch_frames), float(floor), build.pointer(ms),
                batch, frames, plan['sequences'], plan['tile'],
                build.stream(device))
        build.raise_on_error(lib, 'constant_recurrence', code)
        recurrence.launches += 1
    return ms


recurrence.launches = 0


def decode_constant(observation, batch_frames, initial, floor):
    """Closed-form decode of a converted (batch, frames, states)
    observation under a constant transition ``floor``; ``batch_frames``
    (batch,) int32, ``initial`` (states,). Returns (batch, frames) int32,
    positions from ``batch_frames[b] - 1`` on holding the seed; a
    ``batch_frames`` past ``frames`` decodes as ``frames``."""
    batch, frames, _ = observation.shape
    device = observation.device
    floor_t = torch.tensor(floor, dtype=torch.float32, device=device)
    bf = batch_frames

    post0 = observation[:, 0, :] + initial[None, :]     # (B, S)
    g0 = post0.amax(dim=1)                               # (B,)
    maxima = observation.amax(dim=2)                     # (B, T)
    ms = recurrence(maxima, g0, bf, floor)               # (B, T-1)

    # Backpointers: first argmax of fl(post + floor) per frame
    pred0 = (post0 + floor_t).argmax(dim=1)
    pred_rest = (
        (observation[:, 1:, :] + ms[:, :, None]) + floor_t).argmax(dim=2)
    pred = torch.cat([pred0[:, None], pred_rest], dim=1).to(torch.int32)

    # Seed: first argmax of the posterior at each row's last valid frame
    last = (bf.long() - 1).clamp(0, frames - 1)          # (B,)
    rows = torch.arange(batch, device=device)
    obs_last = observation[rows, last]                   # (B, S)
    m_last = torch.nn.functional.pad(ms, (1, 1))[rows, last][:, None]
    post_last = torch.where(
        (last == 0)[:, None], post0, obs_last + m_last)
    seed = post_last.argmax(dim=1).to(torch.int32)

    t = torch.arange(frames, device=device)[None, :]
    # Positions bf-1 .. T-1 hold the seed
    return torch.where(t >= bf[:, None] - 1, seed[:, None], pred)


def _library():
    lib = build.library('constant')
    lib.constant_recurrence.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_float, ctypes.c_void_p] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.constant_recurrence.restype = ctypes.c_int
    return lib
