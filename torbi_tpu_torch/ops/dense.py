"""Dense Viterbi forward pass.

Counterpart of ``torbi_tpu/ops/pallas.py``: the forward recursion for any
transition the banded kernel does not take,

    score[j] = max_i(posterior[i] + transition[j, i])
    posterior'[j] = observation[t, j] + score[j]   (frozen for t >= batch_frames)

computing values only. Like the banded pass it streams the posterior of
every frame, and ops/backtrace.py recovers the backpointers along the
chosen path, lowest source index first on ties.
"""
import ctypes

import torch

from ..csrc import build

# K2's launch plan (csrc/dense_forward.cu): a thread's register tile of
# TILE sequences x TILE destinations, at most MAX_THREADS threads a CTA,
# within the opt-in shared memory of the H100 (227 KB)
TILE = 4
MAX_THREADS = 512
SMEM_BYTES = 232448
# The plan's cost model, in clocks of one CTA per frame: FP32 instructions
# per candidate (an add and a max) at 128 a clock; the bytes it reads from
# L2 at 20 a clock, in flight while it computes; two barriers and a wait a
# chunk at 500 clocks. The last two from timing every plan at 12 shapes
# (scripts/dense_timing.py --sweep, H100 at 700 W): a streamed slice cost
# 19-27 bytes a clock over the resident one at equal chunks, an extra
# chunk 490-820 clocks; with L2 at 20 or less and a chunk at 400-800 the
# plan is within 0.7% of the fastest plan at every one of the 12 shapes
FP32_PER_CLOCK = 128
L2_BYTES_PER_CLOCK = 20
CHUNK_CLOCKS = 500
# The plan's fields in the order csrc/dense_forward.cu takes them
PLAN_FIELDS = ('bc', 'bp', 'jc', 'groups', 'dest_groups', 'split', 'chunk',
               'resident', 'vec', 'threads')


def _ceil(value, divisor):
    return -(-value // divisor)


def chunk_stride(chunk):
    """Shared row stride of a chunk, in floats: chunk + 4, a multiple of 4
    whose quarter is odd (chunk is a multiple of 8), so that 16-byte loads
    of 8 consecutive rows fall on the 32 banks once"""
    return chunk + 4


def slice_stride(sources, chunk, resident):
    """Shared row stride of the transition slice: its ``sources`` (the
    whole row, or a band's window) rounded up to 8, plus 4, when it stays
    resident; else a chunk's"""
    return _ceil(sources, 8) * 8 + 4 if resident else chunk_stride(chunk)


def band_window(states, jc, width):
    """The most sources of one CTA's window in K1's wide-band design
    (csrc/band_wide.cu, max_window) for ``jc`` destinations of a band of
    this width: jc + width - 1, widened to 4 floats at both ends, within
    the states rounded up to 4; none for a width-0 band"""
    if width == 0:
        return 0
    return min(_ceil(states, 4) * 4, _ceil(jc + width + 2, 4) * 4)


def smem_bytes(plan, states):
    """Shared memory of a plan: the transition slice (whole, or two
    chunks) and two chunks of a pass's posterior rows; a plan of the
    wide-band design (one with a ``window``) holds the slice over its
    window and also a (bp, jc / 4) table of row maxima, bc floor terms and
    the bc sequences' batch_frames"""
    wide = 'window' in plan
    slice_floats = plan['jc'] * slice_stride(
        plan['window'] if wide else states, plan['chunk'], plan['resident'])
    floor_floats = (plan['bp'] * (plan['jc'] // TILE) + 2 * plan['bc']
                    if wide else 0)
    return 4 * ((1 if plan['resident'] else 2) * slice_floats
                + 2 * plan['bp'] * chunk_stride(plan['chunk'])
                + floor_floats)


def dense_plans(batch, states, resident, smem=SMEM_BYTES, width=None):
    """Every launch plan of K2 that fits: how ``resident`` CTAs (one per
    SM, all held at once) share the (batch x states) outputs of every
    frame. Given a band ``width``, the plans of K1's wide-band design
    (csrc/band_wide.cu) instead: K2's plans over each CTA's source window
    (``band_window``, the plan's ``window``) in place of the whole row.

    The CTAs form ``groups`` sequence groups of ``dest_groups`` CTAs; CTA
    (g, d) owns sequences [g bc, g bc + bc) and destinations [d jc, d jc +
    jc), each thread a TILE x TILE tile of them in passes of ``bp``
    sequences, ``split`` lanes per tile cell (each every split-th group of
    4 sources) when the cells are few. A CTA reads its sequences'
    posterior in chunks of ``chunk`` sources, double-buffered (``vec``:
    16-byte asynchronous copies, when the states are a multiple of 4);
    its transition slice stays in shared memory for the launch
    (``resident``) or streams with the chunks. For each group count the
    plans of both slice modes that fit, each with the largest chunk that
    fits and its modelled time per frame (``cost``, in clocks): the larger
    of the CTA's candidates at two FP32 instructions each and the bytes it
    reads from L2, over the row or the window, plus its chunks' barriers.
    Each plan is a dict with those fields, ``ctas``, ``threads`` and
    ``smem_bytes``."""
    for groups in range(1, min(batch, resident) + 1):
        per_group = _ceil(_ceil(batch, groups), TILE) * TILE
        jc = _ceil(_ceil(states, resident // groups), TILE) * TILE
        dest_groups = _ceil(states, jc)
        sources = states if width is None else band_window(states, jc, width)
        if jc // TILE > MAX_THREADS:
            continue
        # Sequences in passes of bp, so that a pass's cells fit the threads
        passes = _ceil((per_group // TILE) * (jc // TILE), MAX_THREADS)
        bp = _ceil(_ceil(per_group, passes), TILE) * TILE
        bc = passes * bp
        if _ceil(batch, bc) != groups:
            continue
        cells = (bp // TILE) * (jc // TILE)
        split = 1
        while split < 32 and 2 * split * cells <= MAX_THREADS:
            split *= 2
        step = max(8, 4 * split)
        for streamed in (False, True):
            plan = {
                'groups': groups, 'dest_groups': dest_groups, 'bc': bc,
                'bp': bp, 'jc': jc, 'split': split, 'chunk': step,
                'resident': not streamed, 'vec': states % 4 == 0,
                'threads': _ceil(split * cells, 32) * 32,
                'ctas': groups * dest_groups}
            if width is not None:
                plan['window'] = sources
            if smem_bytes(plan, states) > smem:
                continue
            # The largest chunk that fits, up to the whole row or window
            while (plan['chunk'] < sources and smem_bytes(
                    dict(plan, chunk=plan['chunk'] + step), states) <= smem):
                plan['chunk'] += step
            plan['smem_bytes'] = smem_bytes(plan, states)
            read = (bc + (jc if streamed else 0)) * sources * 4
            plan['cost'] = (
                max(2 * bc * jc * sources / FP32_PER_CLOCK,
                    read / L2_BYTES_PER_CLOCK)
                + passes * _ceil(sources, plan['chunk']) * CHUNK_CLOCKS)
            yield plan


def dense_plan(batch, states, resident, smem=SMEM_BYTES):
    """K2's launch plan: of ``dense_plans``, the one of least ``cost``
    (the fewest groups, then the resident slice, on ties), or None when
    no plan fits"""
    return min(dense_plans(batch, states, resident, smem),
               key=lambda plan: plan['cost'], default=None)


def dense_forward_reference(observation, batch_frames, transition, initial):
    """Plain PyTorch version of the dense forward kernel (K2).

    observation: (batch, frames, states) float32 log-probabilities
    batch_frames: (batch,) int32
    transition: (states, states) float32, row = destination
    initial: (states,) float32

    Returns (post_seq, posterior) as ops/band.py::band_forward_reference.
    """
    frames = observation.shape[1]
    post = observation[:, 0, :] + initial[None, :]
    post_seq = torch.empty_like(observation)
    post_seq[:, 0] = post
    for t in range(1, frames):
        score = (post[:, None, :] + transition[None, :, :]).amax(dim=-1)
        valid = (t < batch_frames)[:, None]
        post = torch.where(valid, observation[:, t, :] + score, post)
        post_seq[:, t] = post
    return post_seq, post_seq[:, -1]


def viterbi_forward_dense(observation, batch_frames, transition, initial,
                          plan=None):
    """Dense forward pass: the K2 kernel (csrc/dense_forward.cu) on CUDA
    tensors, its plain version on CPU tensors. Arguments and results as in
    ``dense_forward_reference``; all tensors contiguous on one device.
    ``plan`` replaces the launch plan ``dense_plan`` picks for the card."""
    device = observation.device
    if device.type == 'cpu':
        return dense_forward_reference(
            observation, batch_frames, transition, initial)
    batch, frames, states = observation.shape
    build.check('observation', observation, (batch, frames, states),
                torch.float32, device)
    build.check('batch_frames', batch_frames, (batch,), torch.int32, device)
    build.check('transition', transition, (states, states), torch.float32,
                device)
    build.check('initial', initial, (states,), torch.float32, device)
    post_seq = torch.empty_like(observation)
    if batch and frames:
        plan = dict(plan or dense_plan(batch, states, _sms(device)) or {})
        if not plan:
            raise ValueError(
                f'no launch plan of the dense forward kernel holds {batch} '
                f'x {states} states')
        # The 16-byte copies read the transition rows too
        plan['vec'] = plan['vec'] and transition.data_ptr() % 16 == 0
        counters = torch.zeros(
            (plan['groups'],), dtype=torch.int32, device=device)
        lib = _library()
        with torch.cuda.device(device):
            code = lib.dense_forward(
                build.pointer(observation), build.pointer(batch_frames),
                build.pointer(initial), build.pointer(transition),
                build.pointer(post_seq), build.pointer(counters), batch,
                frames, states, *(int(plan[key]) for key in PLAN_FIELDS),
                build.stream(device))
        build.raise_on_error(lib, 'dense_forward', code)
        viterbi_forward_dense.launches += 1
    return post_seq, post_seq[:, -1]


viterbi_forward_dense.launches = 0


def _sms(device):
    """The CTAs the card holds at once for K2: one per SM"""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _library():
    lib = build.library('dense_forward')
    lib.dense_forward.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * (3 + len(PLAN_FIELDS)) + [ctypes.c_void_p]
    lib.dense_forward.restype = ctypes.c_int
    return lib
