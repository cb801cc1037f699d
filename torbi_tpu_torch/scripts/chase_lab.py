"""Chase lab on the card: the parts of the batch-1 backtrace step.

Counterpart of the repo's ``scripts/chase_lab.py``. The batch-1 chase (K5,
K6) is a chain of dependent steps; each variant here is a hand-written
CUDA kernel (``csrc/lab_chase.cu``, one CTA) that runs ``frames`` such
steps from index 7, last frame first (f = frames - 1 .. 0, k = f mod 128),
and returns the final index. In natural state order, with S states,
M = ceil(S / 128) and v = trans[idx, c] + post[f, c]:

    scalar_only      idx = (5 idx + k) mod S          the integer chain
    scalar_nomod     idx = (5 idx + k) & 1023
    v2s_floor        idx = (int(trans[idx, 0]) mod S + k) mod S
    v2s_nomod        idx = ((int(trans[idx, 0]) & 1023) + k) & 1023
                                       plus a dependent L2 load
    tree1            idx = lowest argmax of v over c < min(128, S)
                                       plus one warp reduction
    tree12           idx = lowest argmax of v over every state (fused
                     (value, index) pairs)
    two_trees        idx = (s // M) * M mod S, s the lowest argmax of v,
                     by two sequential reductions (max, then the lowest
                     maximal index)
    two_trees_nomod  two_trees with & 1023 in place of mod S

where int() truncates toward zero and mod is floored. The JAX lab works in
the TPU's layout, where stored column c of the transition and the
posterior holds state (c mod 128) * M + c // 128; its tree12, two_trees and
two_trees_nomod are these functions on its inputs with the columns
permuted to states, and its other variants these functions on its inputs
as they are (column 0 is state 0 in both orders; tree1 reads the first 128
stored columns).

``--threads`` sets the shape of tree12 and the two_trees variants: 32 (one
warp, K3's and K6's shape) or 192 (one CTA with a __syncthreads per
reduction, K5's); a comma list runs each. The scalar and v2s variants run
on one thread, tree1 on one warp.

Usage:
    python -m torbi_tpu_torch.scripts.chase_lab \\
        [--variants scalar_only,v2s_floor,tree1,tree12,two_trees] \\
        [--frames 10240] [--states 1440] [--iters 8] [--threads 32,192] \\
        [--device cuda]

It runs on the card (``--device``, default ``cuda``) and raises without
one; on CPU tensors every variant runs its plain version
(``chase_reference``), which is what the CPU tests hold against the JAX
lab.
"""
import argparse
import ctypes
import json

import numpy as np
import torch

from ..csrc import build

# Variant codes of csrc/lab_chase.cu
VARIANTS = {
    'scalar_only': 0, 'scalar_nomod': 1, 'v2s_floor': 2, 'v2s_nomod': 3,
    'tree1': 4, 'tree12': 5, 'two_trees': 6, 'two_trees_nomod': 7}
ROW_VARIANTS = ('tree12', 'two_trees', 'two_trees_nomod')
THREAD_SHAPES = (32, 192)
SEED = 7
# The two_trees kernels keep a row's values in registers
TWO_TREES_MAX_STATES = 2048
# v2s_nomod and two_trees_nomod load rows up to index 1023
NOMOD_MIN_STATES = 1024


def _check_variant(variant, states=None):
    if variant not in VARIANTS:
        raise ValueError(
            f'unknown variant {variant!r}; expected one of {list(VARIANTS)}')
    if (variant in ('v2s_nomod', 'two_trees_nomod') and states is not None
            and states < NOMOD_MIN_STATES):
        raise ValueError(
            f'{variant} reads rows up to 1023: it needs at least '
            f'{NOMOD_MIN_STATES} states, got {states}')


def threads_of(variant, threads=32):
    """Threads the kernel of ``variant`` runs on"""
    _check_variant(variant)
    if variant in ROW_VARIANTS:
        if threads not in THREAD_SHAPES:
            raise ValueError(f'threads must be one of {THREAD_SHAPES}')
        return threads
    return 32 if variant == 'tree1' else 1


def chase_reference(variant, transition, posterior):
    """Plain PyTorch version of a chase variant: the final index (int).

    transition: (states, states) float32; posterior: (frames, states)
    float32.
    """
    states = transition.shape[0]
    _check_variant(variant, states)
    blocks = -(-states // 128)
    idx = SEED
    for f in range(posterior.shape[0] - 1, -1, -1):
        k = f % 128
        if variant == 'scalar_only':
            idx = (idx * 5 + k) % states
        elif variant == 'scalar_nomod':
            idx = (idx * 5 + k) & 1023
        elif variant in ('v2s_floor', 'v2s_nomod'):
            # int() of the float32 value truncates toward zero; Python's %
            # is floored and & acts on two's complement, as the kernel's
            x = int(float(transition[idx, 0]))
            if variant == 'v2s_floor':
                idx = (x % states + k) % states
            else:
                idx = ((x & 1023) + k) & 1023
        else:
            width = min(128, states) if variant == 'tree1' else states
            # torch.argmax returns the first maximal index
            best = int((transition[idx, :width]
                        + posterior[f, :width]).argmax())
            if variant in ('tree1', 'tree12'):
                idx = best
            elif variant == 'two_trees':
                idx = best // blocks * blocks % states
            else:
                idx = best // blocks * blocks & 1023
    return idx


def lab_chase(variant, transition, posterior, threads=32):
    """A chase variant: its kernel (csrc/lab_chase.cu) on CUDA tensors,
    ``chase_reference`` on CPU tensors. Returns a (1,) int32 tensor holding
    the final index."""
    threads = threads_of(variant, threads)
    _check_variant(variant, transition.shape[0])
    device = posterior.device
    if device.type == 'cpu':
        return torch.tensor(
            [chase_reference(variant, transition, posterior)],
            dtype=torch.int32)
    frames, states = posterior.shape
    build.check('transition', transition, (states, states), torch.float32,
                device)
    build.check('posterior', posterior, (frames, states), torch.float32,
                device)
    if (variant in ('two_trees', 'two_trees_nomod')
            and states > TWO_TREES_MAX_STATES):
        raise ValueError(
            f'{variant} takes at most {TWO_TREES_MAX_STATES} states')
    out = torch.empty((1,), dtype=torch.int32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        code = lib.lab_chase(
            build.pointer(transition), build.pointer(posterior),
            build.pointer(out), VARIANTS[variant], threads, frames, states,
            build.stream(device))
    build.raise_on_error(lib, f'lab_chase ({variant}, {threads} threads)',
                         code)
    lab_chase.launches += 1
    return out


lab_chase.launches = 0


def _library():
    lib = build.library('lab_chase')
    lib.lab_chase.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.lab_chase.restype = ctypes.c_int
    return lib


def lab_inputs(frames, states, device):
    """The JAX lab's inputs, from seed 0: a standard-normal transition
    (states, states), then a posterior (frames, states)"""
    rng = np.random.default_rng(0)
    trans = rng.normal(size=(states, states)).astype(np.float32)
    post = rng.normal(size=(frames, states)).astype(np.float32)
    return (torch.from_numpy(trans).to(device),
            torch.from_numpy(post).to(device))


def main(argv=None):
    """Run the lab; returns the 'results' ({label: result row}, the label
    being the variant with ``@threads`` for the row variants, the row
    holding the final index of the last timed call) and the 'inputs'
    (transition, posterior)"""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        '--variants', default='scalar_only,v2s_floor,tree1,tree12,two_trees')
    parser.add_argument('--frames', type=int, default=10240)
    parser.add_argument('--states', type=int, default=1440)
    parser.add_argument('--iters', type=int, default=8)
    parser.add_argument('--threads', default='32')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)

    from ..utils import profile
    from ..utils.convert import resolve_device

    device = resolve_device(args.device)
    shapes = [int(value) for value in args.threads.split(',')]
    runs = []
    for variant in args.variants.split(','):
        for threads in (shapes if variant in ROW_VARIANTS
                        else [threads_of(variant)]):
            threads_of(variant, threads)
            runs.append((variant, threads))
    trans, post = lab_inputs(args.frames, args.states, device)
    results = {}
    for variant, threads in runs:
        label = f'{variant}@{threads}' if variant in ROW_VARIANTS else variant
        last = {}

        def call(variant=variant, threads=threads):
            last['index'] = lab_chase(variant, trans, post, threads)
            return last['index']

        seconds = profile.time_submissions(
            call, lambda result: result[0], args.iters)
        results[label] = {
            'ms_per_call': seconds * 1e3,
            'ns_per_step': seconds / args.frames * 1e9,
            'index': int(last['index'][0])}
        print(json.dumps({label: results[label]}), flush=True)
    print(json.dumps({'frames': args.frames, 'states': args.states,
                      'results': results}), flush=True)
    return {'results': results, 'inputs': (trans, post)}


if __name__ == '__main__':
    main()
