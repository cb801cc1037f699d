"""The caller of madmom's DBN beat tracker over full-length tracks, a batch
a call.

The mix's keys:

- ``pool``: tracks, their activations drawn from the seed
  (``benchmark/beats.py``) and their log densities made on the card in
  set-up; ``lengths``: the law of their frames (``inputs.lengths``:
  median, sigma, low, high);
- ``order``: ``sorted`` (by length) or ``arrival`` (the seed's order);
  batches of the configuration's ``BATCH_SIZE`` rows, each padded to its
  longest row, its lengths passed;
- ``activations``: the activations' laws (``benchmark/beats.py``);
- ``sample``: tracks, drawn from the seed with the longest among them,
  whose paths are checked in every call of the window;
- ``trace_cycles``: whole cycles of the pool that a traced run profiles.

A call is ``from_probabilities(densities, batch_frames, transition,
initial, log_probs=True)`` with madmom's transition (row = destination,
zeros -inf) and its uniform initial distribution, as float32 logs
(``reference/beats.py``), then its indices fetched to the host with
``.cpu()``. The reference's paths of the checked tracks (madmom's sparse
Viterbi, ``reference/beats.py``) are computed in set-up, and each checked
call's copy is compared with them in ``counts``, outside the call's time,
then dropped, as a caller who writes each path out does. The comparison
is ``check.differing``'s, in numpy: torch's elementwise ops on the host
stalled for tens of ms a call on the card's machine (the traced gaps of
``aten::ne``), and the window holds that time. The peak memory is read
from after that set-up, so it is the program's and the pool's.
Each call counts its real frames, its work (``roofline.decode_work`` over
the transition's positive pairs and the floor's max; the in-list
kernels' own work, ``sparse_work.py``), and the delta of the program's
``viterbi_forward_sparse.pairs`` where the program has that counter, and
nothing where it has not.
"""
import importlib

import numpy as np
import torch

from benchmark import beats, check, inputs, loop, roofline, sparse_work
from benchmark.reference import beats as reference


def differing(output, path):
    """``check.differing`` of a host output row and a numpy path: the
    frames where they differ, all of them where the output is missing or
    too short"""
    length = len(path)
    if output is None or output.ndim != 1 or output.shape[0] < length:
        return length
    return int(np.count_nonzero(output[:length].numpy() != path))


def counters(program):
    """{'sparse_pairs': the program's ``viterbi_forward_sparse.pairs``}
    where it has that counter, else {}"""
    try:
        module = importlib.import_module(f'{program.__name__}.ops.sparse')
    except ImportError:
        return {}
    pairs = getattr(getattr(module, 'viterbi_forward_sparse', None),
                    'pairs', None)
    return {} if pairs is None else {'sparse_pairs': pairs}


class Pool:
    """A run's inputs: the pool's batches of log densities on the device,
    madmom's HMM, each batch's counts, and the tracks checked"""

    def __init__(self, ctx):
        config, mix, device = ctx.config, ctx.traffic, ctx.device
        dbn = config['dbn']
        self.edges, self.transition, self.initial = reference.hmm(
            dbn, device)
        states = int(config['states'])
        if self.transition.shape != (states, states):
            raise ValueError(
                f"the configuration's {states} states are not madmom's "
                f'{self.transition.shape[0]}')
        batch = int(config['BATCH_SIZE'])
        host = inputs.host_generator(ctx.seed)
        pool_lengths = inputs.permuted(
            inputs.lengths(int(mix['pool']), **mix['lengths']), host)
        pool = len(pool_lengths)
        order = list(range(pool))
        if mix['order'] == 'sorted':
            order.sort(key=lambda i: pool_lengths[i])
        groups = [order[k:k + batch] for k in range(0, pool, batch)]
        self.lengths = [[pool_lengths[i] for i in group] for group in groups]

        tracks = beats.activations(pool_lengths, mix['activations'],
                                   dbn['fps'], host)
        self.observations = [
            beats.log_densities([tracks[i] for i in group], dbn, device)
            for group in groups]
        self.batch_frames = [
            torch.tensor(rows, dtype=torch.int32, device=device)
            for rows in self.lengths]

        pairs, floor = roofline.candidates_per_frame(
            torch.exp(self.transition))
        self.counts = []
        for rows in self.lengths:
            operations, moved = roofline.decode_work(
                rows, states, pairs, floor)
            forward_ops, forward_bytes = sparse_work.forward_work(
                rows, states, pairs)
            self.counts.append({
                'frames': sum(rows), 'operations': operations,
                'bytes': moved, 'sparse_forward_operations': forward_ops,
                'sparse_forward_bytes': forward_bytes,
                'sparse_chase_bytes': sparse_work.chase_work(rows)[1]})

        longest = max(range(pool), key=lambda i: pool_lengths[i])
        sampled = set(inputs.sample(pool, int(mix['sample']), host,
                                    [longest]))
        self.checked = [(g, row) for g, group in enumerate(groups)
                        for row, i in enumerate(group) if i in sampled]
        ctx.log(f'{pool} tracks of {min(pool_lengths)}-{max(pool_lengths)} '
                f'frames, {sum(pool_lengths)} in all, in batches padded to '
                f'{[max(r) for r in self.lengths]}; {pairs} positive pairs '
                f'of {states} states')

    def samples(self):
        """The checked tracks' log densities, stabilised as
        ``from_probabilities(..., log_probs=True)`` takes them, and their
        lengths"""
        observations = [
            reference.stabilised(
                self.observations[g][row, :self.lengths[g][row]])
            for g, row in self.checked]
        return observations, [self.lengths[g][row] for g, row in self.checked]


def control_samples(ctx):
    """(observations, lengths, transition, initial) of the tracks a run of
    this cell checks, in log space, for the control (``control.py``)"""
    pool = Pool(ctx)
    observations, lengths = pool.samples()
    pool.observations = None
    return observations, lengths, pool.transition, pool.initial


def reference_paths(pool):
    """{(batch, row): the reference's path on the host} of the checked
    tracks, decoded together"""
    observations, lengths = pool.samples()
    batch = torch.zeros((len(lengths), max(lengths),
                         observations[0].shape[-1]), dtype=torch.float32,
                        device=observations[0].device)
    for row, observation in enumerate(observations):
        batch[row, :lengths[row]] = observation
    del observations
    decoded = reference.decode(batch, lengths, pool.edges, pool.initial)
    return {key: decoded[row, :lengths[row]].cpu().numpy()
            for row, key in enumerate(pool.checked)}


def run(ctx):
    pool = Pool(ctx)
    program = ctx.program
    paths = reference_paths(pool)
    ctx.free()
    if ctx.device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(ctx.device)
    before, fetched = {}, {}

    def call(g):
        before.clear()
        before.update(counters(program))
        fetched[g] = program.from_probabilities(
            pool.observations[g], pool.batch_frames[g], pool.transition,
            pool.initial, log_probs=True, gpu=ctx.device).cpu()
        return True

    def counts(g):
        found = dict(pool.counts[g])
        for key, value in counters(program).items():
            found[key] = value - before[key]
        output = fetched.pop(g)
        checked = [(row, path) for (b, row), path in paths.items()
                   if b == g]
        if checked:
            found['mismatched_frames'] = sum(
                differing(output[row], path) for row, path in checked)
            found['checked_calls'] = 1
        return found

    # Every shape of the cell once
    cycle = list(range(len(pool.lengths)))
    for g in cycle:
        call(g)
        fetched.clear()
    ctx.synchronize()
    window = loop.run(ctx, cycle, call, counts)
    window['memory_peak_bytes'] = ctx.memory_peak()
    window.pop('kept')
    window['checks'] = check.readings(
        window.get('mismatched_frames', 0), window['failed'])
    window['checked'] = {'tracks': len(paths),
                         'calls': window.get('checked_calls', 0),
                         'frames': sum(len(path) for path in paths.values())}
    ctx.log(f"checked {window['checked']}")
    return window
