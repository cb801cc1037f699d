"""The caller of pYIN's observations in batches, a batch a call.

The mix's keys:

- ``pool``: utterances, made on the card in set-up (``benchmark/pyin.py``);
  ``lengths``: the law of their frames (``inputs.lengths``: median,
  sigma, low, high);
- ``order``: ``sorted`` (by length, as the port's loader sorts files) or
  ``arrival`` (the seed's order); batches of the configuration's
  ``BATCH_SIZE`` rows, each padded to its longest row, its lengths passed;
- ``voicing``: the laws of the voiced and unvoiced runs; ``frames``: what
  a voiced and an unvoiced frame put on the pitch bins
  (``benchmark/pyin.py``);
- ``sample``: pool rows, drawn from the seed with the longest among
  them, whose output is checked in every call of the cycles that the
  window keeps (``loop.run``);
- ``trace_cycles``: whole cycles of the pool that a traced run profiles.

A call is ``from_probabilities(probabilities, batch_frames, transition,
initial, log_probs=False)`` with pYIN's transition and initial
distribution as probabilities (``reference/pyin.py``, the transition with
row = destination), then its indices fetched to the host with ``.cpu()``.
Each call counts its real frames, its work (``roofline.decode_work`` over
the transition's positive pairs and the floor's max), and the delta of
the program's ``convert.values`` (``ops/dispatch.py``) where the program
has that counter, and nothing where it has not. The checked rows are
decoded by ``reference/viterbi.py`` on the observation, the transition and
the initial distribution converted as the configuration's guarantees
state (``reference/pyin.py``).
"""
import importlib
import time

import torch

from benchmark import check, inputs, loop, pyin, roofline
from benchmark.reference import pyin as reference
from benchmark.reference import viterbi


def counters(program):
    """{'convert_values': the program's ``convert.values``} where it has
    that counter, else {}"""
    convert = importlib.import_module(
        f'{program.__name__}.ops.dispatch').convert
    values = getattr(convert, 'values', None)
    return {} if values is None else {'convert_values': values}


class Pool:
    """A run's inputs: the pool's batches on the device, pYIN's transition
    and initial distribution as probabilities, each batch's counts, and the
    rows checked"""

    def __init__(self, ctx):
        config, mix, device = ctx.config, ctx.traffic, ctx.device
        self.transition, self.initial = reference.hmm(config['pyin'], device)
        bins, _ = reference.sizes(config['pyin'])
        states = int(config['states'])
        if states != 2 * bins or self.transition.shape != (states, states):
            raise ValueError(
                f"the configuration's {states} states are not twice its "
                f'{bins} pitch bins')
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

        generator = inputs.device_generator(ctx.seed, device)
        self.observations = [
            pyin.observations(rows, bins, mix, generator, device)
            for rows in self.lengths]
        self.batch_frames = [
            torch.tensor(rows, dtype=torch.int32, device=device)
            for rows in self.lengths]

        pairs, floor = roofline.candidates_per_frame(self.transition)
        self.counts = []
        for rows in self.lengths:
            operations, moved = roofline.decode_work(
                rows, states, pairs, floor)
            self.counts.append({'frames': sum(rows),
                                'operations': operations, 'bytes': moved})

        longest = max(range(pool), key=lambda i: pool_lengths[i])
        sampled = set(inputs.sample(pool, int(mix['sample']), host,
                                    [longest]))
        self.checked = [(g, row) for g, group in enumerate(groups)
                        for row, i in enumerate(group) if i in sampled]
        ctx.log(f'{pool} utterances of {min(pool_lengths)}-'
                f'{max(pool_lengths)} frames, {sum(pool_lengths)} in all, '
                f'in batches padded to {[max(r) for r in self.lengths]}; '
                f'{pairs} positive pairs of {states} states')

    def samples(self):
        """The checked rows' observations in log space, as the
        guarantees convert them, and their lengths; frees the pool"""
        observations = [
            reference.log_observation(
                self.observations[g][row, :self.lengths[g][row]])
            for g, row in self.checked]
        lengths = [self.lengths[g][row] for g, row in self.checked]
        self.observations = self.batch_frames = None
        return observations, lengths


def control_samples(ctx):
    """(observations, lengths, transition, initial) of the rows a run of
    this cell checks, in log space, for the control (``control.py``)"""
    pool = Pool(ctx)
    return (*pool.samples(), *reference.log_hmm(pool.transition,
                                                pool.initial))


def run(ctx):
    pool = Pool(ctx)
    program = ctx.program
    before = {}

    def call(g):
        before.clear()
        before.update(counters(program))
        return program.from_probabilities(
            pool.observations[g], pool.batch_frames[g], pool.transition,
            pool.initial, log_probs=False, gpu=ctx.device).cpu()

    def counts(g):
        found = dict(pool.counts[g])
        for key, value in counters(program).items():
            found[key] = value - before[key]
        return found

    # Every shape of the cell once
    cycle = list(range(len(pool.lengths)))
    started = time.perf_counter()
    for g in cycle:
        call(g)
    ctx.synchronize()
    ctx.log(f'warm cycle {time.perf_counter() - started} s')
    window = loop.run(ctx, cycle, call, counts)
    window['memory_peak_bytes'] = ctx.memory_peak()

    # The check, once the program's inputs are freed
    observations, lengths = pool.samples()
    ctx.free()
    paths = viterbi.decode_blocks(
        observations, lengths, *reference.log_hmm(pool.transition,
                                                  pool.initial))
    mismatched, outputs = 0, 0
    for kept in window.pop('kept'):
        for (g, row), path in zip(pool.checked, paths):
            output = kept[g]
            mismatched += check.differing(
                None if output is None else output[row], path)
            outputs += 1
    window['checks'] = check.readings(mismatched, window['failed'])
    window['checked'] = {'rows': len(paths), 'outputs': outputs}
    ctx.log(f"checked {window['checked']}")
    return window
