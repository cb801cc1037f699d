"""The caller of an in-memory pool of utterances, a batch a call.

The mix's keys:

- ``entry``: the entry point each call goes through,
  ``from_probabilities`` (``log_probs=True``, the default initial
  distribution) or ``decode_sharded`` (the batch split over the world's
  ranks, one ``all_gather``; the initial distribution passed);
- ``pool``: utterances, made on the card in set-up; ``lengths``: the law
  of their frames (``inputs.lengths``: median, sigma, low, high);
- ``order``: ``sorted`` (by length, as the port's loader sorts files) or
  ``arrival`` (the seed's order);
- ``batch``: rows a call (the configuration's ``BATCH_SIZE`` where
  absent), each batch padded to its longest row, its lengths passed;
- ``sample``: pool rows, drawn from the seed with the longest among
  them, whose output is checked in every call of the cycles that the
  window keeps (``loop.run``);
- ``trace_cycles``: whole cycles of the pool that a traced run profiles.

A call is the entry point, then its indices fetched to the host with
``.cpu()``, as a caller takes them.
"""
import time

import torch

from benchmark import check, inputs, loop, roofline
from benchmark.reference import viterbi as reference


def share(rows, rank, world):
    """This rank's rows of a batch split over ``world`` ranks:
    ceil(rows / world) a rank, in rank order"""
    per = -(-rows // world)
    return min(rank * per, rows), min((rank + 1) * per, rows)


def entries(ctx, transition, initial):
    """{entry name: (call(observation, batch_frames), the conversion the
    entry applies to the observation)}"""
    program = ctx.program

    def from_probabilities(observation, batch_frames):
        return program.from_probabilities(
            observation, batch_frames, transition, log_probs=True,
            gpu=ctx.device)

    def decode_sharded(observation, batch_frames):
        return program.parallel.decode_sharded(
            observation, batch_frames, transition, initial,
            finite_observation=True, device=ctx.device)

    return {'from_probabilities': (from_probabilities, reference.stabilised),
            'decode_sharded': (decode_sharded, lambda x: x)}


class Pool:
    """A run's inputs: the pool's batches on the device, the transition,
    the initial distribution, each batch's counts, and the rows checked"""

    def __init__(self, ctx):
        config, mix, device = ctx.config, ctx.traffic, ctx.device
        states = int(config['states'])
        batch = int(mix.get('batch') or config['BATCH_SIZE'])
        host = inputs.host_generator(ctx.seed)
        pool_lengths = inputs.permuted(
            inputs.lengths(int(mix['pool']), **mix['lengths']), host)
        pool = len(pool_lengths)
        order = list(range(pool))
        if mix['order'] == 'sorted':
            order.sort(key=lambda i: pool_lengths[i])
        groups = [order[k:k + batch] for k in range(0, pool, batch)]
        self.lengths = [[pool_lengths[i] for i in group] for group in groups]

        probabilities = inputs.transition_probabilities(config, device)
        self.transition = inputs.log_transition(probabilities)
        self.initial = reference.default_initial(states, device)
        generator = inputs.device_generator(ctx.seed, device)
        self.observations = [
            inputs.posteriorgrams(rows, states, generator, device)
            for rows in self.lengths]
        self.batch_frames = [
            torch.tensor(rows, dtype=torch.int32, device=device)
            for rows in self.lengths]
        self.decode, self.convert = entries(
            ctx, self.transition, self.initial)[mix['entry']]

        # The work of this card: its rows of each batch
        pairs, floor = roofline.candidates_per_frame(probabilities)
        self.counts = []
        for rows in self.lengths:
            start, stop = (share(len(rows), ctx.rank, ctx.world)
                           if mix['entry'] == 'decode_sharded'
                           else (0, len(rows)))
            operations, moved = roofline.decode_work(
                rows[start:stop], states, pairs, floor)
            self.counts.append({'frames': sum(rows),
                                'operations': operations, 'bytes': moved})

        longest = max(range(pool), key=lambda i: pool_lengths[i])
        sampled = set(inputs.sample(pool, int(mix['sample']), host,
                                    [longest]))
        self.checked = [(g, row) for g, group in enumerate(groups)
                        for row, i in enumerate(group) if i in sampled]

    def samples(self):
        """The checked rows' observations, as the entry point converts
        them, and their lengths; frees the pool"""
        observations = [
            self.convert(
                self.observations[g][row, :self.lengths[g][row]].clone())
            for g, row in self.checked]
        lengths = [self.lengths[g][row] for g, row in self.checked]
        self.observations = self.batch_frames = None
        return observations, lengths


def control_samples(ctx):
    """(observations, lengths, transition, initial) of the rows a run of
    this cell checks, for the control (``control.py``)"""
    pool = Pool(ctx)
    return (*pool.samples(), pool.transition, pool.initial)


def run(ctx):
    pool = Pool(ctx)

    def call(g):
        return pool.decode(pool.observations[g], pool.batch_frames[g]).cpu()

    # Every shape of the cell once (a world twice, timing the second)
    cycle = list(range(len(pool.lengths)))
    for _ in range(2 if ctx.world > 1 else 1):
        ctx.barrier()
        started = time.perf_counter()
        for g in cycle:
            call(g)
        ctx.synchronize()
        cycle_seconds = time.perf_counter() - started
    window = loop.run(ctx, cycle, call, lambda g: pool.counts[g],
                      ctx.agree_cycles(cycle_seconds))
    window['memory_peak_bytes'] = ctx.memory_peak()

    # The check, once the program's inputs are freed
    observations, lengths = pool.samples()
    ctx.free()
    paths = reference.decode_blocks(
        observations, lengths, pool.transition, pool.initial)
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
