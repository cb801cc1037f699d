"""The caller of an in-memory pool of long recordings, one a call.

The mix's keys:

- ``pool``: recordings, made on the card in set-up
  (``benchmark/recordings.py``); ``lengths``: the law of their frames
  (``inputs.lengths``: median, sigma, low, high), in the seed's order;
- ``voicing``: the laws of the voiced and unvoiced runs, each with the
  width of its frames' Gaussian (``bins``);
- ``sample``: recordings, drawn from the seed with the longest among
  them, whose output is checked in every call of the window;
- ``trace_cycles``: whole cycles of the pool that a traced run profiles.

A call is ``from_probabilities(recording, None, transition,
log_probs=True)`` on one (1, frames, states) recording, then its indices
fetched to the host with ``.cpu()``. It passes no ``batch_frames``: the
program caches a recording's split plan per ``batch_frames`` tensor, and
a user decoding a new recording pays for the entropy pass and the plan on
every call, so every call here plans afresh.

The host copy of each checked call's path is compared with the
reference's in ``counts``, outside the call's time, and every copy is
dropped once its call is counted, as a caller who writes each path out
does. So the loop keeps nothing of a call (the call returns True), and
the reference's paths are computed in set-up, before three warm cycles
that let the card's caching allocator stop growing. Holding the paths
(the loop's reservoir of three cycles, on the host or on the card) kept
the allocator calling ``cudaMalloc`` through the window, about 20 times a
cycle, with stalls of 0.1-0.5 s on an H100 (PERF.md).

The answer is each chunk's exact path under the configuration's split
rule, held against the plain chunked reference (``reference/chunked.py``),
whose plan also gives each call's work (``roofline.decode_work`` over its
chunks). Each call also counts the deltas of the program's auto-chunk
counters (``decode_chunked.plans``, ``.rows``, ``.declines``) where the
program has them, and nothing where it has not.
"""
import importlib
import statistics

from benchmark import check, inputs, loop, recordings, roofline
from benchmark.reference import chunked
from benchmark.reference import viterbi as reference

# {count's key: the attribute of the auto-chunk route that holds it}
COUNTERS = {'autochunk_plans': 'plans', 'autochunk_rows': 'rows',
            'autochunk_declines': 'declines'}


def counters(program):
    """{key: value} of the program's auto-chunk counters that it has (a
    dict of counts by reason is summed); {} for none"""
    route = importlib.import_module(
        f'{program.__name__}.ops.autochunk').decode_chunked
    found = {}
    for key, attribute in COUNTERS.items():
        value = getattr(route, attribute, None)
        if value is not None:
            found[key] = sum(value.values()) if isinstance(
                value, dict) else value
    return found


class Pool:
    """A run's inputs: the recordings on the device, the transition, the
    initial distribution, each recording's reference plan and counts, and
    the recordings checked"""

    def __init__(self, ctx):
        config, mix, device = ctx.config, ctx.traffic, ctx.device
        states = int(config['states'])
        threshold = float(config['ENTROPY_THRESHOLD'])
        chunk_frames = int(config['BATCH1_CHUNK_FRAMES'])
        min_frames = int(config['BATCH1_AUTO_CHUNK_MIN_FRAMES'])
        host = inputs.host_generator(ctx.seed)
        self.lengths = inputs.permuted(
            inputs.lengths(int(mix['pool']), **mix['lengths']), host)

        probabilities = inputs.transition_probabilities(config, device)
        self.transition = inputs.log_transition(probabilities)
        self.initial = reference.default_initial(states, device)
        generator = inputs.device_generator(ctx.seed, device)
        self.observations, self.plans = [], []
        voiced = 0
        for frames in self.lengths:
            made = recordings.recording(frames, states, mix['voicing'],
                                        threshold, generator, device)
            self.observations.append(made.observation[None])
            self.plans.append(chunked.plan(
                made.entropy.tolist(), frames, chunk_frames, threshold,
                min_frames))
            voiced += int(made.voiced.sum())
            del made
        self.voiced_share = voiced / sum(self.lengths)

        pairs, floor = roofline.candidates_per_frame(probabilities)
        self.counts = []
        for frames, chunk_plan in zip(self.lengths, self.plans):
            operations, moved = roofline.decode_work(
                [length for _, length in chunk_plan], states, pairs, floor)
            self.counts.append({'frames': frames, 'operations': operations,
                                'bytes': moved})

        pool = len(self.lengths)
        longest = max(range(pool), key=lambda i: self.lengths[i])
        self.checked = inputs.sample(pool, int(mix['sample']), host,
                                     [longest])
        rows = [len(chunk_plan) for chunk_plan in self.plans]
        ctx.log(f'{pool} recordings of {min(self.lengths)}-'
                f'{max(self.lengths)} frames, {sum(self.lengths)} in all; '
                f'voiced share {self.voiced_share}; reference chunks a '
                f'recording {min(rows)}-{max(rows)} (median '
                f'{statistics.median(rows)}), {sum(rows)} in all')

    def samples(self):
        """The checked recordings, (frames, states) each, and their
        plans"""
        return ([self.observations[i][0] for i in self.checked],
                [self.plans[i] for i in self.checked])


def control_samples(ctx):
    """(chunks, lengths, transition, initial) of the recordings a run of
    this cell checks, for the control (``control.py``)"""
    pool = Pool(ctx)
    observations, plans = pool.samples()
    rows = [row for observation, chunk_plan in zip(observations, plans)
            for row in chunked.chunks(observation, chunk_plan)]
    lengths = [length for chunk_plan in plans for _, length in chunk_plan]
    return rows, lengths, pool.transition, pool.initial


def run(ctx):
    pool = Pool(ctx)
    program = ctx.program
    observations, plans = pool.samples()
    paths = dict(zip(pool.checked, (path.cpu() for path in chunked.decode(
        observations, plans, pool.transition, pool.initial))))
    del observations
    ctx.free()
    before, fetched = {}, {}

    def call(i):
        before.clear()
        before.update(counters(program))
        fetched[i] = program.from_probabilities(
            pool.observations[i], None, pool.transition, log_probs=True,
            gpu=ctx.device).cpu()
        return True

    def counts(i):
        found = dict(pool.counts[i])
        for key, value in counters(program).items():
            found[key] = value - before[key]
        output = fetched.pop(i)
        if i in paths:
            found['mismatched_frames'] = check.differing(output[0], paths[i])
            found['checked_calls'] = 1
        return found

    cycle = list(range(len(pool.lengths)))
    for _ in range(3):
        for i in cycle:
            call(i)
            fetched.clear()
    ctx.synchronize()
    window = loop.run(ctx, cycle, call, counts)
    window['memory_peak_bytes'] = ctx.memory_peak()
    window.pop('kept')
    window['checks'] = check.readings(
        window.get('mismatched_frames', 0), window['failed'])
    window['checked'] = {'recordings': len(paths),
                         'calls': window.get('checked_calls', 0),
                         'frames': sum(len(path) for path in paths.values())}
    ctx.log(f"checked {window['checked']}")
    return window
