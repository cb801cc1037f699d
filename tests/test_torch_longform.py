"""Long recordings decoded one a call through batch-1 auto-chunking, on
the CPU, against the plain chunked reference of the benchmark
(``benchmark/reference/chunked.py``).

Recordings of voiced and unvoiced runs (``benchmark/recordings.py``) at
128 states under a banded pitch transition, 1,500-3,000 frames, with
auto-chunking from 1,024 frames in chunks of about 256: the program's
paths must equal the reference's bitwise, whether the route plans (a
recording that starts voiced, one that starts unvoiced) or declines for
too few split points (the full path). The route's spans and counters
(``ops/autochunk.py``) are held under a CPU ``torch.profiler``.
"""
import pytest
import torch

import torbi_tpu_torch
from torbi_tpu_torch.ops import autochunk, dispatch
from benchmark import inputs, recordings
from benchmark.reference import chunked, viterbi
from torch_sharded_worker import profile_spans

STATES = 128
CHUNK_FRAMES = 256
MIN_FRAMES = 1024
THRESHOLD = 0.5
# The configuration's voicing, with voiced frames 1 bin wide: a Gaussian
# of 3 bins over 128 states lies near the threshold (entropy 0.52)
VOICING = {
    'voiced': {'median': 25, 'sigma': 0.6, 'low': 5, 'high': 150, 'bins': 1},
    'unvoiced': {'median': 12, 'sigma': 1.0, 'low': 3, 'high': 300,
                 'bins': 200}}
# Two 5-frame voiced runs in 2,000 frames: at most 2 split points
SPARSE = {
    'voiced': {'median': 5, 'sigma': 0.0, 'low': 5, 'high': 5, 'bins': 1},
    'unvoiced': {'median': 1200, 'sigma': 0.0, 'low': 1200, 'high': 1200,
                 'bins': 200}}
PITCH = {'states': STATES, 'transition': {
    'kind': 'penn', 'cents_per_bin': 5, 'octave': 1200,
    'max_octaves_per_second': 35.92, 'hopsize': 8, 'sample_rate': 8000}}


@pytest.fixture
def knobs(monkeypatch):
    monkeypatch.setattr(torbi_tpu_torch, 'BATCH1_AUTO_CHUNK', True)
    monkeypatch.setattr(torbi_tpu_torch, 'BATCH1_AUTO_CHUNK_MIN_FRAMES',
                        MIN_FRAMES)
    monkeypatch.setattr(torbi_tpu_torch, 'BATCH1_CHUNK_FRAMES', CHUNK_FRAMES)
    monkeypatch.setattr(torbi_tpu_torch, 'ENTROPY_THRESHOLD', THRESHOLD)


def transition():
    return inputs.log_transition(
        inputs.transition_probabilities(PITCH, 'cpu'))


def made(frames, laws, voiced_first):
    """The first recording of the seeds from 0 on whose first run is
    voiced (or unvoiced) as asked"""
    for seed in range(64):
        found = recordings.recording(
            frames, STATES, laws, THRESHOLD,
            inputs.device_generator(seed, 'cpu'), 'cpu')
        if bool(found.voiced[0]) == voiced_first:
            return found
    raise AssertionError('no seed gave the first run asked for')


def reference_path(found):
    frames = found.observation.shape[0]
    chunk_plan = chunked.plan(found.entropy.tolist(), frames, CHUNK_FRAMES,
                              THRESHOLD, MIN_FRAMES)
    path, = chunked.decode([found.observation], [chunk_plan], transition(),
                           viterbi.default_initial(STATES))
    return path, chunk_plan


def counts():
    route = autochunk.decode_chunked
    return route.plans, route.rows, dict(route.declines)


def decode(observation, batch_frames=None):
    """The program's path of one (1, frames, states) recording"""
    return torbi_tpu_torch.from_probabilities(
        observation, batch_frames, transition(), log_probs=True,
        gpu='cpu')[0]


@pytest.mark.parametrize('frames, laws, voiced_first, planned', [
    (3000, VOICING, True, True),
    (1500, VOICING, False, True),
    (2000, SPARSE, True, False),
], ids=['starts-voiced', 'starts-unvoiced', 'too-few-splits'])
def test_route_matches_the_chunked_reference(knobs, frames, laws,
                                              voiced_first, planned):
    found = made(frames, laws, voiced_first)
    path, chunk_plan = reference_path(found)
    assert (len(chunk_plan) > 1) == planned
    # The reference's plan is the program's, from its float32 entropy
    port_plan = autochunk.plan_splits(
        autochunk.framewise_entropy(found.observation[None], STATES, True)
        .numpy(), frames, CHUNK_FRAMES)
    if planned:
        assert port_plan[0].tolist() == [start for start, _ in chunk_plan]
        assert port_plan[1].tolist() == [length for _, length in chunk_plan]
    else:
        assert port_plan is None
    plans, rows, declines = counts()
    got = decode(found.observation[None])
    assert torch.equal(got.to(torch.int64), path)
    after = counts()
    assert after[0] == plans + 1
    if planned:
        assert after[1] == rows + len(chunk_plan)
        assert after[2] == declines
    else:
        assert after[1] == rows
        assert after[2] == dict(declines, plan=declines['plan'] + 1)


def test_spans_and_counters_of_a_planned_call(knobs):
    found = made(1500, VOICING, True)
    path, chunk_plan = reference_path(found)
    observation = found.observation[None]
    batch_frames = torch.tensor([1500], dtype=torch.int32)
    plans, rows, declines = counts()
    plan_bytes = autochunk.decode_chunked.plan_bytes
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as profile:
        got = decode(observation, batch_frames)
    spans = [pair for pair in profile_spans(profile)
             if pair[0].startswith('torbi.autochunk.')]
    assert spans == [('torbi.autochunk.entropy', 'torbi.decode'),
                     ('torbi.autochunk.plan', 'torbi.decode'),
                     ('torbi.autochunk.stitch', 'torbi.decode')]
    assert torch.equal(got.to(torch.int64), path)
    assert counts() == (plans + 1, rows + len(chunk_plan), declines)
    # Only the chunks' starts and lengths cross to the device: int32 each
    assert (autochunk.decode_chunked.plan_bytes
            == plan_bytes + 8 * len(chunk_plan))

    # The same observation and batch_frames tensor: nothing is cached, so
    # the call runs the entropy pass and plans again
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as profile:
        again = decode(observation, batch_frames)
    assert [name for name, _ in profile_spans(profile)
            if name.startswith('torbi.autochunk.')] == [
        'torbi.autochunk.entropy', 'torbi.autochunk.plan',
        'torbi.autochunk.stitch']
    assert torch.equal(again, got)
    assert counts() == (plans + 2, rows + 2 * len(chunk_plan), declines)
    assert (autochunk.decode_chunked.plan_bytes
            == plan_bytes + 16 * len(chunk_plan))


@pytest.mark.parametrize('reason', ['memory', 'frames', 'plan'])
def test_declines_count_by_reason(knobs, monkeypatch, reason):
    """Each decline hands the call to the serial route, which decodes the
    full sequence: the reference's one chunk"""
    found = made(2000, SPARSE if reason == 'plan' else VOICING, True)
    valid = 2000
    if reason == 'memory':
        monkeypatch.setattr(torbi_tpu_torch, 'DECODE_MEMORY_BUDGET', 1)
    elif reason == 'frames':
        valid = MIN_FRAMES - 1
    full, = viterbi.decode_blocks(
        [viterbi.stabilised(found.observation)], [valid], transition(),
        viterbi.default_initial(STATES))
    plans, rows, declines = counts()
    plan_bytes = autochunk.decode_chunked.plan_bytes
    got = dispatch.decode(
        found.observation[None], torch.tensor([valid], dtype=torch.int32),
        transition(), viterbi.default_initial(STATES), log_input=True,
        apply_epsilon=True, device='cpu')[0]
    assert torch.equal(got[:valid].to(torch.int64), full)
    assert counts() == (plans + (reason == 'plan'), rows,
                        dict(declines, **{reason: declines[reason] + 1}))
    # A declined call copies no plan to the device
    assert autochunk.decode_chunked.plan_bytes == plan_bytes


def test_the_port_tile_rule_never_declines_the_configurations_plans():
    """The reference leaves out the port's rule that declines a plan whose
    8-row tiles times its longest chunk's frame bucket exceed half the
    recording's bucket: from 10,240 to 180,000 frames at 1,280 frames a
    chunk, with chunks at most min_chunk + 302 frames long (unvoiced runs
    of at most 300 frames), the rule never holds"""
    for valid in range(10240, 180001):
        min_chunk = valid // max(8, -(-valid // 1280))
        tiles = -(-(valid // min_chunk + 1) // 8)
        assert (tiles * autochunk._bucket_frames(min_chunk + 302) * 2
                <= autochunk._bucket_frames(valid))
