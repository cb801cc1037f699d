"""The program's profiler spans (``utils/timing.py``), on the CPU.

With no profiler recording a span enters no ``record_function``; under
``torch.profiler.profile`` every route leaves its ``torbi.*`` ranges,
nested as the decode nests: the entry point, ``torbi.decode`` (nested
again on the memory guard's row groups), the forward and chase kernels by
their launch counters' names, the gather of a split batch, and a rebuilt
cache entry as ``torbi.build``.
"""
import json

import numpy as np
import pytest
import torch

import torbi_tpu_torch
from torbi_tpu_torch.ops import dispatch
from torbi_tpu_torch.utils import cache, timing
from test_autochunk import peaked_case
from torch_sharded_worker import profile_spans, run_world

TINY = np.finfo(np.float32).tiny


def banded_case(batch, frames=24, states=64, seed=0):
    """A log-space observation and a banded log transition (offsets -3..3
    over log(tiny))"""
    rng = np.random.default_rng(seed)
    obs = np.log(rng.dirichlet(np.ones(states) * 0.3, size=(batch, frames))
                 .astype(np.float32) + TINY)
    trans = np.full((states, states), np.log(TINY), np.float32)
    rows = np.arange(states)
    for offset in range(-3, 4):
        keep = (rows + offset >= 0) & (rows + offset < states)
        trans[rows[keep], rows[keep] + offset] = np.log(
            rng.uniform(0.05, 1, keep.sum()))
    bf = np.linspace(frames, frames // 2, batch).astype(np.int32)
    return (torch.from_numpy(obs), torch.from_numpy(bf),
            torch.from_numpy(trans))


def profiled(run):
    """run() under a CPU profile: [(span name, enclosing span name or
    None)] of the ``torbi.*`` ranges in the order they opened"""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as profile:
        run()
    return profile_spans(profile)


def without_builds(found):
    return [pair for pair in found if pair[0] != 'torbi.build']


def decode(obs, bf, trans):
    return torbi_tpu_torch.from_probabilities(
        obs, bf, trans, log_probs=True, gpu='cpu')


def test_no_profiler_enters_no_record_function(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counted(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, 'record_function', counted)
    obs, bf, trans = banded_case(3)
    assert decode(obs, bf, trans).shape == (3, 24)
    assert entered == []
    # The same patch sees the spans once a profiler records
    profiled(lambda: decode(obs, bf, trans))
    assert 'torbi.decode' in entered


@pytest.mark.parametrize('batch, forward, chase', (
    (3, 'band_forward', 'backtrace'),
    (1, 'band_spread', 'backtrace_fused1'),
))
def test_banded_call_nests_its_spans(batch, forward, chase):
    obs, bf, trans = banded_case(batch)
    found = profiled(lambda: decode(obs, bf, trans))
    assert without_builds(found) == [
        ('torbi.from_probabilities', None),
        ('torbi.decode', 'torbi.from_probabilities'),
        (f'torbi.forward.{forward}', 'torbi.decode'),
        (f'torbi.chase.{chase}', 'torbi.decode'),
    ]
    # A fresh transition: its conversion, band detection and band matrix
    # are rebuilt inside the call
    builds = [parent for name, parent in found if name == 'torbi.build']
    assert builds and set(builds) <= {
        'torbi.from_probabilities', 'torbi.decode'}


def test_memory_guard_nests_decode_spans(monkeypatch):
    obs, bf, trans = banded_case(3)
    monkeypatch.setattr(torbi_tpu_torch, 'DECODE_MEMORY_BUDGET', 1)
    found = without_builds(profiled(lambda: decode(obs, bf, trans)))
    assert found[:2] == [('torbi.from_probabilities', None),
                         ('torbi.decode', 'torbi.from_probabilities')]
    # One nested decode a row group of one row, each with its own kernels
    assert found[2:] == 3 * [
        ('torbi.decode', 'torbi.decode'),
        ('torbi.forward.band_spread', 'torbi.decode'),
        ('torbi.chase.backtrace_fused1', 'torbi.decode')]


def test_auto_chunk_route_spans_its_kernels(monkeypatch):
    monkeypatch.setattr(torbi_tpu_torch, 'BATCH1_AUTO_CHUNK', True)
    monkeypatch.setattr(torbi_tpu_torch, 'BATCH1_AUTO_CHUNK_MIN_FRAMES', 128)
    monkeypatch.setattr(torbi_tpu_torch, 'BATCH1_CHUNK_FRAMES', 48)
    obs, trans, init = peaked_case(600, 64, 3)
    chunked = []
    real = dispatch.autochunk.decode_chunked

    def spy(*args, **kwargs):
        chunked.append(real(*args, **kwargs))
        return chunked[-1]

    monkeypatch.setattr(dispatch.autochunk, 'decode_chunked', spy)
    found = without_builds(profiled(lambda: dispatch.decode(
        obs, np.array([600], np.int32), trans, init, device='cpu')))
    assert chunked and chunked[0] is not None
    # The entropy pass and the host plan run inside the plan cache's build
    assert found == [('torbi.decode', None),
                     ('torbi.autochunk.entropy', 'torbi.build'),
                     ('torbi.autochunk.plan', 'torbi.build'),
                     ('torbi.forward.band_forward', 'torbi.decode'),
                     ('torbi.chase.backtrace', 'torbi.decode'),
                     ('torbi.autochunk.stitch', 'torbi.decode')]


def test_dense_route_spans(monkeypatch):
    rng = np.random.default_rng(1)
    obs = np.log(rng.dirichlet(np.ones(16), size=(2, 12)).astype(np.float32))
    trans = np.log(rng.dirichlet(np.ones(16), size=16).astype(np.float32))
    found = without_builds(profiled(lambda: decode(
        torch.from_numpy(obs), None, torch.from_numpy(trans))))
    assert found[2:] == [('torbi.forward.dense_forward', 'torbi.decode'),
                         ('torbi.chase.backtrace', 'torbi.decode')]


def test_decode_sharded_spans_in_a_gloo_world(tmp_path):
    obs, bf, trans = banded_case(5)
    inputs = tmp_path / 'inputs.npz'
    initial = np.log(np.full(64, 1 / 64, np.float32))
    np.savez(inputs, **{'banded/observation': obs.numpy(),
                        'banded/batch_frames': bf.numpy(),
                        'banded/transition': trans.numpy(),
                        'banded/initial': initial})
    for path in run_world('trace', 2, inputs, tmp_path):
        found = [tuple(pair) for pair in json.loads(path.read_text())]
        assert without_builds(found) == [
            ('torbi.decode_sharded', None),
            ('torbi.decode', 'torbi.decode_sharded'),
            ('torbi.forward.band_forward', 'torbi.decode'),
            ('torbi.chase.backtrace', 'torbi.decode'),
            ('torbi.gather', 'torbi.decode_sharded')]


def test_context_accumulates_without_a_device():
    timing.reset()
    with timing.context('torbi'):
        pass
    with timing.context('torbi'):
        pass
    assert set(timing.results()) == {'torbi'}
    assert timing.results()['torbi'] >= 0.0
    timing.reset()
    assert timing.results() == {}


def test_identity_cache_builds_on_a_miss_only():
    store = {}
    tensor = torch.zeros(4)

    def compute():
        return float(tensor.sum())

    def builds():
        return [name for name, _ in profiled(
            lambda: cache.identity_cached(store, tensor, compute))]

    assert builds() == ['torbi.build']
    assert builds() == []
    tensor.add_(1.0)
    assert builds() == ['torbi.build']
    # What the cache cannot key is rebuilt on every call
    assert [name for name, _ in profiled(lambda: cache.identity_cached(
        store, [1.0], lambda: 1.0))] == ['torbi.build']


def test_span_closes_on_an_exception():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as profile:
        with pytest.raises(ValueError):
            with timing.span('torbi.outer'):
                raise ValueError('raised inside a span')
        with timing.span('torbi.after'):
            pass
    assert profile_spans(profile) == [('torbi.outer', None), ('torbi.after', None)]
