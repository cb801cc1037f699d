"""The seeded inputs of benchmark/inputs.py and of the callers"""
import statistics

import torch

from benchmark import inputs, run, spec
from benchmark.callers import batches
from benchmark.tests.layout import tiny_layout


def test_length_law():
    lengths = inputs.lengths(4096, 400, 0.6, 100, 2000)
    assert lengths == sorted(lengths)
    assert (min(lengths), max(lengths)) == (100, 2000)
    assert abs(statistics.fmean(lengths) - 477.44) < 0.01
    assert statistics.quantiles(lengths, n=20)[18] == 1074.15
    assert statistics.median(lengths) == 400


def test_generators_repeat_from_the_seed():
    first = inputs.posteriorgrams([5, 3], 16, inputs.device_generator(
        2 ** 31 + 11, 'cpu'), 'cpu')
    again = inputs.posteriorgrams([5, 3], 16, inputs.device_generator(
        2 ** 31 + 11, 'cpu'), 'cpu')
    other = inputs.posteriorgrams([5, 3], 16, inputs.device_generator(
        2 ** 31 + 12, 'cpu'), 'cpu')
    assert torch.equal(first, again)
    assert not torch.equal(first, other)
    # Padding is zero; each real frame is a distribution in log space
    assert torch.all(first[1, 3:] == 0)
    assert torch.allclose(torch.logsumexp(first[0], dim=-1),
                          torch.zeros(5), atol=1e-5)
    order = inputs.permuted(list(range(10)), inputs.host_generator(5))
    assert order == inputs.permuted(list(range(10)),
                                    inputs.host_generator(5))
    assert sorted(order) == list(range(10))
    chosen = inputs.sample(100, 8, inputs.host_generator(5), [99])
    assert len(chosen) == 8 and 99 in chosen
    assert chosen == inputs.sample(100, 8, inputs.host_generator(5), [99])


def test_every_seed_decodes_the_same_work(tmp_path):
    """Seeds change the order and the contents, never the set of calls"""
    root = tiny_layout(tmp_path)
    for name in ('tiny-sorted', 'tiny-single'):
        cell = spec.Cell(root, name)
        pools = [batches.Pool(run.Context(cell, seed, 0, False,
                                          torch.device('cpu'), None))
                 for seed in (1, 2, 2)]
        calls = [sorted(map(sorted, pool.lengths)) for pool in pools]
        assert calls[0] == calls[1]
        assert pools[1].lengths == pools[2].lengths
        for a, b in zip(pools[1].observations, pools[2].observations):
            assert torch.equal(a, b)
    sorted_cell = spec.Cell(root, 'tiny-sorted')
    first, second = (batches.Pool(run.Context(
        sorted_cell, seed, 0, False, torch.device('cpu'), None))
        for seed in (1, 2))
    assert first.counts == second.counts
