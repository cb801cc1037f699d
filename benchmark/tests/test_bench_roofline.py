"""The work counts of benchmark/roofline.py"""
import torch

from benchmark import inputs, roofline
from benchmark.tests.layout import REPO

import json

PENN = json.loads((REPO / 'benchmark/configs/penn1440-default.json')
                  .read_text())


def test_penn_band_counts():
    probabilities = inputs.transition_probabilities(PENN, 'cpu')
    assert roofline.candidates_per_frame(probabilities) == (244_344, 1440)
    # Each destination's sources with p > 0 are the band lo -87, width 175,
    # clipped to the states
    positive = probabilities > 0
    for d in (0, 500, 1439):
        sources = torch.nonzero(positive[d]).flatten()
        assert int(sources[0]) == max(0, d - 87)
        assert int(sources[-1]) == min(1439, d - 87 + 174)
    operations, _ = roofline.decode_work([2], 1440, 244_344, 1440)
    assert operations == 491_568


def test_dense_count_and_work_at_a_tiny_size():
    dense = torch.full((5, 5), 0.2)
    assert roofline.candidates_per_frame(dense) == (25, 0)
    banded = torch.tensor([[0.5, 0.5, 0.0], [0.3, 0.4, 0.3],
                           [0.0, 0.5, 0.5]])
    pairs, floor = roofline.candidates_per_frame(banded)
    assert (pairs, floor) == (7, 3)
    # Rows of 4 and 1 frames: 3 steps; 5 frames read and written
    operations, moved = roofline.decode_work([4, 1], 3, pairs, floor)
    assert operations == 2 * 3 * (7 + 3)
    assert moved == 4 * (5 * 3 + 7 + 5)
    # One instruction a float32 lane a clock: half the published FLOP/s
    assert roofline.least_seconds(33.5e12, 0) == 1.0
    assert roofline.least_seconds(0, 3.35e12) == 1.0


def test_roofline_share_holds_the_compute_kernels_alone():
    """Copies, fills and collectives are not the kernels' time"""
    from benchmark import spec

    reader = spec.load(REPO / 'benchmark/metrics/decode_roofline.py')
    stretch = {'device_events': 3, 'operations': 33.5e12 / 2, 'bytes': 0,
               'busy_s': 2.0, 'compute_busy_s': 1.0}
    assert reader.read({'stretches': [stretch]}) == 50.0
    assert reader.read({'stretches': [dict(stretch, operations=0)]}) is None
