"""The port's reference decoder (``torbi_tpu_torch/reference``) against
torbi_tpu's: the same pitch files, decoded in one process and over a pool
of two ``spawn`` workers, give output files equal to torbi_tpu's, dtype
included."""
import numpy as np
import pytest

import torbi_tpu
import torbi_tpu_torch
from torbi_tpu.utils import io as jax_io
from torbi_tpu_torch.models import pitch
from torbi_tpu_torch.utils import io


@pytest.mark.parametrize('num_threads', [1, 2])
def test_reference_files_equal_jax(tmp_path, num_threads):
    inputs = []
    for i, frames in enumerate((31, 64, 7, 48)):
        path = tmp_path / f'{i:06d}.pt'
        io.save(pitch.synthetic_posteriorgrams(1, frames, seed=i)[0], path)
        inputs.append(path)
    trans_file = tmp_path / 'transition.pt'
    io.save(pitch.transition_matrix(), trans_file)
    got = [tmp_path / f'port-{p.name}' for p in inputs]
    want = [tmp_path / f'jax-{p.name}' for p in inputs]
    torbi_tpu_torch.reference.from_files_to_files(
        inputs, got, transition_file=trans_file, log_probs=True,
        num_threads=num_threads)
    torbi_tpu.reference.from_files_to_files(
        inputs, want, transition_file=trans_file, log_probs=True)
    for got_file, want_file, source in zip(got, want, inputs):
        path, expected = io.load(got_file), jax_io.load(want_file)
        assert path.dtype == expected.dtype == np.int32
        assert path.shape == (io.load(source).shape[0],)
        np.testing.assert_array_equal(path, expected)
