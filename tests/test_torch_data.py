"""The port's data pipeline against torbi_tpu's: tensor file IO, collate and
separate, the dataset, the native .npy loader and the loaders.

Inputs are made with numpy from a seed. torbi_tpu's collate pads the states
to a lane multiple and the frames to its decode buckets; the port pads the
frames to the longest row only, so torbi_tpu's batch is compared after
cutting both paddings off (the cut-off part holds only padding). The native
loader builds with g++ here (``csrc/build.py::host_library``).
"""
import os

import numpy as np
import pytest
import torch

import torbi_tpu
import torbi_tpu_torch
from torbi_tpu.data.collate import collate as jax_collate
from torbi_tpu.data.collate import separate as jax_separate
from torbi_tpu.utils import io as jax_io
from torbi_tpu_torch.csrc import build
from torbi_tpu_torch.data import collate, loader, native, separate
from torbi_tpu_torch.data.loader import DataLoader, NativeDataLoader
from torbi_tpu_torch.models import pitch
from torbi_tpu_torch.utils import io


def observations(lengths, states, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(frames, states)).astype(np.float32)
            for frames in lengths]


def write_npy(tmp_path, arrays, prefix='x'):
    files = []
    for i, array in enumerate(arrays):
        file = tmp_path / f'{prefix}{i}.npy'
        np.save(file, array)
        files.append(file)
    return files


@pytest.mark.parametrize('suffix', ['.pt', '.npy'])
@pytest.mark.parametrize('writer', ['port', 'torbi_tpu'])
@pytest.mark.parametrize('dtype', [np.float32, np.int32])
def test_io_across_packages(tmp_path, suffix, writer, dtype):
    """A file written by either package loads through the other (and
    through itself) to the same dtype and values"""
    array = (np.random.default_rng(0).normal(size=(7, 3)) * 100).astype(
        dtype)
    file = tmp_path / f'x{suffix}'
    (io if writer == 'port' else jax_io).save(array, file)
    for load in (io.load, jax_io.load):
        loaded = load(file)
        assert loaded.dtype == dtype
        np.testing.assert_array_equal(loaded, array)


def test_io_saves_tensors_on_any_device(tmp_path):
    """save takes a tensor and writes its dtype; torbi_tpu reads it"""
    indices = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    for suffix in ('.pt', '.npy'):
        io.save(indices, tmp_path / f'i{suffix}')
        loaded = jax_io.load(tmp_path / f'i{suffix}')
        assert loaded.dtype == np.int32
        np.testing.assert_array_equal(loaded, indices.numpy())


@pytest.mark.parametrize('states', [7, 1440])
@pytest.mark.parametrize('chunked', [False, True])
def test_collate_equals_jax(states, chunked):
    """The natural-layout batch is torbi_tpu's with its lane and bucket
    padding cut off; batch_frames, batch_chunks and files are equal"""
    arrays = observations((5, 3, 11), states, seed=1)
    if chunked:
        items = [([arrays[0], arrays[1]], 'a.npy'), ([arrays[2]], 'b.npy')]
    else:
        items = [(array, f'{i}.npy') for i, array in enumerate(arrays)]
    got = collate(items)
    want = jax_collate(items)
    frames = max(len(array) for array in arrays)
    assert got[0].shape == (len(arrays), frames, states)
    np.testing.assert_array_equal(got[0], want[0][:, :frames, :states])
    assert (want[0][:, frames:, :states] == 0).all()
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == np.int32
    assert got[2] == want[2] and got[3] == want[3]


def test_collate_rejects_empty_batch():
    with pytest.raises(ValueError):
        collate([([], 'a.npy')])


def test_separate_equals_jax():
    rng = np.random.default_rng(2)
    indices = rng.integers(0, 50, size=(4, 9)).astype(np.int32)
    batch_frames = np.array([9, 3, 1, 6], np.int32)
    for batch_chunks in ([2, 2], [1, 3], [4]):
        got = separate(indices, batch_chunks, batch_frames)
        want = jax_separate(indices, batch_chunks, batch_frames)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('min_chunk_size', [None, 16])
def test_dataset_equals_jax(tmp_path, monkeypatch, min_chunk_size):
    """Items are (observation, file), chunk lists when MIN_CHUNK_SIZE is
    set, as in torbi_tpu"""
    for package in (torbi_tpu, torbi_tpu_torch):
        monkeypatch.setattr(package, 'MIN_CHUNK_SIZE', min_chunk_size)
    files = write_npy(tmp_path, [
        pitch.synthetic_posteriorgrams(1, 100, 256, seed=3)[0]])
    got, path = torbi_tpu_torch.data.Dataset(files)[0]
    want, _ = torbi_tpu.data.Dataset(files)[0]
    assert path == files[0]
    if min_chunk_size is None:
        np.testing.assert_array_equal(got, want)
    else:
        assert len(got) == len(want) > 1
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_host_library_builds_into_the_build_dir():
    path = build.host_library('loader')
    assert path is not None and path.parent == build.BUILD_DIR
    assert path.name.startswith('libloader-') and path.suffix == '.so'
    assert native.available()


def test_probe_equals_jax(tmp_path):
    from torbi_tpu.data import native as jax_native

    files = write_npy(tmp_path, observations((17, 1), 5, seed=4))
    assert [native.probe(f) for f in files] == [(17, 5), (1, 5)]
    if jax_native.available():
        assert [jax_native.probe(f) for f in files] == [(17, 5), (1, 5)]


def test_probe_rejects_other_files(tmp_path):
    """Three-dimensional, one-dimensional, float64 and .pt files are not
    the native loader's"""
    np.save(tmp_path / 'batched.npy', np.zeros((1, 16, 8), np.float32))
    np.save(tmp_path / 'flat.npy', np.zeros(16, np.float32))
    np.save(tmp_path / 'double.npy', np.zeros((4, 8), np.float64))
    io.save(np.zeros((4, 8), np.float32), tmp_path / 'a.pt')
    for name in ('batched.npy', 'flat.npy', 'double.npy', 'a.pt',
                 'missing.npy'):
        assert native.probe(tmp_path / name) is None


def test_load_batch_equals_collate(tmp_path):
    """The native batch is the Python collate's, bitwise, zero-padded"""
    arrays = observations((10, 4, 1, 7), 6, seed=5)
    files = write_npy(tmp_path, arrays)
    observation, frames = native.load_batch(files, 10, 6, num_threads=3)
    want, want_frames, _, _ = collate(
        [(array, file) for array, file in zip(arrays, files)])
    assert observation.dtype == torch.float32
    assert frames.dtype == torch.int32
    np.testing.assert_array_equal(observation.numpy(), want)
    np.testing.assert_array_equal(frames.numpy(), want_frames)


def test_changed_file_falls_back(tmp_path, monkeypatch):
    """A file that grows between probe and load: the native load fails, the
    loader counts a fallback and loads the batch through the Python path,
    equal to the Python collate of the files as they are now"""
    monkeypatch.setattr(torbi_tpu_torch, 'BATCH_SIZE', 8)
    arrays = observations((6, 9, 3), 5, seed=6)
    files = write_npy(tmp_path, arrays)
    data_loader = loader(files)
    assert isinstance(data_loader, NativeDataLoader)
    grown = observations((20,), 5, seed=7)[0]
    np.save(files[0], grown)
    counts = dict(native.counts)
    (observation, batch_frames, batch_chunks, names), = list(data_loader)
    assert native.counts['fallback'] == counts['fallback'] + 1
    assert native.counts['filled'] == counts['filled']
    by_name = {str(files[0]): grown, str(files[1]): arrays[1],
               str(files[2]): arrays[2]}
    want = collate([(by_name[name], name) for name in names])
    np.testing.assert_array_equal(np.asarray(observation), want[0])
    np.testing.assert_array_equal(np.asarray(batch_frames), want[1])
    assert batch_chunks == [1, 1, 1]


def test_native_loader_sorts_and_caps(tmp_path, monkeypatch):
    """Length-sorted batches of at most BATCH_SIZE files, padded to their
    own longest row, each row its file; every batch filled natively"""
    monkeypatch.setattr(torbi_tpu_torch, 'BATCH_SIZE', 3)
    lengths = (8, 3, 12, 5, 2)
    arrays = observations(lengths, 7, seed=8)
    files = write_npy(tmp_path, arrays)
    data_loader = loader(files)
    assert isinstance(data_loader, NativeDataLoader)
    assert len(data_loader) == 2 and len(data_loader.dataset) == 5
    counts = dict(native.counts)
    batches = list(data_loader)
    assert native.counts['filled'] == counts['filled'] + 2
    assert native.counts['fallback'] == counts['fallback']
    assert [b[1].tolist() for b in batches] == [[2, 3, 5], [8, 12]]
    by_name = {str(f): a for f, a in zip(files, arrays)}
    for observation, batch_frames, batch_chunks, names in batches:
        assert observation.shape[1] == int(batch_frames.max())
        assert batch_chunks == [1] * len(names)
        for row, name, n in zip(observation.numpy(), names,
                                batch_frames.tolist()):
            np.testing.assert_array_equal(row[:n], by_name[name])
            assert (row[n:] == 0).all()


@pytest.mark.parametrize('case', ['pt', 'chunked', 'switched-off'])
def test_python_loader_where_native_does_not_apply(tmp_path, monkeypatch,
                                                   case):
    """.pt files, chunked decoding and USE_NATIVE_LOADER = False take the
    Python loader; its batches equal torbi_tpu's after cutting padding"""
    monkeypatch.setattr(torbi_tpu_torch, 'BATCH_SIZE', 2)
    monkeypatch.setattr(torbi_tpu, 'BATCH_SIZE', 2)
    arrays = [pitch.synthetic_posteriorgrams(1, n, 256, seed=9 + n)[0]
              for n in (40, 25, 33)]
    if case == 'pt':
        files = []
        for i, array in enumerate(arrays):
            io.save(array, tmp_path / f'{i}.pt')
            files.append(tmp_path / f'{i}.pt')
    else:
        files = write_npy(tmp_path, arrays)
    if case == 'chunked':
        for package in (torbi_tpu, torbi_tpu_torch):
            monkeypatch.setattr(package, 'MIN_CHUNK_SIZE', 8)
    if case == 'switched-off':
        monkeypatch.setattr(torbi_tpu_torch, 'USE_NATIVE_LOADER', False)
    data_loader = loader(files)
    assert isinstance(data_loader, DataLoader)
    got = list(data_loader)
    want = list(torbi_tpu.data.DataLoader(
        torbi_tpu.data.Dataset(files), batch_size=2, num_workers=0))
    assert len(got) == len(want) == 2
    if case == 'chunked':
        assert sum(len(batch[1]) for batch in got) > len(files)
    for (obs, bf, chunks, names), (jobs, jbf, jchunks, jnames) in zip(
            got, want):
        np.testing.assert_array_equal(obs, jobs[:, :obs.shape[1], :256])
        np.testing.assert_array_equal(bf, jbf)
        assert chunks == jchunks and names == jnames


def test_loader_prefetch_threads(tmp_path, monkeypatch):
    """The threaded Python loader yields the batches in order"""
    monkeypatch.setattr(torbi_tpu_torch, 'BATCH_SIZE', 2)
    monkeypatch.setattr(torbi_tpu_torch, 'USE_NATIVE_LOADER', False)
    arrays = observations((4, 4, 4, 4, 4), 3, seed=10)
    files = write_npy(tmp_path, arrays)
    batches = list(loader(files, num_workers=2))
    assert [b[0].shape for b in batches] == [(2, 4, 3), (2, 4, 3),
                                             (1, 4, 3)]
    np.testing.assert_array_equal(
        np.concatenate([b[0] for b in batches]), np.stack(arrays))


def test_native_build_uses_a_name_per_process(tmp_path, monkeypatch):
    """Two builds of the loader in one directory do not share a temporary
    file: each process writes its own, then renames it into place"""
    monkeypatch.setattr(build, 'BUILD_DIR', tmp_path)
    names = []
    real_run = build.subprocess.run

    def run(command, **kwargs):
        names.append(command[command.index('-o') + 1])
        return real_run(command, **kwargs)

    monkeypatch.setattr(build.subprocess, 'run', run)
    path = build.host_library('loader')
    assert path.parent == tmp_path and path.exists()
    assert names == [str(path.with_name(
        f'{path.name}.{os.getpid()}.partial'))]
    assert not list(tmp_path.glob('*.partial'))
