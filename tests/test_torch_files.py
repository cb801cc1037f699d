"""The port's file API against torbi_tpu's: from_file, from_file_to_file,
from_files_to_files, from_dataloader, save and save_masked.

The same files, made with numpy from a seed, go through torbi_tpu on the
CPU (its default scan route there) and through the port with gpu='cpu'
(the kernels' plain versions); the output files must be equal bitwise,
dtype included. Observations are peaked synthetic posteriorgrams
(``models/pitch.py``), so that probability-space inputs keep clear margins
(``torch.log`` and ``jnp.log`` differ by one ulp on some inputs). The
transition files hold probabilities: a band (which ``from_file`` takes to
a pure -inf band, ``from_files_to_files`` to a band over log(tiny)), a
random dense matrix, or none (the uniform default).
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import torbi_tpu
import torbi_tpu_torch
from torbi_tpu.utils import io as jax_io
from torbi_tpu_torch import core
from torbi_tpu_torch.data import native
from torbi_tpu_torch.models import pitch
from torbi_tpu_torch.ops import autochunk
from torbi_tpu_torch.utils import io, timing

STATES = 256
LENGTHS = (37, 120, 1, 64)


def band_probabilities(states, halfwidth=8):
    bins = np.arange(states)
    trans = np.clip(
        halfwidth + 1.0 - np.abs(bins[:, None] - bins[None, :]), 0, None)
    return (trans / trans.sum(axis=1, keepdims=True)).astype(np.float32)


def transition_file(tmp_path, kind, states=STATES):
    """The transition's probability file, or None for the uniform default"""
    if kind is None:
        return None
    if kind == 'band':
        trans = band_probabilities(states)
    else:
        trans = np.random.default_rng(5).dirichlet(
            np.ones(states), size=states).astype(np.float32)
    path = tmp_path / f'transition-{kind}.npy'
    np.save(path, trans)
    return path


def corpus(tmp_path, lengths=LENGTHS, log_probs=True, suffix='.npy',
           states=STATES, seed=0):
    """One observation file per length; returns the input paths"""
    files = []
    for i, frames in enumerate(lengths):
        obs = pitch.synthetic_posteriorgrams(1, frames, states,
                                             seed=seed + i)[0]
        if not log_probs:
            obs = np.exp(obs)
        path = tmp_path / f'obs{i}{suffix}'
        io.save(obs, path)
        files.append(path)
    return files


def outputs(tmp_path, files, tag):
    return [tmp_path / f'{Path(f).stem}-{tag}{Path(f).suffix}'
            for f in files]


def assert_same_files(got_files, want_files, lengths):
    for got_file, want_file, frames in zip(got_files, want_files, lengths):
        got, want = jax_io.load(got_file), io.load(want_file)
        assert got.dtype == want.dtype == np.int32
        assert got.shape == (frames,)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('log_probs', [True, False])
@pytest.mark.parametrize('kind', ['band', None, 'dense'])
def test_from_file_equals_jax(tmp_path, log_probs, kind):
    """from_file takes log(x) of the transition file in log space"""
    obs_file, = corpus(tmp_path, (150,), log_probs)
    trans_file = transition_file(tmp_path, kind)
    got = torbi_tpu_torch.from_file(
        obs_file, trans_file, log_probs=log_probs, gpu='cpu')
    want = np.asarray(torbi_tpu.from_file(
        obs_file, trans_file, log_probs=log_probs))
    assert got.dtype == torch.int32 and got.device.type == 'cpu'
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('suffix', ['.pt', '.npy'])
def test_from_file_to_file_equals_jax(tmp_path, suffix):
    obs_file, = corpus(tmp_path, (90,), suffix=suffix)
    trans_file = transition_file(tmp_path, 'band')
    initial = tmp_path / f'initial{suffix}'
    io.save(np.log(np.random.default_rng(6).dirichlet(np.ones(STATES))
                   .astype(np.float32)), initial)
    got, want = tmp_path / f'got{suffix}', tmp_path / f'want{suffix}'
    torbi_tpu_torch.from_file_to_file(
        obs_file, got, trans_file, initial, log_probs=True, gpu='cpu')
    torbi_tpu.from_file_to_file(
        obs_file, want, trans_file, initial, log_probs=True)
    assert_same_files([got], [want], [90])


def test_from_file_auto_chunks_as_jax(tmp_path, monkeypatch):
    """A long single file takes the auto-chunk route in both packages
    (small knobs: auto-chunking from 128 frames, 48-frame chunks; torbi_tpu
    on its kernel route in interpret mode), with equal paths"""
    for package in (torbi_tpu, torbi_tpu_torch):
        monkeypatch.setattr(package, 'BATCH1_AUTO_CHUNK_MIN_FRAMES', 128)
        monkeypatch.setattr(package, 'BATCH1_CHUNK_FRAMES', 48)
    monkeypatch.setattr(torbi_tpu, 'BACKEND', 'pallas')
    monkeypatch.setattr(torbi_tpu, 'BAND_KERNEL_LAYOUT', 'rolled')
    monkeypatch.setattr(
        autochunk, '_FRAME_BUCKETS', tuple(torbi_tpu.FRAME_BUCKETS))
    from torbi_tpu.ops import autochunk as jax_autochunk

    engaged = {}
    for name, module in (('port', autochunk), ('jax', jax_autochunk)):
        orig = module.decode_chunked

        def spy(*args, _orig=orig, _name=name, **kwargs):
            out = _orig(*args, **kwargs)
            engaged[_name] = out is not None
            return out

        monkeypatch.setattr(module, 'decode_chunked', spy)
    obs_file, = corpus(tmp_path, (384,), states=192)
    trans_file = transition_file(tmp_path, 'band', states=192)
    got = torbi_tpu_torch.from_file(
        obs_file, trans_file, log_probs=True, gpu='cpu')
    want = np.asarray(torbi_tpu.from_file(
        obs_file, trans_file, log_probs=True))
    assert engaged == {'port': True, 'jax': True}
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('log_probs', [True, False])
@pytest.mark.parametrize('kind', ['band', None, 'dense'])
def test_from_files_to_files_equals_jax(tmp_path, log_probs, kind):
    """from_files_to_files takes log(x + tiny) of the transition file in
    log space; one native batch"""
    files = corpus(tmp_path, log_probs=log_probs)
    trans_file = transition_file(tmp_path, kind)
    got, want = outputs(tmp_path, files, 'got'), outputs(
        tmp_path, files, 'want')
    counts = dict(native.counts)
    torbi_tpu_torch.from_files_to_files(
        files, got, trans_file, log_probs=log_probs, gpu='cpu')
    assert native.counts['filled'] == counts['filled'] + 1
    torbi_tpu.from_files_to_files(files, want, trans_file,
                                  log_probs=log_probs)
    assert_same_files(got, want, LENGTHS)


@pytest.mark.parametrize('suffix', ['.pt', '.npy'])
def test_from_files_to_files_in_several_batches(tmp_path, monkeypatch,
                                                suffix):
    """BATCH_SIZE 2: several batches, so the decode of one overlaps the
    writes of the one before; .pt files take the Python loader"""
    for package in (torbi_tpu, torbi_tpu_torch):
        monkeypatch.setattr(package, 'BATCH_SIZE', 2)
    lengths = (37, 120, 1, 64, 80)
    files = corpus(tmp_path, lengths, suffix=suffix)
    trans_file = transition_file(tmp_path, 'band')
    got, want = outputs(tmp_path, files, 'got'), outputs(
        tmp_path, files, 'want')
    torbi_tpu_torch.from_files_to_files(
        files, got, trans_file, log_probs=True, gpu='cpu')
    torbi_tpu.from_files_to_files(files, want, trans_file, log_probs=True)
    assert_same_files(got, want, lengths)


@pytest.mark.parametrize('suffix', ['.pt', '.npy'])
def test_from_files_to_files_chunked_equals_jax(tmp_path, monkeypatch,
                                                suffix):
    """MIN_CHUNK_SIZE set in both packages: each file decodes as chunk rows
    that are joined again"""
    for package in (torbi_tpu, torbi_tpu_torch):
        monkeypatch.setattr(package, 'MIN_CHUNK_SIZE', 16)
    lengths = (200, 90)
    files = corpus(tmp_path, lengths, suffix=suffix)
    assert len(torbi_tpu_torch.chunk(io.load(files[0]))) > 2
    trans_file = transition_file(tmp_path, 'band')
    got, want = outputs(tmp_path, files, 'got'), outputs(
        tmp_path, files, 'want')
    torbi_tpu_torch.from_files_to_files(
        files, got, trans_file, log_probs=True, gpu='cpu')
    torbi_tpu.from_files_to_files(files, want, trans_file, log_probs=True)
    assert_same_files(got, want, lengths)


@pytest.mark.parametrize('key', [str, Path])
def test_from_dataloader_keys(tmp_path, key):
    """from_dataloader takes str- or Path-keyed output maps"""
    files = corpus(tmp_path)
    transition = torch.from_numpy(
        np.log(band_probabilities(STATES) + np.float32(1e-30)))
    got = outputs(tmp_path, files, 'got')
    torbi_tpu_torch.from_dataloader(
        torbi_tpu_torch.data.loader(files),
        {key(f): out for f, out in zip(files, got)},
        transition=transition, log_probs=True, gpu='cpu')
    for file, out, frames in zip(files, got, LENGTHS):
        expected = torbi_tpu_torch.from_probabilities(
            io.load(file)[None], transition=transition, log_probs=True,
            gpu='cpu')[0]
        np.testing.assert_array_equal(io.load(out), expected.numpy())


def test_from_dataloader_writes_behind_the_next_decode(tmp_path,
                                                       monkeypatch):
    """Batch n's files are written only after batch n + 1's decode is
    queued; the 'torbi' timing holds the decodes, not the writes"""
    monkeypatch.setattr(torbi_tpu_torch, 'BATCH_SIZE', 2)
    files = corpus(tmp_path)
    events = []
    decode = core._dispatch_decode
    save_masked = core.save_masked

    def spy_decode(observation, *args):
        events.append(('decode', len(observation)))
        return decode(observation, *args)

    def spy_save(tensor, file, length):
        events.append(('save', Path(file).name))
        return save_masked(tensor, file, length)

    monkeypatch.setattr(core, '_dispatch_decode', spy_decode)
    monkeypatch.setattr(core, 'save_masked', spy_save)
    timing.reset()
    torbi_tpu_torch.from_files_to_files(
        files, outputs(tmp_path, files, 'got'), log_probs=True, gpu='cpu')
    assert [kind for kind, _ in events] == [
        'decode', 'decode', 'save', 'save', 'save', 'save']
    assert 'torbi' in timing.results()


def test_save_and_save_masked_equal_jax(tmp_path):
    indices = torch.arange(24, dtype=torch.int32).reshape(2, 12)
    for suffix in ('.pt', '.npy'):
        core.save(indices, tmp_path / f'a{suffix}')
        torbi_tpu.save(indices.numpy(), tmp_path / f'b{suffix}')
        core.save_masked(indices[1], tmp_path / f'c{suffix}', 5)
        torbi_tpu.save_masked(indices[1].numpy(), tmp_path / f'd{suffix}', 5)
        for mine, theirs in (('a', 'b'), ('c', 'd')):
            got = jax_io.load(tmp_path / f'{mine}{suffix}')
            want = io.load(tmp_path / f'{theirs}{suffix}')
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)
        assert io.load(tmp_path / f'c{suffix}').tolist() == list(
            range(12, 17))


def test_packed_batches_write_the_same_files(tmp_path, monkeypatch):
    """torbi_tpu's mod-M packed batches (for its stitched band kernel, run
    here in interpret mode; the states padded to 256 lanes), which the port
    leaves out, change no output file"""
    import torbi_tpu.core as jax_core

    states, lengths = 240, (12, 30, 7)
    files = corpus(tmp_path, lengths, states=states)
    trans_file = transition_file(tmp_path, 'band', states=states)
    monkeypatch.setattr(torbi_tpu, 'BACKEND', 'band')
    monkeypatch.setattr(torbi_tpu, 'BAND_KERNEL_LAYOUT', 'stitched')
    packs = []
    orig = jax_core._pack_eligible
    monkeypatch.setattr(jax_core, '_pack_eligible', lambda *args: (
        packs.append(orig(*args)) or packs[-1]))
    got, want = outputs(tmp_path, files, 'got'), outputs(
        tmp_path, files, 'want')
    torbi_tpu_torch.from_files_to_files(
        files, got, trans_file, log_probs=True, gpu='cpu')
    torbi_tpu.from_files_to_files(files, want, trans_file, log_probs=True)
    assert packs == [True]
    assert_same_files(got, want, lengths)


def test_bucket_split_writes_the_same_files(tmp_path, monkeypatch):
    """torbi_tpu's native loader split at frame buckets, with power-of-two
    subdivision (LOADER_SPLIT_MIN_ROWS), which the port leaves out, changes
    no output file: the port decodes the files in one batch"""
    from torbi_tpu.data.loader import NativeDataLoader as JaxNativeLoader

    lengths = (12, 30, 7, 70, 3, 140, 20, 9, 260)
    files = corpus(tmp_path, lengths)
    trans_file = transition_file(tmp_path, 'band')
    monkeypatch.setattr(torbi_tpu, 'LOADER_SPLIT_MIN_ROWS', 1)
    # Given the shapes, the JAX loader splits without its native library
    # (without it, each batch loads through the Python collate)
    jax_loader = JaxNativeLoader(
        files, batch_size=8, num_threads=1,
        shapes=[np.load(f, mmap_mode='r').shape for f in files])
    assert len(jax_loader) > 2
    assert len(torbi_tpu_torch.data.loader(files)) == 1
    got, want = outputs(tmp_path, files, 'got'), outputs(
        tmp_path, files, 'want')
    torbi_tpu_torch.from_files_to_files(
        files, got, trans_file, log_probs=True, gpu='cpu')
    transition = np.load(trans_file)
    torbi_tpu.from_dataloader(
        jax_loader, {str(f): out for f, out in zip(files, want)},
        transition=np.log(transition + np.finfo(np.float32).tiny),
        log_probs=True)
    assert_same_files(got, want, lengths)
