"""Data loaders of the file APIs.

Counterpart of ``torbi_tpu/data/loader.py``. Two loaders yield the same
batches, ``(observation, batch_frames, batch_chunks, input_files)``:

- ``DataLoader``: the Python path (any ``.pt`` or ``.npy`` file, chunked
  decoding), ``Dataset`` items through ``collate``, loaded ahead of the
  consumer by a pool of threads;
- ``NativeDataLoader``: every input a ``.npy`` file and chunking off; the
  C++ loader (``native.py``) fills each batch with its own threads, outside
  the interpreter's lock, one batch ahead of the consumer. The files are
  sorted by length first, so that a batch's rows pad to similar lengths
  (outputs are keyed by file name, so order does not matter), and batches
  hold at most ``batch_size`` files. With ``pin_memory`` it fills pinned
  buffers from PyTorch's caching host allocator, which reuses a buffer only
  after the copy queued from it has run.

The JAX package's bucket split and power-of-two subdivision of batches
serve the TPU's compiled shapes; here batches are only capped.
"""
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import torbi_tpu_torch
from . import native
from .collate import collate as default_collate
from .dataset import Dataset


class DataLoader:

    def __init__(self, dataset, batch_size, num_workers=0, collate_fn=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.collate_fn = collate_fn or default_collate

    def _batches(self):
        indices = range(len(self.dataset))
        return [
            list(indices[i:i + self.batch_size])
            for i in range(0, len(self.dataset), self.batch_size)]

    def _load_batch(self, index_batch):
        return self.collate_fn([self.dataset[i] for i in index_batch])

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        batches = self._batches()
        if self.num_workers <= 0:
            for index_batch in batches:
                yield self._load_batch(index_batch)
            return

        # Prefetch up to 2 * num_workers batches ahead
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            depth = 2 * self.num_workers
            futures = [
                pool.submit(self._load_batch, b) for b in batches[:depth]]
            next_submit = depth
            for i in range(len(batches)):
                yield futures[i].result()
                futures[i] = None
                if next_submit < len(batches):
                    futures.append(
                        pool.submit(self._load_batch, batches[next_submit]))
                    next_submit += 1


class NativeDataLoader:
    """Batch loader backed by the C++ threaded .npy reader"""

    def __init__(self, input_files, batch_size, num_threads, shapes=None,
                 pin_memory=False):
        self.dataset = Dataset(input_files)
        input_files = [str(f) for f in input_files]
        self.num_threads = max(num_threads, 8)
        self.pin_memory = pin_memory
        # Shapes probed while checking eligibility are reused: each probe
        # is a file open and a header parse
        if shapes is None:
            shapes = [native.probe(f) for f in input_files]
        order = sorted(range(len(input_files)), key=lambda i: shapes[i][0])
        self.input_files = [input_files[i] for i in order]
        self.shapes = [shapes[i] for i in order]
        self.segments = [
            (start, min(start + batch_size, len(order)))
            for start in range(0, len(order), batch_size)]

    def __len__(self):
        return len(self.segments)

    def _load(self, segment):
        start, stop = segment
        files = self.input_files[start:stop]
        shapes = self.shapes[start:stop]
        result = native.load_batch(
            files, max(shape[0] for shape in shapes), shapes[0][1],
            self.num_threads, pin_memory=self.pin_memory)
        if result is None:
            # A file changed since it was probed, or does not parse
            observation, batch_frames, _, _ = default_collate(
                [(Dataset([f])[0][0], f) for f in files])
            result = (torch.from_numpy(observation),
                      torch.from_numpy(batch_frames))
        observation, batch_frames = result
        return observation, batch_frames, [1] * len(files), tuple(files)

    def __iter__(self):
        # Depth-1 prefetch: the next batch's file reads (C++ threads, the
        # interpreter's lock released) overlap the consumer's decode
        with ThreadPoolExecutor(max_workers=1) as pool:
            pending = None
            for segment in self.segments:
                future = pool.submit(self._load, segment)
                if pending is not None:
                    yield pending.result()
                pending = future
            if pending is not None:
                yield pending.result()


def _native_eligible(input_files):
    """Probed (frames, states) per file when the native loader applies,
    else None"""
    if not (torbi_tpu_torch.USE_NATIVE_LOADER
            and torbi_tpu_torch.MIN_CHUNK_SIZE is None
            and len(input_files) > 0
            and all(Path(f).suffix == '.npy' for f in input_files)
            and native.available()):
        return None
    shapes = [native.probe(f) for f in input_files]
    return shapes if all(shape is not None for shape in shapes) else None


def loader(input_files, num_workers=None, collate_fn=None, pin_memory=False):
    """The data loader of ``input_files``: the native loader where it
    applies (every file a two-dimensional float32 .npy, chunking off,
    ``USE_NATIVE_LOADER``), else the Python loader with ``num_workers``
    threads (``NUM_WORKERS`` by default). ``pin_memory`` lets the native
    loader fill pinned buffers, for a decode on the card."""
    if num_workers is None:
        num_workers = torbi_tpu_torch.NUM_WORKERS
    if collate_fn is None:
        shapes = _native_eligible(input_files)
        if shapes is not None:
            return NativeDataLoader(
                input_files, torbi_tpu_torch.BATCH_SIZE, num_workers,
                shapes=shapes, pin_memory=pin_memory)
    return DataLoader(
        Dataset(input_files),
        batch_size=torbi_tpu_torch.BATCH_SIZE,
        num_workers=num_workers,
        collate_fn=collate_fn)
