"""End-to-end evaluation artifact over synthetic 1440-state corpora.

The port's counterpart of the repo's ``scripts/eval_synth.py``. The daps
and vctk corpora need a download and penn, so this script builds the same
kind of artifact from synthetic corpora of peaked 1440-state pitch
posteriorgrams (``models/pitch.py::synthetic_posteriorgrams``, the clipped
walks of the repo's benchmark) pushed through the unmodified evaluation
harness: the reference decode on the CPU (kept on disk, resumable file by
file), this package's decode through ``from_files_to_files`` on the card,
the RPA metrics and the speed accounting.

    python -m torbi_tpu_torch.scripts.eval_synth --reference-only \\
        --num-threads 8                       # CPU, slow, resumable
    python -m torbi_tpu_torch.scripts.eval_synth          # decode, score

Configurations score through the same machinery: ``--batch-size 1`` as
``torbi_tpu_torch/config/nobatch.py``, ``--min-chunk N`` the chunked mode,
``--eval-backend scan`` the plain route, or ``--config FILE ...``. The
results JSON is copied to ``ROOT_DIR/eval/<name>.json``; the name is
``--config-name``, else the ``CONFIG`` a ``--config`` file sets, else
``synth-h100``. The corpora and reference outputs live under
``--workdir`` (``~/.cache/torbi_tpu_torch/synth_eval``), apart from the
JAX script's.
"""
import json
import os
import shutil
from pathlib import Path

import numpy as np

# Two corpora mirror the two evaluation datasets (daps, vctk); 'synth' and
# 'synthsweep' are the JAX script's smaller corpora
DATASET_SEEDS = {
    'synthdaps': 11, 'synthvctk': 7011, 'synth': 11, 'synthsweep': 4242}

# Stem counts at the evaluation's scale: EVALUATION_SAMPLES (8192) per
# dataset, but the shipped daps partition holds 700 stems
DATASET_FILES = {'synthdaps': 700, 'synthvctk': 8192}

# The artifact's name when neither --config-name nor a --config file
# names it
DEFAULT_NAME = 'synth-h100'


def build_corpus(workdir, dataset, n_files, min_frames, max_frames, seed):
    """Synthetic log-space posteriorgram corpus and its partition file.

    Files are written once (the seed fixes their contents) in the cache
    layout the harness expects, ``CACHE_DIR/<dataset>/<stem>.pt``. The
    generation parameters are kept beside the corpus, and cached files are
    reused only when they match; otherwise the corpus and its reference
    outputs are rebuilt. Returns (stems, frame counts).
    """
    from ..models.pitch import synthetic_posteriorgrams

    cache = workdir / 'cache' / dataset
    cache.mkdir(parents=True, exist_ok=True)
    meta_path = workdir / 'cache' / f'{dataset}_meta.json'
    meta = {'n_files': n_files, 'min_frames': min_frames,
            'max_frames': max_frames, 'seed': seed,
            # generator 2: clipped (non-wrapping) pitch walks; a wrapped
            # walk decodes legitimately differently under the log(p + tiny)
            # floor than under the reference's exact zeros, which would
            # break the RPA@0 = 1.0 exactness contract
            'generator': 2}
    stale = True
    if meta_path.exists():
        with open(meta_path) as file:
            stale = json.load(file) != meta
    elif not any(cache.iterdir()):
        stale = False  # nothing to rebuild; a new directory just fills
    if stale:
        shutil.rmtree(cache)
        cache.mkdir(parents=True)
        refs = workdir / 'eval' / dataset / 'reference'
        if refs.exists():
            shutil.rmtree(refs)
    with open(meta_path, 'w') as file:
        json.dump(meta, file)
    rng = np.random.default_rng(seed)
    lengths = rng.integers(min_frames, max_frames, size=n_files)
    stems = [f'{i:06d}' for i in range(n_files)]

    import torch
    for i, (stem, frames) in enumerate(zip(stems, lengths)):
        path = cache / f'{stem}.pt'
        if path.exists():
            continue
        obs = synthetic_posteriorgrams(1, int(frames), 1440, seed=seed + i)[0]
        torch.save(torch.from_numpy(obs), path)

    partitions = workdir / 'partitions'
    partitions.mkdir(exist_ok=True)
    with open(partitions / f'{dataset}.json', 'w') as file:
        json.dump(stems, file)
    return stems, [int(n) for n in lengths]


def configure(workdir, config_name, datasets, n_files):
    """Point the harness at the work directory's corpora"""
    import torbi_tpu_torch

    torbi_tpu_torch.CONFIG = config_name
    torbi_tpu_torch.CACHE_DIR = workdir / 'cache'
    torbi_tpu_torch.EVAL_DIR = workdir / 'eval'
    torbi_tpu_torch.PARTITION_DIR = workdir / 'partitions'
    torbi_tpu_torch.PITCH_TRANSITION_MATRIX = (
        workdir / 'stats' / 'transition.pt')
    torbi_tpu_torch.DATASETS = datasets
    torbi_tpu_torch.EVALUATION_SAMPLES = n_files


def reference_pass(datasets, num_threads):
    """Write the reference outputs every dataset still lacks"""
    import torbi_tpu_torch
    from ..evaluate.core import _ensure_targets, _stems

    for dataset in datasets:
        stems = _stems(dataset)
        input_files = [
            torbi_tpu_torch.CACHE_DIR / dataset / f'{stem}.pt'
            for stem in stems]
        _ensure_targets(dataset, stems, input_files, num_threads)


def main(argv=None):
    import torbi_tpu_torch
    from ..config import ArgumentParser
    from ..utils.convert import device_argument

    parser = ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument(
        '--files', default='256',
        help="files per corpus: an integer, or 'reference' for the "
             'per-dataset sizes at the evaluation scale '
             f'({DATASET_FILES}, 8192 elsewhere)')
    parser.add_argument('--min-frames', type=int, default=128)
    parser.add_argument('--max-frames', type=int, default=512)
    parser.add_argument(
        '--datasets', default='synthdaps,synthvctk',
        help='comma-separated corpus names (known seeds: '
             f'{sorted(DATASET_SEEDS)})')
    parser.add_argument(
        '--workdir',
        default=os.path.expanduser('~/.cache/torbi_tpu_torch/synth_eval'))
    parser.add_argument(
        '--config-name', default=None,
        help='artifact name; by default the CONFIG a --config file sets, '
             f"else '{DEFAULT_NAME}' ('composed' also keeps the --config "
             "file's CONFIG)")
    parser.add_argument(
        '--num-threads', type=int, default=1,
        help='processes of the CPU reference decoder')
    parser.add_argument(
        '--gpu', type=device_argument, default=None,
        help='CUDA index to decode on, or cpu; cuda:0 when omitted')
    parser.add_argument(
        '--batch-size', type=int, default=None,
        help='override BATCH_SIZE (1 as config/nobatch.py)')
    parser.add_argument(
        '--min-chunk', type=int, default=None,
        help='override MIN_CHUNK_SIZE (entropy-chunked decoding)')
    parser.add_argument(
        '--eval-backend', default=None,
        help="override EVAL_BACKEND ('kernel' or 'scan')")
    parser.add_argument(
        '--reference-only', action='store_true',
        help='only run the (slow, CPU) reference decode pass and exit; '
             'its outputs are kept, so the main run skips it')
    # The --config files are applied while parsing; keep the CONFIG they
    # set before configure() below replaces it
    default_config = torbi_tpu_torch.CONFIG
    args = parser.parse_args(argv)
    composed = torbi_tpu_torch.CONFIG

    if args.config_name in (None, 'composed'):
        config_name = (
            composed if args.config_name == 'composed'
            or composed != default_config else DEFAULT_NAME)
    else:
        config_name = args.config_name

    workdir = Path(args.workdir)
    datasets = args.datasets.split(',')
    counts = {
        dataset: (DATASET_FILES.get(dataset, 8192)
                  if args.files == 'reference' else int(args.files))
        for dataset in datasets}
    for dataset in datasets:
        stems, lengths = build_corpus(
            workdir, dataset, counts[dataset], args.min_frames,
            args.max_frames,
            seed=DATASET_SEEDS.get(dataset, abs(hash(dataset)) % 10000))
        print(f'corpus {dataset}: {len(stems)} files, {sum(lengths)} frames',
              flush=True)

    configure(workdir, config_name, datasets, max(counts.values()))
    if args.batch_size is not None:
        torbi_tpu_torch.BATCH_SIZE = args.batch_size
    if args.min_chunk is not None:
        torbi_tpu_torch.MIN_CHUNK_SIZE = args.min_chunk
    if args.eval_backend is not None:
        torbi_tpu_torch.EVAL_BACKEND = args.eval_backend

    if args.reference_only:
        reference_pass(datasets, args.num_threads)
        for dataset in datasets:
            print(f'reference outputs ready: {dataset}', flush=True)
        return None

    results = torbi_tpu_torch.evaluate.datasets(
        datasets, gpu=args.gpu, num_threads=args.num_threads)
    for dataset in datasets:
        print(dataset, json.dumps(results[dataset], indent=1), flush=True)

    # The committed location: eval/<name>.json at the repository root
    repo_eval = torbi_tpu_torch.ROOT_DIR / 'eval'
    repo_eval.mkdir(exist_ok=True)
    shutil.copyfile(
        torbi_tpu_torch.EVAL_DIR / f'{config_name}.json',
        repo_eval / f'{config_name}.json')
    print(f'artifact: {repo_eval / f"{config_name}.json"}', flush=True)
    return results


if __name__ == '__main__':
    main()
