"""Command-line decode: ``python -m torbi_tpu_torch`` maps onto
``from_files_to_files``.

The flag names are those of ``python -m torbi_tpu`` (and of the reference
CLI), so invocations written for either run unchanged. ``--gpu`` takes a
CUDA index, or ``cpu`` to decode on the CPU (the kernels' plain versions);
absent, the decode runs on cuda:0. ``--config FILE ...`` applies override
files (config/core.py) before the decode.

    python -m torbi_tpu_torch --input_files a.npy b.npy \\
        --output_files a_out.npy b_out.npy --transition_file t.npy \\
        --log_probs [--gpu 0] [--config over.py]
"""
from pathlib import Path

import torbi_tpu_torch
from torbi_tpu_torch.config import ArgumentParser
from torbi_tpu_torch.utils.convert import device_argument


# Declarative flag table: one row per reference-compatible flag
_FLAGS = (
    ('--input_files', dict(
        type=Path, nargs='+', required=True,
        help='Observation files to decode (.pt or .npy, (frames, states))')),
    ('--output_files', dict(
        type=Path, nargs='+', required=True,
        help='Where each decoded index sequence lands (paired one-to-one '
             'with --input_files)')),
    ('--transition_file', dict(
        type=Path,
        help='Transition matrix in probability space, row = destination; '
             'a uniform matrix is assumed when omitted')),
    ('--initial_file', dict(
        type=Path,
        help='First-frame state distribution; uniform when omitted')),
    ('--log_probs', dict(
        action='store_true',
        help='Observation files already hold natural-log probabilities')),
    ('--gpu', dict(
        type=device_argument,
        help='CUDA index to decode on, or cpu; cuda:0 when omitted')),
    ('--num_threads', dict(
        type=int, default=1,
        help='Accepted for reference-CLI compatibility; unused')),
)


def parse_args(argv=None):
    parser = ArgumentParser(
        description='Viterbi-decode time-varying categorical distributions')
    for flag, spec in _FLAGS:
        parser.add_argument(flag, **spec)
    return parser.parse_known_args(argv)[0]


def main(argv=None):
    torbi_tpu_torch.from_files_to_files(**vars(parse_args(argv)))


if __name__ == '__main__':
    main()
