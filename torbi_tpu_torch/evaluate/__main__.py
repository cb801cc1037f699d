"""Command line of the evaluation harness: ``python -m
torbi_tpu_torch.evaluate``, the flags of ``python -m torbi_tpu.evaluate``.
``--gpu`` takes a CUDA index, or ``cpu`` for the kernels' plain versions;
absent, the decode runs on cuda:0. ``--config FILE ...`` applies override
files (config/core.py) when the arguments are parsed.

    python -m torbi_tpu_torch.evaluate --datasets daps vctk \\
        [--gpu 0] [--num_threads 8] [--config over.py]
"""
import torbi_tpu_torch
from torbi_tpu_torch.config import ArgumentParser
from torbi_tpu_torch.utils.convert import device_argument


def parse_args(argv=None):
    parser = ArgumentParser(
        description='Score decoding accuracy and speed over pitch corpora')
    parser.add_argument(
        '--datasets',
        nargs='+',
        help='Corpora to score (DATASETS when omitted, read after --config)')
    parser.add_argument(
        '--gpu',
        type=device_argument,
        help='CUDA index to decode on, or cpu; cuda:0 when omitted')
    parser.add_argument(
        '--num_threads',
        type=int,
        default=1,
        help='Processes of the CPU reference decoder')
    return parser.parse_args(argv)


def main(argv=None):
    return torbi_tpu_torch.evaluate.datasets(**vars(parse_args(argv)))


if __name__ == '__main__':
    main()
