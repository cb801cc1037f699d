"""Command line: sample evaluation partitions, ``python -m
torbi_tpu_torch.partition [--datasets daps vctk] [--config over.py]``"""
import torbi_tpu_torch
from torbi_tpu_torch.config import ArgumentParser


def parse_args(argv=None):
    parser = ArgumentParser(
        description='Sample per-dataset evaluation stem lists')
    parser.add_argument(
        '--datasets',
        nargs='+',
        help='Corpora to sample partitions from (DATASETS when omitted)')
    return parser.parse_args(argv)


def main(argv=None):
    torbi_tpu_torch.partition.datasets(**vars(parse_args(argv)))


if __name__ == '__main__':
    main()
