"""Command line: download the evaluation corpora, ``python -m
torbi_tpu_torch.data.download [--datasets daps vctk] [--config over.py]``
(needs network access and torchaudio)"""
import torbi_tpu_torch
from torbi_tpu_torch.config import ArgumentParser


def parse_args(argv=None):
    parser = ArgumentParser(description='Download datasets')
    parser.add_argument(
        '--datasets',
        nargs='+',
        help='Corpora to fetch (daps, vctk; DATASETS when omitted)')
    return parser.parse_args(argv)


def main(argv=None):
    torbi_tpu_torch.data.download.datasets(**vars(parse_args(argv)))


if __name__ == '__main__':
    main()
