"""Command line: infer pitch posteriorgrams for the downloaded corpora,
``python -m torbi_tpu_torch.data.preprocess [--datasets daps vctk]
[--gpu 0|cpu] [--config over.py]`` (needs penn and torchaudio). ``--gpu``
takes a CUDA index, or ``cpu``; absent, inference runs on cuda:0."""
import torbi_tpu_torch
from torbi_tpu_torch.config import ArgumentParser
from torbi_tpu_torch.utils.convert import device_argument


def parse_args(argv=None):
    parser = ArgumentParser(
        description='Infer pitch posteriorgrams for evaluation corpora')
    parser.add_argument(
        '--datasets',
        nargs='+',
        help='Corpora to run penn inference over (DATASETS when omitted)')
    parser.add_argument(
        '--gpu',
        type=device_argument,
        help='CUDA index for penn inference, or cpu; cuda:0 when omitted')
    return parser.parse_args(argv)


def main(argv=None):
    torbi_tpu_torch.data.preprocess.datasets(**vars(parse_args(argv)))


if __name__ == '__main__':
    main()
