"""Command-line entry point:

    python -m pyratbay_tpu_torch -c config.cfg [--device cpu]

It runs on the CUDA device unless --device names another.
"""
import argparse
import sys


def build_parser():
    parser = argparse.ArgumentParser(
        prog='python -m pyratbay_tpu_torch',
        description='Run a configuration (runmode = tli, atmosphere, '
                    'spectrum, opacity or retrieval) on PyTorch (CPU or '
                    'CUDA)',
    )
    parser.add_argument('-c', '--cfile', metavar='CONFIG', required=True,
                        help='configuration file to run')
    parser.add_argument('--device', default='cuda',
                        help="torch device: 'cuda' (the default) or 'cpu'")
    parser.add_argument('--root', default=None,
                        help="path substituted for '{ROOT}' in config paths")
    parser.add_argument('--seed', type=int, default=0,
                        help='random seed of the sampler')
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    from .driver import run
    run(args.cfile, device=args.device, root=args.root, seed=args.seed)
    return 0


if __name__ == '__main__':
    sys.exit(main())
