"""Command-line entry point:

    python -m pyratbay_tpu_torch -c config.cfg [--device cpu]
    python -m pyratbay_tpu_torch --post config.cfg [--suffix _post]

It runs on the CUDA device unless --device names another.  --post redoes
a retrieval's post-processing from the posterior saved in
<logfile>.npz.
"""
import argparse
import sys


def build_parser():
    parser = argparse.ArgumentParser(
        prog='python -m pyratbay_tpu_torch',
        description='Run a configuration (runmode = tli, atmosphere, '
                    'spectrum, opacity, radeq or retrieval) on PyTorch '
                    '(CPU or CUDA)',
    )
    parser.add_argument('-c', '--cfile', metavar='CONFIG',
                        help='configuration file to run')
    parser.add_argument('--post', metavar='CONFIG', default=None,
                        help='post-process a saved retrieval posterior')
    parser.add_argument('-suf', '--suffix', default='',
                        help='suffix for post-processed output files')
    parser.add_argument('--device', default='cuda',
                        help="torch device: 'cuda' (the default) or 'cpu'")
    parser.add_argument('--root', default=None,
                        help="path substituted for '{ROOT}' in config paths")
    parser.add_argument('--seed', type=int, default=0,
                        help='random seed of the sampler')
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.post is not None:
        from .retrieval.driver import posterior_post_processing
        posterior_post_processing(args.post, suffix=args.suffix,
                                  root=args.root, device=args.device)
        return 0
    if args.cfile is None:
        parser.error('one of -c/--cfile or --post is required')
    from .driver import run
    run(args.cfile, device=args.device, root=args.root, seed=args.seed)
    return 0


if __name__ == '__main__':
    sys.exit(main())
