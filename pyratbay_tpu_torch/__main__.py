"""Command-line entry point:

    python -m pyratbay_tpu_torch -c config.cfg [--device cpu]
    python -m pyratbay_tpu_torch --post config.cfg [--suffix _post]
    python -m pyratbay_tpu_torch -pf tips MOLECULE [OUTFILE]
    python -m pyratbay_tpu_torch -cs hitran FILE [TSTEP [WSTEP]]
    python -m pyratbay_tpu_torch -cs borysow FILE SPECIES1 SPECIES2
    python -m pyratbay_tpu_torch -v

It runs on the CUDA device unless --device names another.  --post redoes
a retrieval's post-processing from the posterior saved in
<logfile>.npz.  -pf writes a TIPS partition-function file and -cs
reformats a HITRAN or Borysow CIA file into a cross-section table (host
tools, no device).
"""
import argparse
import sys

PROG = 'python -m pyratbay_tpu_torch'


def build_parser():
    parser = argparse.ArgumentParser(
        prog=PROG,
        description='Run a configuration (runmode = tli, atmosphere, '
                    'spectrum, opacity, radeq or retrieval) on PyTorch '
                    '(CPU or CUDA)',
    )
    parser.add_argument('-v', '--version', action='store_true',
                        help='show the version number and exit')
    parser.add_argument('-c', '--cfile', metavar='CONFIG',
                        help='configuration file to run')
    parser.add_argument('-pf', nargs='*', metavar='ARGS',
                        help='partition-function tools: '
                             '"-pf tips MOLECULE [OUTFILE]"')
    parser.add_argument('-cs', nargs='*', metavar='ARGS',
                        help='cross-section reformat: "-cs hitran FILE '
                             '[TSTEP [WSTEP]]" or "-cs borysow FILE '
                             'SPECIES1 SPECIES2"')
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


def partition_tool(args):
    """-pf tips MOLECULE [OUTFILE]: write the TIPS partition functions."""
    from .io import io as pio
    from .opacity import partitions
    if len(args) >= 2 and args[0] == 'tips':
        pf, isotopes, temp = partitions.tips(args[1])
        outfile = args[2] if len(args) > 2 else f'PF_tips_{args[1]}.dat'
        pio.write_pf(outfile, pf, isotopes, temp)
        print(f"Written partition-function file: '{outfile}'")
        return 0
    print(f'Usage: {PROG} -pf tips MOLECULE [OUTFILE]')
    return 1


def cross_section_tool(args):
    """-cs hitran FILE [TSTEP [WSTEP]] | -cs borysow FILE SP1 SP2."""
    from . import tools
    if len(args) >= 2 and args[0] == 'hitran':
        tstep = int(args[2]) if len(args) > 2 else 1
        wstep = int(args[3]) if len(args) > 3 else 1
        for path in tools.cia_hitran(args[1], tstep, wstep):
            print(f"Written cross-section file: '{path}'")
        return 0
    if len(args) == 4 and args[0] == 'borysow':
        path = tools.cia_borysow(args[1], args[2], args[3])
        print(f"Written cross-section file: '{path}'")
        return 0
    print(f'Usage: {PROG} -cs hitran FILE [TSTEP [WSTEP]] | '
          '-cs borysow FILE SPECIES1 SPECIES2')
    return 1


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.version:
        from .version import __version__
        print(f'pyratbay_tpu_torch version {__version__}')
        return 0
    if args.pf is not None:
        return partition_tool(args.pf)
    if args.cs is not None:
        return cross_section_tool(args.cs)
    if args.post is not None:
        from .retrieval.driver import posterior_post_processing
        posterior_post_processing(args.post, suffix=args.suffix,
                                  root=args.root, device=args.device)
        return 0
    if args.cfile is None:
        parser.error('one of -c/--cfile, --post, -pf, -cs or -v is required')
    from .driver import run
    run(args.cfile, device=args.device, root=args.root, seed=args.seed)
    return 0


if __name__ == '__main__':
    sys.exit(main())
