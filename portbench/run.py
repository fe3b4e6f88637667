"""Run one cell of the benchmark of pyratbay_tpu_torch once, on the card
of the machine it starts on, and print the result as the last line of
standard output.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

Without --trace the line has the cell's end-to-end metrics; with it its
per-layer metrics, the device's busy and window seconds and the
breakdown.  The numbers compared with the plain reference, each beside
its limit, end standard error and the line.  A run without the cards the
cell asks for, or whose process loaded JAX or the JAX package, exits
with another code than 0 and prints no result.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import harness  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    man = harness.manifest()
    work, config, mix = harness.cell(man, args.workload)
    why = harness.missing_cards(work['chips'])
    if why is not None:
        print(f'portbench: {why}', file=sys.stderr)
        return 2
    out = harness.driver(mix['driver']).run(
        work=work, config=config, mix=mix, seed=args.seed,
        seconds=args.seconds, trace=bool(args.trace), t0=T0)
    line = harness.result_line(man, work, out, bool(args.trace))
    loaded = sorted(set(harness.forbidden_loaded())
                    | set(out.get('forbidden', [])))
    if loaded:
        print('portbench: the run loaded ' + ', '.join(loaded),
              file=sys.stderr)
        return 3
    print(harness.checks_text(out['checks']), file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
