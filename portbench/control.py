"""The readings that the limits of portbench/limits/ are set from: for a
cell and a list of seeds, in one process, the numbers compared by sound
runs of the program (a short window of the cell's own load) and by the
control, the plain reference computed in TF32 (reference/flagship.py
precision='tf32') put in the program's place on the same answers.

    python3 portbench/control.py --workload <name> --seconds <s>
        --seeds <n> [<n> ...]

Prints one JSON line a seed: {"seed", "program": {...}, "control": {...}}.
Runs on the card; the benchmark's own runs never run the control.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import checks, compare, harness  # noqa: E402


def control_numbers(work, config, out, seed):
    """The control's numbers on the answers of one run."""
    ans = out['answers']
    reference = harness.family(config).Reference
    control = reference(config, ans['paths'], precision='tf32')
    observed, chains = ans['observed'], ans['chains']
    ref = observed.reference
    idx = checks.reference_sample(len(chains), ref.nlayers, ref.nwave,
                                  harness.seed_int(seed, 3))
    want = ref.log_post(chains[idx], observed.data, observed.uncert)
    got = control.log_post(chains[idx], observed.data, observed.uncert)
    return {'logp_gap': compare.logp_gap(got, want),
            'moved_share': compare.moved_share(ans['start'], chains)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seconds', type=float, default=3.0)
    parser.add_argument('--seeds', type=int, nargs='+', required=True)
    args = parser.parse_args(argv)
    work, config, mix = harness.cell(harness.manifest(), args.workload)
    why = harness.missing_cards(work['chips'])
    if why is not None:
        print(f'portbench: {why}', file=sys.stderr)
        return 2
    for seed in args.seeds:
        out = harness.driver(mix['driver']).run(
            work=work, config=config, mix=mix, seed=seed,
            seconds=args.seconds, trace=False, t0=time.perf_counter())
        program = {c['name']: c['value'] for c in out['checks']}
        print(json.dumps({'seed': seed, 'correct': bool(out['correct']),
                          'program': program,
                          'control': control_numbers(work, config, out,
                                                     seed)}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
