"""What a run hands the reference once its window has closed, and the
numbers it compares (compare.py): the chains and log-posteriors of a
DEMC window."""
import numpy as np

from . import compare

__all__ = ['reference_sample', 'judge_demc']

# Chord-product operations the reference may spend on a check, which
# keeps it to a few seconds of the host's numpy: every chain at 3,209
# columns, ~75 at 50,062.
_REF_BUDGET = 1e10


def reference_sample(n, nlayers, nwave, seed):
    """Indices of the answers the reference recomputes: all of them, or
    as many as the budget allows, drawn from the seed."""
    k = min(n, max(16, int(_REF_BUDGET / (nlayers * nlayers * nwave))))
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n, k, replace=False))


def judge_demc(cell, reference, observed, start, chains, logp, seed):
    """(correct, checks, compared) of a DEMC window: the log-posterior
    the program holds for a sample of its final chains against the
    reference's, and the share of chains the window moved."""
    idx = reference_sample(len(chains), reference.nlayers,
                           reference.nwave, seed)
    want = reference.log_post(chains[idx], observed.data, observed.uncert)
    numbers = {'logp_gap': compare.logp_gap(logp[idx], want),
               'moved_share': compare.moved_share(start, chains)}
    correct, checks = compare.judge(numbers, compare.limits(cell))
    return correct, checks, len(idx)
