"""The comparison that decides `correct`: the numbers a run compares
with the plain reference, and their limits (portbench/limits/<cell>.json,
each set from the readings PERF.md gives).

Every number is a widest gap, so it passes when it is at most its limit,
except `moved_share`, the share of the chains whose parameters the
window moved, which passes when it is at least its limit.
"""
import json
import os

import numpy as np

__all__ = ['logp_gap', 'moved_share', 'judge', 'limits']

_HERE = os.path.dirname(os.path.abspath(__file__))
AT_LEAST = ('moved_share',)


def limits(cell):
    """The cell's limits: {number: limit}."""
    with open(os.path.join(_HERE, 'limits', f'{cell}.json')) as f:
        return json.load(f)['limits']


def logp_gap(got, want):
    """max |got - want| / (1 + |want|) of log-posteriors; inf where one
    is finite and the other not (both -inf is agreement)."""
    got = np.asarray(got, float)
    want = np.asarray(want, float)
    if not np.array_equal(np.isfinite(got), np.isfinite(want)):
        return float('inf')
    fin = np.isfinite(want)
    if not np.any(fin):
        return 0.0
    return float(np.max(np.abs(got[fin] - want[fin])
                        / (1.0 + np.abs(want[fin]))))


def moved_share(before, after):
    """The share of chains (rows) with any parameter changed."""
    before = np.asarray(before, float)
    after = np.asarray(after, float)
    return float(np.mean(np.any(before != after, axis=1)))


def judge(numbers, cell_limits):
    """(correct, checks): each number beside its limit, in order."""
    checks = []
    correct = True
    for name, value in numbers.items():
        limit = cell_limits[name]
        ok = value >= limit if name in AT_LEAST else value <= limit
        correct = correct and bool(ok) and np.isfinite(value)
        checks.append({'name': name, 'value': float(value),
                       'limit': float(limit),
                       'pass': 'at least' if name in AT_LEAST else 'at most'})
    return correct, checks
