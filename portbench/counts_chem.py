"""The work of the equilibrium solve, counted from a configuration's
network shape: what its inputs need, whatever implements it.

A system (a layer of a chain) of S species and C element columns solves
by `chem_steps` damped Newton steps of the element-potential dual on the
(C + 1)-square bordered matrix (atmosphere/chem.py, csrc/chem_gibbs.cu),
the last 32 of them averaged.  A step's float64 operations (an FMA
counts two, a transcendental, a square root or a division one, a
comparison one), with the stoichiometry dense:
  the abundances and potentials:  S + 1 exponentials, 5 S;
  the matrix S^T diag(n) S (upper triangle), S^T n and S^T (n mu):
  S C (C + 5); the right-hand side 2 C + 4;
  the regularisation and the symmetric scaling: C + 3, 5 (C + 1),
  M (M + 1) + M with M = C + 1;
  the elimination of the symmetric system and its back substitution
  (below), M for the unscaling;
  the step: S (2 C + 4) + 1, its limit 3, the updates 4 + 4 S;
and S more in each averaged step.  Once a system: the G/RT lerp and the
budget (4 S + 8 C), the start (S + 2) and the normalised VMRs (4 S).
Bytes: the temperatures in (float32), the VMRs out (float64), the G/RT
table [chem_table_temps, S] and two float64 parameters a chain, read
once.  The rates are the card's float64 peaks (peaks_fp64.json).
"""
import json
import os

__all__ = ['step_flops', 'system_flops', 'solve_work', 'bound_ms',
           'peaks']

_HERE = os.path.dirname(os.path.abspath(__file__))
N_AVG = 32


def peaks():
    """The card's published float64 rates (portbench/peaks_fp64.json)."""
    with open(os.path.join(_HERE, 'peaks_fp64.json')) as f:
        return json.load(f)


def _elimination(m):
    """Operations of the symmetric elimination and back substitution of
    an m-square system (upper triangle): a division a pivot, and for each
    row below it a multiplier, the row's update and the right-hand
    side's; then a division and the dot products of the back
    substitution."""
    ops = 0
    for k in range(m):
        ops += 1
        for r in range(k + 1, m):
            ops += 1 + 2 * (m - r) + 2
    return ops + m * m


def step_flops(ns, ncols):
    """float64 operations of one Newton step of one system."""
    m = ncols + 1
    return ((ns + 1) + 5 * ns + ns * ncols * (ncols + 5) + 2 * ncols + 4
            + ncols + 3 + 5 * m + m * (m + 1) + m + _elimination(m) + m
            + ns * (2 * ncols + 4) + 1 + 3 + 4 + 4 * ns)


def system_flops(ns, ncols, steps):
    """float64 operations of one system's solve of `steps` steps."""
    return (steps * step_flops(ns, ncols) + N_AVG * ns
            + 4 * ns + 8 * ncols + ns + 2 + 4 * ns)


def solve_work(work, nchains, nlayers):
    """(operations, bytes) of one solve of nchains x nlayers systems of
    the configuration's `work` terms (chem_species, chem_cols,
    chem_steps, chem_table_temps)."""
    ns, nc = int(work['chem_species']), int(work['chem_cols'])
    nsys = int(nchains) * int(nlayers)
    flops = nsys * system_flops(ns, nc, int(work['chem_steps']))
    nbytes = (nsys * (4 + 8 * ns) + 8 * int(work['chem_table_temps']) * ns
              + 16 * int(nchains))
    return flops, nbytes


def bound_ms(flops, nbytes, peak_name, bytes_per_s):
    """(the least time in ms, 'operations' or 'bytes'): the larger of the
    operations over the float64 peak `peak_name` and the bytes over
    `bytes_per_s`."""
    t_ops = flops / peaks()[peak_name]
    t_bytes = nbytes / bytes_per_s
    return 1e3 * max(t_ops, t_bytes), (
        'operations' if t_ops >= t_bytes else 'bytes')
