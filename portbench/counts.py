"""The work of the transit kernels and of a forward, counted from the
shapes of a configuration: what the inputs need, whatever implements it.

For the ensemble kernel (K1) at B chains, l layers and W wavenumbers:
every operand read once (the line-sample table [n_ls, l, W], the CIA
table [n_cia, W], the rank-1 rows [B, n_r1, W], the per-chain weights,
columns, chord matrices and scalars) and the [B, W] result written
once; operations (an FMA counts two, a transcendental or a division
one): the triangular chord product, B W l (l + 1); the rank-1 terms, two
a term; the two-hot line-sample and CIA weights, two a weight that is
not zero, two weights a layer of each table; about 10 a row of the
epilogue.

The terms of the work and the peak the kernels run at are the
configuration's (its `work` entry); the peaks are the published ones of
portbench/peaks.json.
"""
import json
import os

__all__ = ['shape_of', 'transit_work', 'forward_flops',
           'bound_ms', 'peaks']

_HERE = os.path.dirname(os.path.abspath(__file__))


def peaks():
    """The card's published peak rates (portbench/peaks.json)."""
    with open(os.path.join(_HERE, 'peaks.json')) as f:
        return json.load(f)


def shape_of(config, nwave, nchains):
    """The kernels' shapes for a configuration with `nwave` wavenumbers
    and `nchains` chains: its layers and bands, and the terms of its
    `work` entry (line-sample species and temperatures, CIA tables and
    temperatures, rank-1 terms, dense parts, and the name of the peak of
    portbench/peaks.json the kernels run at)."""
    work = config['work']
    return {
        'nchains': int(nchains),
        'nlayers': int(config['nlayers']),
        'nwave': int(nwave),
        'ls_species': int(work['ls_species']),
        'ls_temps': int(work['ls_temps']),
        'cia_tables': int(work['cia_tables']),
        'cia_temps': int(work['cia_temps']),
        'rank1': int(work['rank1']),
        'dense_parts': int(work['dense_parts']),
        'nbands': int(config['bands']['n']),
        'peak': work['peak'],
    }


def _flops(s, nb):
    nl, nw = s['nlayers'], s['nwave']
    weights = 2 * nl * (s['ls_species'] + s['cia_tables'])
    assembly = 2 * s['rank1'] + max(s['dense_parts'] - 1, 0)
    return (nb * nw * nl * (nl + 1) + nb * nw * nl * (assembly + 10)
            + 2 * nb * weights * nw)


def _small_operands(s, nb):
    """Bytes of the per-chain operands: chord matrix [B, l, l], radius
    and step columns [B, 3, l], scalars [B, 8], rank-1 columns [B, n_r1,
    l], line-sample and CIA weights [B, n, l]."""
    nl = s['nlayers']
    per_chain = (nl * nl + 3 * nl + 8 + s['rank1'] * nl
                 + s['ls_species'] * s['ls_temps'] * nl
                 + s['cia_tables'] * s['cia_temps'] * nl)
    return 4 * nb * per_chain


def transit_work(s):
    """(operations, bytes) of K1 on the whole ensemble."""
    nb, nl, nw = s['nchains'], s['nlayers'], s['nwave']
    tables = (s['ls_species'] * s['ls_temps'] * nl
              + s['cia_tables'] * s['cia_temps']) * nw
    rows = nb * s['rank1'] * nw + nb * s['dense_parts'] * nl * nw
    nbytes = 4 * (tables + rows + nb * nw) + _small_operands(s, nb)
    return _flops(s, nb), nbytes


def forward_flops(s):
    """float32 operations of one batched forward at the ensemble's
    shapes: the transit kernel's and the band product's (the [B, l]
    work of T(p), VMRs and radii is left out: under 0.1% of it)."""
    nb, nw = s['nchains'], s['nwave']
    return _flops(s, nb) + 2 * nb * nw * s['nbands']


def bound_ms(flops, nbytes, peak_name):
    """(the least time in ms, 'operations' or 'bytes'): the larger of the
    operations over the peak `peak_name` and the bytes over the memory
    rate."""
    peak = peaks()
    t_ops = flops / peak[peak_name]
    t_bytes = nbytes / peak['bytes_per_s']
    return 1e3 * max(t_ops, t_bytes), (
        'operations' if t_ops >= t_bytes else 'bytes')
