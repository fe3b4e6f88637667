"""Shared utilities: timers, formatted writers, depth conversions and
the CLI's cross-section reformatters (cia_hitran, cia_borysow).

Host-side numpy copy of pyratbay_tpu/tools.py.
Reference behavior: pyratbay/tools/tools.py (Timer :832, Formatted_Write
:736, radius_to_depth/depth_to_radius :1119-1215, divisors :314).
"""
import time

import numpy as np

from . import constants as pc

__all__ = [
    'Timer',
    'Formatted_Write',
    'divisors',
    'radius_to_depth',
    'depth_to_radius',
    'ifirst',
    'ilast',
    'cia_hitran',
    'cia_borysow',
]


class Timer:
    """Wall-clock delta timer: each clock() returns seconds since the
    previous call."""

    def __init__(self):
        self.t0 = time.time()

    def clock(self):
        t1 = time.time()
        delta = t1 - self.t0
        self.t0 = t1
        return delta


class Formatted_Write:
    """Accumulate formatted lines into a text blob (str(obj) builder).

    fw = Formatted_Write(); fw.write('x = {:.3f}', 1.0); fw.text
    """

    def __init__(self, indent=0, fmt=None, edge=None, prec=None):
        self.text = ''
        self.indent = indent
        self.fmt = fmt
        self.edge = edge
        self.prec = prec

    def write(self, text, *args, fmt=None, edge=None, prec=None):
        fmt = fmt if fmt is not None else self.fmt
        edge = edge if edge is not None else self.edge
        prec = prec if prec is not None else self.prec
        options = {}
        if fmt is not None:
            options['formatter'] = fmt
        if prec is not None:
            options['precision'] = prec
        if edge is not None:
            options['edgeitems'] = edge
            options['threshold'] = 2 * edge
        if options:
            with np.printoptions(**options):
                str_args = [
                    str(arg) if isinstance(arg, np.ndarray) else arg
                    for arg in args
                ]
                line = text.format(*str_args)
        else:
            line = text.format(*args) if args else text
        pad = ' ' * self.indent
        self.text += ''.join(
            pad + subline + '\n' for subline in line.split('\n')
        )


def divisors(number):
    """Integer divisors of number, ascending."""
    return np.array([
        i for i in range(1, number + 1) if number % i == 0
    ])


def ifirst(data, default_ret=-1):
    """Index of the first True element (or default_ret if none)."""
    data = np.asarray(data, bool)
    idx = np.argmax(data)
    if not data[idx]:
        return default_ret
    return int(idx)


def ilast(data, default_ret=-1):
    """Index of the last True element (or default_ret if none)."""
    data = np.asarray(data, bool)
    idx = len(data) - 1 - np.argmax(data[::-1])
    if not data[idx]:
        return default_ret
    return int(idx)


def radius_to_depth(rprs, rprs_err):
    """Transit radius ratio -> depth: depth = (Rp/Rs)^2, with errors."""
    rprs = np.asarray(rprs)
    rprs_err = np.asarray(rprs_err)
    depth = rprs**2
    depth_err = 2.0 * rprs * rprs_err
    return depth, depth_err


def depth_to_radius(depth, depth_err):
    """Transit depth -> radius ratio: Rp/Rs = sqrt(depth), with errors."""
    depth = np.asarray(depth)
    depth_err = np.asarray(depth_err)
    rprs = np.sqrt(depth)
    rprs_err = 0.5 * depth_err / rprs
    return rprs, rprs_err


def cia_hitran(ciafile, tstep=1, wstep=1, outdir='.'):
    """Reformat a HITRAN CIA file into the native CIA table format.

    The HITRAN file is a sequence of blocks, each a header line
    ('PAIR  wnmin wnmax npts temp ...') followed by npts '(wn, cs)'
    rows; cross sections are cm5 molec-2 (converted to the amagat^-2
    convention on write).  tstep/wstep thin the temperature/wavenumber
    sampling.  Returns the list of written file paths.
    (Reference behavior: tools/tools.py::cia_hitran.)
    """
    import os
    from . import constants as pc
    from .io import io as pio

    with open(ciafile) as f:
        lines = f.read().splitlines()
    pair = lines[0].split()[0]
    species = pair.split('-')

    # Parse blocks (header + npts rows each):
    blocks = []
    i = 0
    while i < len(lines):
        info = lines[i].split()
        npts = int(info[3])
        temp = float(info[4])
        rows = np.array([
            line.split()[:2] for line in lines[i + 1:i + 1 + npts]
        ], float)
        blocks.append((temp, rows[:, 0], rows[:, 1]))
        i += 1 + npts

    # Group consecutive blocks sharing a wavenumber grid into one
    # table each:
    written = []
    i = 0
    while i < len(blocks):
        wn = blocks[i][1][::wstep]
        j = i
        while j < len(blocks) and len(blocks[j][1][::wstep]) == len(wn) \
                and np.array_equal(blocks[j][1][::wstep], wn):
            j += 1
        temps = np.array([b[0] for b in blocks[i:j:tstep]])
        cs = np.array([b[2][::wstep] for b in blocks[i:j:tstep]])
        cs = cs * pc.amagat**2

        wl_min = 1.0 / (wn[-1] * pc.um)
        wl_max = 1.0 / (wn[0] * pc.um)
        csfile = os.path.join(outdir, (
            f'CIA_HITRAN_{pair}_{wl_min:.1f}-{wl_max:.1f}um_'
            f'{temps[0]:04.0f}-{temps[-1]:04.0f}K.dat'
        ))
        header = (
            f'# Reformatted {pair} CIA data from\n'
            f'# HITRAN file: {ciafile}\n\n'
        )
        pio.write_cs(csfile, cs, species, temps, wn, header)
        written.append(csfile)
        i = j
    return written


def cia_borysow(ciafile, species1, species2, outdir='.'):
    """Reformat a Borysow CIA table (wn rows x temperature columns,
    temperatures on the second header line) into the native format.
    Returns the written file path.
    (Reference behavior: tools/tools.py::cia_borysow.)
    """
    import os
    from . import constants as pc
    from .io import io as pio

    data = np.loadtxt(ciafile, skiprows=3)
    wn = data[:, 0]
    cs = data[:, 1:].T
    with open(ciafile) as f:
        f.readline()
        temps = [
            float(t.replace('K', '')) for t in f.readline().split()[1:]
        ]
    species = [species1, species2]
    pair = f'{species1}-{species2}'
    wl_min = 1.0 / (wn[-1] * pc.um)
    wl_max = 1.0 / (wn[0] * pc.um)
    csfile = os.path.join(outdir, (
        f'CIA_Borysow_{pair}_{wl_min:.1f}-{wl_max:.1f}um_'
        f'{temps[0]:04.0f}-{temps[-1]:04.0f}K.dat'
    ))
    header = (
        f'# Reformatted {pair} CIA data from:\n'
        f'# {os.path.basename(ciafile)}\n\n'
    )
    pio.write_cs(csfile, cs, species, np.asarray(temps), wn, header)
    return csfile
