"""Line-list readers: extract (wavenumber, gf, Elow, isotope) transitions
from public molecular databases.

Host-side numpy copy of pyratbay_tpu/opacity/linelists.py for the
HITRAN/HITEMP .par reader (its numpy parsing branch: the JAX package's
native multithreaded parser is a host accelerator of the same parse).
The other readers and partition-function files are not ported yet
(ROADMAP.md A13).
"""
import os

import numpy as np

from .. import constants as pc
from ..data import get_iso
from . import partitions as pf

__all__ = ['Linelist', 'Hitran', 'get_linelist_reader']


def _gf_from_a21(g2, a21, wn):
    """Simeckova et al. (2006), eq. (36): gf from Einstein A."""
    return g2 * a21 * pc.C1 / (8.0 * np.pi * pc.c) / wn**2


class Linelist:
    """Base reader; subclasses implement dbread()."""

    def __init__(self, dbfile, pffile):
        self.dbfile = dbfile
        self.pffile = pffile

    def getpf(self):
        """Partition functions: (temp, pf [niso, ntemp], isotopes)."""
        if self.pffile == 'tips':
            pf_data, isotopes, temp = pf.tips(self.molecule)
            return temp, pf_data, isotopes
        if self.pffile == 'poly':
            pf_data, temp = pf.poly_pf(self.pf_coeffs)
            return temp, pf_data, list(self.isotopes)
        raise NotImplementedError(
            'Partition-function files (pflist entries other than tips) '
            'are not ported to pyratbay_tpu_torch yet (ROADMAP.md A13)')

    def dbread(self, wn_low, wn_high):
        """Transitions in [wn_low, wn_high]: (wn, gf, elow, iso_id),
        or None if the database does not overlap the range."""
        raise NotImplementedError


_HITRAN_ISO_MAP = {
    '1': 0, '2': 1, '3': 2, '4': 3, '5': 4, '6': 5,
    '7': 6, '8': 7, '9': 8, '0': 9, 'A': 10, 'B': 11,
}


class Hitran(Linelist):
    """HITRAN / HITEMP 160-char .par format."""

    def __init__(self, dbfile, pffile):
        super().__init__(dbfile, pffile)
        if not os.path.isfile(dbfile):
            raise FileNotFoundError(
                f"Input database file '{dbfile}' does not exist"
            )
        with open(dbfile) as f:
            mol_id = int(f.read(2))
        self.molecule = pf.get_tips_molname(mol_id)
        self.name = 'HITRAN ' + self.molecule

        iso_names, mass, ratio = get_iso(self.molecule)
        # Isotopes follow the HITRAN (TIPS) ordering:
        isotopes = pf.tips(self.molecule)[1]
        isort = [iso_names.index(iso) for iso in isotopes]
        self.isotopes = isotopes
        self.mass = np.array(mass)[isort]
        self.isoratio = np.array(ratio)[isort]

    def dbread(self, wn_low, wn_high):
        with open(self.dbfile, 'rb') as f:
            first = f.readline()
            recsize = len(first)
            f.seek(0)
            raw = f.read()
        nlines = len(raw) // recsize
        rec = np.frombuffer(raw, dtype=f'S{recsize}', count=nlines)
        view = rec.view('S1').reshape(nlines, recsize)

        def col(lo, hi, dtype=float):
            text = view[:, lo:hi].view(f'S{hi-lo}').ravel()
            return np.char.strip(text.astype(str)).astype(dtype)

        wn = col(3, 15)
        iso_char = view[:, 2].astype(str)
        a21 = col(25, 35)
        elow = col(45, 55)
        g2 = col(146, 153)
        iso_id = np.array([_HITRAN_ISO_MAP[ch] for ch in iso_char])

        if wn_low > wn[-1] or wn_high < wn[0]:
            return None
        gf = _gf_from_a21(g2, a21, wn)

        # Range + valid-Elow filter (Rothman et al. 1996 flags bad
        # lower-state energies as negative):
        keep = (wn >= wn_low) & (wn <= wn_high) & (elow > 0)
        return wn[keep], gf[keep], elow[keep], iso_id[keep]


_READERS = {'hitran': Hitran}
_NOT_PORTED = ('exomol', 'repack', 'pands', 'tioschwenke', 'voplez', 'vald')


def get_linelist_reader(dbtype):
    if dbtype in _NOT_PORTED:
        raise NotImplementedError(
            f"The '{dbtype}' line-list reader is not ported to "
            'pyratbay_tpu_torch yet (ROADMAP.md A13)')
    if dbtype not in _READERS:
        raise ValueError(
            f"Unknown database type '{dbtype}', select from "
            f'{sorted([*_READERS, *_NOT_PORTED])}'
        )
    return _READERS[dbtype]
