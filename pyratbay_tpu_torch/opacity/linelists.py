"""Line-list readers: extract (wavenumber, gf, Elow, isotope) transitions
from public molecular databases: HITRAN/HITEMP, ExoMol, repack,
Partridge & Schwenke H2O, Schwenke TiO, Plez VO and VALD.

Host-side numpy copy of pyratbay_tpu/opacity/linelists.py.  Unlike the
reference's per-record seek loops (pyratbay/opacity/linelist/*.py),
these readers parse whole files as numpy record views and filter by
wavenumber with vectorized masks.  The HITRAN reader parses through the
native runtime (runtime.parse_hitran_records).
"""
import os
import bz2
import struct

import numpy as np

from .. import constants as pc
from .. import runtime
from ..data import get_iso
from ..io import io as pio
from . import partitions as pf

__all__ = ['Linelist', 'Hitran', 'Exomol', 'Repack', 'Pands', 'Tioschwenke',
           'Voplez', 'Vald', 'get_exomol_mol', 'get_linelist_reader']


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
        pf_data, iso, temp = pio.read_pf(self.pffile)
        return temp, pf_data, list(iso)

    def dbread(self, wn_low, wn_high):
        """Transitions in [wn_low, wn_high]: (wn, gf, elow, iso_id),
        or None if the database does not overlap the range."""
        raise NotImplementedError


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
        # The native multithreaded parser (runtime.parse_hitran_records;
        # the IO hot path for GB-scale HITEMP lists):
        wn, a21, g2, elow, iso_id = runtime.parse_hitran_records(
            raw, recsize)

        if wn_low > wn[-1] or wn_high < wn[0]:
            return None
        gf = _gf_from_a21(g2, a21, wn)

        # Range + valid-Elow filter (Rothman et al. 1996 flags bad
        # lower-state energies as negative):
        keep = (wn >= wn_low) & (wn <= wn_high) & (elow > 0)
        return wn[keep], gf[keep], elow[keep], iso_id[keep]


class Exomol(Linelist):
    """ExoMol .trans / .states file pairs."""

    def __init__(self, dbfile, pffile):
        super().__init__(dbfile, pffile)
        if not os.path.isfile(dbfile):
            raise FileNotFoundError(f"Exomol file '{dbfile}' does not exist")
        # The states file beside it: NAME__DB.states[.bz2] for
        # NAME__DB__RANGE.trans.  The rule reads the file's name only
        # (the JAX package applies it to the whole path, so a directory
        # named with 'trans', '__' or '.' hides the states file):
        directory, name = os.path.split(dbfile)
        sname = name.replace('trans', 'states')
        if sname.count('__') == 2:
            suffix = sname[sname.rindex('__'):sname.index('.')]
            sname = sname.replace(suffix, '')
        sfile = os.path.join(directory, sname)
        if os.path.isfile(sfile):
            with open(sfile) as f:
                lines = f.readlines()
        elif os.path.isfile(sfile + '.bz2'):
            with bz2.open(sfile + '.bz2', 'rt') as f:
                lines = f.readlines()
        else:
            raise FileNotFoundError(f"Exomol file '{sfile}' does not exist")

        cols = np.array([line.split()[0:3] for line in lines])
        state_id = cols[:, 0].astype(int)
        nstates = state_id.max() + 1
        self.e_state = np.zeros(nstates)
        self.g_state = np.zeros(nstates, int)
        self.e_state[state_id] = cols[:, 1].astype(float)
        self.g_state[state_id] = cols[:, 2].astype(int)

        self.molecule, self.iso = get_exomol_mol(dbfile)
        self.name = 'Exomol ' + self.molecule
        isotopes, mass, ratio = get_iso(self.molecule)
        self.isotopes = isotopes
        self.mass = mass
        self.isoratio = ratio

    def dbread(self, wn_low, wn_high):
        data = np.loadtxt(self.dbfile, usecols=(0, 1, 2))
        up = data[:, 0].astype(int)
        lo = data[:, 1].astype(int)
        a21 = data[:, 2]
        wn = self.e_state[up] - self.e_state[lo]
        if wn_low > np.amax(wn) or wn_high < np.amin(wn):
            return None
        keep = (wn >= wn_low) & (wn <= wn_high)
        wn = wn[keep]
        gf = _gf_from_a21(self.g_state[up[keep]], a21[keep], wn)
        elow = self.e_state[lo[keep]]
        iso_id = np.full(len(wn), self.isotopes.index(self.iso), int)
        return wn, gf, elow, iso_id


class Repack(Linelist):
    """repack binary format: (wn, elow, gf, iso) double/int records."""

    def __init__(self, dbfile, pffile):
        super().__init__(dbfile, pffile)
        self.molecule, self.dbtype = \
            os.path.split(dbfile)[1].split('_')[0:2]
        self.name = f'repack {self.dbtype} {self.molecule}'
        isotopes, mass, ratio = get_iso(self.molecule)
        self.isotopes = isotopes
        self.mass = mass
        self.isoratio = ratio

    def dbread(self, wn_low, wn_high):
        recsize = struct.calcsize('dddi')
        dtype = np.dtype([
            ('wn', 'f8'), ('elow', 'f8'), ('gf', 'f8'), ('iso', 'i4'),
        ])
        assert dtype.itemsize == recsize
        data = np.fromfile(self.dbfile, dtype=dtype)
        wn = data['wn']
        if wn_low > wn[-1] or wn_high < wn[0]:
            return None
        keep = (wn >= wn_low) & (wn <= wn_high)
        data = data[keep]

        iso_len = len(self.isotopes[0])
        unique_iso, inverse = np.unique(data['iso'], return_inverse=True)
        idx = np.zeros(len(unique_iso), int)
        missing = []
        for i, iso in enumerate(unique_iso):
            name = str(iso).zfill(iso_len)
            if name in self.isotopes:
                idx[i] = self.isotopes.index(name)
            else:
                missing.append(name)
        if missing:
            raise ValueError(
                f'Unrecognized isotope names for {self.molecule} '
                f'line-list: {missing}'
            )
        return data['wn'], data['gf'], data['elow'], idx[inverse]


def get_exomol_mol(dbfile):
    """Molecule name + isotope code from an ExoMol file name.

    Follows the ExoMol naming convention (Tennyson et al. 2016):
    '1H2-16O__POKAZATEL__00400-00500.trans' -> ('H2O', '116').
    """
    import itertools
    import re
    atoms = os.path.split(dbfile)[1].split('_')[0].split('-')
    elements = []
    isotope = ''
    for atom in atoms:
        match = re.match(r'([0-9]+)([a-z]+)([0-9]*)', atom, re.I)
        count = 1 if match.group(3) == '' else int(match.group(3))
        elements += count * [match.group(2)]
        isotope += match.group(1)[-1:] * count
    composition = [list(g[1]) for g in itertools.groupby(elements)]
    molecule = ''.join(
        c[0] + str(len(c)) * (len(c) > 1) for c in composition
    )
    if molecule == 'OCO':
        molecule = 'CO2'
    return molecule, isotope


class Pands(Linelist):
    """Partridge & Schwenke (1997) H2O binary line list.

    Records are packed (uint32 log-wavelength index, int16 Elow code,
    int16 gf code); gf/Elow decode through a 10^(0.001 x) table and the
    isotope hides in the sign bits.
    """

    _RATIOLOG = np.log(1.0 + 1.0 / 2e6)
    _TABLOG = 10.0 ** (0.001 * (np.arange(32769) - 16384))

    def __init__(self, dbfile, pffile):
        super().__init__(dbfile, pffile)
        # Short (exomol-style) isotope labels, consistent with the PF
        # files written by partitions.kurucz:
        self.isotopes = ['116', '117', '118', '126']
        self.mass = [18.01056468, 19.01478156, 20.01481046, 19.01684143]
        self.isoratio = [0.997000, 0.000508, 0.000508, 0.001984]
        self.molecule = 'H2O'
        self.name = 'Partridge & Schwenke (1997)'

    def dbread(self, wn_low, wn_high):
        dtype = np.dtype([('iw', '<u4'), ('ielo', '<i2'), ('igf', '<i2')])
        data = np.fromfile(self.dbfile, dtype=dtype)
        wn = 1.0 / (np.exp(data['iw'] * self._RATIOLOG) * pc.nm)
        # File is sorted by increasing wavelength = decreasing wn:
        if wn_low > wn[0] or wn_high < wn[-1]:
            if wn_low > np.amax(wn) or wn_high < np.amin(wn):
                return None
        keep = (wn >= wn_low) & (wn <= wn_high)
        data = data[keep]
        wn = wn[keep]
        gf = 4.0 * self._TABLOG[np.abs(data['igf'])]
        elow = np.abs(data['ielo']).astype(float)
        iso_id = 2 * (data['ielo'] < 0) + 1 * (data['igf'] < 0)
        order = np.argsort(wn)
        return wn[order], gf[order], elow[order], iso_id[order]


class Tioschwenke(Linelist):
    """Schwenke (1998) TiO binary line list (Kurucz distribution)."""

    _RATIOLOG = np.log(1.0 + 1.0 / 2e6)
    _TABLOG = 10.0 ** (0.001 * (np.arange(32769) - 16384))

    def __init__(self, dbfile, pffile):
        super().__init__(dbfile, pffile)
        self.name = 'Schwenke TiO (1998)'
        self.molecule = 'TiO'
        isotopes, mass, ratio = get_iso(self.molecule)
        self.isotopes = isotopes
        self.mass = mass
        self.isoratio = ratio

    def dbread(self, wn_low, wn_high):
        # 16-byte records; first 10 bytes are (int32 iw, 3x int16):
        dtype = np.dtype([
            ('iw', '<i4'), ('ieli', '<i2'), ('ielo', '<i2'),
            ('igf', '<i2'), ('pad', 'V6'),
        ])
        data = np.fromfile(self.dbfile, dtype=dtype)
        wn = 1.0 / (np.exp(data['iw'] * self._RATIOLOG) * pc.nm)
        if wn_low > np.amax(wn) or wn_high < np.amin(wn):
            return None
        keep = (wn >= wn_low) & (wn <= wn_high)
        data = data[keep]
        wn = wn[keep]
        gf = self._TABLOG[data['igf']]
        elow = self._TABLOG[data['ielo']]
        iso_id = np.abs(data['ieli']) - 8950
        order = np.argsort(wn)
        return wn[order], gf[order], elow[order], iso_id[order]


class Voplez(Linelist):
    """Plez (1998) VO ASCII line list (53-char records, sorted by
    wavelength; Elow in eV)."""

    def __init__(self, dbfile, pffile):
        super().__init__(dbfile, pffile)
        self.name = 'Bertrand Plez VO'
        self.molecule = 'VO'
        self.isotopes = ['16']
        self.mass = [66.941]
        self.isoratio = [1.0]
        # Partition-function polynomial coefficients (B. Plez):
        self.pf_coeffs = np.array([[
            6.62090157e+02, -4.03350494e+02, 9.82836218e+01,
            -1.18526504e+01, 7.08429905e-01, -1.67235124e-02,
        ]])

    def dbread(self, wn_low, wn_high):
        recsize = 53
        with open(self.dbfile, 'rb') as f:
            raw = f.read()
        nlines = len(raw) // recsize
        rec = np.frombuffer(raw, dtype=f'S{recsize}', count=nlines)
        view = rec.view('S1').reshape(nlines, recsize)

        def col(lo, hi):
            text = view[:, lo:hi].view(f'S{hi-lo}').ravel()
            return np.char.strip(text.astype(str)).astype(float)

        wn = col(33, 43)
        if wn_low > np.amax(wn) or wn_high < np.amin(wn):
            return None
        keep = (wn >= wn_low) & (wn <= wn_high)
        gf = col(21, 32)[keep]
        elow = col(44, 50)[keep] * pc.eV   # eV -> cm-1
        wn = wn[keep]
        iso_id = np.zeros(len(wn), int)
        order = np.argsort(wn)
        return wn[order], gf[order], elow[order], iso_id[order]


class Vald(Linelist):
    """VALD atomic line lists (short-format CSV extract)."""

    def __init__(self, dbfile, pffile, ion=None):
        super().__init__(dbfile, pffile)
        if ion is None:
            # Infer the ion from the file name, e.g. VALD_Fe.dat -> Fe:
            base = os.path.splitext(os.path.basename(dbfile))[0]
            ion = base.split('_')[-1]
        self.molecule = ion
        self.isotopes = [ion]
        self.isoratio = [1.0]
        atom = ion.replace('+', '')
        ion_count = 1 + ion.count('+')
        ion_label = f"'{atom} {ion_count}'"
        with open(dbfile) as f:
            self._data = [
                line for line in f.readlines()
                if line.startswith(ion_label)
            ]
        self.name = f'VALD {self.molecule}'
        names, masses, _ = pio.read_molecs()
        if atom in names:
            self.mass = [float(masses[list(names).index(atom)])]
        else:
            self.mass = [1.0]

    def dbread(self, wn_low, wn_high):
        if not self._data:
            return None
        records = [line.split(',') for line in self._data]
        wn = np.array([rec[1] for rec in records], float)
        if wn_low > np.amax(wn) or wn_high < np.amin(wn):
            return None
        keep = (wn >= wn_low) & (wn <= wn_high)
        elow = np.array([rec[2] for rec in records], float)[keep]
        loggf = np.array([rec[3] for rec in records], float)[keep]
        wn = wn[keep]
        iso_id = np.zeros(len(wn), int)
        order = np.argsort(wn)
        return wn[order], 10.0**loggf[order], elow[order], iso_id[order]


_READERS = {
    'hitran': Hitran,
    'exomol': Exomol,
    'repack': Repack,
    'pands': Pands,
    'tioschwenke': Tioschwenke,
    'voplez': Voplez,
    'vald': Vald,
}


def get_linelist_reader(dbtype):
    if dbtype not in _READERS:
        raise ValueError(
            f"Unknown database type '{dbtype}', select from "
            f'{sorted(_READERS)}'
        )
    return _READERS[dbtype]
