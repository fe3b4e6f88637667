"""Transition-Line-Information (TLI) binary files.

Host-side numpy copy of pyratbay_tpu/opacity/tli.py: byte-compatible
with the reference's Lineread 6.x format (pyratbay/opacity/lread.py
writer, pyratbay/pyrat/line_by_line.py reader), so TLI files exchange
freely between the packages.  A finite wavenumber range is extracted by
the native runtime's binary search (runtime.tli_extract_range).

Layout: [endian char][3h version][2d wn range][h n_databases]
then per database: name, molecule (length-prefixed strings),
[h ntemp][h niso], temperatures, per-isotope (name, mass, ratio, pf),
then [i n_lines][i n_iso][per-db n_lines_iso arrays] and the
concatenated (wn, iso_id, elow, gf) arrays sorted by isotope then
wavenumber.
"""
import struct
import sys

import numpy as np

from .. import constants as pc
from .. import runtime
from .linelists import get_linelist_reader

__all__ = ['make_tli', 'read_tli', 'TliDatabase']

TLI_VERSION = (6, 5, 0)


def _pack_str(f, string):
    size = len(string)
    f.write(struct.pack(f'h{size}s', size, string.encode('utf-8')))


def _unpack(f, count, fmt):
    size = struct.calcsize(fmt) * count
    data = struct.unpack(f'{count}{fmt}', f.read(size))
    if fmt == 's':
        return data[0].decode('utf-8')
    if count == 1:
        return data[0]
    return data


class TliDatabase:
    """Per-database block of a TLI file."""

    def __init__(self, name, molname, temp, iso_name, iso_mass, iso_ratio,
                 iso_pf):
        self.name = name
        self.molname = molname
        self.temp = np.asarray(temp)
        self.ntemp = len(self.temp)
        self.iso_name = np.asarray(iso_name)
        self.niso = len(self.iso_name)
        self.iso_mass = np.asarray(iso_mass)
        self.iso_ratio = np.asarray(iso_ratio)
        self.iso_pf = np.asarray(iso_pf)


def make_tli(
        dblist, pflist, dbtype, tlifile, wl_low, wl_high, wl_units='um',
        verbose=True,
    ):
    """Compile line-list databases into a TLI file.

    Parameters
    ----------
    dblist/pflist/dbtype: lists of database files, partition-function
        sources ('tips', 'poly', or a file), and database types.
    wl_low/wl_high: wavelength range in `wl_units`.

    Returns the per-database summary list (for logging/tests).
    """
    if isinstance(dblist, str):
        dblist = [dblist]
    nfiles = len(dblist)
    if isinstance(pflist, str):
        pflist = [pflist]
    if len(pflist) == 1:
        pflist = pflist * nfiles
    if isinstance(dbtype, str):
        dbtype = [dbtype]
    if len(dbtype) == 1:
        dbtype = dbtype * nfiles
    if nfiles != len(pflist) or nfiles != len(dbtype):
        raise ValueError(
            f'The number of line-transition files ({nfiles}) does not '
            f'match the number of partition-function files '
            f'({len(pflist)}) or database types ({len(dbtype)})'
        )

    readers = []
    unique_dbs = []
    for dbase, pffile, dtype in zip(dblist, pflist, dbtype):
        reader = get_linelist_reader(dtype.lower())(dbase, pffile)
        readers.append(reader)
        if reader.name not in unique_dbs:
            unique_dbs.append(reader.name)

    wn_low = 1.0 / wl_high / pc.u(wl_units)
    wn_high = 1.0 / wl_low / pc.u(wl_units)

    databases = []
    summaries = []
    for db_name in unique_dbs:
        wn, gf, elow, iso_id = [], [], [], []
        db = None
        for reader in readers:
            if reader.name != db_name:
                continue
            db = reader
            transitions = reader.dbread(wn_low, wn_high)
            if transitions is None:
                continue
            wn.append(transitions[0])
            gf.append(transitions[1])
            elow.append(transitions[2])
            iso_id.append(transitions[3])
        if not wn:
            raise ValueError(
                f"Database '{db_name}' has no transitions in the "
                f'[{wn_low:.2f}, {wn_high:.2f}] cm-1 range'
            )
        wn = np.concatenate(wn)
        gf = np.concatenate(gf)
        elow = np.concatenate(elow)
        iso_id = np.concatenate(iso_id)

        # Sort by isotope then wavenumber (lexsort does both at once):
        isort = np.lexsort((wn, iso_id))
        wn, gf, elow, iso_id = wn[isort], gf[isort], elow[isort], \
            iso_id[isort]
        unique_iso, iso_idx, ntrans_iso = np.unique(
            iso_id, return_inverse=True, return_counts=True,
        )

        iso_names = np.array(db.isotopes)[unique_iso]
        iso_mass = np.array(db.mass)[unique_iso]
        iso_ratio = np.array(db.isoratio)[unique_iso]
        temp, partition, pf_iso = db.getpf()
        missing = np.setdiff1d(iso_names, pf_iso)
        if len(missing):
            raise ValueError(
                'No partition functions found for these isotopes of the '
                f'{db.molecule} line list: {missing}'
            )
        pf_idx = [list(pf_iso).index(iso) for iso in iso_names]
        partition = np.asarray(partition)[pf_idx]

        databases.append({
            'name': db.name,
            'molecule': db.molecule,
            'n_lines': len(wn),
            'n_lines_iso': ntrans_iso,
            'iso_id': iso_idx,
            'wn': wn, 'elow': elow, 'gf': gf,
            'temperatures': temp,
            'isotopes': iso_names,
            'iso_mass': iso_mass,
            'iso_ratio': iso_ratio,
            'partition': partition,
        })
        summaries.append({
            'name': db.name,
            'molecule': db.molecule,
            'n_lines': len(wn),
            'isotopes': list(iso_names),
            'n_lines_iso': list(ntrans_iso),
            'ntemp': len(temp),
        })

    with open(tlifile, 'wb') as f:
        endian = sys.byteorder[0]
        f.write(struct.pack('s', endian.encode('utf-8')))
        f.write(struct.pack('3h', *TLI_VERSION))
        f.write(struct.pack('2d', wn_low, wn_high))
        f.write(struct.pack('h', len(databases)))
        for db in databases:
            _pack_str(f, db['name'])
            _pack_str(f, db['molecule'])
            f.write(struct.pack(
                'hh', len(db['temperatures']), len(db['isotopes']),
            ))
            f.write(np.asarray(db['temperatures'], '<f8').tobytes())
            for j, iso in enumerate(db['isotopes']):
                _pack_str(f, str(iso))
                f.write(struct.pack('d', db['iso_mass'][j]))
                f.write(struct.pack('d', db['iso_ratio'][j]))
                f.write(np.asarray(db['partition'][j], '<f8').tobytes())
        n_lines = int(np.sum([db['n_lines'] for db in databases]))
        f.write(struct.pack('i', n_lines))
        n_lines_iso = np.concatenate(
            [db['n_lines_iso'] for db in databases],
        )
        f.write(struct.pack('i', len(n_lines_iso)))
        for db in databases:
            f.write(np.asarray(db['n_lines_iso'], '<i4').tobytes())
        for db in databases:
            f.write(np.asarray(db['wn'], '<f8').tobytes())
        for db in databases:
            f.write(np.asarray(db['iso_id'], '<i2').tobytes())
        for db in databases:
            f.write(np.asarray(db['elow'], '<f8').tobytes())
        for db in databases:
            f.write(np.asarray(db['gf'], '<f8').tobytes())
    return summaries


def read_tli(tli_file, wn_low=-np.inf, wn_high=np.inf):
    """Read a TLI file, extracting transitions within a wavenumber range.

    Returns (databases, wn, gf, elow, iso_id) with iso_id indexing the
    concatenated per-database isotope lists.
    """
    with open(tli_file, 'rb') as f:
        endian = f.read(1).decode()
        if endian != sys.byteorder[0]:
            raise ValueError(
                f'Incompatible endianness between TLI file ({endian}) '
                f'and host ({sys.byteorder[0]})'
            )
        ver, minor, rev = _unpack(f, 3, 'h')
        if ver != 6 or minor not in (1, 2, 3, 4, 5):
            raise ValueError(
                'Incompatible TLI version; must be Lineread 6.1-6.5'
            )
        lbl_wn_low, lbl_wn_high = _unpack(f, 2, 'd')
        n_db = _unpack(f, 1, 'h')

        databases = []
        for _ in range(n_db):
            name = _unpack(f, _unpack(f, 1, 'h'), 's')
            molname = _unpack(f, _unpack(f, 1, 'h'), 's')
            ntemp = _unpack(f, 1, 'h')
            niso = _unpack(f, 1, 'h')
            temp = np.frombuffer(f.read(8 * ntemp), '<f8')
            iso_name = []
            iso_mass = np.zeros(niso)
            iso_ratio = np.zeros(niso)
            iso_pf = np.zeros((niso, ntemp))
            for j in range(niso):
                iso_name.append(_unpack(f, _unpack(f, 1, 'h'), 's'))
                iso_mass[j] = _unpack(f, 1, 'd')
                iso_ratio[j] = _unpack(f, 1, 'd')
                iso_pf[j] = np.frombuffer(f.read(8 * ntemp), '<f8')
            databases.append(TliDatabase(
                name, molname, temp, iso_name, iso_mass, iso_ratio, iso_pf,
            ))

        n_transitions = _unpack(f, 1, 'i')
        n_iso = _unpack(f, 1, 'i')
        niso_tran = np.frombuffer(f.read(4 * n_iso), '<i4')

        wn = np.frombuffer(f.read(8 * n_transitions), '<f8')
        iso_id = np.frombuffer(f.read(2 * n_transitions), '<i2')
        elow = np.frombuffer(f.read(8 * n_transitions), '<f8')
        gf = np.frombuffer(f.read(8 * n_transitions), '<f8')

    # Per-isotope wavenumber-range extraction (arrays are sorted by
    # isotope then wavenumber):
    if np.isfinite(wn_low) or np.isfinite(wn_high):
        wn, iso_id, elow, gf = runtime.tli_extract_range(
            wn, iso_id, elow, gf, niso_tran, wn_low, wn_high)
    else:
        wn, iso_id, elow, gf = runtime.tli_extract_range_plain(
            wn, iso_id, elow, gf, niso_tran, wn_low, wn_high)
    return databases, wn, gf, elow, iso_id
