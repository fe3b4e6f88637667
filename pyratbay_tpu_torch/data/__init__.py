"""Packaged physical data: species properties, isotope tables,
TIPS-2021 partition functions, the bundled CIA tables and the bundled
instrument passbands.

The isotope, TIPS, CIA and filter tables are the JAX package's bundled
files (`pyratbay_tpu/data/*.npz`, `pyratbay_tpu/data/cia/*.npz`), read by
path through TABLES_DIR rather than copied: a file read imports nothing
of that package.
"""
import functools
import os

import numpy as np

__all__ = ['TABLES_DIR', 'isotopes_table', 'tips_table', 'get_iso',
           'list_cia', 'cia_file', 'list_filters', 'filter_response']

TABLES_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.realpath(__file__)))),
    'pyratbay_tpu', 'data')


@functools.lru_cache(maxsize=1)
def isotopes_table():
    """Isotopologue data (HITRAN + ExoMol catalogues).

    Returns dict of arrays: molecule, hitran_iso, exomol_iso, iso_ratio,
    iso_mass.
    """
    with np.load(os.path.join(TABLES_DIR, 'isotopes.npz')) as f:
        return {key: f[key] for key in f.files}


@functools.lru_cache(maxsize=1)
def tips_table():
    """TIPS 2021 partition functions (Gamache et al. 2021).

    Returns (data, temp, mol_ids) where data maps molecule ->
    {isotope: pf_row} and mol_ids maps HITRAN molecule IDs to names.
    """
    with np.load(os.path.join(TABLES_DIR, 'tips_2021.npz')) as f:
        mols = f['molecule']
        isos = f['isotope']
        ntemp = f['ntemp']
        pf = f['pf']
        temp = f['temp']
        mol_ids = dict(zip(f['mol_id_keys'], f['mol_id_names']))
    data = {}
    for i, mol in enumerate(mols):
        data.setdefault(str(mol), {})[str(isos[i])] = pf[i, :ntemp[i]]
    return data, temp, mol_ids


def list_cia():
    """Bundled collision-induced-absorption tables (Borysow data, as
    npz), by name."""
    cia_dir = os.path.join(TABLES_DIR, 'cia')
    return sorted(
        os.path.splitext(f)[0] for f in os.listdir(cia_dir)
        if f.endswith('.npz')
    )


def cia_file(name):
    """Path of a bundled CIA table.

    `name` may be the full table name, a '.dat' reference-style
    basename, or a species pair like 'H2H2' / 'H2He' (the first match
    wins).
    """
    stem = os.path.splitext(os.path.basename(str(name)))[0]
    available = list_cia()
    if stem in available:
        return os.path.join(TABLES_DIR, 'cia', stem + '.npz')
    matches = [cia for cia in available if f'_{stem}_' in cia]
    if matches:
        return os.path.join(TABLES_DIR, 'cia', matches[0] + '.npz')
    raise FileNotFoundError(
        f"No bundled CIA table matching '{name}'; available: {available}"
    )


@functools.lru_cache(maxsize=1)
def _filter_bundle():
    with np.load(os.path.join(TABLES_DIR, 'filters.npz')) as f:
        return {key: f[key] for key in f.files}


def list_filters():
    """Bundled instrument passband names (CHEOPS, Kepler, Spitzer
    IRAC/MIPS, TESS)."""
    return sorted(
        key[:-3] for key in _filter_bundle() if key.endswith('_wl'))


def filter_response(name):
    """(wl [um], response) arrays of a bundled instrument passband."""
    bundle = _filter_bundle()
    key = str(name).lower()
    if key + '_wl' not in bundle:
        raise FileNotFoundError(
            f"No bundled filter named '{name}'; available: "
            f'{list_filters()}')
    return bundle[key + '_wl'], bundle[key + '_response']


def get_iso(molname):
    """Isotope names (exomol notation), masses, and ratios for a molecule.

    Order follows the isotopes table (HITRAN order first).
    """
    table = isotopes_table()
    sel = table['molecule'] == molname
    return (
        [str(iso) for iso in table['exomol_iso'][sel]],
        list(table['iso_mass'][sel]),
        list(table['iso_ratio'][sel]),
    )
