"""Packaged physical data: species properties, isotope tables and
TIPS-2021 partition functions.

The isotope and TIPS tables are the JAX package's bundled files
(`pyratbay_tpu/data/*.npz`), read by path through TABLES_DIR rather
than copied: a file read imports nothing of that package.
"""
import functools
import os

import numpy as np

__all__ = ['TABLES_DIR', 'isotopes_table', 'tips_table', 'get_iso']

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
