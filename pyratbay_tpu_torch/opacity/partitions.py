"""Partition functions: TIPS 2021 tables.

Host-side numpy copy of pyratbay_tpu/opacity/partitions.py (tips,
get_tips_molname).  ExoMol .pf files, Kurucz tables and polynomial
expressions are not ported yet (ROADMAP.md A13).
"""
import numpy as np
from scipy.interpolate import CubicSpline

from ..data import tips_table, isotopes_table

__all__ = ['tips', 'get_tips_molname', 'exomol_pf', 'kurucz', 'poly_pf']


def _not_ported(what):
    return NotImplementedError(
        f'{what} is not ported to pyratbay_tpu_torch yet (ROADMAP.md A13)')


def get_tips_molname(mol_id):
    """TIPS/HITRAN molecule name for a HITRAN molecule ID."""
    if mol_id == 34:
        return 'O'
    _, _, mol_ids = tips_table()
    if mol_id not in mol_ids:
        raise ValueError(
            f'TIPS 2021 database does not contain molecule ID: {mol_id}'
        )
    return str(mol_ids[mol_id])


def tips(molecule, isotopes=None, db_type='as_exomol'):
    """TIPS-2021 partition functions for a molecule.

    Shorter per-isotope tables are extrapolated to the longest one with
    a cubic spline in log(pf) on a 10x-thinned grid (matching the
    reference's extension scheme, partitions.py:130-158).

    Returns (pf [niso, ntemp], isotopes, temp [K]).
    """
    data, tips_temp, _ = tips_table()
    if molecule not in data:
        raise ValueError(f"Molecule '{molecule}' is not in TIPS database.")
    if isotopes is None:
        isotopes = list(data[molecule])
    if isinstance(isotopes, str):
        isotopes = [isotopes]
    for iso in isotopes:
        if iso not in data[molecule]:
            raise ValueError(
                f"Molecule '{molecule}' does not have isotope '{iso}'"
            )

    ntemps = [len(data[molecule][iso]) for iso in isotopes]
    ntemp_max = int(np.amax(ntemps))
    temp = tips_temp[:ntemp_max]
    niso = len(isotopes)
    pf = np.zeros((niso, ntemp_max))
    for i, iso in enumerate(isotopes):
        part = data[molecule][iso]
        ntemp = ntemps[i]
        pf[i, :ntemp] = part
        if ntemp < ntemp_max:
            thin = 10
            spline = CubicSpline(
                tips_temp[:ntemp:thin], np.log(part[::thin]),
                bc_type='not-a-knot',
            )
            pf[i, ntemp:] = np.exp(spline(tips_temp[ntemp:ntemp_max]))

    if db_type == 'as_exomol':
        table = isotopes_table()
        sel = table['molecule'] == molecule
        hitran_to_exomol = dict(zip(
            table['hitran_iso'][sel], table['exomol_iso'][sel],
        ))
        isotopes = [str(hitran_to_exomol.get(iso, iso)) for iso in isotopes]
    return pf, isotopes, temp


def exomol_pf(pf_file):
    """ExoMol .pf partition files (not ported)."""
    raise _not_ported('ExoMol partition functions (exomol_pf)')


def kurucz(pf_file, outfile=None):
    """Kurucz partition-function tables (not ported)."""
    raise _not_ported('Kurucz partition functions (kurucz)')


def poly_pf(coeffs, temp=None):
    """Polynomial partition functions (not ported)."""
    raise _not_ported('Polynomial partition functions (poly_pf)')
