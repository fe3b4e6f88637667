"""Partition functions: TIPS 2021 tables, ExoMol .pf files, Kurucz
tables and polynomial expressions.

Host-side numpy copy of pyratbay_tpu/opacity/partitions.py.
Reference behavior: pyratbay/opacity/partitions/partitions.py.
"""
import numpy as np
from scipy.interpolate import CubicSpline

from ..data import tips_table, isotopes_table
from ..io import io as pio

__all__ = ['tips', 'get_tips_molname', 'exomol_pf', 'kurucz', 'poly_pf']


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
    """Read an ExoMol .pf partition file: (pf, isotope, temp)."""
    data = np.loadtxt(pf_file)
    return data[:, 1], None, data[:, 0]


def kurucz(pf_file, outfile=None):
    """Reformat a Kurucz partition-function table (H2O or TiO).

    Returns (pf [niso, ntemp], isotopes, temp); optionally writes a
    standard PF file.  Isotope labels use the short (exomol-style)
    notation consistent with the rest of the framework.
    """
    if 'h2o' in pf_file.lower():
        molecule = 'H2O'
        isotopes = ['116', '117', '118', '126']
        skiprows = 6
    elif 'tio' in pf_file.lower():
        molecule = 'TiO'
        isotopes = ['66', '76', '86', '96', '06']
        skiprows = 1
    else:
        raise ValueError('Invalid Kurucz partition-function file')
    data = np.loadtxt(pf_file, skiprows=skiprows, unpack=True)
    temp = data[0]
    pf_data = data[1:]
    if outfile == 'default':
        outfile = f'PF_kurucz_{molecule}.dat'
    if outfile is not None:
        pio.write_pf(
            outfile, pf_data, isotopes, temp,
            header=f'# Kurucz {molecule} partition function\n\n',
        )
    return pf_data, isotopes, temp


def poly_pf(coeffs, temp=None):
    """Polynomial log-PF (Irwin 1981, ApJS 45, 621, eq. 2)."""
    if temp is None:
        temp = np.arange(1000.0, 7001.0, 50.0)
    logt = np.log(temp)
    coeffs = np.atleast_2d(coeffs)
    log_pf = sum(
        coeffs[:, i][:, None] * logt[None, :]**i for i in range(6)
    )
    return np.exp(log_pf), temp
