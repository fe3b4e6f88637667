"""Stellar spectra: blackbody flux and Kurucz model grids.

Host-side numpy copy of pyratbay_tpu/spectrum/starspec.py (bbflux,
read_kurucz); starspec SED files are read by io.read_spectra.
"""
import numpy as np

from .. import constants as pc

__all__ = ['bbflux', 'read_kurucz']


def bbflux(wn, teff):
    """Blackbody surface flux pi*B_nu(T) in erg s-1 cm-2 cm.

    Host-side numpy (setup path); the evaluation uses
    ops.planck.blackbody_wn.  Same kernel-parity constants.
    """
    wn = np.asarray(wn, float)
    factor = 2.0 * pc.H_KERNEL * pc.LS_KERNEL**2 * wn**3
    return np.pi * factor / np.expm1(
        pc.H_KERNEL * pc.LS_KERNEL * wn / (pc.KB_KERNEL * teff)
    )


def read_kurucz(filename, temp=None, logg=None):
    """Read a Kurucz .pck stellar model grid.

    With temp/logg given, returns the closest model's
    (flux [erg s-1 cm-2 cm], wavenumber [cm-1], ktemp, klogg);
    else all models ([nmodels, nwave], wn, ktemps, kloggs).  The
    wavenumbers ascend.
    """
    with open(filename) as f:
        lines = f.readlines()

    iheaders = [
        i for i, line in enumerate(lines) if line.startswith('TEFF')
    ]
    headers = [lines[i].strip() for i in iheaders]
    ktemp = np.array([line[5:12] for line in headers], float)
    klogg = np.array([line[22:29] for line in headers], float)

    i = 0
    while lines[i].strip() != 'END':
        i += 1
    wavelength = np.array(
        ''.join(lines[i + 1:iheaders[0]]).split(), float,
    )  # nm
    wavenumber = np.flip(1.0 / (wavelength * pc.nm))

    nmodels = len(headers)
    nwave = len(wavenumber)
    nlines = (iheaders[1] - iheaders[0] - 1) // 2
    vsize = 10

    if temp is not None and logg is not None:
        tmodel = ktemp[np.argmin(np.abs(ktemp - temp))]
        gmodel = klogg[np.argmin(np.abs(klogg - logg))]
        imodels = np.where((ktemp == tmodel) & (klogg == gmodel))[0]
    else:
        imodels = range(nmodels)

    intensity = np.zeros((nmodels, nwave))
    for k, i in enumerate(imodels):
        istart = iheaders[i] + 1
        data = ''.join(lines[istart:istart + nlines]).replace('\n', '')
        intensity[k] = [
            data[j * vsize:(j + 1) * vsize] for j in range(nwave)
        ]

    # Intensity per Hz -> flux per wavenumber (erg s-1 cm-2 cm):
    flux = np.flip(intensity, axis=1) * 4.0 * np.pi * pc.c
    if temp is not None and logg is not None:
        return flux[0], wavenumber, tmodel, gmodel
    return flux, wavenumber, ktemp, klogg
