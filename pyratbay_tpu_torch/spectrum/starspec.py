"""Stellar spectra: the blackbody star.

Host-side numpy copy of pyratbay_tpu/spectrum/starspec.py::bbflux.
Kurucz grids and starspec SED files are not ported yet: Model setup
raises NotImplementedError for them.
"""
import numpy as np

from .. import constants as pc

__all__ = ['bbflux']


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
