"""Planck emission in wavenumber space, on tensors.

B_nu(T) = 2 h c^2 nu^3 / (exp(h c nu / k T) - 1)   [erg s-1 sr-1 cm-2 cm]

Port of pyratbay_tpu/ops/planck.py (same kernel-parity constants).
"""
import torch

from .. import constants as pc

__all__ = ['blackbody_wn']


def blackbody_wn(wn, temp):
    """Planck function over wavenumber (cm-1) and temperature (K).

    Broadcasts wn against temp: blackbody_wn(wn[nw], T[..., None])
    yields [..., nw] spectra.
    """
    factor = 2.0 * pc.H_KERNEL * pc.LS_KERNEL**2 * wn**3
    return factor / torch.expm1(
        pc.H_KERNEL * pc.LS_KERNEL * wn / (pc.KB_KERNEL * temp))
