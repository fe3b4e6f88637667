"""Contribution functions and transmittance diagnostics.

Port of pyratbay_tpu/spectrum/contribution.py on tensors.
"""
import torch

__all__ = ['contribution_function', 'transmittance', 'band_cf']


def contribution_function(optdepth, pressure, bbody):
    """Emission contribution function, Knutson et al. (2009) eq. (2).

    cf[i] = B[i] * d(e^-tau)/dln(p), normalized per wavelength.
    optdepth, bbody [l, W]; pressure [l].
    """
    detau = torch.diff(torch.exp(-optdepth), dim=0)
    detau = torch.where(detau > 0.1, torch.zeros_like(detau), detau)
    dlogp = torch.diff(torch.log(torch.as_tensor(
        pressure, dtype=optdepth.dtype, device=optdepth.device)))
    cf = bbody[:-1] * detau / dlogp[:, None]
    cf = torch.cat([cf, torch.zeros_like(cf[:1])], dim=0)
    return cf / torch.sum(cf, dim=0)


def transmittance(optdepth, ideep):
    """Transit transmittance e^-tau, opaque (0) below the ideep layer."""
    lay = torch.arange(optdepth.shape[0], device=optdepth.device)[:, None]
    transmit = torch.exp(-optdepth)
    return torch.where(lay >= ideep[None, :], torch.zeros_like(transmit),
                       transmit)


def band_cf(cf, band_weight_matrix):
    """Band-averaged contribution functions.

    band_weight_matrix: [nbands, W] trapezoid weight rows over each
    band's response (unnormalized is fine; the output is max-normalized).
    Returns [l, nbands].
    """
    bands_cf = cf @ band_weight_matrix.T
    return bands_cf / torch.max(bands_cf, dim=0).values
