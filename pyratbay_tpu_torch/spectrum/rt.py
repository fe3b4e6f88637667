"""Transit radiative transfer, per chain, in plain torch.

Port of pyratbay_tpu/spectrum/rt.py (transit_depth and
transmission_spectrum).  This is the per-chain reference that the
ensemble kernel's plain version (spectrum/transit_kernel.py) is held
to in the tests.
"""
import numpy as np
import torch
import torch.nn.functional as F

__all__ = ['transit_depth', 'transmission_spectrum']


def transit_depth(ec, path, maxdepth=np.inf, itop=0, ibottom=None):
    """Transmission optical depth for every impact parameter.

    ec [l, nwave] extinction (cm-1); path [l, l-1] chord matrix.
    Returns depth [l, nwave] (zero outside [itop, ibottom)) and ideep
    [nwave]: the first layer whose depth exceeds maxdepth, else
    ibottom-1.
    """
    nlayers = ec.shape[0]
    if ibottom is None:
        ibottom = nlayers
    path2 = F.pad(path, (1, 0)) + F.pad(path, (0, 1))
    depth = path2 @ ec
    rows = torch.arange(nlayers, device=ec.device)
    in_range = (rows >= itop) & (rows < ibottom)
    depth = torch.where(in_range[:, None], depth, torch.zeros_like(depth))
    exceeded = (depth > maxdepth) & in_range[:, None]
    any_exceed = torch.any(exceeded, dim=0)
    first_exceed = torch.argmax(exceeded.to(torch.int8), dim=0)
    ideep = torch.where(
        any_exceed, first_exceed, torch.full_like(first_exceed, ibottom - 1))
    return depth, ideep


def transmission_spectrum(
        depth, ideep, radius, rstar, itop=0, deck_rsurf=None, deck_itop=None,
    ):
    """Transit (Rp/Rs)^2 spectrum:
    (r[itop]^2 + 2 * integral e^-tau r dr) / rstar^2, each wavelength
    integrated down to its ideep layer, with the opaque-deck splice at
    (deck_itop, deck_rsurf)."""
    nlayers = depth.shape[0]
    integ = torch.exp(-depth) * radius[:, None]
    h = radius[1:] - radius[:-1]
    if deck_rsurf is not None:
        j = int(deck_itop) - 1
        w = (radius[j] - deck_rsurf) / (radius[j] - radius[j + 1])
        integ_surf = integ[j] * (1.0 - w) + integ[j + 1] * w
        if int(deck_itop) > int(itop):
            h = h.clone()
            h[j] = deck_rsurf - radius[j]
            integ = integ.clone()
            integ[j + 1] = integ_surf
    terms = 0.5 * h[:, None] * (integ[:-1] + integ[1:])
    idx = torch.arange(nlayers - 1, device=depth.device)[:, None]
    mask = (idx >= itop) & (idx < ideep[None, :])
    integral = torch.sum(
        torch.where(mask, terms, torch.zeros_like(terms)), dim=0)
    return (radius[int(itop)] ** 2 + 2.0 * integral) / rstar**2
