"""Radiative transfer in plain torch: transit, plane-parallel and
two-stream emission.

Port of pyratbay_tpu/spectrum/rt.py.  transit_depth and
transmission_spectrum work on one chain; plane_parallel_depth,
plane_parallel_intensity, two_stream and internal_flux take any leading
(chain) axes.  These are the
references that the kernels' plain versions (spectrum/transit_kernel.py,
spectrum/emission_kernel.py) are held to in the tests; the emission
one also runs them itself.
"""
import numpy as np
import scipy.special as ss
import torch
import torch.nn.functional as F

from .. import constants as pc
from ..ops.planck import blackbody_wn
from ..ops.special import exp1

__all__ = [
    'transit_depth', 'transmission_spectrum', 'plane_parallel_depth',
    'plane_parallel_intensity', 'gauss_quadrature', 'two_stream',
    'internal_flux',
]


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


def _per_chain(value, like, ndim):
    """An int or [...] tensor of layer indices as int64 with `ndim`
    trailing unit axes, broadcastable against `like`'s leading axes."""
    value = torch.as_tensor(value, device=like.device).to(torch.int64)
    return value.reshape(value.shape + (1,) * ndim)


def cumulative_depth(ec, dr, maxdepth=np.inf, itop=0, bottom=None):
    """plane_parallel_depth on layer thicknesses dr [..., l-1] (positive)
    and an integration bottom that is already clipped to [0, l-1]."""
    nlayers, nwave = ec.shape[-2:]
    if bottom is None:
        bottom = nlayers - 1
    itop = _per_chain(itop, ec, 2)
    bottom = _per_chain(bottom, ec, 1)
    steps = 0.5 * dr[..., None] * (ec[..., 1:, :] + ec[..., :-1, :])
    rows = torch.arange(nlayers, device=ec.device)[:, None]
    csum = torch.cumsum(
        torch.where(rows[1:] > itop, steps, torch.zeros_like(steps)), dim=-2)
    depth = torch.cat([torch.zeros_like(csum[..., :1, :]), csum], dim=-2)
    depth = torch.where(rows > itop, depth, torch.zeros_like(depth))
    stop = (depth >= maxdepth) & (rows > itop)
    any_stop = torch.any(stop, dim=-2)
    first_stop = torch.argmax(stop.to(torch.int8), dim=-2)
    ideep = torch.where(
        any_stop, torch.minimum(first_stop, bottom), bottom.expand_as(first_stop))
    return depth, ideep


def plane_parallel_depth(ec, radius, maxdepth=np.inf, itop=0, ibottom=None):
    """Vertical optical depth for plane-parallel (emission) geometry.

    ec [..., l, nwave]; radius [..., l]; itop, ibottom ints or [...]
    tensors.  depth[k] is the cumulative trapezoid of ec over the layer
    thicknesses, zero at and above itop.  ideep [..., nwave] is the
    first row below itop where depth >= maxdepth, clipped to
    min(ibottom, l-1), else that bottom.  Returns (depth, ideep).
    """
    nlayers = ec.shape[-2]
    if ibottom is None:
        ibottom = nlayers
    bottom = torch.clamp(
        torch.as_tensor(ibottom, device=ec.device), max=nlayers - 1)
    dr = radius[..., :-1] - radius[..., 1:]
    return cumulative_depth(ec, dr, maxdepth, itop, bottom)


def gauss_quadrature(nquad):
    """Gauss-Legendre nodes mapped to mu = cos(theta) over a hemisphere.

    Returns (mu [nquad], weights [nquad]) such that
    flux = sum_k weights[k] * I(mu[k]) approximates
    pi * integral I(mu) mu dmu.
    """
    qnodes, qweights = ss.roots_legendre(nquad)
    qnodes = 0.5 * (qnodes + 1.0)
    return np.sqrt(qnodes), 0.5 * np.pi * qweights


def plane_parallel_intensity(depth, bbody, mu, ideep, rtop=0):
    """Emergent intensity I(mu) under plane-parallel LTE.

    I = B[ideep] e^{-tau[ideep]/mu} - integral B d(e^{-tau/mu}) from
    rtop to ideep (per wavelength), a masked trapezoid; a column with a
    single interval gives I = B[ideep].  Terms past ideep are masked
    with where, so NaN there does not reach the result.

    depth, bbody [..., l, nwave]; mu [nmu]; ideep [..., nwave]; rtop an
    int or [...] tensor.  Returns intensity [..., nmu, nwave].
    """
    nlayers = depth.shape[-2]
    mu = torch.as_tensor(mu, dtype=depth.dtype, device=depth.device)
    lay = torch.arange(nlayers - 1, device=depth.device)[:, None]
    taumax = torch.take_along_dim(depth, ideep[..., None, :], dim=-2)
    b_last = torch.take_along_dim(bbody, ideep[..., None, :], dim=-2)
    etau = torch.exp(-depth[..., None, :, :] / mu[:, None, None])
    dtau = etau[..., 1:, :] - etau[..., :-1, :]
    b_mid = (bbody[..., 1:, :] + bbody[..., :-1, :])[..., None, :, :]
    rtop = _per_chain(rtop, depth, 1)
    mask = (lay >= rtop[..., None, None]) & (lay < ideep[..., None, None, :])
    terms = dtau * b_mid
    integral = 0.5 * torch.sum(
        torch.where(mask, terms, torch.zeros_like(terms)), dim=-2)
    intensity = b_last * torch.exp(-taumax / mu[:, None]) - integral
    single = ((ideep - rtop) == 1)[..., None, :]
    return torch.where(single, b_last, intensity)


def two_stream(depth, bbody, wn, flux_down_top, f_int):
    """Heng et al. (2014) two-stream up and down fluxes through each
    layer (pyratbay_tpu spectrum/rt.py two_stream, over leading axes).

    depth, bbody [..., l, W]: the optical depth (no early stop) and the
    Planck function at the layer temperatures; wn [W]; flux_down_top
    [..., W] or [W]: the stellar irradiation at the top; f_int [..., W]
    or [W]: the internal flux, normalised to sigma Tint^4.  Returns
    flux_up, flux_down [..., l, W].

    The two sweeps are loops of l - 1 steps over [..., W] (the
    reference's lax.scan), each step as the reference writes it: a
    closed form by cumulative products would lose precision where the
    transmission is near 0.  Both branches of each guard are evaluated,
    so exp1 takes 1 where dtau = 0 and bp divides by 1 there: no NaN
    reaches the result.
    """
    dtau0 = depth[..., 1:, :] - depth[..., :-1, :]
    positive = dtau0 > 0
    safe_dtau = torch.where(positive, dtau0, torch.ones_like(dtau0))
    # Transmission with diffusivity (Heng et al. 2014, eq. B5):
    trans = (1.0 - dtau0) * torch.exp(-dtau0) + dtau0**2 * torch.where(
        positive, exp1(safe_dtau), torch.zeros_like(dtau0))
    bp = (bbody[..., 1:, :] - bbody[..., :-1, :]) / torch.where(
        dtau0 == 0, torch.ones_like(dtau0), dtau0)
    one_m_etau = -torch.expm1(-dtau0)
    nlayers = depth.shape[-2]

    fdown = flux_down_top.expand(depth[..., 0, :].shape)
    downs = [fdown]
    for i in range(nlayers - 1):
        t_i, bp_i = trans[..., i, :], bp[..., i, :]
        fdown = (
            t_i * fdown
            + np.pi * bbody[..., i, :] * (1.0 - t_i)
            + np.pi * bp_i * (
                -2.0 / 3.0 * one_m_etau[..., i, :]
                + dtau0[..., i, :] * (1.0 - t_i / 3.0))
        )
        downs.append(fdown)
    flux_down = torch.stack(downs, dim=-2)

    # Upward sweep (bottom boundary: down flux + internal flux):
    fup = flux_down[..., -1, :] + f_int
    ups = [fup]
    for i in range(nlayers - 2, -1, -1):
        t_i, bp_i = trans[..., i, :], bp[..., i, :]
        fup = (
            t_i * fup
            + np.pi * bbody[..., i + 1, :] * (1.0 - t_i)
            + np.pi * bp_i * (
                2.0 / 3.0 * one_m_etau[..., i, :]
                - dtau0[..., i, :] * (1.0 - t_i / 3.0))
        )
        ups.append(fup)
    flux_up = torch.stack(ups[::-1], dim=-2)
    return flux_up, flux_down


def internal_flux(wn, tint):
    """Internal heat flux spectrum [W] normalised to sigma Tint^4
    bolometric: the Planck function at tint over wn [W] (tensor)."""
    f_int = blackbody_wn(wn, tint)
    total = torch.trapezoid(f_int, wn)
    scale = torch.where(total > 0, pc.sigma_sb * tint**4 / total,
                        torch.zeros_like(total))
    return f_int * scale
