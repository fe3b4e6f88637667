"""Hydrostatic-equilibrium radius profiles and gas-state helpers on
tensors with leading chain dimensions.

Port of pyratbay_tpu/atmosphere/hydro.py.
"""
import numpy as np
import torch

from .. import constants as pc
from ..ops.integrate import cumtrapz
from ..ops.interp import interp

__all__ = [
    'hydro_g', 'hydro_m', 'hill_radius', 'mean_weight',
    'ideal_gas_density', 'equilibrium_temp',
]


def _per_chain(value, like):
    """Scalar or [B] parameter -> [B] tensor matching `like` [B, l] (a
    scalar filled on the device: no copy from the host)."""
    if not torch.is_tensor(value) and np.ndim(value) == 0:
        return like.new_full((like.shape[0],), float(value))
    return torch.as_tensor(
        value, dtype=like.dtype, device=like.device,
    ).expand(like.shape[0])


def hydro_g(press, temp, mu, g, p0, r0):
    """Hydrostatic radius with constant gravity.

    press [l] bar tensor; temp, mu [B, l]; g, p0, r0 scalars or [B].
    """
    logp = torch.log(press)
    g = _per_chain(g, temp)[:, None]
    radius = cumtrapz(-pc.k * pc.N_A * temp / (mu * g), logp, axis=-1)
    r0 = _per_chain(r0, temp)
    p0 = _per_chain(p0, temp)
    return radius + (r0 - interp(p0, press, radius))[:, None]


def hydro_m(press, temp, mu, mass, p0, r0):
    """Hydrostatic radius with g(r) = G M / r^2, in r0-normalized units.

    press [l] bar tensor; temp, mu [B, l]; mass, p0, r0 scalars or [B].
    Layers above a divergence (non-monotonic radius) are +inf, matching
    the reference's puffy-atmosphere semantics.
    """
    logp = torch.log(press)
    r0 = _per_chain(r0, temp)[:, None]
    mass = _per_chain(mass, temp)[:, None]
    integ = cumtrapz(
        r0 * pc.k * pc.N_A * temp / (pc.G * mu * mass), logp, axis=-1,
    )
    i0 = interp(_per_chain(p0, temp), press, integ)
    radius = r0 / (integ - i0[:, None] + 1.0)

    n = radius.shape[-1]
    bad = radius[:, :-1] <= radius[:, 1:]
    idx = torch.arange(n - 1, device=radius.device)
    last_bad = torch.max(
        torch.where(bad, idx, torch.full_like(idx, -1)), dim=-1,
    ).values
    layer = torch.arange(n, device=radius.device)
    return torch.where(
        layer[None, :] <= last_bad[:, None],
        torch.full_like(radius, np.inf), radius,
    )


def hill_radius(smaxis, mplanet, mstar):
    """Hill radius; inf when any input is missing."""
    if smaxis is None or mplanet is None or mstar is None:
        return np.inf
    return smaxis * (mplanet / (3.0 * mstar)) ** (1.0 / 3.0)


def mean_weight(vmr, mass):
    """Mean molecular mass per layer (g/mol): vmr [..., l, s] -> [..., l]."""
    return torch.sum(vmr * mass, dim=-1)


def ideal_gas_density(vmr, press, temp):
    """Number density (molec cm-3): vmr [..., l, s], press [l] bar,
    temp [..., l] -> [..., l, s]."""
    return vmr * (press / temp)[..., None] * (pc.bar / pc.k)


def equilibrium_temp(
        tstar, rstar, smaxis, albedo=0.0, f=1.0,
        tstar_unc=0.0, rstar_unc=0.0, smaxis_unc=0.0,
    ):
    """Planet equilibrium temperature and its uncertainty (host numpy,
    pyratbay_tpu/atmosphere/hydro.py)."""
    teq = ((1.0 - albedo) / f) ** 0.25 * (0.5 * rstar / smaxis) ** 0.5 * tstar
    teq_unc = teq * np.sqrt(
        (tstar_unc / tstar) ** 2
        + (0.5 * smaxis_unc / smaxis) ** 2
        + (0.5 * rstar_unc / rstar) ** 2
    )
    return teq, teq_unc
