"""Mixing-length convective flux, on tensors.

Port of pyratbay_tpu/spectrum/convection.py: Prandtl mixing-length
theory in the Carroll & Ostlie closed form, a parcel displaced one
mixing length l = alpha*H through a super-adiabatic region carries
F = alpha^2 rho (cp/mu) T sqrt(beta g H) max(0, dlnT/dlnP - grad_ad)^{3/2}.
"""
import torch

from .. import constants as pc

__all__ = ['convective_flux', 'super_adiabatic_gradient']


def super_adiabatic_gradient(pressure, temperature, gamma):
    """max(0, dlnT/dlnP - grad_ad) per layer, grad_ad = 1 - 1/gamma.

    The log-log gradient is a one-sided difference toward the layer
    above; the top layer has none and carries a zero gradient.
    pressure, temperature [..., l]; gamma [..., l] or a scalar.
    """
    grad = torch.diff(torch.log(temperature), dim=-1) / torch.diff(
        torch.log(pressure), dim=-1)
    grad = torch.cat([torch.zeros_like(grad[..., :1]), grad], dim=-1)
    grad_ad = 1.0 - 1.0 / gamma
    return torch.clamp(grad - grad_ad, min=0.0)


def convective_flux(
        pressure, temperature, cp, gravity, mu, rho, alpha=1.5, beta=0.5,
    ):
    """Mixing-length convective flux (erg s-1 cm-2) [..., l], nonzero
    only in layers whose radiative lapse rate exceeds the adiabatic one.

    pressure (barye), temperature (K), cp (molar heat capacity, erg K-1
    mol-1), gravity (cm s-2), mu (g mol-1), rho (g cm-3): [..., l]
    tensors.  alpha: mixing length in pressure scale heights; beta: the
    average kinetic-energy velocity factor, 0 < beta <= 1.
    """
    # gamma = cp/cv with cv = cp - R (ideal gas), R per gram-mole (CGS):
    gamma = cp / (cp - pc.k / pc.amu)
    excess = super_adiabatic_gradient(pressure, temperature, gamma)
    scale_height = pc.k * temperature / (mu * pc.amu * gravity)
    v_avg = torch.sqrt(beta * gravity * scale_height)
    cp_per_gram = cp / mu
    return alpha**2 * rho * cp_per_gram * temperature * v_avg * excess**1.5
