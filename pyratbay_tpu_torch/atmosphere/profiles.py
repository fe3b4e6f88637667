"""Pressure and temperature profile models.

Temperature models are factories: `guillot_tp(press)` returns a
function params [..., npars] -> T [..., nlayers] over the static
pressure grid; leading dimensions are retrieval chains.
Port of pyratbay_tpu/atmosphere/profiles.py.
"""
import numpy as np
import torch

from .. import constants as pc
from ..ops.special import e2

__all__ = [
    'pressure', 'isothermal_tp', 'guillot_tp', 'get_tmodel',
    'TMODEL_PNAMES',
]

TMODEL_PNAMES = {
    'isothermal': ['T_iso'],
    'guillot': [
        "log_kappa'", 'log_gamma1', 'log_gamma2', 'alpha', 'T_irr', 'T_int',
    ],
    'madhu': ['log_p1', 'log_p2', 'log_p3', 'a1', 'a2', 'T0'],
}


def pressure(ptop, pbottom, nlayers, units='bar'):
    """Log-spaced pressure profile in bar (static, numpy)."""
    ptop = pc.get_param(ptop, units, gt=0.0)
    pbottom = pc.get_param(pbottom, units, gt=0.0)
    if ptop >= pbottom:
        raise ValueError(
            f'Bottom-layer pressure ({pbottom/pc.bar:.2e} bar) must be '
            f'higher than the top-layer pressure ({ptop/pc.bar:.2e} bar)'
        )
    return np.logspace(
        np.log10(ptop / pc.bar), np.log10(pbottom / pc.bar), nlayers,
    )


def isothermal_tp(press):
    """Isothermal profile model: params = [T]."""
    nlayers = len(press)

    def temp_fn(params):
        return params[..., :1].expand(*params.shape[:-1], nlayers)
    return temp_fn


def _xi(gamma, tau):
    """Three-channel Eddington xi function (Line et al. 2013, eq. 14)."""
    gt = gamma * tau
    return 2.0 / 3.0 * (
        (1.0 / gamma) * (1.0 + (0.5 * gt - 1.0) * torch.exp(-gt))
        + gamma * (1.0 - 0.5 * tau**2) * e2(gt)
        + 1.0
    )


def guillot_tp(press):
    """Guillot (2010) / Line (2013) profile model.

    params = [log10(kappa'), log10(gamma1), log10(gamma2), alpha,
              T_irr, T_int];  press in bar (numpy).
    """
    press_barye = np.asarray(press) * pc.bar

    def temp_fn(params):
        pb = torch.as_tensor(
            press_barye, dtype=params.dtype, device=params.device)
        col = lambda i: params[..., i:i + 1]
        kappa = 10.0 ** col(0)
        gamma1 = 10.0 ** col(1)
        gamma2 = 10.0 ** col(2)
        alpha = col(3)
        t_irr = col(4)
        t_int = col(5)
        tau = kappa * pb
        # Both channels in one elementwise pass (halves the launches of
        # the fixed-length E_2 series and continued fraction):
        xi1, xi2 = _xi(torch.stack([gamma1, gamma2]), tau)
        t4 = 0.75 * (
            t_int**4 * (2.0 / 3.0 + tau)
            + t_irr**4 * (1.0 - alpha) * xi1
            + t_irr**4 * alpha * xi2
        )
        return t4 ** 0.25
    return temp_fn


def get_tmodel(name, press):
    """Temperature model factory by registry name."""
    if name == 'isothermal':
        fn = isothermal_tp(press)
    elif name in ('guillot', 'tcea'):
        fn = guillot_tp(press)
    elif name == 'madhu':
        raise NotImplementedError(
            "tmodel 'madhu' is not ported yet (ROADMAP.md A2: "
            'madhu_tp with its gaussian_filter1d)'
        )
    else:
        raise ValueError(
            f"Invalid temperature model '{name}', select from {pc.TMODELS}"
        )
    fn.name = name
    fn.npars = len(TMODEL_PNAMES[name])
    return fn
