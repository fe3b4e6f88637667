"""Pressure and temperature profile models.

Temperature models are factories: `guillot_tp(press)` returns a
function params [..., npars] -> T [..., nlayers] over the static
pressure grid; leading dimensions are retrieval chains.  On a CUDA
tensor the Guillot profile is one launch of csrc/guillot_tp.cu
(guillot_cuda).
Port of pyratbay_tpu/atmosphere/profiles.py.
"""
import ctypes
import functools

import numpy as np
import torch

from .. import constants as pc
from ..ops.special import e2

__all__ = [
    'pressure', 'isothermal_tp', 'guillot_tp', 'madhu_tp',
    'gaussian_filter1d', 'get_tmodel', 'guillot_cuda', 'TMODEL_NPARS',
    'TMODEL_PNAMES',
]

TMODEL_NPARS = {'isothermal': 1, 'guillot': 6, 'madhu': 6}

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


def _constant(values):
    """fn(like) -> `values` (host numpy) as a tensor of like's dtype and
    device, made once for each: a copy from the host on every call
    would wait for the device's stream to drain."""
    made = {}

    def on(like):
        key = (like.dtype, like.device)
        if key not in made:
            made[key] = torch.as_tensor(values, dtype=like.dtype,
                                        device=like.device)
        return made[key]

    return on


@functools.lru_cache(maxsize=1)
def _kernel_library():
    from ..spectrum.transit_kernel import _library
    lib = _library()
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    lib.pbt_guillot_tp.argtypes = (
        [cint] * 3 + [ptr, ctypes.c_longlong, ptr, ptr, ptr])
    lib.pbt_guillot_tp.restype = cint
    return lib


def guillot_cuda(params, pb):
    """The Guillot profile of params [..., 6] (or more columns, the first
    six read) over the scaled pressures pb [l] in one launch of the kernel
    (csrc/guillot_tp.cu): float64 arithmetic, the result in params' dtype
    (float32 or float64, pb's too), T [..., l].  Each launch adds one to
    `guillot_cuda.launches`."""
    if not params.is_cuda:
        raise TypeError('guillot_cuda: expected CUDA tensors')
    if params.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'guillot_cuda: float32 or float64, not '
                        f'{params.dtype}')
    if params.shape[-1] < 6:
        raise ValueError(f'guillot_cuda: 6 parameters a row, not '
                         f'{params.shape[-1]}')
    lead = params.shape[:-1]
    rows = params.reshape(-1, params.shape[-1])
    if rows.stride(-1) != 1:
        rows = rows.contiguous()
    pb = pb.to(device=params.device, dtype=params.dtype).contiguous()
    nrows, nlayers = rows.shape[0], pb.shape[0]
    temp = torch.empty((nrows, nlayers), dtype=params.dtype,
                       device=params.device)
    err = _kernel_library().pbt_guillot_tp(
        int(params.dtype == torch.float64), nrows, nlayers, rows.data_ptr(),
        rows.stride(0) if nrows > 1 else rows.shape[1], pb.data_ptr(),
        temp.data_ptr(), torch.cuda.current_stream(params.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f'Guillot profile kernel launch failed: CUDA error {err}')
    guillot_cuda.launches += 1
    return temp.reshape(*lead, nlayers)


guillot_cuda.launches = 0


def guillot_tp(press, gravity=None):
    """Guillot (2010) / Line (2013) profile model.

    params = [log10(kappa'), log10(gamma1), log10(gamma2), alpha,
              T_irr, T_int];  press in bar (numpy). The optical depth is
    kappa' p / g: gravity (cm s-2), a scalar or one value a layer, is
    broadcast over the pressure grid; None means ones.  On a CUDA tensor
    the profile is one launch (guillot_cuda).
    """
    press_barye = np.asarray(press) * pc.bar
    if gravity is not None:
        press_barye = press_barye / np.broadcast_to(
            np.asarray(gravity, dtype=float), press_barye.shape)
    press_barye = _constant(press_barye)

    def temp_fn(params):
        pb = press_barye(params)
        if params.is_cuda:
            return guillot_cuda(params, pb)
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


def _gaussian_kernel1d(sigma, radius):
    x = np.arange(-radius, radius + 1)
    phi = np.exp(-0.5 * (x / sigma) ** 2)
    return phi / phi.sum()


_KERNELS = {}      # gaussian_filter1d's kernels by sigma, dtype and device


def gaussian_filter1d(y, sigma, mode='nearest'):
    """scipy's gaussian_filter1d in mode 'nearest' (the only mode) along
    the last axis of y [..., l], as a static convolution."""
    if mode != 'nearest':
        raise ValueError(f'Unsupported mode {mode}')
    radius = int(4.0 * sigma + 0.5)
    key = (sigma, y.dtype, y.device)
    if key not in _KERNELS:
        _KERNELS[key] = torch.as_tensor(
            _gaussian_kernel1d(sigma, radius), dtype=y.dtype,
            device=y.device)
    kernel = _KERNELS[key]
    edge = lambda v: v.expand(*v.shape[:-1], radius)
    ypad = torch.cat([edge(y[..., :1]), y, edge(y[..., -1:])], dim=-1)
    return ypad.unfold(-1, 2 * radius + 1, 1) @ kernel


def madhu_tp(press):
    """Madhusudhan & Seager (2009) three-zone profile model.

    params = [log_p1, log_p2, log_p3, a1, a2, T0] (pressures in bar).
    An invalid ordering (p1 > p3) gives an all-zero profile, which the
    callers reject as out of bounds.
    """
    logp_np = np.log10(np.asarray(press))
    logp0 = float(np.amin(logp_np))
    dlogp = float(logp_np[1] - logp_np[0])
    fsmooth = 0.33 / dlogp
    loge = np.log10(np.e)

    logp_of = _constant(logp_np)

    def temp_fn(params):
        logp = logp_of(params)
        logp1, logp2, logp3, a1, a2, t0 = (
            params[..., i:i + 1] for i in range(6))
        t1 = t0 + ((logp1 - logp0) / (a1 * loge)) ** 2
        t2 = t1 - ((logp1 - logp2) / (a2 * loge)) ** 2
        t3 = t2 + ((logp3 - logp2) / (a2 * loge)) ** 2
        temp = torch.where(
            logp < logp1,
            t0 + ((logp - logp0) / (a1 * loge)) ** 2,
            torch.where(
                logp < logp3,
                t2 + ((logp - logp2) / (a2 * loge)) ** 2,
                t3.expand_as(t0 + logp)))
        temp = gaussian_filter1d(temp, fsmooth)
        return torch.where(logp1 > logp3, torch.zeros_like(temp), temp)
    return temp_fn


def get_tmodel(name, press, gravity=None):
    """Temperature model factory by registry name; gravity goes to the
    Guillot model (see guillot_tp)."""
    if name == 'isothermal':
        fn = isothermal_tp(press)
    elif name in ('guillot', 'tcea'):
        fn = guillot_tp(press, gravity)
    elif name == 'madhu':
        fn = madhu_tp(press)
    else:
        raise ValueError(
            f"Invalid temperature model '{name}', select from {pc.TMODELS}"
        )
    fn.name = name
    fn.npars = len(TMODEL_PNAMES[name])
    return fn
