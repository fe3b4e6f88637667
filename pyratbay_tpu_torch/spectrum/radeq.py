"""Radiative(-convective) equilibrium: iterate the two-stream fluxes to
a steady temperature profile.

Port of pyratbay_tpu/spectrum/radeq.py as one loop on the model's
device with the arithmetic of the reference's host loop: each iteration
solves the two-stream fluxes at the current profile (the equilibrium
chemistry solved again there, as the reference re-runs chemcat), takes
the net flux's layer-to-layer differences, and moves each layer by
scale * sign(dF) |dF|^0.1 / (sigma T^3 dlnp); the scale grows x1.15
a step, or halves where the sign of dF changed against any of the last
four steps (the wobble test), is clipped to [1, 1e8] and smoothed
(a Gaussian of sigma 1.5); the new profile is made isothermal at the
top, smoothed but for its last layer (sigma = mean|dT| / 10 clipped to
[0.75, 2]) and clipped to [tmin, tmax].  The Gaussian smoothings are
explicit weighted sums over reflect-padded profiles with the support
and normalisation of scipy's gaussian_filter1d (truncate = 4.0).

The sign history lives on the device as the last four rows and their
validity.  A warm restart keeps the reference's quirk: its sign history
restarts as zeros, up to four of them valid, which count as a wobble
against any nonzero sign.  The temperature history stays on the device
and is copied to the host once, at the end; with convection=True each
iteration copies one flag to the host to decide whether the convective
flux redoes the update (the reference's data-dependent branch).
"""
import numpy as np
import torch

from .. import constants as pc
from ..tracing import to_host
from ..atmosphere import hydro
from .convection import convective_flux

__all__ = ['radiative_equilibrium']

_MAXF = 1.0e8   # maximum temperature scale factor
_NSIGN = 4      # rows of sign history in the wobble test


def _gauss_filter_reflect(y, sigma, radius):
    """scipy.ndimage.gaussian_filter1d(y, sigma) (mode 'reflect',
    truncate 4.0) of a profile y [l] with a support of `radius` layers
    and sigma a float or a 0-d tensor: the weights beyond
    floor(4 sigma + 0.5) are zero, the rest normalised to one."""
    x = torch.arange(-radius, radius + 1, dtype=y.dtype, device=y.device)
    sigma = torch.as_tensor(sigma, dtype=y.dtype, device=y.device)
    w = torch.exp(-0.5 * (x / sigma)**2)
    w = torch.where(torch.abs(x) <= torch.floor(4.0 * sigma + 0.5), w,
                    torch.zeros_like(w))
    w = w / torch.sum(w)
    ypad = torch.cat([torch.flip(y[:radius], [0]), y,
                      torch.flip(y[-radius:], [0])])
    return torch.sum(ypad.unfold(0, 2 * radius + 1, 1) * w, dim=-1)


def _flux_step(model):
    """temp [l] -> (flux_up, flux_down) [l, W]: the two-stream fluxes
    of the model at one profile (pyratbay_tpu radeq.py _step), with the
    configured opacity parameters, the top at layer 0, and the
    equilibrium chemistry solved at temp (else the base VMRs)."""
    from ..retrieval.batched import (
        assemble_opacity, line_sample_table, two_stream_rt)
    pars_list = [None if p is None else p[None] for p in model.model_pars()]
    vmr_pars = None if model.vmr_pars is None else [
        None if p is None else model._tensor(p).reshape(1, -1)
        for p in model.vmr_pars]
    ls_tab = line_sample_table(model)
    rtop = torch.zeros(1, dtype=torch.int64, device=model.device)

    def step(temp):
        t1 = temp[None]
        if model.chem_model is not None:
            vmr = model.eval_vmr_batched(vmr_pars, t1)
        else:
            vmr = model._base_vmr[None]
        dens = hydro.ideal_gas_density(vmr, model._press, t1)
        mm = hydro.mean_weight(vmr, model._mol_mass)
        radius = model.eval_radius(temp, mm[0])[None]
        ops = assemble_opacity(model, t1, dens, radius, pars_list, ls_tab)
        fluxes = two_stream_rt(model, ops, ls_tab, t1, radius, rtop)
        return fluxes['flux_up'][0], fluxes['flux_down'][0]

    return step


def _update(temp, diff_flux, scale, buf, valid, dpress, tmin, tmax):
    """The reference's wobble-damped temperature update of one
    iteration: (new profile, new scale, this step's signs)."""
    sign = torch.sign(diff_flux)
    wobble = torch.any(valid[:, None] & (buf != sign[None, :]), dim=0)
    scale = torch.where(wobble, scale * 0.5, scale * 1.15)
    scale = _gauss_filter_reflect(torch.clamp(scale, 1.0, _MAXF), 1.5, 6)
    dt = (scale * sign * torch.abs(diff_flux)**0.1
          / (pc.sigma_sb * temp**3 * dpress))
    t1 = temp + dt
    t1 = torch.cat([t1[1:2], t1[1:]])   # isothermal top
    sigma = torch.clamp(torch.mean(torch.abs(dt)) / 10.0, 0.75, 2.0)
    smoothed = _gauss_filter_reflect(t1, sigma, 8)
    t1 = torch.cat([smoothed[:-1], t1[-1:]])
    return torch.clamp(t1, tmin, tmax), scale, sign


def _convective(model, temp_rt, temp_new):
    """The convective flux [l] of the reference's convective branch
    (radeq.py:312-338 there): the atmosphere of the step that made the
    fluxes (temp_rt, the base VMRs) with the updated profile temp_new,
    and cp/R = 3.5 (the network has no heat capacity)."""
    vmr = model._base_vmr
    press = model._press
    cp = torch.full_like(temp_rt, 3.5) * pc.k / pc.amu
    mm = vmr @ model._mol_mass
    dens = vmr * (press / temp_rt)[:, None] * pc.bar / pc.k
    rho = torch.sum(dens * model._mol_mass, dim=1) * pc.amu
    radius = model.eval_radius(temp_rt, mm)
    gravity = pc.G * model.mplanet / radius**2
    return convective_flux(press * pc.bar, temp_new, cp, gravity, mm, rho)


def radiative_equilibrium(
        model, nsamples=100, convection=False, tmin=0.0, tmax=6000.0,
        radeq_temps=None, dt_scale=None,
    ):
    """Iterate toward radiative equilibrium on the model's device.

    model: a Model with a two-stream rt_path; nsamples iterations;
    convection: add the mixing-length convective flux; tmin, tmax: the
    temperature clip; radeq_temps [n, l] and dt_scale [l]: the state of
    a previous call to continue from (model.radeq_temps,
    model._dt_scale).  Returns the profiles [n + nsamples, l] (numpy;
    n = 1 without a warm start: the model's temperature profile) and
    stores them and the scale on the model.
    """
    if not model.two_stream:
        raise ValueError(
            "Radiative equilibrium requires rt_path = "
            "'emission_two_stream'"
        )
    nlayers = model.nlayers
    if nlayers <= 8:
        raise ValueError(
            f'Radiative equilibrium needs more than 8 layers (got '
            f'{nlayers}): the Gaussian smoothing reaches 8 layers')
    dev, dt = model.device, model.dtype
    tensor = lambda a: torch.as_tensor(
        np.asarray(a, float), dtype=dt, device=dev)
    if radeq_temps is None:
        history = model.eval_temp()[None]
    else:
        history = tensor(np.atleast_2d(radeq_temps))
    n_prev = history.shape[0]
    # The reference's initial temperature scale factor:
    scale = tensor(np.tile(1.0e5, nlayers) if dt_scale is None
                   else dt_scale)
    dpress = np.ediff1d(np.log(np.asarray(model.press)), to_begin=1.0)
    dpress[0] = dpress[1]
    dpress = tensor(dpress)
    wn = model._wn
    step = _flux_step(model)

    buf = torch.zeros((_NSIGN, nlayers), dtype=dt, device=dev)
    valid = torch.arange(_NSIGN, device=dev) >= (
        _NSIGN - min(n_prev - 1, _NSIGN))
    temp = history[-1]
    rows = []
    for _ in range(nsamples):
        flux_up, flux_down = step(temp)
        q_net = torch.trapezoid(flux_up, wn, dim=1) \
            - torch.trapezoid(flux_down, wn, dim=1)
        diff_flux = torch.cat([torch.zeros_like(q_net[:1]),
                               torch.diff(q_net)])
        t1, new_scale, sign = _update(
            temp, diff_flux, scale, buf, valid, dpress, tmin, tmax)
        if convection:
            conv = _convective(model, temp, t1)
            if bool(to_host(torch.any(conv != 0.0))):
                q_conv = q_net + conv
                diff_flux = torch.cat([torch.zeros_like(q_conv[:1]),
                                       torch.diff(q_conv)])
                t1, new_scale, sign = _update(
                    temp, diff_flux, scale, buf, valid, dpress, tmin, tmax)
        buf = torch.cat([buf[1:], sign[None]])
        valid = torch.cat([valid[1:], torch.ones_like(valid[:1])])
        scale, temp = new_scale, t1
        rows.append(t1)

    temps = to_host(torch.cat([history] + [r[None] for r in rows])).numpy()
    model.radeq_temps = temps
    model._dt_scale = to_host(scale).numpy()
    return temps
