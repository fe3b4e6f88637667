"""Retrieval forward model: params -> (spectrum, bandflux).

Port of pyratbay_tpu/retrieval/forward.py.  `build_state` maps a
[B, npars] parameter ensemble onto the atmospheric state (T, VMR,
densities, radius) for every chain at once; the per-chain forward and
log-posterior are the batched ones (retrieval/batched.py) at B = 1.
"""
import numpy as np
import torch

from .. import constants as pc
from .. import tracing
from ..atmosphere import hydro
from ..device import index_tensor

__all__ = ['build_state', 'build_forward', 'build_log_posterior']


def build_state(model, ret=None):
    """Build state(params [B, npars] or None) -> dict of batched state.

    Same mapping as pyratbay_tpu forward.state (forward.py:124-217):
    parameters overwrite the T(p), VMR and opacity-model slots, the
    planet's radius, mass and reference pressure, the patchy-cloud
    fraction, the emission's dilution factor, the star's temperature
    and the radial velocity of the high-res channel (rv_shift, km/s).
    """
    if (ret is not None and ret.itstar is not None
            and model.rt_path in pc.ECLIPSE_RT
            and model.sed_temps is None and not model.star_is_blackbody):
        raise ValueError(
            'Cannot retrieve tstar from a fixed input stellar spectrum; '
            'provide a temperature-gridded SED file (starspec with '
            '@TEMPERATURES) or a blackbody star (tstar alone)'
        )
    dev, dt = model.device, model.dtype
    tensor = lambda a: torch.as_tensor(
        np.asarray(a, float), dtype=dt, device=dev)
    base_tpars = None if model.tpars is None else tensor(model.tpars)
    base_pars = [
        tensor(m.pars) if getattr(m, 'npars', 0) > 0 else None
        for _, m, _ in model.opacity_models
    ]
    # Made here once, as the index lists below: host data copied to
    # the card on every call would wait for its stream to drain.
    base_vmr_pars = None if model.vmr_pars is None else [
        None if p is None else tensor(p) for p in model.vmr_pars]
    index = lambda idx: index_tensor(idx, dev)
    if ret is not None:
        itemp, map_temp = index(ret.itemp), index(ret.map_temp)
        iopacity = [(index(idx), index(slots)) if idx else None
                    for idx, slots in zip(ret.iopacity, ret.map_opacity)]
    runits = pc.u(model.cfg.runits or 'rjup')
    mass_units = pc.u(model.cfg.mass_units or 'mjup')

    def state(params=None):
        nb = 1 if params is None else params.shape[0]
        tpars = None if base_tpars is None else base_tpars.expand(nb, -1)
        vmr_par_list = None
        if base_vmr_pars is not None:
            vmr_par_list = [
                None if p is None else p.expand(nb, -1)
                for p in base_vmr_pars
            ]
        pars_list = [
            None if p is None else p.expand(nb, -1) for p in base_pars
        ]
        rplanet = model.rplanet
        mplanet = model.mplanet
        refpress = model.refpressure
        fpatchy = model.fpatchy
        f_dilution = model.cfg.f_dilution
        tstar = model.tstar
        rv_shift = None

        if ret is not None and params is not None:
            if ret.itemp:
                tpars = (
                    base_tpars if base_tpars is not None
                    else torch.zeros(len(ret.map_temp), dtype=dt, device=dev)
                ).expand(nb, -1).clone()
                tpars[:, map_temp] = params[:, itemp]
            if ret.imol:
                if vmr_par_list is None:
                    vmr_par_list = [None] * len(model.vmr_var_names)
                for i_par, slot in zip(ret.imol, ret.map_mol):
                    vmr_par_list[slot] = params[:, i_par:i_par + 1]
            for j, indices in enumerate(iopacity):
                if indices is None:
                    continue
                idx, slots = indices
                pars = pars_list[j].clone()
                pars[:, slots] = params[:, idx]
                pars_list[j] = pars
            if ret.irad is not None:
                rplanet = params[:, ret.irad] * runits
            if ret.imass is not None:
                mplanet = params[:, ret.imass] * mass_units
            if ret.ipress is not None:
                refpress = 10.0 ** params[:, ret.ipress]
            if ret.ipatchy is not None:
                fpatchy = params[:, ret.ipatchy]
            if ret.idilut is not None:
                f_dilution = params[:, ret.idilut]
            if ret.itstar is not None:
                tstar = params[:, ret.itstar]
            if ret.irv is not None:
                rv_shift = params[:, ret.irv]

        with tracing.span('pbt.state.tp'):
            if tpars is not None and model.temp_model is not None:
                temp = model.temp_model(tpars)
            else:
                temp = model._base_temp.expand(nb, -1)
        # Equilibrium chemistry is solved again for every chain, at
        # its temperature, as under the JAX package's jit:
        with tracing.span('pbt.state.vmr'):
            vmr = model.eval_vmr_batched(vmr_par_list, temp)
        with tracing.span('pbt.state.radius'):
            press = model._press
            dens = hydro.ideal_gas_density(vmr, press, temp)
            mm = hydro.mean_weight(vmr, model._mol_mass)
            if model.rmodelname == 'hydro_m':
                radius = hydro.hydro_m(press, temp, mm, mplanet, refpress,
                                       rplanet)
            elif model.rmodelname == 'hydro_g':
                gplanet = pc.G * mplanet / rplanet**2
                radius = hydro.hydro_g(press, temp, mm, gplanet, refpress,
                                       rplanet)
            elif model._input_radius is not None:
                radius = model._input_radius.expand(nb, -1)
            else:
                raise ValueError('Transit geometry needs a radius profile')

            rtop = torch.zeros(nb, dtype=torch.int64, device=dev)
            if np.isfinite(model.rhill):
                inside = radius < model.rhill
                rtop = torch.where(
                    torch.any(inside, dim=1),
                    torch.argmax(inside.to(torch.int8), dim=1), rtop)
        return {
            'params': params, 'tpars': tpars, 'vmr_par_list': vmr_par_list,
            'pars_list': pars_list, 'rplanet': rplanet, 'mplanet': mplanet,
            'refpress': refpress, 'fpatchy': fpatchy,
            'f_dilution': f_dilution, 'tstar': tstar, 'rv_shift': rv_shift,
            'temp': temp, 'vmr': vmr, 'dens': dens,
            'mm': mm, 'radius': radius, 'rtop': rtop,
        }
    return state


def _unbatch(fn):
    """Per-chain view of a batched function: params [npars] -> outputs
    of the B = 1 evaluation with the chain axis dropped."""
    def one(params=None, **kw):
        if params is not None:
            params = torch.as_tensor(params)[None]
        out = fn(params, **kw)
        if isinstance(out, dict):
            return {k: v[0] for k, v in out.items()}
        return out[0]
    return one


def build_forward(model, obs=None, ret=None):
    """Per-chain forward(params [npars], diagnostics=False) ->
    dict(spectrum [W], bandflux [nbands], bandflux_hires [H] with a
    high-res channel, temperature [l], good, and the RT diagnostics on
    request): the batched forward at B = 1, so
    its transit RT is one kernel launch at B = 1."""
    from .batched import build_forward_batched
    forward_b = build_forward_batched(model, obs, ret)
    forward = _unbatch(forward_b)
    forward.state = forward_b.state
    return forward


def build_log_posterior(model, obs, ret):
    """Per-chain log-posterior(params [npars]) -> scalar tensor."""
    from .batched import build_log_posterior_batched
    return _unbatch(build_log_posterior_batched(model, obs, ret))
