"""Batched ensemble forward and log-posterior: the retrieval hot path.

Port of the transit and plane-parallel emission branches of
pyratbay_tpu/retrieval/batched.py with one layout for the card: dense
extinction parts are [B, l, W].

* state (T, VMR, densities, radius) for the whole ensemble at once
  (retrieval/forward.py build_state);
* line-sampled opacity: per-chain layer weights [B, K2, l] contracted
  in the kernel against the table [K2, l, W] when the table's wave-tile
  slab fits the kernel's shared memory (transit_kernel.ls_in_kernel, a
  static size rule), else one einsum that makes a dense part;
* CIA: per-layer table weights [B, l, K], contracted in the kernel;
* Lecavelier haze: a rank-1 (layer column, wave row) pair per chain;
* alkali lines with no on-grid support are pruned statically;
* deck: the surface triple that bounds the integration;
* transit RT: one launch of the ensemble kernel
  (spectrum/transit_kernel.py) on CUDA, its plain version on the CPU;
* emission/eclipse RT: one launch of the emission kernel
  (spectrum/emission_kernel.py), then the post-scalings: f_dilution,
  the eclipse's / starflux * (Rp/Rs)^2 and the f_lambda flux at Earth;
* band integration: one [B, W] x [W, nbands] product.

Float32 CUDA matmuls run in full float32: the TF32 switch
(torch.backends.cuda.matmul.allow_tf32) is set to False when a CUDA
forward is built.
"""
import numpy as np
import torch

from .forward import build_state
from .. import constants as pc
from ..atmosphere import vmr as vmr_models
from ..ops.planck import blackbody_wn
from ..spectrum.transit_kernel import ls_in_kernel

__all__ = ['build_forward_batched', 'build_log_posterior_batched']


def build_forward_batched(model, obs=None, ret=None):
    """Build forward_b(params [B, npars]) -> dict of batched outputs
    (spectrum [B, W], bandflux [B, nbands], good [B], temperature
    [B, l]); same semantics as pyratbay_tpu's build_forward_batched."""
    dev, dt = model.device, model.dtype
    if dev.type == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False
    state = build_state(model, ret)
    tmin_bound = max([model.tmin[k] for k in model.tmin], default=-np.inf)
    tmax_bound = min([model.tmax[k] for k in model.tmax], default=np.inf)
    if ret is not None:
        tmin_bound = max(tmin_bound, ret.tlow)
        tmax_bound = min(tmax_bound, ret.thigh)
    qcap = ret.qcap if ret is not None else None
    is_transit = model.rt_path in pc.TRANSMISSION_RT
    is_eclipse = model.rt_path in pc.ECLIPSE_RT
    retrieve_tstar = ret is not None and ret.itstar is not None
    if is_eclipse and not retrieve_tstar and model.starflux is None:
        raise ValueError(
            'Undefined stellar flux (tstar), required for eclipse spectra')
    if model.rt_path == 'f_lambda' and model.distance is None:
        raise ValueError(
            'Undefined distance to the system, required for f_lambda flux')
    has_bands = obs is not None and obs.nbands > 0
    if has_bands:
        obs.to(dev, dt)
    # All line-sample tables go into the kernel, or none:
    ls_models = [m for mtype, m, _ in model.opacity_models
                 if mtype == 'line_sample']
    ls_fused = bool(ls_models) and ls_in_kernel(
        sum(m.nspec * m.ntemp for m in ls_models), model.nlayers)
    ls_tab = torch.cat([m.kernel_table for m in ls_models]) \
        if ls_fused else None

    def forward_b(params_b=None):
        if params_b is not None:
            params_b = torch.as_tensor(params_b, dtype=dt, device=dev)
        st = state(params_b)
        temp = st['temp']
        dens = st['dens']
        radius = st['radius']
        nb = temp.shape[0]

        parts = []
        r1_cols, r1_rows = [], []
        cia_ws, cia_tabs = [], []
        ls_ws = []
        elem = None
        deck_surface = None
        for (mtype, m, imol), pars in zip(
                model.opacity_models, st['pars_list']):
            if m.name == 'deck':
                deck_surface = m.surface(radius, temp, pars)
                continue
            if mtype == 'line_sample':
                if ls_fused:
                    ls_ws.append(
                        m.kernel_weights(temp, dens[:, :, imol], pars))
                else:
                    parts.append(m.extinction(temp, dens[:, :, imol], pars))
            elif mtype == 'cia':
                cia_ws.append(m.kernel_weights(temp, dens[:, :, imol]))
                cia_tabs.append(m._tab)
            elif mtype == 'alkali':
                if not m.active_lines:
                    # Every line's cutoff window is off this grid: the
                    # contribution is exactly zero.
                    continue
                contrib = m.extinction(temp, dens[:, :, imol])
                elem = contrib if elem is None else elem + contrib
            elif mtype == 'cloud':
                col, row = m.ec_rank1(temp, pars)
                r1_cols.append(col)
                r1_rows.append(row)
            else:
                raise ValueError(f'Unsupported opacity type {mtype}')
        if elem is not None:
            parts.append(elem)

        kernel_operands = dict(
            cia_w=torch.cat(cia_ws, dim=2) if cia_ws else None,
            cia_tab=torch.cat(cia_tabs, dim=0) if cia_tabs else None,
            r1_cols=torch.stack(r1_cols, dim=1) if r1_cols else None,
            r1_rows=torch.stack(r1_rows, dim=1) if r1_rows else None,
            ls_w=torch.cat(ls_ws, dim=1) if ls_ws else None,
            ls_tab=ls_tab,
        )
        if is_transit:
            spectrum = model._run_transit(
                parts, radius, st['rtop'], deck_surface, **kernel_operands)
        else:
            spectrum = model._run_emission(
                parts, temp, radius, st['rtop'], deck_surface,
                **kernel_operands)
            spectrum = _emission_scalings(
                model, spectrum, st, retrieve_tstar)

        tmin = torch.min(temp, dim=1).values
        tmax = torch.max(temp, dim=1).values
        good = (tmin >= tmin_bound) & (tmax <= tmax_bound) & (tmin > 0)
        if qcap is not None and model.ibulk is not None:
            good = good & ~vmr_models.qcapcheck(st['vmr'], qcap, model.ibulk)
        spectrum = torch.where(
            good[:, None], spectrum, torch.zeros_like(spectrum))
        out = {'spectrum': spectrum, 'temperature': temp, 'good': good}
        if has_bands:
            bandflux = obs.band_integrate(spectrum)
            out['bandflux'] = torch.where(
                good[:, None], bandflux, torch.full_like(bandflux, np.inf))
        return out

    forward_b.state = state
    return forward_b


def _emission_scalings(model, spectrum, st, retrieve_tstar):
    """The post-scalings of an emission flux (pyratbay_tpu
    batched.py:517-555): dilution, then the eclipse depth
    F_p / F_s (Rp/Rs)^2 or the flux at Earth in W m-2 um-1."""
    per_chain = lambda v: v[:, None] if torch.is_tensor(v) else v
    if st['f_dilution'] is not None:
        spectrum = spectrum * per_chain(st['f_dilution'])
    rp = per_chain(st['rplanet'])
    if model.rt_path in pc.ECLIPSE_RT:
        if retrieve_tstar:
            sflux = blackbody_wn(model._wn, st['tstar'][:, None]) * np.pi
        else:
            sflux = model._starflux
        spectrum = spectrum / sflux * (rp / model.rstar)**2
    if model.rt_path == 'f_lambda':
        # 10x converts erg s-1 cm-2 cm to W m-2 um-1 after the
        # (wn um)^2 wavelength-unit Jacobian:
        spectrum = 10.0 * spectrum * (
            rp / model.distance * model._wn * pc.um)**2
    return spectrum


def build_log_posterior_batched(model, obs, ret):
    """Batched params [B, n] -> log-posterior [B]: Gaussian likelihood
    of the band-integrated data, uniform bounds and optional two-sided
    Gaussian priors; -inf for rejected or out-of-bounds chains."""
    if obs.data is None or obs.nbands == 0:
        raise ValueError(
            'Undefined observed data (data/obsfile), required to build '
            'the likelihood'
        )
    dev, dt = model.device, model.dtype
    forward_b = build_forward_batched(model, obs, ret)
    tensor = lambda a: torch.as_tensor(
        np.asarray(a, float), dtype=dt, device=dev)
    data = tensor(obs.data)
    uncert = tensor(obs.uncert)
    pmin, pmax = tensor(ret.pmin), tensor(ret.pmax)
    prior = tensor(ret.prior)
    priorlow, priorup = tensor(ret.priorlow), tensor(ret.priorup)
    has_prior = torch.as_tensor(ret.priorlow > 0, device=dev)

    def log_post_b(params_b):
        params_b = torch.as_tensor(params_b, dtype=dt, device=dev)
        result = forward_b(params_b)
        data_adj = data[None, :]
        uncert_adj = uncert[None, :]
        log_norm = 0.0
        if ret.ioffset:
            data_adj = obs.offset_data(params_b[:, ret.ioffset])
        if ret.ierror:
            uncert_adj = obs.scale_uncert(params_b[:, ret.ierror])
            log_norm = -torch.sum(
                torch.log(uncert_adj / uncert[None, :]), dim=1)
        resid = (result['bandflux'] - data_adj) / uncert_adj
        log_like = -0.5 * torch.sum(resid**2, dim=1) + log_norm
        in_bounds = torch.all(
            (params_b >= pmin[None]) & (params_b <= pmax[None]), dim=1)
        sigma = torch.where(params_b > prior[None], priorup[None],
                            priorlow[None])
        dev_sq = ((params_b - prior[None]) / torch.where(
            sigma > 0, sigma, torch.ones_like(sigma)))**2
        log_prior = -0.5 * torch.sum(torch.where(
            has_prior[None], dev_sq, torch.zeros_like(dev_sq)), dim=1)
        logp = log_like + log_prior
        bad = ~in_bounds | ~result['good'] | ~torch.isfinite(log_like)
        return torch.where(bad, torch.full_like(logp, -np.inf), logp)

    return log_post_b
