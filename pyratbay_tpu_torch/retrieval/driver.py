"""Retrieval run-mode driver: config -> observation -> parameter space
-> batched posterior -> DEMC -> best-fit spectrum -> results .npz.

Port of pyratbay_tpu/retrieval/driver.py::run_retrieval for the DEMC
(snooker) sampler.  Like the reference, the posterior keeps every
generation after the burn-in: `thinning` is read by neither.
Checkpoint/resume, history thinning, the nested
sampler and the post-processing plots and envelopes are not ported
yet (ROADMAP.md A6).
"""
import os

import numpy as np
import torch

from ..observation import Observation
from .batched import build_log_posterior_batched
from .forward import build_forward
from .params import RetrievalParams
from .samplers import gelman_rubin, sample_demc

__all__ = ['run_retrieval']


def run_retrieval(model, seed=0):
    """Run the MCMC retrieval configured in model.cfg on model.device.

    Stores results on the model (.posterior, .bestp, .spec_best, ...)
    and writes <logfile>.npz with posterior, bestp, best_log_post,
    spec_best and bandflux_best.  Returns the sampler's result dict.
    """
    cfg = model.cfg
    if cfg.sampler not in (None, 'snooker'):
        raise NotImplementedError(
            f'sampler = {cfg.sampler} is not ported yet (ROADMAP.md A10)')
    if cfg.resume or cfg.dt_retrieval_snapshot is not None:
        raise NotImplementedError(
            'Retrieval checkpoints/resume are not ported yet '
            '(ROADMAP.md A6)')
    obs = Observation(
        cfg, model.wn, root=os.path.dirname(cfg.config_file) + '/')
    if obs.data is None or obs.nbands == 0:
        raise ValueError(
            'Undefined observed data/filters, required for retrieval')
    ret = RetrievalParams(model, obs)
    log_post_b = build_log_posterior_batched(model, obs, ret)

    nchains = ret.nchains or 21
    nsamples = ret.nsamples or 1000
    burnin_gens = int(ret.burnin or 0)
    log = model.log
    log.head(
        f'Retrieval: {len(ret.ifree)} free parameters, {nchains} '
        f'chains, {nsamples} samples (snooker sampler) on {model.device}'
    )
    generator = torch.Generator(device=model.device).manual_seed(seed)
    with torch.no_grad():
        results = sample_demc(
            log_post_b, ret.params, nsamples=nsamples, generator=generator,
            nchains=nchains, pstep=ret.pstep, pmin=ret.pmin, pmax=ret.pmax,
            burnin=burnin_gens, dtype=model.dtype, device=model.device,
        )
        forward = build_forward(model, obs, ret)
        best = forward(torch.as_tensor(results['bestp']))

    model.ret = ret
    model.obs = obs
    model.posterior = results['posterior']
    model.bestp = results['bestp']
    model.best_log_post = float(results['best_log_post'])
    model.acceptance_rate = results['acceptance_rate']
    model.spec_best = best['spectrum'].cpu().numpy()
    model.bandflux_best = best['bandflux'].cpu().numpy()
    history = results['chain_history'][burnin_gens:]
    if len(history) > 2:
        model.grfactor = gelman_rubin(history)

    if cfg.logfile is not None:
        outfile = os.path.splitext(cfg.logfile)[0] + '.npz'
        np.savez(
            outfile,
            posterior=model.posterior,
            bestp=model.bestp,
            pnames=np.asarray(ret.pnames),
            best_log_post=model.best_log_post,
            acceptance_rate=model.acceptance_rate,
            spec_best=model.spec_best,
            bandflux_best=model.bandflux_best,
            data=obs.data,
            uncert=obs.uncert,
        )
        log.msg(f'Posterior saved to {outfile}')
    log.msg(
        f'Acceptance rate: {model.acceptance_rate:.3f}; best '
        f'log-posterior: {model.best_log_post:.2f}'
    )
    if hasattr(model, 'grfactor'):
        log.msg('Gelman-Rubin: '
                + ' '.join(f'{g:.4f}' for g in model.grfactor))
    return results
