"""Retrieval run-mode driver: config -> observation -> parameter space
-> batched posterior -> sampler -> best-fit spectrum -> results .npz ->
post-processing.

Port of pyratbay_tpu/retrieval/driver.py.  `sampler = multinest` runs
the batched nested sampler (retrieval/nested.py) over a uniform
unit-cube prior on [pmin, pmax]; every other sampler (snooker, demc, or
none) runs the snooker DEMC (retrieval/samplers.py), checkpointed and
resumable.  Like the reference, the DEMC posterior keeps every
generation after the burn-in: `thinning` is read by neither.

Unlike the reference, the numeric post-processing steps (the
temperature and spectrum envelopes, the median atmosphere, the band
contributions) raise on failure: they launch the RT kernels, and a
failed launch stops the run instead of leaving a warning behind an exit
code of 0.  Only the plots log a warning when they fail (matplotlib may
be missing).
"""
import os

import numpy as np
import torch

from .. import constants as pc
from ..observation import Observation
from .batched import build_forward_batched, build_log_posterior_batched
from .forward import build_forward
from .nested import sample_nested
from .params import RetrievalParams
from .samplers import gelman_rubin, sample_demc
from ..tracing import to_host

__all__ = ['run_retrieval', 'posterior_post_processing', 'post_process',
           'unit_cube_prior']


def _observation(model):
    cfg = model.cfg
    return Observation(
        cfg, model.wn, root=os.path.dirname(cfg.config_file) + '/')


def unit_cube_prior(ret, device):
    """The prior transform of `sampler = multinest`: u [n, nfree] in the
    unit cube -> params [n, npars] (float64 on `device`), the free
    parameters uniform over their [pmin, pmax], the fixed ones at their
    values."""
    free = torch.as_tensor(np.asarray(ret.ifree), device=device)
    base = torch.as_tensor(np.asarray(ret.params, float), device=device)
    lo = base.new_tensor(ret.pmin[ret.ifree])
    span = base.new_tensor(ret.pmax[ret.ifree] - ret.pmin[ret.ifree])
    return lambda u: base.expand(u.shape[0], -1).index_copy(
        1, free, lo + span * u)


def _run_nested(model, ret, log_post_b, seed):
    """The nested-sampling run of `sampler = multinest` over
    unit_cube_prior: nlive live points (400 by default), the generator
    seeded from `seed`; the result in the DEMC contract too (bestp and
    best_log_post at the largest log-likelihood, acceptance_rate the
    walks' efficiency, chain_history the posterior as one record, so
    that no Gelman-Rubin is computed)."""
    dev = model.device
    generator = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        results = sample_nested(
            log_post_b, unit_cube_prior(ret, dev), ndim=len(ret.ifree),
            nlive=model.cfg.nlive or 400, generator=generator, device=dev,
            dtype=torch.float64)
    log_like = results['log_like']
    ibest = int(np.argmax(log_like))
    results['bestp'] = results['samples'][ibest]
    results['best_log_post'] = float(log_like[ibest])
    results['acceptance_rate'] = results['efficiency']
    results['chain_history'] = results['posterior'][None]
    return results


def run_retrieval(model, seed=0):
    """Run the retrieval configured in model.cfg on model.device: the
    nested sampler for `sampler = multinest`, the snooker DEMC
    otherwise.

    Stores results on the model (.posterior, .bestp, .spec_best, ...,
    and .logz, .logz_err of a nested run), writes <logfile>.npz with
    posterior, bestp, best_log_post, spec_best and bandflux_best (and
    logz, logz_err), checkpoints the DEMC sampler to
    <logfile>_checkpoint.npz when dt_retrieval_snapshot or resume is
    set, then post-processes (post_process).  Returns the sampler's
    result dict.
    """
    cfg = model.cfg
    obs = _observation(model)
    has_lowres = obs.data is not None and obs.nbands > 0
    if not has_lowres and obs.data_hires is None:
        raise ValueError(
            'Undefined observed data/filters, required for retrieval')
    ret = RetrievalParams(model, obs)
    log_post_b = build_log_posterior_batched(model, obs, ret)

    nchains = ret.nchains or 21
    nsamples = ret.nsamples or 1000
    burnin_gens = int(ret.burnin or 0)
    log = model.log
    if log.logname is None and cfg.logfile is not None \
            and not log.screen_only:
        # Called directly (not through driver.run): open the file log.
        from ..logger import Log
        log = model.log = Log(
            logname=cfg.logfile, verb=log.verb, append=bool(cfg.resume))
    checkpoint_file = None
    if cfg.logfile is not None and (
            cfg.dt_retrieval_snapshot is not None or cfg.resume):
        checkpoint_file = os.path.splitext(cfg.logfile)[0] + '_checkpoint.npz'
    log.head(
        f'Retrieval: {len(ret.ifree)} free parameters, {nchains} '
        f'chains, {nsamples} samples ({ret.sampler or "snooker"} sampler) '
        f'on {model.device}'
    )
    if ret.sampler == 'multinest':
        # What runs is not pymultinest but this package's sampler:
        log.msg(
            'sampler = multinest runs the batched nested sampler '
            '(retrieval/nested.py): MultiNest-style evidence and posterior '
            'from a live-point ensemble on the device, with '
            'friends-of-friends mode separation (per-mode evidences in '
            "results['mode_logz']) and a Monte-Carlo (volume-resampling) "
            'logz_err.')
        results = _run_nested(model, ret, log_post_b, seed)
    else:
        generator = torch.Generator(device=model.device).manual_seed(seed)
        with torch.no_grad():
            results = sample_demc(
                log_post_b, ret.params, nsamples=nsamples,
                generator=generator, nchains=nchains, pstep=ret.pstep,
                pmin=ret.pmin, pmax=ret.pmax, burnin=burnin_gens,
                checkpoint_file=checkpoint_file,
                checkpoint_dt=cfg.dt_retrieval_snapshot,
                resume=bool(cfg.resume), log=log,
                dtype=model.dtype, device=model.device,
            )
    with torch.no_grad():
        forward = build_forward(model, obs, ret)
        best = forward(torch.as_tensor(results['bestp']))

    model.ret = ret
    model.obs = obs
    extra = {}
    if 'logz' in results:
        model.logz = results['logz']
        model.logz_err = results['logz_err']
        extra = dict(logz=model.logz, logz_err=model.logz_err)
    model.posterior = results['posterior']
    model.bestp = results['bestp']
    model.best_log_post = float(results['best_log_post'])
    model.acceptance_rate = results['acceptance_rate']
    model.spec_best = to_host(best['spectrum']).numpy()
    # High-res data alone have no bands: an empty best-fit band flux.
    model.bandflux_best = to_host(best['bandflux']).numpy() if has_lowres \
        else np.zeros(0)
    history = results['chain_history'][burnin_gens:]
    if len(history) > 2:
        model.grfactor = gelman_rubin(history)

    if cfg.logfile is not None:
        outfile = os.path.splitext(cfg.logfile)[0] + '.npz'
        np.savez(
            outfile,
            **extra,
            posterior=model.posterior,
            bestp=model.bestp,
            pnames=np.asarray(ret.pnames),
            best_log_post=model.best_log_post,
            acceptance_rate=model.acceptance_rate,
            spec_best=model.spec_best,
            bandflux_best=model.bandflux_best,
            data=obs.data if has_lowres else np.zeros(0),
            uncert=obs.uncert if has_lowres else np.zeros(0),
        )
        log.msg(f'Posterior saved to {outfile}')
    log.msg(
        f'Acceptance rate: {model.acceptance_rate:.3f}; best '
        f'log-posterior: {model.best_log_post:.2f}'
    )
    if hasattr(model, 'grfactor'):
        log.msg('Gelman-Rubin: '
                + ' '.join(f'{g:.4f}' for g in model.grfactor))
    post_process(model, obs, ret)
    return results


def posterior_post_processing(cfg_file, suffix='', root=None, device=None):
    """Redo the retrieval post-processing from the posterior saved in
    <logfile>.npz (the `--post CONFIG` entry), writing the outputs
    under <logfile stem><suffix>.  Returns the Model."""
    from ..model import Model

    model = Model(cfg_file, device=device, root=root)
    cfg = model.cfg
    obs = _observation(model)
    ret = RetrievalParams(model, obs)

    base = os.path.splitext(cfg.logfile)[0]
    with np.load(base + '.npz') as saved:
        model.posterior = saved['posterior']
        model.bestp = saved['bestp']
        model.best_log_post = float(saved['best_log_post'])
        model.spec_best = saved['spec_best']
        model.bandflux_best = saved['bandflux_best']
    if suffix:
        cfg.logfile = base + suffix + os.path.splitext(cfg.logfile)[1]
    post_process(model, obs, ret)
    return model


def post_process(model, obs, ret):
    """Retrieval outputs of model.posterior and model.bestp under
    <logfile stem>: marginal statistics (the log),
    _temperature_posterior.npz, _spectrum_posterior.npz (at most
    128 draws in one batched forward), _median.atm,
    _band_contribution.npz (the best fit's diagnostics) and the plots
    (pyratbay_tpu's post_process).  The numeric steps raise on failure;
    the plots log a warning."""
    from .posterior import (
        marginal_statistics, spectrum_posterior, temperature_posterior,
    )
    from ..io import io as pio

    cfg = model.cfg
    log = model.log
    if cfg.logfile is None:
        return
    base = os.path.splitext(cfg.logfile)[0]
    posterior = model.posterior
    ifree = np.asarray(ret.ifree)
    forward_b = build_forward_batched(model, obs, ret)
    forward = build_forward(model, obs, ret)

    stats = marginal_statistics(posterior[:, ifree])
    for j, i in enumerate(ifree):
        log.msg(
            f'  {ret.pnames[i]:16s} = {stats[1, j]:.4e} '
            f'+{stats[2, j] - stats[1, j]:.3e} '
            f'-{stats[1, j] - stats[0, j]:.3e}'
        )

    with torch.no_grad():
        # Temperature-profile envelope, on at most ~2000 draws:
        tpost = None
        if ret.itemp and model.temp_model is not None:
            tpars_draws = posterior[:, np.asarray(ret.itemp)]
            base_tpars = model._tensor(
                model.tpars if model.tpars is not None
                else np.zeros(len(ret.map_temp)))
            slots = np.asarray(ret.map_temp)

            def tmodel(draws):
                pars = base_tpars.expand(len(draws), -1).clone()
                pars[:, slots] = model._tensor(draws)
                return model.temp_model(pars)

            draws = tpars_draws[:: max(1, len(tpars_draws) // 2000)]
            tpost = temperature_posterior(draws, tmodel)
            np.savez(
                base + '_temperature_posterior.npz',
                press=model.press, median=tpost[0],
                low1=tpost[1], high1=tpost[2], low2=tpost[3], high2=tpost[4])

        spost = spectrum_posterior(
            posterior[:: max(1, len(posterior) // 256)],
            lambda p: forward_b(p)['spectrum'], max_draws=128)
        np.savez(
            base + '_spectrum_posterior.npz',
            wn=np.asarray(model.wn), median=spost[0],
            low1=spost[1], high1=spost[2], low2=spost[3],
            high2=spost[4], spec_best=model.spec_best)

        # Posterior-median atmosphere (the configured VMR models at the
        # median's temperature, as the reference writes it):
        med = np.median(posterior, axis=0)
        temp = forward(med)['temperature']
        median_vmr = to_host(model.eval_vmr(temp=temp)).numpy()
        pio.write_atm(
            base + '_median.atm', model.press, to_host(temp).numpy(),
            model.species, median_vmr, punits='bar')

        # Band contribution functions (emission) or transmittances
        # (transit) at the best fit:
        band_cf = None
        if obs.nbands and model.bestp is not None:
            best = forward(model.bestp, diagnostics=True)
            band_cf = model.band_contribution(obs, result=best)
            np.savez(
                base + '_band_contribution.npz',
                press=np.asarray(model.press), band_cf=band_cf,
                band_wl=np.asarray(obs.band_wl))
            log.msg('Band contribution functions written to '
                    f'{base}_band_contribution.npz')

    try:
        _plots(model, obs, ret, base, tpost, band_cf, median_vmr)
    except Exception as exc:   # matplotlib missing or failing: no numbers
        log.warning(f'Plotting failed: {exc!r}')


def _plots(model, obs, ret, base, tpost, band_cf, median_vmr):
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot
    from .. import plots

    ifree = np.asarray(ret.ifree)
    rt_key = ('transit' if model.rt_path in pc.TRANSMISSION_RT else
              'eclipse' if model.rt_path in pc.ECLIPSE_RT else 'emission')
    plots.spectrum(
        model.spec_best, 1.0 / (np.asarray(model.wn) * pc.um),
        data=obs.data, uncert=obs.uncert, band_wl=obs.band_wl,
        bandflux=model.bandflux_best, rt_path=rt_key,
        filename=base + '_bestfit_spectrum.png')
    plots.posteriors(
        model.posterior[:, ifree], pnames=[ret.pnames[i] for i in ifree],
        bestp=model.bestp[ifree], filename=base + '_posteriors.png')
    if tpost is not None:
        plots.temperature(
            model.press, profiles=[tpost[0]],
            bounds=(tpost[1], tpost[2], tpost[3], tpost[4]),
            filename=base + '_temperature.png')
    if band_cf is not None:
        plots.contribution(
            band_cf, np.asarray(obs.band_wl), np.asarray(model.press),
            filename=base + '_band_contribution.png')
    plots.abundance(
        median_vmr, np.asarray(model.press), model.species,
        filename=base + '_abundance.png')
    matplotlib.pyplot.close('all')
    model.log.msg(f'Plots written to {base}_*.png')
