"""Top-level driver: run a configuration on a device.

Port of pyratbay_tpu/driver.py for runmode = tli (line lists to a TLI
file), atmosphere (the atmospheric profiles to output_atmfile),
spectrum (one forward spectrum, Model.run, to specfile), opacity (a
cross-section table from TLI files through Model.compute_opacity's
default engine, the parity engine), radeq (radiative equilibrium of a
two-stream model, spectrum/radeq.py) and retrieval (the snooker DEMC
with checkpoints and resume, or the nested sampler of `sampler =
multinest`, then the post-processing; a model with TLI files retrieves
through the direct line-by-line engine on the device).  With dist_* keys
or PBT_* variables every rank of the process group runs the whole
config and only rank 0 logs (parallel/distributed.py, logger.py), as in
the JAX package.
"""
import os

import numpy as np

from . import constants as pc
from .atmosphere import hydro
from .config import parser as cfg_parser
from .io import io as pio
from .logger import Log
from .model import Model
from .parallel.distributed import initialize_distributed
from .tracing import to_host
from .version import __version__

__all__ = ['run']

_RUNMODES = ('tli', 'atmosphere', 'spectrum', 'opacity', 'radeq',
             'retrieval')


def run(cfile, device=None, root=None, seed=0, with_log=True):
    """Execute a configuration on `device`.

    Returns the TLI summary list (runmode = tli) or the Model (with the
    spectrum of Model.run for runmode = spectrum, the retrieval results
    for runmode = retrieval).  runmode = atmosphere writes the
    temperature, VMR and radius profiles to output_atmfile; runmode =
    spectrum writes the spectrum to specfile.  runmode = opacity calls
    Model.compute_opacity() with its default engine, the parity engine
    (the reference's profile-grid sampling, host float64), and writes
    the table to sampled_cross_sec; the direct engine on the device is
    Model(cfg, device).compute_opacity(engine='direct').  runmode = radeq
    iterates the profile toward radiative equilibrium (nsamples
    iterations, 100 by default, clipped to the opacity models' common
    temperature range) and writes the profiles to <logfile>.npz
    (pressure, temps) and the last one, with the base VMRs, to
    <logfile>.atm.  As in the JAX package, resume continues only from a
    Model that carries a previous call's state, which a configuration
    file does not: a warm restart is radiative_equilibrium(model,
    radeq_temps=model.radeq_temps, dt_scale=model._dt_scale).
    with_log=False logs to the screen only, with no log file; a log file
    that cannot be opened warns and logs to the screen only, as in the
    JAX package.
    """
    cfg = cfg_parser.parse(cfile, root=root)
    if cfg.runmode not in _RUNMODES:
        raise NotImplementedError(
            f'runmode = {cfg.runmode} is not a run mode of '
            f'pyratbay_tpu_torch ({", ".join(_RUNMODES)})'
        )
    # Several processes (no-op unless dist_* keys or PBT_* variables are
    # set): every rank runs the whole config, only rank 0 speaks.
    initialize_distributed(cfg, device)
    verb = cfg.verb if cfg.verb is not None else 2
    logname = cfg.logfile if with_log else None
    try:
        log = Log(logname=logname, verb=verb, append=bool(cfg.resume))
    except OSError:
        log = Log(verb=verb)
        log.warning(f'Could not open log file {logname!r}')
    # No file log later either (run_retrieval opens one otherwise):
    log.screen_only = log.logname is None
    log.head(
        f'{log.sep}\n  pyratbay_tpu_torch v{__version__}\n'
        f'  Run mode: {cfg.runmode}\n  Config: {cfile}\n{log.sep}'
    )
    if cfg.runmode == 'tli':
        from .opacity.tli import make_tli
        tlifile = cfg.tlifile[0] if cfg.tlifile else None
        if tlifile is None and cfg.logfile is not None:
            tlifile = os.path.splitext(cfg.logfile)[0] + '.tli'
        wl_units = cfg.wlunits or 'um'
        result = make_tli(
            cfg.dblist, cfg.pflist, cfg.dbtype, tlifile,
            cfg.wl_low / pc.u(wl_units), cfg.wl_high / pc.u(wl_units),
            wl_units,
        )
    elif cfg.runmode == 'atmosphere':
        result = Model(cfg, device=device, log=log)
        temp = result.eval_temp()
        radius = None
        if result.rmodelname is not None and result.base_vmr is not None:
            mm = hydro.mean_weight(result._base_vmr, result._mol_mass)
            radius = to_host(result.eval_radius(temp, mm)).numpy()
        if cfg.output_atmfile is not None:
            pio.write_atm(
                cfg.output_atmfile, result.press, to_host(temp).numpy(),
                result.species, result.base_vmr, radius, punits='bar')
    elif cfg.runmode == 'spectrum':
        result = Model(cfg, device=device, log=log)
        result.run()
        if cfg.specfile is not None:
            if result.rt_path in pc.TRANSMISSION_RT:
                spec_type = 'transit'
            elif result.rt_path in pc.EMISSION_RT:
                spec_type = 'emission'
            else:
                spec_type = 'eclipse'
            pio.write_spectrum(1.0 / (np.asarray(result.wn) * pc.um),
                               result.spectrum, cfg.specfile, spec_type)
    elif cfg.runmode == 'opacity':
        result = Model(cfg, device=device, log=log)
        result.compute_opacity()
    elif cfg.runmode == 'radeq':
        from .spectrum.radeq import radiative_equilibrium
        result = Model(cfg, device=device, log=log)
        temps = radiative_equilibrium(
            result, nsamples=int(cfg.nsamples or 100),
            tmin=max(result.tmin.values(), default=0.0),
            tmax=min(result.tmax.values(), default=6000.0))
        if cfg.logfile is not None:
            base = os.path.splitext(cfg.logfile)[0]
            np.savez(base + '.npz', pressure=result.press, temps=temps)
            pio.write_atm(base + '.atm', result.press, temps[-1],
                          result.species, result.base_vmr, punits='bar')
    else:
        from .retrieval.driver import run_retrieval
        result = Model(cfg, device=device, log=log)
        run_retrieval(result, seed=seed)
    # The set-up and last-run timings, where the JAX package's driver
    # hands them to the summary:
    log.summary(None if cfg.runmode in ('tli', 'atmosphere')
                else result.timestamps)
    log.close()
    return result
