"""Top-level driver: run a configuration on a device.

Port of pyratbay_tpu/driver.py for runmode = tli (line lists to a TLI
file), opacity (the JAX default engine, whose port is pending) and
retrieval; the other run modes are not ported yet (ROADMAP.md A7/A10).
"""
import os

from . import constants as pc
from .config import parser as cfg_parser
from .logger import Log
from .model import Model
from .version import __version__

__all__ = ['run']

_RUNMODES = ('tli', 'opacity', 'retrieval')


def run(cfile, device=None, root=None, seed=0):
    """Execute a configuration on `device`.

    Returns the TLI summary list (runmode = tli) or the Model (with the
    retrieval results attached for runmode = retrieval).  runmode =
    opacity calls Model.compute_opacity() with its default engine, the
    parity engine, which raises NotImplementedError (ROADMAP.md A11):
    tabulate with Model(cfg, device).compute_opacity(engine='direct').
    """
    cfg = cfg_parser.parse(cfile, root=root)
    if cfg.runmode not in _RUNMODES:
        raise NotImplementedError(
            f'runmode = {cfg.runmode} is not ported to pyratbay_tpu_torch '
            'yet (ROADMAP.md A7/A10)'
        )
    log = Log(
        logname=cfg.logfile, verb=cfg.verb if cfg.verb is not None else 2)
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
    elif cfg.runmode == 'opacity':
        result = Model(cfg, device=device, log=log)
        result.compute_opacity()
    else:
        from .retrieval.driver import run_retrieval
        result = Model(cfg, device=device, log=log)
        run_retrieval(result, seed=seed)
    log.summary()
    log.close()
    return result
