"""Top-level driver: run a configuration on a device.

Port of pyratbay_tpu/driver.py for runmode = retrieval; the other run
modes are not ported yet (ROADMAP.md A7/A10).
"""
from .config import parser as cfg_parser
from .logger import Log
from .model import Model
from .version import __version__

__all__ = ['run']


def run(cfile, device=None, root=None, seed=0):
    """Execute a retrieval configuration on `device`; returns the Model
    with the retrieval results attached."""
    cfg = cfg_parser.parse(cfile, root=root)
    if cfg.runmode != 'retrieval':
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
    from .retrieval.driver import run_retrieval
    model = Model(cfg, device=device, log=log)
    run_retrieval(model, seed=seed)
    log.summary()
    log.close()
    return model
