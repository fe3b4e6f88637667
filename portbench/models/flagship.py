"""The flagship family on the program's side: the model, the observation
and the batched log-posterior of pyratbay_tpu_torch, built from the
inputs that portbench/reference/inputs.py writes for a configuration
file, and the family's plain reference."""
import os

import numpy as np

from ..reference import inputs
from ..reference.flagship import Flagship

__all__ = ['prepare', 'build', 'Observed', 'Reference']

# The family's plain reference (reference/flagship.py):
Reference = Flagship


def prepare(config, root):
    """The configuration's input files, written once into the checkout
    (portbench/_inputs/<name>/, listed in .gitignore): users hold their
    tables on disk, so a run reads them and writes none after the first."""
    return inputs.write_inputs(
        config, os.path.join(root, 'portbench', '_inputs', config['name']))


class Observed:
    """The observation both sides are handed: the reference's band fluxes
    at the configuration's true parameters plus Gaussian noise of
    `uncert_ppm` drawn from the seed."""

    def __init__(self, config, paths, seed):
        ref = Flagship(config, paths)
        truth = ref.forward(ref.params0[None])['bandflux'][0]
        self.uncert = np.full(len(truth), config['uncert_ppm'] * 1e-6)
        rng = np.random.default_rng([int(seed), 1])
        self.data = truth + self.uncert * rng.standard_normal(len(truth))
        self.reference = ref


def build(config, paths, observed, device):
    """(model, obs, ret) of the program on `device`: Model from the cfg,
    an Observation of the configuration's tophats with the observed data,
    and the retrieval parameters."""
    from pyratbay_tpu_torch.model import Model
    from pyratbay_tpu_torch.observation import Observation
    from pyratbay_tpu_torch.retrieval.params import RetrievalParams

    model = Model(paths['cfg'], device=device)
    bands = config['bands']
    centers = np.linspace(config['wl_low_um'] + bands['margin_um'],
                          config['wl_high_um'] - bands['margin_um'],
                          bands['n'])

    class ObsCfg:
        data = observed.data
        uncert = observed.uncert
        filters = [f"tophat {wl0:.4f} {bands['half_width_um']}"
                   for wl0 in centers]
        obsfile = None
        dunits = None
        offset_inst = None
        uncert_scaling = None

    obs = Observation(ObsCfg, model.wn)
    ret = RetrievalParams(model, obs)
    return model, obs, ret
