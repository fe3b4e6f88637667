"""The equilibrium-chemistry flagship family on the program's side: the
flagship's model, observation and batched log-posterior (models/
flagship.py build), from the equilibrium cfg that reference/eq_inputs.py
writes, and the family's plain torch reference
(torch_reference/flagship_eq.py).

Its traced runs also count the device launches inside the program's
pbt.state.chem spans (chem_trace.py).

The configuration solves the network in one launch of the program's
equilibrium kernel (its `kernels.chem`): a program without that solve
(no pyratbay_tpu_torch.atmosphere.chem.equilibrium_cuda) cannot run it,
and prepare stops the run there, before any set-up, with exit code 2."""
import os
import sys

import numpy as np

from .. import chem_trace
from ..reference import eq_inputs
from ..torch_reference.flagship_eq import FlagshipEq
from . import flagship

__all__ = ['prepare', 'build', 'Observed', 'Reference']

# The family's plain reference:
Reference = FlagshipEq


def prepare(config, root):
    """The configuration's input files, written once into the checkout
    (portbench/_inputs/<name>/, listed in .gitignore); SystemExit(2)
    for a program without the solve kernel the configuration names."""
    from pyratbay_tpu_torch.atmosphere import chem
    if not hasattr(chem, 'equilibrium_cuda'):
        print(f"portbench: {config['name']} solves the equilibrium in one "
              f"launch of {', '.join(config['kernels']['chem'])}, and this program "
              f"has no such solve (pyratbay_tpu_torch.atmosphere.chem."
              f"equilibrium_cuda)", file=sys.stderr)
        raise SystemExit(2)
    return eq_inputs.write_inputs(
        config, os.path.join(root, 'portbench', '_inputs', config['name']))


class Observed:
    """The observation both sides are handed: the reference's band fluxes
    at the configuration's true parameters plus Gaussian noise of
    `uncert_ppm` drawn from the seed."""

    def __init__(self, config, paths, seed):
        ref = FlagshipEq(config, paths)
        truth = ref.forward(ref.params0[None])['bandflux'][0]
        self.uncert = np.full(len(truth), config['uncert_ppm'] * 1e-6)
        rng = np.random.default_rng([int(seed), 1])
        self.data = truth + self.uncert * rng.standard_normal(len(truth))
        self.reference = ref


def build(config, paths, observed, device):
    """(model, obs, ret) of the program on `device`, as the flagship
    family builds them (the cfg is the equilibrium one)."""
    chem_trace.install()
    return flagship.build(config, paths, observed, device)
