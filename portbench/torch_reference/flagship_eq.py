"""The plain reference of the equilibrium-chemistry flagship: the frozen
numpy float64 transit reference (reference/flagship.py Flagship), whose
state takes its VMRs from the plain torch equilibrium solve (gibbs.py) at
each chain's temperatures, [M/H] and C/O, on the frozen thermochemical
data of the configuration's `chemistry.gibbs_file`.  It imports nothing
of the program.

The precisions (`precision`):
* 'float64': the reference;
* 'tf32': the control, below the configuration's float32 RT and the
  program's float64 solve: the transit reference's TF32 arithmetic and
  the solve in float32;
* 'float32_solve': the solve alone in float32, the RT in float64 (does
  the comparison see the solve's precision at all?).
"""
import hashlib
import os

import numpy as np
import torch

from ..reference import inputs
from ..reference.flagship import Flagship
from . import gibbs

__all__ = ['FlagshipEq', 'GIBBS_SHA256', 'PRECISIONS', 'gibbs_path']

# The sha256 of the frozen data file (portbench/write_gibbs_table.py):
GIBBS_SHA256 = \
    'd64a6f17ae6f3f48a35527913dc283c952072a93427826ab5c19d86067af6941'
PRECISIONS = ('float64', 'tf32', 'float32_solve')
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def gibbs_path(config):
    """The configuration's frozen data file, checked against its
    digest."""
    path = os.path.join(_ROOT, config['chemistry']['gibbs_file'])
    with open(path, 'rb') as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != GIBBS_SHA256:
        raise ValueError(f'{path}: sha256 {digest} is not the frozen '
                         f'table\'s {GIBBS_SHA256}')
    return path


class FlagshipEq(Flagship):
    """The reference forward of the equilibrium flagship configuration,
    on the inputs written at `paths` (reference/eq_inputs.py)."""

    def __init__(self, config, paths, precision='float64'):
        if precision not in PRECISIONS:
            raise ValueError(f'Unknown precision {precision!r}')
        super().__init__(config, paths,
                         'tf32' if precision == 'tf32' else 'float64')
        self.precision = precision
        self.solve_dtype = torch.float64 if precision == 'float64' \
            else torch.float32
        self.network = gibbs.Network(gibbs_path(config))
        if self.network.species != self.species:
            raise ValueError(f'The network {self.network.species} is not '
                             f'the atmosphere\'s {self.species}')

    def state(self, params):
        """Temperature, VMRs, densities and radius of B chains: params
        [B, npars] in the order of the configuration's retrieval_params;
        the VMRs the equilibrium at each layer."""
        c = self._c
        params = c(params)
        nb = params.shape[0]
        tpars = np.tile(c(self.tpars), (nb, 1))
        tpars[:, 0] = self._param(params, "log_kappa'", self.tpars[0])
        tpars[:, 4] = self._param(params, 'T_irr', self.tpars[4])
        temp = self.guillot(tpars)
        chem = self.config['chemistry']
        vmr = c(self.network.vmr(
            temp, self.press,
            self._param(params, '[M/H]', chem['metallicity']),
            self._param(params, 'C/O', chem['c_to_o']), self.solve_dtype))
        press = c(self.press)
        dens = vmr * (press / temp)[:, :, None] * (inputs.BAR
                                                   / inputs.K_BOLTZ)
        mu = np.sum(vmr * c(self.mass), axis=2)
        rplanet = self._param(params, 'R_planet',
                              self.config['planet']['rplanet_rjup']) \
            * inputs.RJUP
        radius = self.hydro_m(temp, mu, rplanet)
        return dict(temp=temp, vmr=vmr, dens=dens, radius=radius,
                    params=params)
