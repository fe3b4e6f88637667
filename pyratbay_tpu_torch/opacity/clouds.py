"""Cloud and haze models: opaque deck, constant-gray cloud and
power-law (Lecavelier) haze.

Port of pyratbay_tpu/opacity/clouds.py.  Parameters arrive per chain
([B, npars]); the haze and the gray cloud ship to the RT kernels as
rank-1 (layer column, wave row) pairs instead of dense [B, l, nwave]
buffers, except in a patchy model, whose clear spectrum leaves them out.
"""
import numpy as np
import torch

from .. import constants as pc
from ..ops.interp import interp

__all__ = ['Lecavelier', 'CCSgray', 'Deck']

_S0 = 5.31e-27   # H2 Rayleigh cross section at 0.35 um (cm2 molec-1)
_L0 = 3.5e-5     # Nominal wavelength (cm)


class Lecavelier:
    """Power-law haze: cs = 10**k * s0 * (wn*l0)**(-alpha), over the
    total gas density p/kT.  pars = [log_k_ray, alpha_ray]."""

    def __init__(self, pressure, wn):
        self.name = 'lecavelier'
        self.pressure = np.asarray(pressure)
        self.wn = np.asarray(wn)
        self.pars = [0.0, -4.0]
        self.npars = 2
        self.pnames = ['log_k_ray', 'alpha_ray']
        self.mol = None

    def to(self, device, dtype):
        self._press = torch.as_tensor(
            self.pressure, dtype=dtype, device=device)
        self._wn = torch.as_tensor(self.wn, dtype=dtype, device=device)
        return self

    def cross_section(self, pars):
        """[B, 2] parameters -> [B, nwave] cross sections."""
        return 10.0 ** pars[:, :1] * _S0 \
            * (self._wn * _L0) ** (-pars[:, 1:2])

    def extinction(self, temperature, pars):
        """EC (cm-1) [B, l, nwave]."""
        col, row = self.ec_rank1(temperature, pars)
        return row[:, None, :] * col[:, :, None]

    def ec_rank1(self, temperature, pars):
        """(layer column [B, l], wave row [B, nwave]) factors of the EC."""
        density = self._press * pc.bar / temperature / pc.k
        return density, self.cross_section(pars)


class CCSgray:
    """Constant (gray) cross-section cloud between two pressure levels.
    pars = [log_k_gray, log_p_top, log_p_bot] (pressures in bar)."""

    def __init__(self, pressure, wn):
        self.name = 'ccsgray'
        self.pressure = np.asarray(pressure)
        self.wn = np.asarray(wn)
        self.pars = [0.0, -4.0, 2.0]
        self.npars = 3
        self.pnames = ['log_k_gray', 'log_p_top', 'log_p_bot']
        self.mol = None

    def to(self, device, dtype):
        self._press = torch.as_tensor(
            self.pressure, dtype=dtype, device=device)
        self._ones = torch.ones(len(self.wn), dtype=dtype, device=device)
        return self

    def extinction(self, temperature, pars):
        """EC (cm-1) [B, l, nwave]."""
        col, row = self.ec_rank1(temperature, pars)
        return col[:, :, None] * row[:, None, :]

    def ec_rank1(self, temperature, pars):
        """(layer column [B, l], wave row [B, nwave] of ones) factors."""
        press = self._press
        in_cloud = (press >= 10.0 ** pars[:, 1:2]) \
            & (press <= 10.0 ** pars[:, 2:3])
        cs = torch.where(in_cloud, 10.0 ** pars[:, :1] * _S0,
                         torch.zeros_like(temperature))
        density = press * pc.bar / temperature / pc.k
        return cs * density, self._ones.expand(temperature.shape[0], -1)


class Deck:
    """Opaque cloud deck at pressure 10**pars[0] bar: no extinction of
    its own, a lower boundary for the path integration."""

    def __init__(self, pressure, wn):
        self.name = 'deck'
        self.pressure = np.asarray(pressure)
        self.wn = np.asarray(wn)
        self.pars = [-1.0]
        self.npars = 1
        self.pnames = ['log_p_cl']
        self.mol = None

    def to(self, device, dtype):
        self._press = torch.as_tensor(
            self.pressure, dtype=dtype, device=device)
        return self

    def surface(self, radius, temperature, pars):
        """Cloud-top layer index and interpolated radius/temperature.

        radius, temperature [B, l]; pars [B, 1].  Returns (itop [B]
        int64, clipped to [1, nlayers-1]; rsurf [B]; tsurf [B]).
        """
        press = self._press
        nlayers = press.shape[0]
        ptop = (10.0 ** pars[:, 0]).contiguous()
        itop = torch.searchsorted(press, ptop, right=False)
        itop = torch.where(
            ptop >= press[-1], torch.full_like(itop, nlayers - 1), itop)
        itop = torch.clamp(itop, 1, nlayers - 1)
        tsurf = interp(ptop, press, temperature)
        rsurf = interp(ptop, press, radius)
        return itop, rsurf, tsurf


def _cloud_str(self):
    from ..tools import Formatted_Write
    fw = Formatted_Write()
    fw.write('Cloud opacity model: {}', self.name)
    fw.write(
        'Parameters ({}): {}', self.pnames,
        [float(p) for p in self.pars],
    )
    return fw.text


Lecavelier.__str__ = _cloud_str
CCSgray.__str__ = _cloud_str
Deck.__str__ = _cloud_str
