"""Collision-induced absorption from tabulated cross sections.

Setup (cubic-spline resampling onto the working grid, amagat units) is
a numpy copy of pyratbay_tpu/opacity/cia.py.  At runtime the
temperature lerp and the density product become per-layer weights
[B, l, ntemp] that the transit kernel contracts against the table
[ntemp, nwave] (pyratbay_tpu/retrieval/batched.py:248-267).  The cross
section itself, in (molec cm-3)^-N units (~1e-46 for a pair, below
float32's range), is `cross_section`, in float64 on any device.
"""
import numpy as np
import torch

from .. import constants as pc
from ..io import io as pio
from ..ops.interp import lin_interp_trow, second_deriv_ref, splinterp
from .line_sample import two_hot

__all__ = ['CIA']


class CIA:
    """One CIA table (e.g. H2-H2 or H2-He)."""

    def __init__(self, cia_file, wn=None):
        self.cia_file = cia_file
        absorption, species, temps, tab_wn = pio.read_cs(cia_file)

        self.species = species
        self.nspec = len(species)
        self.name = 'CIA ' + '-'.join(species)
        self.npars = 0
        self.pnames = []
        self.pars = []

        t_sort = np.argsort(temps)
        absorption = absorption[t_sort]
        self.temps = temps[t_sort]
        self.ntemp = len(self.temps)
        self.tmin = self.temps.min()
        self.tmax = self.temps.max()

        if wn is None:
            self.wn = tab_wn
            cross_section = absorption
        else:
            self.wn = np.asarray(wn)
            sorted_wn = self.wn[::-1] if self.wn[1] < self.wn[0] else self.wn
            sorted_tab = tab_wn[::-1] if tab_wn[1] < tab_wn[0] else tab_wn
            cross_section = np.zeros((self.ntemp, len(self.wn)))
            for j in range(self.ntemp):
                y2 = second_deriv_ref(absorption[j], sorted_tab)
                cross_section[j] = splinterp(
                    absorption[j], sorted_tab, y2, sorted_wn, extrap=0.0,
                )
            if self.wn[1] < self.wn[0]:
                cross_section = np.fliplr(cross_section)
        self.nwave = len(self.wn)
        # amagat^-N units: O(1e-7) values, float32-safe.
        self.tab_cs_amagat = cross_section
        self.tab_cross_section = cross_section / pc.amagat**self.nspec
        # The wavenumber span the table covers, and the slopes in T:
        good = (self.wn >= tab_wn.min()) & (self.wn <= tab_wn.max())
        self._wn_lo = int(np.where(good)[0][0])
        self._wn_hi = int(np.where(good)[0][-1]) + 1
        self._dcs_dt = (
            np.diff(self.tab_cross_section, axis=0)
            / np.expand_dims(np.ediff1d(self.temps), 1)
        )
        self.mol = species

    def to(self, device, dtype):
        """Materialize the static tables as tensors."""
        self._tab = torch.as_tensor(
            self.tab_cs_amagat, dtype=dtype, device=device)
        self._temps = torch.as_tensor(self.temps, dtype=dtype, device=device)
        return self

    def kernel_weights(self, temperature, densities):
        """Per-layer table weights [B, l, ntemp]: two-hot temperature
        lerp times the amagat-normalized density product.

        temperature [B, l] (clamped into the table range); densities
        [B, l, nspec] of the colliding species.
        """
        tcl = torch.clamp(temperature, float(self.tmin), float(self.tmax))
        tlo = torch.clamp(
            torch.searchsorted(self._temps, tcl.contiguous(), right=True) - 1,
            0, self.ntemp - 2,
        )
        w_hi = (tcl - self._temps[tlo]) \
            / (self._temps[tlo + 1] - self._temps[tlo])
        w_t = two_hot(tlo, w_hi, self.ntemp)              # [B, t, l]
        dprod = torch.prod(densities / pc.amagat, dim=2)  # [B, l]
        return (w_t * dprod[:, None, :]).transpose(1, 2)

    def cross_section(self, temperature):
        """CS (cm-1 (molec cm-3)^-N) in float64: temperature [...] (a
        tensor, numpy array or number, clamped into the table's range)
        -> [..., nwave], on the temperature's device."""
        device = temperature.device if torch.is_tensor(temperature) \
            else 'cpu'
        temp = torch.clamp(
            torch.as_tensor(temperature, dtype=torch.float64, device=device),
            float(self.tmin), float(self.tmax))
        cs = lin_interp_trow(
            self.tab_cross_section, self.temps, self._dcs_dt,
            temp.reshape(-1), self._wn_lo, self._wn_hi)
        return cs.reshape(*temp.shape, self.nwave)

    def extinction(self, temperature, densities):
        """EC (cm-1): [B, l] temperatures -> [B, l, nwave]."""
        return self.kernel_weights(temperature, densities) @ self._tab

    def __str__(self):
        from ..tools import Formatted_Write
        fw = Formatted_Write()
        fw.write('Collision-induced absorption: {}', self.name)
        fw.write('Species: {}', list(self.species))
        fw.write(
            'Temperature range: {:.1f} -- {:.1f} K ({:d} samples)',
            float(self.tmin), float(self.tmax), self.ntemp,
        )
        fw.write('Wavenumber samples (nwave): {:d}', self.nwave)
        return fw.text
