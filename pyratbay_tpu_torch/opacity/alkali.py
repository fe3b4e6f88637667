"""Alkali (Na, K) resonance-line opacity (Burrows et al. 2000 van der
Waals + statistical-theory profile).

Port of pyratbay_tpu/opacity/alkali.py: the same static pruning of
lines whose cutoff window misses the wavenumber grid (`active_lines`;
on the flagship 1.1-1.7 um grid the Na D lines are all pruned and the
model contributes nothing), and the same elementwise profile over the
ensemble.
"""
import numpy as np
import torch

from .. import constants as pc
from ..ops.special import voigt_ref

__all__ = ['SodiumVdW', 'PotassiumVdW', 'get_alkali_model']


class VanderWaals:
    """Base alkali model; subclasses define the line data."""

    species = None
    wn0 = None
    gf = None
    elow = None
    lpar = None
    part_func = None
    detuning = None

    def __init__(self, pressure, wn, cutoff=4500.0, mass=None):
        self.pressure = np.asarray(pressure)
        self.wn = np.asarray(wn)
        self.nwave = len(self.wn)
        self.nlayers = len(self.pressure)
        self.cutoff = cutoff
        self.nlines = len(self.wn0)
        self.npars = 0
        self.pnames = []
        self.pars = []
        if mass is None:
            from ..io.io import species_properties
            masses, _ = species_properties([self.species])
            mass = masses[0]
        self.mass = mass
        self.mol = self.species
        self.active_lines = [
            i for i in range(self.nlines)
            if (self.wn0[i] - cutoff <= self.wn[-1]
                and self.wn0[i] + cutoff >= self.wn[0])
        ]

    def to(self, device, dtype):
        """Materialize the static arrays as tensors."""
        self._press = torch.as_tensor(
            self.pressure * pc.bar, dtype=dtype, device=device)
        self._wn = torch.as_tensor(self.wn, dtype=dtype, device=device)
        self._wn0 = torch.as_tensor(self.wn0, dtype=dtype, device=device)
        return self

    def cross_section(self, temperature):
        """Cross section (cm2 molec-1): T [B, l] -> [B, l, nwave]."""
        temp = temperature[..., None]                      # [B, l, 1]
        press = self._press[:, None]                       # [l, 1]
        wn0 = self._wn0                                    # [line]
        doppler = (
            torch.sqrt(2.0 * pc.k * temp / (self.mass * pc.amu)) * wn0 / pc.c
        )                                                  # [B, l, line]
        lorentz = self.lpar * (temp / 2000.0) ** -0.7 * press / pc.atm
        dsigma = self.detuning * (temp / 500.0) ** 0.6     # [B, l, 1]
        voigt_det = voigt_ref(dsigma, lorentz, doppler)    # [B, l, line]

        if not self.active_lines:
            return torch.zeros(
                (*temperature.shape, len(self._wn)),
                dtype=temperature.dtype, device=temperature.device,
            )
        wave = self._wn
        total = None
        for i in self.active_lines:
            dwn = wave - wn0[i]
            abs_dwn = torch.abs(dwn)
            strength = pc.C3_KERNEL * float(self.gf[i]) / self.part_func
            t_ratio = dsigma / abs_dwn
            wing = (
                voigt_det[..., i:i + 1]
                * (t_ratio * torch.sqrt(t_ratio))
                * strength
                * torch.exp(-pc.C2_KERNEL * (abs_dwn - dsigma) / temp)
            )
            core = lorentz / np.pi / (lorentz**2 + dwn**2) * strength
            profile = torch.where(abs_dwn >= dsigma, wing, core)
            profile = torch.where(
                abs_dwn <= self.cutoff, profile, torch.zeros_like(profile))
            total = profile if total is None else total + profile
        return total

    def extinction(self, temperature, density):
        """EC (cm-1): T [B, l], density [B, l] of this species."""
        return self.cross_section(temperature) * density[..., None]

    def __str__(self):
        from ..tools import Formatted_Write
        fw = Formatted_Write()
        fw.write('Alkali van der Waals opacity: {}', self.name)
        fw.write('Species: {}', self.species)
        fw.write('Line centers (cm-1): {}',
                 [float(w) for w in np.round(self.wn0, 3)])
        fw.write('Detuning cutoff (cutoff): {}', self.cutoff)
        return fw.text


class SodiumVdW(VanderWaals):
    """Na D doublet (VALD line data; Burrows et al. 2000)."""

    species = 'Na'
    wn0 = [16960.87, 16978.07]
    elow = [0.0, 0.0]
    gf = [0.65464, 1.30918]
    lpar = 0.071
    part_func = 2.0
    detuning = 30.0

    def __init__(self, pressure, wn, cutoff=4500.0, mass=None):
        self.name = 'sodium_vdw'
        super().__init__(pressure, wn, cutoff, mass)


class PotassiumVdW(VanderWaals):
    """K resonance doublet (VALD line data; Burrows et al. 2000)."""

    species = 'K'
    wn0 = [12988.76, 13046.486]
    elow = [0.0, 0.0]
    gf = [0.701455, 1.40929]
    lpar = 0.14
    part_func = 2.0
    detuning = 20.0

    def __init__(self, pressure, wn, cutoff=4500.0, mass=None):
        self.name = 'potassium_vdw'
        super().__init__(pressure, wn, cutoff, mass)


def get_alkali_model(name, *args, **kwargs):
    if name == 'sodium_vdw':
        return SodiumVdW(*args, **kwargs)
    if name == 'potassium_vdw':
        return PotassiumVdW(*args, **kwargs)
    raise ValueError(
        f"Invalid alkali model '{name}', select from {pc.ALKALI_MODELS}"
    )
