"""H- bound-free and free-free opacity, John (1988), AA 193, 189.

Port of pyratbay_tpu/opacity/h_ion.py: the wavelength factors of the
cross sections are host numpy, set up once; at run time the
temperature polynomial gives a dense [B, l, nwave] extinction (it
depends on T in every layer, so it is no rank-1 term).
"""
import numpy as np
import torch

from .. import constants as pc

__all__ = ['HydrogenIon']

# Bound-free photo-detachment coefficients, John (1988) eq. (5):
_C_BF = [152.519, 49.534, -118.858, 92.536, -34.194, 4.982]

# Free-free coefficients, John (1988) eq. (6) Tables 3a/3b:
_FF_SHORT = np.array([
    [518.1021, -734.8666, 1021.1775, -479.0721, 93.1373, -6.4285],
    [473.2636, 1443.4137, -1977.3395, 922.3575, -178.9275, 12.3600],
    [-482.2089, -737.1616, 1096.8827, -521.1341, 101.7963, -7.0571],
    [115.5291, 169.6374, -245.649, 114.243, -21.9972, 1.5097],
]).T  # [6 coef types, 4 beta orders]
_FF_LONG = np.array([
    [2483.346, 285.827, -2054.291, 2827.776, -1341.537, 208.952],
    [-3449.889, -1158.382, 8746.523, -11485.632, 5303.609, -812.939],
    [2200.040, 2427.719, -13651.105, 16755.524, -7510.494, 1132.738],
    [-696.271, -1841.400, 8624.970, -10051.530, 4400.067, -655.020],
    [88.283, 444.517, -1863.864, 2095.288, -901.788, 132.985],
]).T  # [6 coef types, 5 beta orders]

_WN0_BF = 6090.5       # photo-detachment threshold (cm-1), wl0 = 1.6419 um
_WL_CRIT = 0.3645      # free-free wavelength-regime boundary (um)


class HydrogenIon:
    """H- opacity model; species are H and e-."""

    def __init__(self, wn):
        self.name = 'H- bound-free/free-free'
        self.species = ['H', 'e-']
        self.wn = np.asarray(wn)
        self.nwave = len(self.wn)
        self.npars = 0
        self.pnames = []
        self.pars = []
        self._alpha = pc.h * pc.c / pc.k

        # Bound-free wavelength factor (eq. 4-5):
        wn = self.wn
        mask = wn > _WN0_BF
        red_wl = 1e-2 * np.sqrt(np.where(mask, wn - _WN0_BF, 0.0))
        f_lambda = np.zeros(self.nwave)
        for n in range(6):
            f_lambda += _C_BF[n] * red_wl**n
        self.sigma_bf = np.where(
            mask, 1e-6 * (red_wl / np.where(mask, wn, 1.0))**3 * f_lambda,
            0.0)

        # Free-free factors over beta powers 2..7 (eq. 6), the two
        # wavelength regimes in disjoint slots:
        wl = 1e4 / wn
        factors = np.zeros((self.nwave, 6))
        poly = np.stack(
            [wl**2, np.ones_like(wl), 1 / wl, 1 / wl**2, 1 / wl**3, 1 / wl**4],
            axis=1)
        sw = (wl > 0.182) & (wl < _WL_CRIT)
        lw = wl >= _WL_CRIT
        factors[sw, 0:4] = poly[sw] @ _FF_SHORT
        factors[lw, 1:6] = poly[lw] @ _FF_LONG
        self._ff_factors = 1e-29 * factors

    def to(self, device, dtype):
        tensor = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        self._wn = tensor(self.wn)
        self._sigma_bf = tensor(self.sigma_bf)
        self._ff = tensor(self._ff_factors)
        return self

    def cross_section_bound_free(self, temperature):
        """Bound-free cross section (cm5 / H / e-, eq. 3): temperature
        [...] -> [..., nwave]."""
        temp = temperature[..., None]
        return (
            0.75 * temp**-1.5 * pc.k
            * torch.exp(_WN0_BF * self._alpha / temp)
            * -torch.expm1(-self._wn * self._alpha / temp)
            * self._sigma_bf)

    def cross_section_free_free(self, temperature):
        """Free-free cross section (cm5 / H / e-, eq. 6): temperature
        [...] -> [..., nwave]."""
        tclip = torch.clamp(temperature, 1000.0, 10080.0)
        beta = torch.sqrt(5040.0 / tclip)
        powers = torch.stack([beta ** (i + 2) for i in range(6)], dim=-1)
        return (powers @ self._ff.T) * (pc.k * tclip)[..., None]

    def cross_section(self, temperature):
        """Bound-free plus free-free cross section (cm5 / H / e-):
        temperature [B, l] -> [B, l, nwave]."""
        return self.cross_section_bound_free(temperature) \
            + self.cross_section_free_free(temperature)

    def extinction(self, temperature, dens_h, dens_e):
        """EC (cm-1): [B, l] profiles -> [B, l, nwave]."""
        return self.cross_section(temperature) * (dens_h * dens_e)[..., None]

    def __str__(self):
        from ..tools import Formatted_Write
        fw = Formatted_Write()
        fw.write('H- bound-free/free-free opacity (John 1988)')
        fw.write('Species: {}', self.species)
        fw.write('Wavenumber samples (nwave): {:d}', self.nwave)
        return fw.text
