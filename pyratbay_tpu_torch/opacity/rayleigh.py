"""Rayleigh-scattering cross sections of H, H2, He and free electrons.

Port of pyratbay_tpu/opacity/rayleigh.py: Dalgarno (1962), Kurucz
(1970) and Dalgarno & Williams (1962) polynomials, and the Thomson cross
section.  The cross section is a static spectrum (host numpy); at run
time the extinction is its product with the species' density, which the
RT kernels take as a rank-1 (layer column, wave row) pair.
"""
import numpy as np
import torch

__all__ = ['Rayleigh']

_COEFS = {
    'H': (5.799e-45, 1.422e-54, 2.784e-64),
    'H2': (8.140e-45, 1.280e-54, 1.610e-64),
}
_HE_COEFS = (5.484e-46, 2.440e-11, 5.940e-42, 2.900e-11)
_THOMSON_CS = 6.653e-25  # cm2


class Rayleigh:
    """Zero-parameter Rayleigh model for one species."""

    def __init__(self, species, wn):
        if species not in ('H', 'H2', 'He', 'e-'):
            raise ValueError(f"Invalid Rayleigh species '{species}'")
        self.name = f'rayleigh_{species}'
        self.species = species
        self.wn = np.asarray(wn)
        self.npars = 0
        self.pnames = []
        self.pars = []
        wn = self.wn
        if species in _COEFS:
            c0, c1, c2 = _COEFS[species]
            cs = c0 * wn**4 + c1 * wn**6 + c2 * wn**8
        elif species == 'He':
            c0, c1, c2, c3 = _HE_COEFS
            cs = c0 * wn**4 * (
                1.0 + c1 * wn**2 + c2 * wn**4 / (1.0 - c3 * wn**2)) ** 2
        else:
            cs = np.full(len(wn), _THOMSON_CS)
        self.cross_section = cs

    def to(self, device, dtype):
        self._cs = torch.as_tensor(
            self.cross_section, dtype=dtype, device=device)
        return self

    def extinction(self, density):
        """EC (cm-1): density [B, l] of this species -> [B, l, nwave]."""
        return self._cs * density[:, :, None]

    def ec_rank1(self, density):
        """(layer column [B, l], wave row [B, nwave]) factors of the EC."""
        return density, self._cs.expand(density.shape[0], -1)

    def __str__(self):
        from ..tools import Formatted_Write
        fw = Formatted_Write()
        fw.write('Rayleigh opacity model: {}', self.name)
        fw.write('Species: {}', self.species)
        fw.write(
            'Cross section range: {:.3e} -- {:.3e} cm2 molec-1',
            float(np.min(self.cross_section)),
            float(np.max(self.cross_section)),
        )
        return fw.text
