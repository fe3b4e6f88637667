"""Instrument passbands as dense band-weight rows.

Port of the tophat part of pyratbay_tpu/spectrum/passbands.py: each
band precomputes a weight row on the model grid, and the observation
reduces to one [B, nwave] x [nwave, nbands] product.
"""
import numpy as np

from .. import constants as pc

__all__ = ['Tophat', 'band_matrix']

_COUNTING_TYPES = ['photon', 'energy']


def _trapz_weights(x):
    """Weights w such that sum(w*f) = trapz(f, x)."""
    w = np.zeros(len(x))
    dx = np.diff(x)
    w[:-1] += 0.5 * dx
    w[1:] += 0.5 * dx
    return w


class Tophat:
    """Tophat passband centered at wl0 (um) with given half-width (um)."""

    def __init__(
            self, wl0, half_width, name='tophat', wl=None, wn=None,
            counting_type='photon', ignore_gaps=False,
        ):
        self.wl0 = wl0
        self.half_width = half_width
        self.wn0 = 1.0 / (wl0 * pc.um)
        self.name = name
        self.ignore_gaps = ignore_gaps
        if counting_type not in _COUNTING_TYPES:
            raise ValueError(
                f"Invalid 'counting_type', must be one of {_COUNTING_TYPES}"
            )
        self.counting_type = counting_type
        self.idx = None
        if wn is not None or wl is not None:
            self.set_sampling(wl=wl, wn=wn)

    def set_sampling(self, wl=None, wn=None):
        if (wl is None) == (wn is None):
            raise ValueError(
                'Either provide wavelength or wavenumber array, not both'
            )
        if wn is None:
            wn = 1.0 / (np.asarray(wl) * pc.um)
        else:
            wn = np.asarray(wn)
        sign = np.sign(np.ediff1d(wn))
        if not (np.all(sign == 1) or np.all(sign == -1)):
            raise ValueError(
                'Input wavelength/wavenumber array must be strictly '
                'increasing or decreasing'
            )
        sign0 = sign[0]
        nwave = len(wn)
        wn_low = 1.0 / ((self.wl0 + self.half_width) * pc.um)
        wn_high = 1.0 / ((self.wl0 - self.half_width) * pc.um)
        in_band = (wn >= wn_low) & (wn <= wn_high)
        indices = np.where(in_band)[0]
        if len(indices) == 0:
            if self.ignore_gaps:
                self.idx = self.response = None
                self.wn = self.wl = None
                return None, None
            raise ValueError(
                f'Tophat() passband at wl0 = {self.wl0:.3f} um does not '
                'cover any spectral point'
            )
        first = max(indices[0] - 1, 0)
        last = min(indices[-1] + 2, nwave)
        idx = np.arange(first, last)
        if sign0 < 0:
            idx = np.flip(idx)
        order = np.argsort(wn[idx])
        self.idx = idx[order]
        self.wn = wn[self.idx]
        self.wl = 1.0 / (self.wn * pc.um)
        self.response = np.array(in_band[self.idx], float)
        if self.counting_type == 'photon':
            self.height = 1.0 / np.trapezoid(self.response * self.wl, self.wn)
        else:
            self.height = 1.0 / np.trapezoid(self.response, self.wn)
        return self.wn, self.response

    def weights(self, nwave):
        """Dense weight row: band_flux = weights . spectrum."""
        w = np.zeros(nwave)
        tw = _trapz_weights(self.wn)
        if self.counting_type == 'photon':
            w[self.idx] = tw * self.wl * self.response * self.height
        else:
            w[self.idx] = tw * self.response * self.height
        return w


def band_matrix(bands, nwave):
    """Stack band weight rows into one [nbands, nwave] matrix (numpy)."""
    return np.stack([band.weights(nwave) for band in bands])
