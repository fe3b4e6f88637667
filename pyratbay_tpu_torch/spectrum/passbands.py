"""Instrument passbands as dense band-weight rows.

Port of pyratbay_tpu/spectrum/passbands.py (host numpy): filter files,
the bundled filter library (PassBand.from_arrays) and tophats.  Each
band precomputes a weight row on the model grid, and the observation
reduces to one [B, nwave] x [nwave, nbands] product.
"""
import os

import numpy as np

from .. import constants as pc
from ..io import io as pio

__all__ = ['PassBand', 'Tophat', 'bin_spectrum', 'band_matrix',
           'band_cf_matrix']

_COUNTING_TYPES = ['photon', 'energy']


def _trapz_weights(x):
    """Weights w such that sum(w*f) = trapz(f, x)."""
    w = np.zeros(len(x))
    dx = np.diff(x)
    w[:-1] += 0.5 * dx
    w[1:] += 0.5 * dx
    return w


def _check_counting(counting_type):
    if counting_type not in _COUNTING_TYPES:
        raise ValueError(
            f"Invalid 'counting_type', must be one of {_COUNTING_TYPES}")
    return counting_type


def _sampling_grid(wl, wn):
    """The wavenumber grid of set_sampling and the sign of its steps."""
    if (wl is None) == (wn is None):
        raise ValueError(
            'Either provide wavelength or wavenumber array, not both')
    wn = 1.0 / (np.asarray(wl) * pc.um) if wn is None else np.asarray(wn)
    sign = np.sign(np.ediff1d(wn))
    if not (np.all(sign == 1) or np.all(sign == -1)):
        raise ValueError(
            'Input wavelength/wavenumber array must be strictly '
            'increasing or decreasing')
    return wn, sign[0]


class PassBand:
    """A filter passband read from file (wavelength um, response)."""

    def __init__(self, filter_file, wl=None, wn=None,
                 counting_type='photon'):
        self.name = os.path.splitext(os.path.basename(filter_file))[0]
        self.counting_type = _check_counting(counting_type)
        self.filter_file = os.path.realpath(filter_file)
        input_wl, input_response = pio.read_spectrum(
            self.filter_file, wn=False)
        self._set_input(input_wl, input_response)
        if wn is not None or wl is not None:
            self.set_sampling(wl=wl, wn=wn)

    @classmethod
    def from_arrays(cls, wl, response, name, wn=None,
                    counting_type='photon'):
        """Build a passband from (wl [um], response) arrays: the bundled
        instrument filter library (data.filter_response)."""
        band = cls.__new__(cls)
        band.name = str(name)
        band.counting_type = _check_counting(counting_type)
        band.filter_file = None
        band._set_input(np.asarray(wl, float), np.asarray(response, float))
        if wn is not None:
            band.set_sampling(wn=wn)
        return band

    def _set_input(self, input_wl, input_response):
        self.wl0 = np.sum(input_wl * input_response) / np.sum(input_response)
        self.wn0 = 1.0 / (self.wl0 * pc.um)
        input_wn = 1.0 / (input_wl * pc.um)
        wn_sort = np.argsort(input_wn)
        self.input_response = input_response[wn_sort]
        self.input_wn = input_wn[wn_sort]
        self.response = np.copy(self.input_response)
        self.wn = np.copy(self.input_wn)
        self.wl = 1.0 / (self.wn * pc.um)
        self.idx = None

    def _set_height(self):
        if self.counting_type == 'photon':
            self.height = 1.0 / np.trapezoid(self.response * self.wl, self.wn)
        else:
            self.height = 1.0 / np.trapezoid(self.response, self.wn)

    def set_sampling(self, wl=None, wn=None):
        """Resample the response onto a spectral grid; normalize so the
        band integral of a flat spectrum is 1."""
        wn, _ = _sampling_grid(wl, wn)
        inside = (wn > self.input_wn[0]) & (wn < self.input_wn[-1])
        idx = np.where(inside)[0]
        response = np.interp(wn[idx], self.input_wn, self.input_response)
        order = np.argsort(wn[idx])
        self.idx = idx[order]
        self.wn = wn[self.idx]
        self.wl = 1.0 / (self.wn * pc.um)
        self.response = response[order] / np.amax(response)
        self._set_height()
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

    def integrate(self, spectrum):
        """Band-integrate a spectrum sampled on the set grid."""
        spec = np.asarray(spectrum)[self.idx]
        if self.counting_type == 'photon':
            integ = np.trapezoid(self.wl * spec * self.response, self.wn)
        else:
            integ = np.trapezoid(spec * self.response, self.wn)
        return integ * self.height

    def __call__(self, spectrum):
        return self.integrate(spectrum)

    def __repr__(self):
        return f"pyratbay_tpu_torch.spectrum.PassBand('{self.filter_file}')"

    def __str__(self):
        from ..tools import Formatted_Write
        fw = Formatted_Write()
        fw.write('Instrument passband:')
        fw.write('Name (name): {}', self.name)
        fw.write('Central wavelength (wl0): {:.4f} um', self.wl0)
        fw.write('Counting type: {}', self.counting_type)
        fw.write(
            'Wavelength range: {:.4f} -- {:.4f} um ({:d} samples)',
            float(np.min(self.wl)), float(np.max(self.wl)), len(self.wl),
        )
        if self.idx is not None:
            fw.write('Resampled onto the model grid (idx set)')
        return fw.text


class Tophat(PassBand):
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
        self.counting_type = _check_counting(counting_type)
        self.idx = None
        if wn is not None or wl is not None:
            self.set_sampling(wl=wl, wn=wn)

    def set_sampling(self, wl=None, wn=None):
        wn, sign0 = _sampling_grid(wl, wn)
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
        # One spectral point as margin:
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
        self._set_height()
        return self.wn, self.response

    def __repr__(self):
        return (f'pyratbay_tpu_torch.spectrum.Tophat({self.wl0}, '
                f'{self.half_width})')


def band_matrix(bands, nwave):
    """Stack band weight rows into one [nbands, nwave] matrix (numpy)."""
    return np.stack([band.weights(nwave) for band in bands])


def band_cf_matrix(bands, nwave):
    """Raw response-weighted trapezoid rows for contribution functions:
    the reference's band_cf integrates the max-normalized response with
    no photon-counting wl factor and no height (the per-band scale
    cancels in band_cf's max-normalization)."""
    matrix = np.zeros((len(bands), nwave))
    for i, band in enumerate(bands):
        matrix[i, band.idx] = _trapz_weights(band.wn) * band.response
    return matrix


def bin_spectrum(bin_wl, wl, spectrum, half_widths=None, gaps=None):
    """Bin a spectrum down to the bin_wl sampling via tophat bands."""
    if gaps is not None and gaps not in ('interpolate', 'ignore'):
        raise ValueError("Invalid value for 'gaps' argument")
    if half_widths is None:
        half_widths = np.ediff1d(bin_wl, 0, 0)
        half_widths[0] = half_widths[1]
        half_widths[-1] = half_widths[-2]
        half_widths = half_widths / 2.0
    bands = [
        Tophat(wl0, hw, wl=wl, ignore_gaps=gaps is not None)
        for wl0, hw in zip(bin_wl, half_widths)
    ]
    flux = np.array([
        np.nan if band.idx is None else band(spectrum)
        for band in bands
    ])
    mask = np.isnan(flux)
    if gaps == 'interpolate' and np.any(mask):
        flux[mask] = np.interp(bin_wl[mask], bin_wl[~mask], flux[~mask])
    return flux
