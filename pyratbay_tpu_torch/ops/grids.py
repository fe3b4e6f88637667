"""Spectral sampling grids.

Wavenumber arrays are static (host-side numpy): they define array shapes
for everything downstream, so they must be concrete before tracing.
Reference behavior: pyratbay/pyrat/spectrum.py:181-228 and
pyratbay/spectrum/spec_tools.py:461-505.
"""
import numpy as np

__all__ = [
    'constant_resolution_spectrum',
    'wavenumber_grid',
    'divisors',
    'HIGHLY_COMPOSITE',
]

# Highly composite numbers, used to pick oversampling factors whose divisor
# sets are rich (enables integer downsampling of the fine grid).
HIGHLY_COMPOSITE = np.array([
    1, 2, 4, 6, 12, 24, 36, 48, 60, 120, 180, 240, 360, 720, 840,
    1260, 1680, 2160, 2520, 5040, 7560, 10080, 15120, 20160, 25200,
    27720, 45360, 50400, 55440, 83160, 110880, 221760, 277200,
])


def constant_resolution_spectrum(wave_min, wave_max, resolution):
    """Geometric-series sampling with constant resolving power R = w/dw.

    Successive samples follow w[i+1] = w[i] * g with g = (1+f)/(1-f),
    f = 0.5/R, so that the midpoint resolution is exactly R.
    """
    f = 0.5 / resolution
    g = (1.0 + f) / (1.0 - f)
    nwave = int(np.ceil(-np.log(wave_min / wave_max) / np.log(g)))
    return wave_min * g ** np.arange(nwave)


def divisors(number):
    """All integer divisors of `number`, ascending."""
    divs = [i for i in range(1, number + 1) if number % i == 0]
    return np.asarray(divs, int)


class WavenumberGrid:
    """Static description of the spectral sampling.

    Attributes
    ----------
    wn: 1D array -- output (coarse) wavenumber grid (cm-1), increasing.
    own: 1D array or None -- fine (oversampled) grid for line-by-line work.
    wnosamp: int -- oversampling factor (own step = wnstep / wnosamp).
    resolution / wnstep / wlstep: the sampling mode actually in effect.
    """

    def __init__(self, wn, own=None, wnstep=None, ownstep=None, wnosamp=None,
                 resolution=None, wlstep=None, wnlow=None, wnhigh=None):
        self.wn = np.asarray(wn)
        self.nwave = len(self.wn)
        self.own = None if own is None else np.asarray(own)
        self.onwave = 0 if own is None else len(self.own)
        self.wnstep = wnstep
        self.ownstep = ownstep
        self.wnosamp = wnosamp
        self.resolution = resolution
        self.wlstep = wlstep
        self.wnlow = self.wn[0] if wnlow is None else wnlow
        self.wnhigh = self.wn[-1] if wnhigh is None else wnhigh
        self.odivisors = (
            divisors(wnosamp) if wnosamp is not None else None
        )

    @property
    def wl(self):
        """Wavelength in micron."""
        return 1.0 / (self.wn * 1e-4)

    def __str__(self):
        lines = [
            'Wavenumber sampling:',
            f'Range: {self.wnlow:.3f} -- {self.wnhigh:.3f} cm-1 '
            f'({self.nwave} samples)',
        ]
        if self.resolution is not None:
            lines.append(
                f'Constant resolving power (resolution): '
                f'{self.resolution:.1f}'
            )
        elif self.wlstep is not None:
            lines.append(
                f'Constant wavelength step (wlstep): {self.wlstep:.3e} um'
            )
        elif self.wnstep is not None:
            lines.append(
                f'Constant wavenumber step (wnstep): {self.wnstep:.3f} '
                'cm-1'
            )
        if self.own is not None:
            lines.append(
                f'Fine grid: {self.onwave} samples '
                f'(oversampling factor {self.wnosamp})'
            )
        return ''.join(line + '\n' for line in lines)


def wavenumber_grid(
        wnlow=None, wnhigh=None, wl_low=None, wl_high=None,
        wnstep=None, wlstep=None, resolution=None, wnosamp=None,
    ):
    """Build the coarse + fine wavenumber sampling.

    Three sampling modes (reference pyrat/spectrum.py:201-217):
      resolution -> constant-R geometric series;
      wlstep     -> constant wavelength step (cm units internally);
      wnstep     -> constant wavenumber step (default).
    A fine grid `own` oversamples [wnlow, wn[-1]] by `wnosamp` for
    line-by-line opacity sampling; default targets step <= 4e-4 cm-1.

    Wavelength bounds are in cm (CGS) when given.
    """
    if wnlow is None:
        if wl_high is None:
            raise ValueError('Undefined low wavenumber boundary')
        wnlow = 1.0 / wl_high
    if wnhigh is None:
        if wl_low is None:
            raise ValueError('Undefined high wavenumber boundary')
        wnhigh = 1.0 / wl_low
    if wl_low is None:
        wl_low = 1.0 / wnhigh
    if wl_high is None:
        wl_high = 1.0 / wnlow
    if wnlow > wnhigh:
        # Reference message (pyrat/spectrum.py:115-119):
        raise ValueError(
            f'Wavenumber low boundary ({wnlow:.1f} cm-1) must be '
            f'larger than the high boundary ({wnhigh:.1f} cm-1)'
        )
    if wnstep is None and wlstep is None and resolution is None:
        raise ValueError(
            'Undefined spectral sampling rate: set resolution, wnstep, '
            'or wlstep'
        )

    eff_wnstep = wnstep
    if wnosamp is None:
        if eff_wnstep is None:
            eff_wnstep = 1.0
        wnosamp = int(
            HIGHLY_COMPOSITE[eff_wnstep / HIGHLY_COMPOSITE <= 0.0004][0]
        )

    if resolution is not None:
        wn = constant_resolution_spectrum(wnlow, wnhigh, resolution)
        wlstep = None
    elif wlstep is not None:
        wl = np.arange(wl_low, wl_high, wlstep)
        wn = 1.0 / np.flip(wl)
        wnlow = wn[0]
        resolution = None
    else:
        nwave = int((wnhigh - wnlow) / eff_wnstep) + 1
        wn = wnlow + np.arange(nwave) * eff_wnstep
    if eff_wnstep is None:
        eff_wnstep = 1.0

    # Fine oversampled grid:
    ownstep = eff_wnstep / wnosamp
    onwave = int(np.ceil((wn[-1] - wnlow) / ownstep)) + 1
    own = wnlow + np.arange(onwave) * ownstep

    return WavenumberGrid(
        wn=wn, own=own, wnstep=eff_wnstep, ownstep=ownstep, wnosamp=wnosamp,
        resolution=resolution, wlstep=wlstep, wnlow=wnlow, wnhigh=wnhigh,
    )
