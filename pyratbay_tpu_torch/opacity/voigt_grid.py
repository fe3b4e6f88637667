"""Pre-computed grid of binned Voigt profiles for line-by-line sampling.

Replicates the reference's profile machinery exactly (src_c/vprofile.c,
src_c/include/voigt.h, pyratbay/pyrat/voigt.py):

* Pierluissi et al. (1977) three-region approximation of Re[w(z)], with
  the same per-point series truncation;
* >= 50 samples per Doppler width via oversampled evaluation, binned
  down with Simpson averages (area-preserving);
* log-spaced (nlor x ndop) width grids with profile sizes bounded by
  `extent` (HWHMs) and `cutoff` (cm-1);
* dedup: profiles with doppler/lorentz < dlratio alias the previous
  Doppler column.

Everything is vectorized numpy (profiles are static setup data computed
once); the hot per-layer sampling lives in lbl.py.  Host-side copy of
pyratbay_tpu/opacity/voigt_grid.py; `cached_grid` keeps one grid per
set of arguments for the life of the process (a flagship grid takes
tens of seconds and ~1.4 GB).
"""
import numpy as np

from ..ops.special import min_widths, max_widths

__all__ = ['pierluissi_voigt', 'voigt_binned_profile', 'VoigtGrid',
           'cached_grid']

_SQRTLN2 = 0.83255461115769775635
_TWOOSQRTPI = 1.12837916709551257389
_SQRTLN2PI = 0.46971863934982566689   # sqrt(ln2/pi)

# Region II/III rational coefficients (Pierluissi 1977):
_A = (0.46131350, 0.19016350, 0.09999216, 1.78449270, 0.002883894,
      5.52534370)
_B = (0.51242424, 0.27525510, 0.05176536, 2.72474500)

# 1/(n! (2n+1)) series coefficients for the region-I expansion:
_NFERF = 61
_FERF = np.zeros(_NFERF)
_fact = 1.0
for _n in range(_NFERF):
    if _n > 0:
        _fact *= _n
    _FERF[_n] = 1.0 / (_fact * (2 * _n + 1))


def pierluissi_voigt(x, y, alpha_dop):
    """Voigt function via the Pierluissi three-region approximation.

    x = sqrt(ln2)|nu-nu0|/alphaD, y = sqrt(ln2) alphaL/alphaD; returns
    the area-normalized profile value (the sqrt(ln2/pi)/alphaD factor
    is folded in).  Matches voigt.h:147-217 including the per-point
    series truncation NFCN = (x<1 ? 15 : 6.842x+8) + 1.
    """
    x = np.asarray(x, float)
    y = float(y)
    x2y2 = x * x - y * y
    xy2 = 2.0 * x * y
    cosxy = np.cos(xy2)
    sinxy = np.sin(xy2)

    out = np.empty_like(x)

    region1 = (x < 3.0) & (y < 1.8)
    region2 = ~region1 & (x < 5.0) & (y < 5.0)
    region3 = ~region1 & ~region2

    # Region I: truncated series of (y - ix) z^{2n} with ferf weights.
    if np.any(region1):
        x1 = x[region1]
        x2y2_1 = x2y2[region1]
        xy2_1 = xy2[region1]
        nfcn = np.where(x1 < 1.0, 15, (6.842 * x1 + 8.0).astype(int)) + 1
        max_n = int(nfcn.max())
        o_r = np.full_like(x1, y)
        o_i = -x1
        a_r = o_r.copy()
        a_i = o_i.copy()
        for i in range(1, max_n + 1):
            n_i = o_r * xy2_1 + o_i * x2y2_1
            n_r = o_r * x2y2_1 - o_i * xy2_1
            live = i <= nfcn
            a_i = np.where(live, a_i + n_i * _FERF[i], a_i)
            a_r = np.where(live, a_r + n_r * _FERF[i], a_r)
            o_i, o_r = n_i, n_r
        out[region1] = (
            _SQRTLN2PI / alpha_dop * np.exp(-x2y2_1)
            * (cosxy[region1] * (1.0 - a_r * _TWOOSQRTPI)
               - sinxy[region1] * a_i * _TWOOSQRTPI)
        )

    # Region II: three-term rational.
    if np.any(region2):
        x2y2_2 = x2y2[region2]
        xy2_2 = xy2[region2]
        ar = xy2_2 * xy2_2
        nr = xy2_2 * x[region2]
        ni = x2y2_2 - _A[1]
        ai = x2y2_2 - _A[3]
        oi = x2y2_2 - _A[5]
        out[region2] = _SQRTLN2PI / alpha_dop * (
            _A[0] * ((nr - ni * y) / (ni * ni + ar))
            + _A[2] * ((nr - ai * y) / (ai * ai + ar))
            + _A[4] * ((nr - oi * y) / (oi * oi + ar))
        )

    # Region III: two-term rational.
    if np.any(region3):
        x2y2_3 = x2y2[region3]
        xy2_3 = xy2[region3]
        ar = xy2_3 * xy2_3
        nr = xy2_3 * x[region3]
        ni = x2y2_3 - _B[1]
        ai = x2y2_3 - _B[3]
        out[region3] = _SQRTLN2PI / alpha_dop * (
            _B[0] * ((nr - ni * y) / (ni * ni + ar))
            + _B[2] * ((nr - ai * y) / (ai * ai + ar))
        )
    return out


_VOIGT_MAXELEMENTS = 99999


def voigt_binned_profile(psize, dwn, alpha_lor, alpha_dop):
    """One binned Voigt profile of 2*psize+1 samples at spacing dwn.

    Evaluates on a sub-grid with >= 50 points per Doppler width and
    Simpson-averages each bin (voigt.h:222-295).  Profiles wider than
    the reference's quick-integration threshold take point samples.
    """
    nwn = 2 * psize + 1
    half = dwn * (nwn // 2)
    y = _SQRTLN2 * alpha_lor / alpha_dop
    ddwn = 2.0 * half / (nwn - 1)

    quick = nwn > _VOIGT_MAXELEMENTS
    nint = 50
    dint = alpha_dop / (nint - 1)
    if ddwn < dint or quick:
        osamp = 1
        dint = ddwn
        nint = nwn + 1
    else:
        osamp = int(ddwn / dint) + 1
        if osamp & 1:
            osamp += 1
        nint = nwn * osamp + 1
        dint = 2.0 * half / (nint - 1)

    i = np.arange(nint)
    x = _SQRTLN2 * np.abs(dint * i - half) / alpha_dop
    fine = pierluissi_voigt(x, y, alpha_dop)

    if quick:
        # Quick integration: point samples at each bin start.
        return fine[:nwn]
    if osamp == 1:
        # Fine sampling already: 2-point trapezoid bins.
        return 0.5 * (fine[:-1] + fine[1:])
    # Simpson average over each bin of osamp+1 points (osamp even):
    ipo = osamp  # last index within each bin window
    idx = np.arange(nwn)[:, None] * osamp + np.arange(osamp + 1)[None, :]
    window = fine[idx]
    odd = window[:, 1:ipo:2].sum(axis=1)
    even = window[:, 2:ipo:2].sum(axis=1)
    return ((odd * 2.0 + even) * 2.0 + window[:, 0] + window[:, ipo]) \
        / (ipo * 3.0)


class VoigtGrid:
    """Grid of binned Voigt profiles over (lorentz, doppler) HWHMs."""

    def __init__(
            self, ownstep, onwave, min_wn, max_wn,
            min_press, max_press, min_mass, max_mass, min_rad, max_rad,
            tmin=100.0, tmax=3000.0,
            ndop=50, nlor=100, dmin=None, dmax=None, lmin=None, lmax=None,
            extent=300.0, cutoff=25.0, dlratio=0.1,
        ):
        self.extent = extent
        self.cutoff = cutoff
        self.dlratio = dlratio

        est_dmin, est_lmin = min_widths(
            tmin, tmax, min_wn, max_mass, min_rad, min_press,
        )
        est_dmax, est_lmax = max_widths(
            tmin, tmax, max_wn, min_mass, max_rad, max_press,
        )
        self.dmin = est_dmin if dmin is None else dmin
        self.dmax = est_dmax if dmax is None else dmax
        self.lmin = est_lmin if lmin is None else lmin
        self.lmax = est_lmax if lmax is None else lmax
        if self.dmax <= self.dmin:
            raise ValueError(
                f'Voigt dmax ({self.dmax:.4e}) must be > dmin '
                f'({self.dmin:.4e})'
            )
        if self.lmax <= self.lmin:
            raise ValueError(
                f'Voigt lmax ({self.lmax:.4e}) must be > lmin '
                f'({self.lmin:.4e})'
            )
        self.ndop = ndop
        self.nlor = nlor
        self.doppler = np.logspace(
            np.log10(self.dmin), np.log10(self.dmax), ndop,
        )
        self.lorentz = np.logspace(
            np.log10(self.lmin), np.log10(self.lmax), nlor,
        )

        # Profile half-sizes (in fine-grid samples):
        self.size = np.zeros((nlor, ndop), int)
        self.index = np.zeros((nlor, ndop), int)
        for i in range(nlor):
            pwidth = self.extent * (
                0.5346 * self.lorentz[i]
                + np.sqrt(0.2166 * self.lorentz[i]**2 + self.doppler**2)
            )
            if self.cutoff > 0:
                pwidth = np.minimum(pwidth, self.cutoff)
            psize = 1 + 2 * np.asarray(pwidth / ownstep + 0.5, int)
            psize = np.clip(psize, 3, 1 + 2 * onwave)
            skip = self.doppler / self.lorentz[i] < self.dlratio
            skip[0] = False
            psize[skip] = 0
            self.size[i] = psize // 2

        # Compute profiles (aliasing skipped columns to the previous):
        chunks = []
        idx = 0
        for m in range(nlor):
            for n in range(ndop):
                if self.size[m, n] != 0:
                    prof = voigt_binned_profile(
                        self.size[m, n], ownstep,
                        self.lorentz[m], self.doppler[n],
                    )
                    chunks.append(prof)
                    self.index[m, n] = idx
                    idx += len(prof)
                else:
                    self.index[m, n] = self.index[m, n - 1]
                    self.size[m, n] = self.size[m, n - 1]
        self.profile = np.concatenate(chunks) if chunks else np.zeros(0)

    def __str__(self):
        return ''.join(line + '\n' for line in (
            'Voigt-profile grid:',
            'Doppler HWHM range (dmin, dmax): '
            f'[{self.dmin:.3e}, {self.dmax:.3e}] cm-1 ({self.ndop} samples)',
            'Lorentz HWHM range (lmin, lmax): '
            f'[{self.lmin:.3e}, {self.lmax:.3e}] cm-1 ({self.nlor} samples)',
            f'Profile extent (extent): {self.extent:.1f} HWHM',
            f'Profile cutoff (cutoff): {self.cutoff:.1f} cm-1',
            'Doppler/Lorentz aliasing threshold (dlratio): '
            f'{self.dlratio:.3f}',
            f'Tabulated profile samples: {len(self.profile)}',
        ))


_GRIDS = {}


def cached_grid(**kwargs):
    """The VoigtGrid of these keyword arguments, computed once a
    process."""
    key = tuple(sorted(
        (name, None if val is None else float(val))
        for name, val in kwargs.items()))
    if key not in _GRIDS:
        _GRIDS[key] = VoigtGrid(**kwargs)
    return _GRIDS[key]
