"""Special functions on tensors: exponential integrals (Guillot T(p)),
the reference-compatible Voigt profile (alkali detuning anchors), the
Lorentz, Gauss and Voigt profile objects and the Doppler and Lorentz
half-widths; and, host numpy, the Voigt-grid width bounds of the
line-by-line engine (min_widths, max_widths).

Elementwise torch ports of pyratbay_tpu/ops/special.py, with the same
fixed iteration counts and region selects, so float64 results agree
with the JAX package to rounding.
"""
import functools

import numpy as np
import torch

from .. import constants as pc
from ..device import as_tensors

__all__ = ['exp1', 'e2', 'wofz_real', 'voigt_profile', 'voigt_ref',
           'Lorentz', 'Gauss', 'Voigt', 'doppler_hwhm', 'lorentz_hwhm',
           'min_widths', 'max_widths']

_SQRT_PI = np.sqrt(np.pi)
_SQRT_LN2 = np.sqrt(np.log(2.0))
_EULER_GAMMA = 0.5772156649015329


def exp1(x):
    """Exponential integral E_1(x) for x > 0: power series for
    x <= 1, fixed-depth continued fraction above."""
    xs = torch.where(x > 0, x, torch.ones_like(x))

    xsmall = torch.clamp(xs, max=1.0)
    term = torch.ones_like(xsmall)
    series = torch.zeros_like(xsmall)
    for k in range(1, 26):
        term = term * (-xsmall) / k
        series = series - term / k
    small = -_EULER_GAMMA - torch.log(xsmall) + series

    xl = torch.clamp(xs, min=1.0)
    cf = torch.zeros_like(xl)
    for k in range(30, 0, -1):
        cf = k / (1.0 + k / (xl + cf))
    large = torch.exp(-xl) / (xl + cf)
    return torch.where(x <= 1.0, small, large)


def e2(x):
    """Exponential integral E_2(x) = exp(-x) - x*E_1(x), for x >= 0."""
    safe = torch.where(x > 0, x, torch.ones_like(x))
    val = torch.exp(-safe) - safe * exp1(safe)
    return torch.where(x > 0, val, torch.ones_like(val))


@functools.lru_cache(maxsize=None)
def _weideman_coeffs(n_terms):
    m = 2 * n_terms
    m2 = 2 * m
    kk = np.arange(-m + 1, m)
    length = np.sqrt(n_terms / np.sqrt(2.0))
    theta = kk * np.pi / m
    t = length * np.tan(theta / 2.0)
    f = np.exp(-t**2) * (length**2 + t**2)
    f = np.concatenate([[0.0], f])
    a = np.real(np.fft.fft(np.fft.fftshift(f))) / m2
    a = np.flipud(a[1:n_terms + 1])
    return length, a


def _wofz_real_asymptotic(x, y):
    r2 = torch.clamp(x**2 + y**2, min=1.0)
    re_q = (x**2 - y**2) / r2**2
    im_q = -2.0 * x * y / r2**2
    re_s, im_s = 29.53125, 0.0
    for coeff in (6.5625, 1.875, 0.75, 0.5):
        re_s, im_s = (
            re_s * re_q - im_s * im_q + coeff,
            re_s * im_q + im_s * re_q,
        )
    re_s, im_s = re_s * re_q - im_s * im_q + 1.0, re_s * im_q + im_s * re_q
    return (y * re_s - x * im_s) / (r2 * _SQRT_PI)


def _weideman(x, y, n_terms=32):
    length, a = _weideman_coeffs(n_terms)
    re_num, im_num = length - y, x
    re_den, im_den = length + y, -x
    den2 = re_den**2 + im_den**2
    re_z = (re_num * re_den + im_num * im_den) / den2
    im_z = (im_num * re_den - re_num * im_den) / den2
    re_p = torch.zeros_like(re_z) + a[0]
    im_p = torch.zeros_like(re_z)
    for coeff in a[1:]:
        re_p, im_p = (
            re_p * re_z - im_p * im_z + coeff,
            re_p * im_z + im_p * re_z,
        )
    re_d2 = re_den**2 - im_den**2
    im_d2 = 2.0 * re_den * im_den
    d4 = re_d2**2 + im_d2**2
    re_q = (re_p * re_d2 + im_p * im_d2) / d4
    im_q = (im_p * re_d2 - re_p * im_d2) / d4
    re_w = 2.0 * re_q + re_den / den2 / _SQRT_PI
    im_w = 2.0 * im_q - im_den / den2 / _SQRT_PI
    return re_w, im_w


def _wofz_real_small_y(x, y, n_terms=32):
    _, im_w0 = _weideman(x, torch.zeros_like(x), n_terms)
    daw = 0.5 * _SQRT_PI * im_w0
    f1 = 1.0 - 2.0 * x * daw
    f2 = -2.0 * daw - 2.0 * x * f1
    f3 = -4.0 * f1 - 2.0 * x * f2
    f4 = -6.0 * f2 - 2.0 * x * f3
    f5 = -8.0 * f3 - 2.0 * x * f4
    gauss = torch.exp(y * y - x * x) * torch.cos(2.0 * x * y)
    im_fc = y * f1 - y**3 / 6.0 * f3 + y**5 / 120.0 * f5
    return gauss - 2.0 / _SQRT_PI * im_fc


def wofz_real(x, y, n_terms=None):
    """Real part of the Faddeeva function w(x + i y), y >= 0: small-y
    Dawson decomposition, Weideman rational interior, asymptotic
    series for |z| >= 14 (32 terms in float64, 16 in float32)."""
    x, y = torch.broadcast_tensors(x, y)
    if n_terms is None:
        n_terms = 16 if x.dtype == torch.float32 else 32
    re_w, _ = _weideman(x, y, n_terms)
    out = torch.where(y < 0.03, _wofz_real_small_y(x, y, n_terms), re_w)
    return torch.where(
        x**2 + y**2 >= 196.0, _wofz_real_asymptotic(x, y), out,
    )


def voigt_profile(x, hwhm_lor, hwhm_dop, n_terms=32):
    """Area-normalized Voigt profile V(x; hwhm_L, hwhm_G)."""
    sigma = hwhm_dop / _SQRT_LN2
    return wofz_real(x / sigma, hwhm_lor / sigma, n_terms) \
        / (sigma * _SQRT_PI)


_VA = np.array([-1.2150, -1.3509, -1.2150, -1.3509])
_VB = np.array([1.2359, 0.3786, -1.2359, -0.3786])
_VC = np.array([-0.3085, 0.5906, -0.3085, 0.5906])
_VD = np.array([0.0210, -1.1858, -0.0210, 1.1858])
_SQRT_PI_LN2 = np.sqrt(np.pi * np.log(2.0))


def voigt_ref(x, hwhm_lor, hwhm_dop):
    """Reference-compatible Voigt profile: exact Faddeeva evaluation
    when HWHM_L/HWHM_G < 0.1, else the 4-term rational approximation."""
    exact = voigt_profile(x, hwhm_lor, hwhm_dop)
    xx = x * _SQRT_LN2 / hwhm_dop
    yy = hwhm_lor * _SQRT_LN2 / hwhm_dop
    v = torch.zeros_like(xx)
    for ai, bi, ci, di in zip(_VA, _VB, _VC, _VD):
        v = v + (ci * (yy - ai) + di * (xx - bi)) / (
            (yy - ai)**2 + (xx - bi)**2
        )
    rational = v * _SQRT_PI_LN2 / (np.pi * hwhm_dop)
    return torch.where(hwhm_lor / hwhm_dop < 0.1, exact, rational)


_H2_RADIUS = 1.445e-8  # cm
_H2_MASS = 2.01588     # amu


def min_widths(min_temp, max_temp, min_wn, max_mass, min_rad, min_press):
    """Minimum Doppler/Lorentz HWHM bounds for an H2-dominated atmosphere
    (host numpy, pyratbay_tpu/ops/special.py)."""
    dmin = (
        np.sqrt(2.0 * np.log(2.0) * pc.k * min_temp / (max_mass * pc.amu))
        * min_wn / pc.c
    )
    min_diam = _H2_RADIUS + min_rad
    lmin = (
        np.sqrt(2.0 / (np.pi * pc.k * max_temp * pc.amu))
        * min_press * pc.bar * min_diam**2 / pc.c
        * np.sqrt(1.0 / max_mass + 1.0 / _H2_MASS)
    )
    return dmin, lmin


def max_widths(min_temp, max_temp, max_wn, min_mass, max_rad, max_press):
    """Maximum Doppler/Lorentz HWHM bounds for an H2-dominated atmosphere
    (host numpy, pyratbay_tpu/ops/special.py)."""
    dmax = (
        np.sqrt(2.0 * np.log(2.0) * pc.k * max_temp / (min_mass * pc.amu))
        * max_wn / pc.c
    )
    max_diam = _H2_RADIUS + max_rad
    lmax = (
        np.sqrt(2.0 / (np.pi * pc.k * min_temp * pc.amu))
        * max_press * pc.bar * max_diam**2 / pc.c
        * np.sqrt(1.0 / min_mass + 1.0 / _H2_MASS)
    )
    return dmax, lmax


class Lorentz:
    """Area-normalized 1D Lorentz profile with center x0, half-width
    hwhm and scale (pyratbay_tpu/ops/special.py); called on a numpy
    array or a tensor, returns a tensor on the input's device."""

    def __init__(self, x0=0.0, hwhm=1.0, scale=1.0):
        self.x0 = x0
        self.hwhm = hwhm
        self.scale = scale

    def __call__(self, x):
        x, = as_tensors(x)
        return (
            self.scale * self.hwhm / np.pi
            / (self.hwhm**2 + (x - self.x0)**2)
        )


class Gauss:
    """Area-normalized 1D Gaussian profile by its HWHM (center x0,
    scale); called on a numpy array or a tensor."""

    def __init__(self, x0=0.0, hwhm=1.0, scale=1.0):
        self.x0 = x0
        self.hwhm = hwhm
        self.scale = scale

    def __call__(self, x):
        x, = as_tensors(x)
        sigma = self.hwhm / np.sqrt(2.0 * np.log(2.0))
        return (
            self.scale / (sigma * np.sqrt(2.0 * np.pi))
            * torch.exp(-0.5 * ((x - self.x0) / sigma)**2)
        )


class Voigt:
    """Area-normalized 1D Voigt profile (center x0, hwhm_L, hwhm_G,
    scale) through `voigt_ref`'s branch selection: the exact Faddeeva
    evaluation for hwhm_L / hwhm_G < 0.1, else the 4-term rational
    approximation; called on a numpy array or a tensor."""

    def __init__(self, x0=0.0, hwhm_L=1.0, hwhm_G=1.0, scale=1.0):
        self.x0 = x0
        self.hwhm_L = hwhm_L
        self.hwhm_G = hwhm_G
        self.scale = scale

    def __call__(self, x):
        x, hwhm_l, hwhm_g = as_tensors(x, self.hwhm_L, self.hwhm_G)
        return self.scale * voigt_ref(x - self.x0, hwhm_l, hwhm_g)


def doppler_hwhm(temperature, mass, wn):
    """Doppler HWHM (cm-1); mass in amu, wn in cm-1, T in K."""
    temperature, mass, wn = as_tensors(temperature, mass, wn)
    return (
        wn / pc.c
        * torch.sqrt(2.0 * np.log(2.0) * pc.k * temperature / (mass * pc.amu))
    )


def lorentz_hwhm(temperature, pressure, masses, radii, vmr, imol):
    """Pressure-broadening Lorentz HWHM (cm-1) of the species `imol`:
    pressure in bar; masses (amu), radii (cm) and vmr per species."""
    temperature, pressure, masses, radii, vmr = as_tensors(
        temperature, pressure, masses, radii, vmr)
    imol = torch.atleast_1d(
        torch.as_tensor(imol, dtype=torch.int64, device=masses.device))
    # Sum over the colliders (last axis) for each species of imol:
    coll = torch.sum(
        vmr[None, :] * (radii[None, :] + radii[imol, None])**2
        * torch.sqrt(1.0 / masses[None, :] + 1.0 / masses[imol, None]),
        dim=-1,
    )
    return (
        pressure * pc.bar / pc.c
        * torch.sqrt(2.0 / (np.pi * pc.k * temperature * pc.amu))
        * coll
    )
