"""High-resolution spectroscopy: instrumental convolution and
radial-velocity shifting.

Host-side numpy copy of pyratbay_tpu/spectrum/hires.py (reference
behavior: pyratbay/spectrum/spec_tools.py:817-908), plus the batched
stage of the retrieval forward on tensors (hires_stage, the high-res
channel of pyratbay_tpu/retrieval/batched.py:579-607): one grouped
convolution of [B, W] spectra with the instrumental kernel, then a
fixed two-point lerp at the data's wavenumbers, or, with a retrieved
radial velocity, a per-chain lerp on the Doppler-shifted grid.
"""
import numpy as np
import scipy.interpolate as si
import torch
import torch.nn.functional as F
from scipy.signal import convolve
from scipy.signal.windows import gaussian

from .. import constants as pc

__all__ = ['inst_convolution', 'instrumental_kernel', 'rv_shift',
           'HiresStage']


def instrumental_kernel(resolution, sampling_res):
    """Gaussian instrumental kernel resampled onto the spectrum's
    velocity sampling (static; reference spec_tools.py:817-860).

    resolution: R = lambda/FWHM of the gaussian; sampling_res: the
    spectrum's sampling resolving power.
    """
    pixel_dv = pc.c / resolution / 1e5     # FWHM in km/s
    n_el = int(6 * pixel_dv) + 1
    kernel = gaussian(n_el, std=pixel_dv / 2.355)
    kernel /= np.sum(kernel)

    rv_pix = np.abs(pc.c / 1e5 / sampling_res)
    n_rv0 = int(((n_el - 1) / 2) / rv_pix)
    rv_array = np.arange(-(n_el - 1) / 2, (n_el - 1) / 2 + 1, 1)
    rv_mod = np.linspace(-n_rv0 * rv_pix, n_rv0 * rv_pix, 2 * n_rv0 + 1)
    spline = si.splrep(rv_array, kernel)
    kernel_pix = si.splev(rv_mod, spline, der=0)
    return kernel_pix / np.sum(kernel_pix)


def inst_convolution(wl, spectrum, resolution, sampling_res=None):
    """Convolve a spectrum to an instrumental resolving power.

    resolution: R = lambda/FWHM of the gaussian kernel.
    sampling_res: resolution of the input sampling (estimated from wl
    when not given).
    """
    if sampling_res is None:
        dv = np.ediff1d(wl) / wl[:-1]
        sampling_res = 1.0 / np.abs(np.mean(dv))
    kernel_pix = instrumental_kernel(resolution, sampling_res)
    return convolve(spectrum, kernel_pix, mode='same')


def rv_shift(vel_km, wn=None, wl=None):
    """Relativistic Doppler shift of a wavenumber/wavelength array.

    vel_km: radial velocity in km/s (positive = redshift for wl).
    """
    vel = vel_km * pc.km
    if wn is not None:
        factor = np.sqrt((1 - vel / pc.c) / (1 + vel / pc.c))
        return np.asarray(wn) * factor
    if wl is not None:
        factor = np.sqrt((1 + vel / pc.c) / (1 - vel / pc.c))
        return np.asarray(wl) * factor
    raise ValueError('Either wn or wl must be provided')


class HiresStage:
    """The high-res channel of the batched forward: spectra [B, W] on
    the model grid -> fluxes [B, H] at the data's wavenumbers.

    wn [W] (increasing) and wn_hires [H] are host float64; kernel is
    instrumental_kernel(inst_resolution, sampling_res).  The
    convolution is torch's grouped correlation with the kernel flipped
    and padded (kw-1) - (kw-1)//2 on the left and (kw-1)//2 on the
    right, which equals np.convolve(mode='same').  Without a radial
    velocity the lerp indices and weights are fixed (host float64);
    with one, the shifted grid wn * sqrt((1 - v/c) / (1 + v/c)) and its
    lerp indices and weights are computed in float64 on the device for
    each chain (a float32 ulp near 6,500 cm-1 is a sizeable share of a
    fine grid's step) and only the weights are cast to the spectra's
    dtype.
    """

    def __init__(self, wn, wn_hires, kernel, device, dtype):
        self.dtype = dtype
        kw = len(kernel)
        self.pad = (kw - 1 - (kw - 1) // 2, (kw - 1) // 2)
        self.kernel = torch.as_tensor(
            np.asarray(kernel, float)[::-1].copy(), dtype=dtype,
            device=device).reshape(1, 1, kw)
        wn = np.asarray(wn, float)
        wn_hires = np.asarray(wn_hires, float)
        # The fixed grid's lerp, clamped at its ends as np.interp clamps:
        ilo = np.clip(np.searchsorted(wn, wn_hires, side='right') - 1,
                      0, len(wn) - 2)
        whi = np.clip((wn_hires - wn[ilo]) / (wn[ilo + 1] - wn[ilo]),
                      0.0, 1.0)
        self.ilo = torch.as_tensor(ilo, device=device)
        self.whi = torch.as_tensor(whi, dtype=dtype, device=device)
        self._wn64 = torch.as_tensor(wn, dtype=torch.float64, device=device)
        self._wh64 = torch.as_tensor(wn_hires, dtype=torch.float64,
                                     device=device)

    def convolve(self, spectrum):
        """spectrum [B, W] -> the instrumental convolution [B, W]."""
        return F.conv1d(F.pad(spectrum[:, None, :], self.pad),
                        self.kernel)[:, 0, :]

    def shifted_lerp(self, velocity):
        """Per-chain lerp (ilo [B, H], whi [B, H]) on the grid shifted
        by `velocity` [B] (cm s-1), clamped at the grid's ends as
        jnp.interp clamps."""
        vel = velocity.to(torch.float64)[:, None]
        factor = torch.sqrt((1.0 - vel / pc.c) / (1.0 + vel / pc.c))
        grid = self._wn64[None, :] * factor                  # [B, W]
        wh = self._wh64[None, :].expand(grid.shape[0], -1).contiguous()
        ilo = torch.clamp(
            torch.searchsorted(grid, wh, right=True) - 1,
            0, grid.shape[1] - 2)
        lo = torch.gather(grid, 1, ilo)
        hi = torch.gather(grid, 1, ilo + 1)
        whi = torch.clamp((wh - lo) / (hi - lo), 0.0, 1.0)
        return ilo, whi.to(self.dtype)

    def __call__(self, spectrum, velocity=None):
        """spectrum [B, W] -> fluxes [B, H]; velocity [B] (cm s-1) or
        None for the fixed grid."""
        conv = self.convolve(spectrum)
        if velocity is None:
            return conv[:, self.ilo] * (1.0 - self.whi) \
                + conv[:, self.ilo + 1] * self.whi
        ilo, whi = self.shifted_lerp(velocity)
        return torch.gather(conv, 1, ilo) * (1.0 - whi) \
            + torch.gather(conv, 1, ilo + 1) * whi

