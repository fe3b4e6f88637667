"""Interpolation: host-side natural cubic spline (CIA setup), the
linear interpolation of a tabulated table's rows on tensors
(lin_interp_trow) and a batched tensor linear interpolation with
jnp.interp's semantics.

`second_deriv_ref` reproduces the reference's spline-tension quirk
(src_c/_spline.c:50-51 divides by x[i+1] - y[i-1]); it is kept, not
fixed, because the published golden spectra were generated with it.
`second_deriv` is the textbook natural spline.  Both are host numpy,
as in pyratbay_tpu/ops/interp.py, like `splinterp` that reads them.
"""
import numpy as np
import torch

from ..device import as_tensors

__all__ = ['second_deriv', 'second_deriv_ref', 'splinterp',
           'lin_interp_trow', 'interp']


def _second_deriv_impl(y, x, ref_quirk):
    """Natural cubic-spline second derivatives (host numpy)."""
    y = np.asarray(y, float)
    x = np.asarray(x, float)
    n = len(y) - 1
    y2 = np.zeros(n + 1)
    u = np.zeros(n)
    for i in range(1, n):
        denom = (x[i + 1] - y[i - 1]) if ref_quirk else (x[i + 1] - x[i - 1])
        sig = (x[i] - x[i - 1]) / denom
        p = sig * y2[i - 1] + 2.0
        y2[i] = (sig - 1.0) / p
        ui = (
            (y[i + 1] - y[i]) / (x[i + 1] - x[i])
            - (y[i] - y[i - 1]) / (x[i] - x[i - 1])
        )
        u[i] = (6.0 * ui / (x[i + 1] - x[i - 1]) - sig * u[i - 1]) / p
    for i in range(n - 1, -1, -1):
        y2[i] = y2[i] * y2[i + 1] + u[i]
    y2[n] = 0.0
    return y2


def second_deriv(y, x):
    """Textbook natural-cubic-spline second derivatives (numpy)."""
    return _second_deriv_impl(y, x, ref_quirk=False)


def second_deriv_ref(y, x):
    """Reference-compatible natural-spline second derivatives (numpy)."""
    return _second_deriv_impl(y, x, ref_quirk=True)


def splinterp(y, x, y2, xout, extrap=0.0):
    """Cubic-spline interpolation of y(x) at xout (numpy); points
    outside [x[0], x[-1]] get `extrap`."""
    y = np.asarray(y, float)
    x = np.asarray(x, float)
    xout = np.asarray(xout, float)
    yout = np.full(len(xout), extrap, float)
    inside = (xout >= x[0]) & (xout <= x[-1])
    idx = np.searchsorted(x, xout[inside], side='right') - 1
    idx = np.clip(idx, 0, len(x) - 2)
    dx = x[idx + 1] - x[idx]
    a = (x[idx + 1] - xout[inside]) / dx
    b = (xout[inside] - x[idx]) / dx
    yout[inside] = (
        a * y[idx] + b * y[idx + 1]
        + ((a**3 - a) * y2[idx] + (b**3 - b) * y2[idx + 1]) * dx * dx / 6.0
    )
    return yout


def lin_interp_trow(table, xin, dy_dx, xout, lo=0, hi=None):
    """Linear interpolation of a [nx, ncol] table along axis 0 at each
    value of `xout` [nout] (e.g. a temperature profile), from the slopes
    `dy_dx` [nx - 1, ncol]; columns outside [lo, hi) are 0, and an
    `xout` beyond the grid takes its end segment's line
    (pyratbay_tpu/ops/interp.py).  Numpy arrays or tensors; returns
    [nout, ncol] on the device of the first tensor among them."""
    table, xin, dy_dx, xout = as_tensors(table, xin, dy_dx, xout)
    nx, ncol = table.shape
    if hi is None:
        hi = ncol
    idx = torch.clamp(
        torch.searchsorted(xin, xout.contiguous(), right=True) - 1,
        0, nx - 2)
    out = table[idx] + (xout - xin[idx])[:, None] * dy_dx[idx]
    col = torch.arange(ncol, device=table.device)
    in_range = (col >= lo) & (col < hi)
    return torch.where(in_range[None, :], out, torch.zeros_like(out))


def interp(x, xp, fp):
    """Linear interpolation of each row of fp at its own point x.

    x: [B] points; xp: [n] increasing grid; fp: [B, n] values.
    Same arithmetic as jnp.interp, including the constant end clamps
    (x < xp[0] -> fp[0], x > xp[-1] -> fp[-1]).  Returns [B].
    """
    n = xp.shape[0]
    i = torch.clamp(
        torch.searchsorted(xp, x.contiguous(), right=True), 1, n - 1,
    )
    f_lo = torch.gather(fp, -1, (i - 1)[:, None])[:, 0]
    f_hi = torch.gather(fp, -1, i[:, None])[:, 0]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = np.spacing(np.finfo(
        np.float64 if xp.dtype == torch.float64 else np.float32).eps)
    dx0 = torch.abs(dx) <= eps
    f = torch.where(
        dx0, f_lo,
        f_lo + (delta / torch.where(dx0, torch.ones_like(dx), dx))
        * (f_hi - f_lo),
    )
    f = torch.where(x < xp[0], fp[:, 0], f)
    return torch.where(x > xp[-1], fp[:, -1], f)
