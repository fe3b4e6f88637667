"""Integration primitives on tensors (trapezoid and Simpson), on any
device: torch ports of pyratbay_tpu/ops/integrate.py.  Numpy arrays
passed beside a tensor follow its device and dtype."""
import torch

from ..device import as_tensors

__all__ = ['trapz_intervals', 'cumtrapz', 'simpson_nonuniform']


def trapz_intervals(data, intervals, axis=0):
    """Trapezoid integral of `data` along `axis` given the intervals
    between its samples:
    0.5 * sum_i intervals[i] * (data[i+1] + data[i])."""
    data, intervals = as_tensors(data, intervals)
    data = torch.movedim(data, axis, 0)
    mids = data[1:] + data[:-1]
    shape = (-1,) + (1,) * (mids.ndim - 1)
    return 0.5 * torch.sum(mids * intervals.reshape(shape), dim=0)


def cumtrapz(y, x, axis=0, initial=0.0):
    """Cumulative trapezoid of y along `axis`, starting at `initial`.

    As in the JAX package, `axis` moves to the front of y and x is
    broadcast against the moved y. A 1-D x with an N-D y lies along
    `axis` (a batch [B, n] over one grid [n] with axis=-1)."""
    if not (torch.is_tensor(y) and torch.is_tensor(x)):
        y, x = as_tensors(y, x)
    y = torch.movedim(y, axis, 0)
    if x.ndim == 1 and y.ndim > 1:
        x = x.reshape((-1,) + (1,) * (y.ndim - 1))
    try:
        shape = torch.broadcast_shapes(x.shape, y.shape)
    except RuntimeError:
        shape = None
    if shape != y.shape:
        raise ValueError(
            f'x of shape {tuple(x.shape)} does not broadcast to y moved '
            f'to {tuple(y.shape)}')
    dx = x[1:] - x[:-1]
    steps = 0.5 * dx * (y[1:] + y[:-1])
    csum = torch.cat(
        [torch.full_like(steps[:1], initial), torch.cumsum(steps, dim=0)])
    return torch.movedim(csum, 0, axis)


def simpson_nonuniform(y, x=None, dx=None, axis=0):
    """Composite Simpson integral of `y` along `axis` on (possibly)
    non-uniform samples `x` (or a constant step `dx`, 1 by default):
    scipy.integrate.simpson's rule, pure Simpson over pairs of
    intervals and, for an odd number of intervals, the asymmetric
    three-point correction for the last one.  Zero-width intervals are
    guarded as in the JAX package."""
    if x is None:
        y, = as_tensors(y)
    else:
        y, x = as_tensors(y, x)
    y = torch.movedim(y, axis, 0)
    n = y.shape[0]
    if x is not None:
        h = torch.diff(x)
    else:
        h = torch.full((n - 1,), 1.0 if dx is None else dx,
                       dtype=y.dtype, device=y.device)

    def nonzero(v):
        return torch.where(v == 0, torch.ones_like(v), v)

    npairs = (n - 1) // 2
    total = 0.0
    if npairs > 0:
        shape = (-1,) + (1,) * (y.ndim - 1)
        h0 = h[0:2 * npairs:2].reshape(shape)
        h1 = h[1:2 * npairs:2].reshape(shape)
        hsum = h0 + h1
        h0div = h0 / nonzero(h1)
        contrib = (hsum / 6.0) * (
            y[0:2 * npairs:2] * (2.0 - 1.0 / nonzero(h0div))
            + y[1:2 * npairs:2] * hsum * hsum / nonzero(h0 * h1)
            + y[2:2 * npairs + 1:2] * (2.0 - h0div)
        )
        total = torch.sum(contrib, dim=0)
    if (n - 1) % 2 == 1:
        # An odd number of intervals: the correction for the last one.
        h1 = h[-1]
        h0 = h[-2] if n >= 3 else h[-1]
        alpha = (2 * h1**2 + 3 * h0 * h1) / (6 * (h0 + h1))
        beta = (h1**2 + 3 * h0 * h1) / (6 * h0)
        eta = h1**3 / (6 * h0 * (h0 + h1))
        total = total + alpha * y[-1] + beta * y[-2] - eta * y[-3]
    return total
