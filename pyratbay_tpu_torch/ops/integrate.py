"""Integration primitives on tensors."""
import torch

__all__ = ['cumtrapz']


def cumtrapz(y, x):
    """Cumulative trapezoid of y [..., n] over x [n] along the last
    axis, starting at zero."""
    dx = x[1:] - x[:-1]
    steps = 0.5 * dx * (y[..., 1:] + y[..., :-1])
    return torch.cat(
        [torch.zeros_like(steps[..., :1]), torch.cumsum(steps, dim=-1)],
        dim=-1,
    )
