"""Ray-path geometry for transit (limb) observations.

Port of pyratbay_tpu/atmosphere/geometry.py.  The chord is a
difference of square roots of r^2 differences, which loses precision
in float32 unless the radii are O(1): callers pass radius / rscale and
multiply the result by rscale (Model._run_transit).
"""
import torch

__all__ = ['transit_path_matrix']


def transit_path_matrix(radius, itop=0):
    """Dense chord-segment matrices.

    path[b, r, i] = sqrt(radius[i]^2 - radius[r]^2)
                  - sqrt(radius[i+1]^2 - radius[r]^2)   for itop <= i < r,
    and 0 elsewhere; radius [B, l] sorted top (largest) to bottom;
    itop an int or a [B] integer tensor.  Returns [B, l, l-1].
    """
    nlayers = radius.shape[-1]
    r2 = radius**2
    diff_outer = r2[:, None, :] - r2[:, :, None]          # [b, r, i]
    s = torch.sqrt(torch.clamp(diff_outer, min=0.0))
    seg = s[..., :-1] - s[..., 1:]
    rows = torch.arange(nlayers, device=radius.device)[:, None]
    cols = torch.arange(nlayers - 1, device=radius.device)[None, :]
    itop = torch.as_tensor(itop, device=radius.device).reshape(-1, 1, 1)
    mask = (cols < rows) & (cols >= itop) & (rows > itop)
    return torch.where(mask, seg, torch.zeros_like(seg))
