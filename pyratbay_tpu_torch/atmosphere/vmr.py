"""Volume-mixing-ratio models and bulk-species balancing on tensors of
shape [..., nlayers, nspecies] (leading dimensions are chains).

Port of pyratbay_tpu/atmosphere/vmr.py.
"""
import numpy as np
import torch

from ..device import index_tensor

__all__ = [
    'uniform_vmr', 'iso_vmr', 'scale_vmr', 'slant_vmr',
    'bulk_ratio', 'balance_bulk', 'vmr_scale', 'qcapcheck',
]


def uniform_vmr(abundances, nlayers):
    """Tile uniform abundances into [nlayers, nspecies] (numpy)."""
    return np.tile(np.asarray(abundances, float), (nlayers, 1))


def iso_vmr(log_vmr, nlayers):
    """Constant-with-altitude VMR: log_vmr [...] -> [..., nlayers]."""
    return (10.0 ** log_vmr)[..., None].expand(*log_vmr.shape, nlayers)


def scale_vmr(base_profile, log_scale):
    """Scale a base VMR profile [nlayers] by 10**log_scale [...]."""
    return base_profile * (10.0 ** log_scale)[..., None]


def slant_vmr(log_press, params):
    """Sloped log-VMR profile, clipped between min/max bounds.

    params [..., 5] = [slope, log_vmr0, log_p0, min_log_vmr,
    max_log_vmr]; log_press [nlayers].
    """
    col = lambda i: params[..., i:i + 1]
    log_vmr = col(0) * (log_press - col(2)) + col(1)
    return 10.0 ** torch.minimum(torch.maximum(log_vmr, col(3)), col(4))


def bulk_ratio(vmr, ibulk):
    """Bulk abundance ratios to the first bulk species:
    (bratio [..., nlayers, nbulk], invsrat [..., nlayers])."""
    ibulk = list(ibulk)
    bratio = vmr[..., index_tensor(ibulk, vmr.device)] \
        / vmr[..., index_tensor(ibulk[:1], vmr.device)]
    bratio[..., 0] = 1.0
    return bratio, 1.0 / torch.sum(bratio, dim=-1)


def balance_bulk(vmr, ibulk, bratio, invsrat):
    """Re-set bulk-species VMRs so each layer sums to one."""
    ibulk = index_tensor(ibulk, vmr.device)
    is_bulk = torch.zeros(vmr.shape[-1], dtype=torch.bool,
                          device=vmr.device)
    is_bulk.index_fill_(0, ibulk, True)   # a scalar: no copy from the host
    sum_traces = torch.sum(
        torch.where(is_bulk, torch.zeros_like(vmr), vmr), dim=-1)
    remainder = 1.0 - sum_traces
    out = vmr.clone()
    out[..., ibulk] = bratio * (remainder * invsrat)[..., None]
    return out


def vmr_scale(base_vmr, scaled_profiles, iscale, ibulk, bratio, invsrat):
    """Replace species columns by free profiles, then re-balance the
    bulk species.  scaled_profiles: list of [..., nlayers]."""
    batch = scaled_profiles[0].shape[:-1] if scaled_profiles else ()
    vmr = base_vmr.expand(*batch, *base_vmr.shape).clone()
    for prof, imol in zip(scaled_profiles, iscale):
        vmr[..., imol] = prof
    return balance_bulk(vmr, ibulk, bratio, invsrat)


def qcapcheck(vmr, qcap, ibulk):
    """True where summed trace abundances exceed the cap: [...] bool."""
    is_bulk = torch.zeros(vmr.shape[-1], dtype=torch.bool,
                          device=vmr.device)
    is_bulk[list(ibulk)] = True
    qtrace = torch.sum(
        torch.where(is_bulk, torch.zeros_like(vmr), vmr), dim=-1)
    return torch.any(qtrace > qcap, dim=-1)
