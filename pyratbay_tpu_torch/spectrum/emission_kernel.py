"""Ensemble plane-parallel emission RT: the hand-written CUDA kernel, its
wrapper and its plain PyTorch version.

The kernel (csrc/emission_rt.cu) replaces the Pallas TPU kernel
pyratbay_tpu/spectrum/emission_pallas.py::_emission_kernel.  It lives in
the same library as the transit kernel, built and loaded by
transit_kernel.build_library / _library at its first launch; importing
this module needs neither nvcc nor a GPU.

`emission_flux_ensemble` prepares the per-chain operands in torch
(prep_emission_chains: the layer thicknesses, the temperature column
with the deck's surface temperature, and the integration rows), then
takes the plain version for CPU tensors and the kernel for CUDA tensors;
a CUDA tensor never falls back to the plain version.
"""
import ctypes

import numpy as np
import torch

from .. import constants as pc
from ..ops.planck import blackbody_wn
from . import rt
from .transit_kernel import (
    LS_TILE, _checked, _library, _pad_to, assembly_operands,
    extinction_plain,
)

__all__ = [
    'emission_flux_ensemble', 'prep_emission_chains', 'emission_rt_plain',
    'emission_rt_cuda',
]

_PLANCK_C1 = 2.0 * pc.H_KERNEL * pc.LS_KERNEL**2      # 2 h c^2
_PLANCK_C2 = pc.H_KERNEL * pc.LS_KERNEL / pc.KB_KERNEL  # h c / k


def prep_emission_chains(radius, temp, itop, ibottom,
                         deck_itop=None, deck_tsurf=None):
    """Per-chain kernel operands (emission_pallas.py prep_emission_chain,
    batched).

    radius, temp [B, l]; itop, ibottom, deck_itop [B] integers (or
    scalars); deck_tsurf [B] or None.  Returns scal [B, 2] int32 =
    (itop, bottom) with bottom = min(ibottom, l-1), clipped to the deck
    row with a deck; dr [B, l-1] = radius[j] - radius[j+1]; and the
    temperature column [B, l] with row deck_itop at deck_tsurf.
    """
    nb, nlayers = radius.shape
    dev = radius.device
    itop = torch.as_tensor(itop, device=dev).to(torch.int64).expand(nb)
    bottom = torch.clamp(
        torch.as_tensor(ibottom, device=dev).to(torch.int64),
        max=nlayers - 1).expand(nb)
    temp_col = temp
    if deck_itop is not None:
        bottom = torch.minimum(bottom, deck_itop)
        temp_col = torch.where(
            torch.arange(nlayers, device=dev)[None, :] == deck_itop[:, None],
            deck_tsurf[:, None], temp)
    scal = torch.stack([itop, bottom], dim=1).to(torch.int32)
    dr = radius[:, :-1] - radius[:, 1:]
    return scal, dr, temp_col


def emission_rt_plain(ec_parts, scal, dr, temp_col, wn, mu, weights,
                      cia_w=None, cia_tab=None, r1_cols=None, r1_rows=None,
                      ls_w=None, ls_tab=None, maxdepth=np.inf):
    """Plain PyTorch version of the kernel on prepared operands.

    ec_parts: list of [B, l, W]; r1_cols [B, n_r1, l] with r1_rows
    [B, n_r1, W]; cia_w [B, l, K] with cia_tab [K, W]; ls_w [B, K2, l]
    with ls_tab [K2, l, W]; wn [W] tensor; mu, weights [nmu] host
    arrays.  Returns the flux [B, W]: the summed extinction
    (extinction_plain), rt.py's cumulative-trapezoid depth and ideep,
    Planck, the masked intensity integral over [B, nmu, l, W], and the
    weighted sum over angles.
    """
    ec = extinction_plain(
        ec_parts, cia_w, cia_tab, r1_cols, r1_rows, ls_w, ls_tab, temp_col)
    itop, bottom = scal[:, 0], scal[:, 1]
    depth, ideep = rt.cumulative_depth(ec, dr, maxdepth, itop, bottom)
    bbody = blackbody_wn(wn, temp_col[:, :, None])
    intensity = rt.plane_parallel_intensity(depth, bbody, mu, ideep, itop)
    weights = torch.as_tensor(
        np.asarray(weights, float), dtype=ec.dtype, device=ec.device)
    return torch.sum(intensity * weights[:, None], dim=1)


def emission_rt_cuda(ec_parts, scal, dr, temp_col, wn, mu, weights,
                     cia_w=None, cia_tab=None, r1_cols=None, r1_rows=None,
                     ls_w=None, ls_tab=None, maxdepth=np.inf):
    """Launch the CUDA kernel on prepared float32 CUDA operands (same
    signature and result as emission_rt_plain).  Each launch adds one
    to `emission_rt_cuda.launches`."""
    nb, nlayers = temp_col.shape
    rows = -(-nlayers // 4) * 4
    keep, assembly, r1_cols, nwave, sizes = assembly_operands(
        ec_parts, cia_w, cia_tab, r1_cols, r1_rows, ls_w, ls_tab, nb,
        nlayers, rows)
    scal = _checked(scal, 'scal', (nb, 2), torch.int32)
    # The layer columns as one [B, 2 + n_r1, rows] block: the layer
    # thicknesses, the temperatures, the rank-1 columns.
    cols = [_pad_to(_checked(dr, 'dr', (nb, nlayers - 1)), nlayers)[:, None],
            _checked(temp_col, 'temp', (nb, nlayers))[:, None]]
    if r1_cols is not None:
        cols.append(r1_cols)
    cols = _pad_to(torch.cat(cols, dim=1), rows)
    wn = _checked(wn, 'wn', (nwave,))
    mu = np.asarray(mu, float)
    weights = np.asarray(weights, float)
    lib = _library()
    nmu, max_mu = len(mu), lib.pbt_emission_rt_max_mu()
    if not 1 <= nmu <= max_mu or len(weights) != nmu:
        raise ValueError(
            f'{nmu} quadrature angles: the kernel takes 1 to {max_mu}, '
            'with one weight each')
    if lib.pbt_emission_rt_warps(nlayers, *sizes) < 1:
        raise ValueError(
            f'No emission kernel for a line-sample slab of {sizes[2]} x '
            f'{nlayers} x {LS_TILE} floats beside the other operands: it '
            'exceeds the shared memory of one block')
    out = torch.empty((nb, nwave), dtype=torch.float32, device=wn.device)
    floats = lambda a: (ctypes.c_float * len(a))(*a)
    err = lib.pbt_emission_rt(
        *assembly, cols.data_ptr(), scal.data_ptr(), wn.data_ptr(),
        floats(1.0 / mu), floats(weights), nmu, _PLANCK_C1, _PLANCK_C2,
        out.data_ptr(), nb, nlayers, nwave, rows, cols.shape[1],
        float(maxdepth), torch.cuda.current_stream(wn.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f'emission_rt kernel launch failed: CUDA error {err}')
    emission_rt_cuda.launches += 1
    return out


emission_rt_cuda.launches = 0


def emission_flux_ensemble(
        ec_parts, radius, temp, wn, mu, weights, itop, ibottom,
        deck_itop=None, deck_tsurf=None, cia_w=None, cia_tab=None,
        ls_w=None, ls_tab=None, ec_parts_lbw=(),
        r1_cols=None, r1_rows=None, *, maxdepth=np.inf):
    """Batched emergent emission flux [B, W] (quadrature-weighted, the
    units of Model._run_emission's spectrum).

    ec_parts: list of [B, l, W] extinction contributions (summed in the
    kernel); radius (cm), temp (K) [B, l]; wn [W] wavenumbers (cm-1);
    mu, weights: the quadrature angles and weights (host arrays); itop,
    ibottom [B] integers (ibottom = deck_itop + 1 with a deck);
    deck_itop / deck_tsurf [B] or None; cia_w [B, l, K] with cia_tab
    [K, W]; ls_w [B, K2, l] with ls_tab [K2, l, W] (the line-sample
    weights and table, contracted in the kernel); r1_cols [B, n_r1, l]
    with r1_rows [B, n_r1, W].  CPU tensors take the plain version,
    CUDA tensors the kernel.

    The Pallas kernel's layer-major parts (ec_parts_lbw) are a TPU
    layout workaround and are not taken.
    """
    if len(ec_parts_lbw):
        raise NotImplementedError(
            'The layer-major operands are not ported (ROADMAP.md B1): '
            'pass dense [B, l, W] parts')
    wn = torch.as_tensor(wn, dtype=radius.dtype, device=radius.device)
    operands = prep_emission_chains(
        radius, temp, itop, ibottom, deck_itop, deck_tsurf)
    flux = emission_rt_cuda if radius.is_cuda else emission_rt_plain
    return flux(list(ec_parts), *operands, wn, mu, weights, cia_w=cia_w,
                cia_tab=cia_tab, r1_cols=r1_cols, r1_rows=r1_rows,
                ls_w=ls_w, ls_tab=ls_tab, maxdepth=maxdepth)
