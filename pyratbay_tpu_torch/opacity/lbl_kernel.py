"""Direct line-by-line passes: the hand-written CUDA kernels, their
wrappers and their plain PyTorch versions.

The kernels (csrc/lbl_voigt.cu) replace the Pallas TPU kernels of
pyratbay_tpu/opacity/lbl_pallas.py:

    wing_sigma_grouped   K4   fine wing sub-tiles, each with its own window
    core_sigma           K5   full Faddeeva Re w(x, y) inside the margin
    wing_sigma           K6   K4's pair computation over 128-point tiles
                              (wing_windows_kernel: K4's per-line design
                              on the window layout)

K4 and K5 come in two operand layouts.  The main path (DirectLBL.
_cross_section_batch) calls `wing_sigma_lines` and `core_sigma_lines`:
the per-cell factors once per line, [ncell, nlines_pad] over the sorted
line array, and the start of each tile's window, a contiguous range
[start, start + lmax) of that array.  `wing_sigma_grouped`, `core_sigma`
and `wing_sigma` keep the JAX wrappers' operands, factors in the window
layout [ncell, ntiles, lmax] (which holds a line once per window it
falls in), for the parity tests and for K6.  Both layouts compute the
same pairs under the same masks.

What bounds the kernels on an H100 is the instructions they issue (~23 a
wing pair and cell, ~120 a core pair and cell), not memory; the note at
the head of csrc/lbl_voigt.cu says what each design does about it, and
PERF.md (section 6) has the measured times beside the bounds.

The kernels live in the library that spectrum/transit_kernel.py builds
from every csrc/*.cu at the first launch on a CUDA tensor; importing
this module needs neither nvcc nor a GPU.  Each public function takes
the plain version for CPU tensors and the kernel for CUDA tensors, and a
CUDA tensor never falls back to the plain version.

Output layouts are the JAX wrappers' ([ncell, ntiles, tile], or
[ncell, nspec, ntiles, tile] for several species), with one change: a
species index per window entry or line (`spec`, int32, with `nspec`)
replaces the Pallas kernels' float one-hot.  The TPU's line-chunk
padding, edge-replicated tile rows and column shipping have no
counterpart here.
"""
import ctypes
import functools

import numpy as np
import torch

from ..ops.special import _weideman_coeffs, wofz_real
from ..spectrum.transit_kernel import _checked, _library

__all__ = [
    'wing_sigma_lines', 'core_sigma_lines',
    'wing_sigma_lines_plain', 'core_sigma_lines_plain',
    'wing_sigma_lines_cuda', 'core_sigma_lines_cuda',
    'wing_sigma_grouped', 'core_sigma', 'wing_sigma',
    'wing_sigma_grouped_plain', 'core_sigma_plain', 'wing_sigma_plain',
    'wing_sigma_grouped_cuda', 'core_sigma_cuda', 'wing_sigma_cuda',
    'wing_series', 'LINE_ALIGN',
]

MAX_SPEC = 8                 # species per launch (csrc/lbl_voigt.cu)
LINE_ALIGN = 4               # per-line arrays: entries per 16-byte copy
_CORE_TERMS = 16             # Weideman terms of wofz_real in float32
_PAIR_BUDGET = 1 << 24       # pair elements per chunk of the plain versions


def wing_series(u, a):
    """S(u, a) of the 5-term asymptotic Re[w]: Re w = y u S / sqrt(pi),
    u = 1/(x^2+y^2), a = x^2 u (pyratbay_tpu lbl_tpu._wing_series: the
    kernels and the plain versions use this polynomial)."""
    return (
        1.0
        + u * (2.0 * a - 0.5)
        + u**2 * ((12.0 * a - 9.0) * a + 0.75)
        + u**3 * (((120.0 * a - 150.0) * a + 45.0) * a - 1.875)
        + u**4 * ((((1680.0 * a - 2940.0) * a + 1575.0) * a - 262.5)
                  * a + 6.5625)
    )


def _tile_chunks(ncell, ntiles, tile, lmax):
    """Tile slices whose [ncell, chunk, tile, lmax] pair block stays
    within the plain versions' memory budget."""
    step = max(1, _PAIR_BUDGET // max(1, ncell * tile * lmax))
    return [slice(t0, min(t0 + step, ntiles))
            for t0 in range(0, ntiles, step)]


def _species_sum(contrib, spec, nspec):
    """[ncell, tc, tile, lmax] contributions -> [ncell, tc, tile] or,
    with a species index [tc, lmax], [ncell, nspec, tc, tile]."""
    if spec is None:
        return torch.sum(contrib, dim=-1)
    onehot = (spec[:, None, :] == torch.arange(
        nspec, device=spec.device)[None, :, None]).to(contrib.dtype)
    return torch.einsum('ctpl,tsl->cstp', contrib, onehot)


def _empty_out(like, ncell, ntiles, tile, spec, nspec):
    shape = (ncell, ntiles, tile) if spec is None \
        else (ncell, nspec, ntiles, tile)
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def wing_sigma_plain(wn_hi, wn_lo, lwn_hi, lwn_lo, c1, y2, inv_ad,
                     spec=None, *, margin, cutoff, nspec=1):
    """Plain PyTorch wing pass, summed over each tile's line window.

    wn_hi, wn_lo [ntiles, tile] output tiles (hi/lo split); lwn_hi,
    lwn_lo [ntiles, lmax] per-tile line windows; c1, y2, inv_ad
    [ncell, ntiles, lmax] per-cell line factors (c1 = y * scale /
    sqrt(pi)); spec [ntiles, lmax] species index or None.  Returns the
    normalized wing cross sections [ncell, ntiles, tile] (or
    [ncell, nspec, ntiles, tile] with spec): the sum over lines of
    c1 u S(u, a), masked to margin < |dnu| <= cutoff, with
    dnu = (wn_hi - lwn_hi) + (wn_lo - lwn_lo).
    """
    ncell, ntiles, lmax = c1.shape
    tile = wn_hi.shape[1]
    out = _empty_out(c1, ncell, ntiles, tile, spec, nspec)
    for sl in _tile_chunks(ncell, ntiles, tile, lmax):
        dwn = ((wn_hi[sl, :, None] - lwn_hi[sl, None, :])
               + (wn_lo[sl, :, None] - lwn_lo[sl, None, :]))
        x2 = (dwn[None] * inv_ad[:, sl, None, :]) ** 2
        u = 1.0 / (x2 + y2[:, sl, None, :])
        a = x2 * u
        s = wing_series(u, a)
        adwn = torch.abs(dwn)
        mask = (adwn > margin) & (adwn <= cutoff)
        contrib = torch.where(
            mask[None], c1[:, sl, None, :] * u * s, torch.zeros_like(u))
        part = _species_sum(contrib, None if spec is None else spec[sl],
                            nspec)
        if spec is None:
            out[:, sl] = part
        else:
            out[:, :, sl] = part
    return out


# K4's pair computation is K6's over another tiling (fine sub-tiles, each
# with its own window): one plain version serves both.
wing_sigma_grouped_plain = wing_sigma_plain


def core_sigma_plain(wn_hi, wn_lo, lwn_hi, lwn_lo, scale, y, inv_ad,
                     spec=None, *, margin, nspec=1):
    """Plain PyTorch core pass: the sum over each fine tile's window of
    Re w(x, y) * scale (ops/special.py wofz_real: 16 Weideman terms in
    float32, 32 in float64), masked to |dnu| <= margin, x = dnu * inv_ad.

    wn_hi, wn_lo [ntiles, tile_core]; lwn_hi, lwn_lo [ntiles, lmax];
    scale, y, inv_ad [ncell, ntiles, lmax]; spec [ntiles, lmax] or None.
    Returns [ncell, ntiles, tile_core] (or [ncell, nspec, ntiles,
    tile_core] with spec).
    """
    ncell, ntiles, lmax = scale.shape
    tile = wn_hi.shape[1]
    out = _empty_out(scale, ncell, ntiles, tile, spec, nspec)
    for sl in _tile_chunks(ncell, ntiles, tile, lmax):
        dwn = ((wn_hi[sl, :, None] - lwn_hi[sl, None, :])
               + (wn_lo[sl, :, None] - lwn_lo[sl, None, :]))
        x = dwn[None] * inv_ad[:, sl, None, :]
        yy = y[:, sl, None, :].expand_as(x)
        voigt = wofz_real(x, yy)
        contrib = torch.where(
            (torch.abs(dwn) <= margin)[None], voigt * scale[:, sl, None, :],
            torch.zeros_like(voigt))
        part = _species_sum(contrib, None if spec is None else spec[sl],
                            nspec)
        if spec is None:
            out[:, sl] = part
        else:
            out[:, :, sl] = part
    return out


def _lines_plain(window_plain, wn_hi, wn_lo, starts, lwn_hi, lwn_lo, f1, f2,
                 f3, spec, lmax, nspec, **kw):
    """A window-layout plain pass on per-line operands: the windows
    [starts[t], starts[t] + lmax) of the line arrays are gathered a
    chunk of tiles at a time."""
    ncell, (ntiles, tile) = f1.shape[0], wn_hi.shape
    out = _empty_out(f1, ncell, ntiles, tile, spec, nspec)
    offsets = torch.arange(lmax, device=starts.device)[None, :]
    for sl in _tile_chunks(ncell, ntiles, tile, lmax):
        idx = starts[sl, None].long() + offsets
        out[..., sl, :] = window_plain(
            wn_hi[sl], wn_lo[sl], lwn_hi[idx], lwn_lo[idx], f1[:, idx],
            f2[:, idx], f3[:, idx], None if spec is None else spec[idx],
            nspec=nspec, **kw)
    return out


def wing_sigma_lines_plain(wn_hi, wn_lo, starts, lwn_hi, lwn_lo, c1, y2,
                           inv_ad, spec=None, *, lmax, margin, cutoff,
                           nspec=1):
    """Plain PyTorch wing pass on per-line operands: what
    wing_sigma_plain computes on the windows [starts[t], starts[t] +
    lmax) of the line arrays.

    wn_hi, wn_lo [ntiles, tile]; starts [ntiles] int32; lwn_hi, lwn_lo
    [nlines_pad] the sorted (and padded) line array; c1, y2, inv_ad
    [ncell, nlines_pad] per-cell factors of each line; spec [nlines_pad]
    species index or None.  Returns [ncell, ntiles, tile] (or [ncell,
    nspec, ntiles, tile] with spec).
    """
    return _lines_plain(wing_sigma_plain, wn_hi, wn_lo, starts, lwn_hi,
                        lwn_lo, c1, y2, inv_ad, spec, lmax, nspec,
                        margin=margin, cutoff=cutoff)


def core_sigma_lines_plain(wn_hi, wn_lo, starts, lwn_hi, lwn_lo, scale, y,
                           inv_ad, spec=None, *, lmax, margin, nspec=1):
    """Plain PyTorch core pass on per-line operands: what
    core_sigma_plain computes on the windows [starts[t], starts[t] +
    lmax) of the line arrays (operands as wing_sigma_lines_plain, with
    scale, y, inv_ad [ncell, nlines_pad])."""
    return _lines_plain(core_sigma_plain, wn_hi, wn_lo, starts, lwn_hi,
                        lwn_lo, scale, y, inv_ad, spec, lmax, nspec,
                        margin=margin)


@functools.lru_cache(maxsize=1)
def _lbl_library():
    lib = _library()
    ptr, cint, cfloat = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.pbt_lbl_wing.argtypes = (
        [ptr] * 9 + [cint] * 6 + [cfloat, cfloat, cint, ptr])
    lib.pbt_lbl_wing.restype = cint
    lib.pbt_lbl_core.argtypes = (
        [ptr] * 9 + [cint] * 5
        + [cfloat, cfloat, ctypes.POINTER(cfloat), cint, ptr])
    lib.pbt_lbl_core.restype = cint
    lib.pbt_lbl_wing_lines.argtypes = (
        [ptr] * 10 + [cint] * 6 + [cfloat, cfloat, ptr])
    lib.pbt_lbl_wing_lines.restype = cint
    lib.pbt_lbl_core_lines.argtypes = (
        [ptr] * 10 + [cint] * 6
        + [cfloat, cfloat, ctypes.POINTER(cfloat), cint, ptr])
    lib.pbt_lbl_core_lines.restype = cint
    lib.pbt_lbl_line_align.argtypes = []
    lib.pbt_lbl_line_align.restype = cint
    if lib.pbt_lbl_line_align() != LINE_ALIGN:
        raise RuntimeError('csrc/lbl_voigt.cu and lbl_kernel.py disagree '
                           'on LINE_ALIGN')
    lib.pbt_lbl_max_spec.argtypes = []
    lib.pbt_lbl_max_spec.restype = cint
    if lib.pbt_lbl_max_spec() != MAX_SPEC:
        raise RuntimeError('csrc/lbl_voigt.cu and lbl_kernel.py disagree '
                           'on MAX_SPEC')
    return lib


def _check_operands(wn_hi, wn_lo, lwn_hi, lwn_lo, f1, f2, f3, spec, nspec):
    ncell, ntiles, lmax = f1.shape
    tile = wn_hi.shape[1]
    if not 1 <= nspec <= MAX_SPEC:
        raise ValueError(f'nspec = {nspec}: the kernels take 1 to {MAX_SPEC}')
    if nspec > 1 and spec is None:
        raise ValueError('nspec > 1 needs the species index (spec)')
    if not 1 <= ncell <= 65535:
        raise ValueError('1 to 65535 cells per launch')
    tiles = [_checked(t, 'wn', (ntiles, tile)) for t in (wn_hi, wn_lo)]
    windows = [_checked(t, 'lwn', (ntiles, lmax)) for t in (lwn_hi, lwn_lo)]
    factors = [_checked(t, 'factor', (ncell, ntiles, lmax))
               for t in (f1, f2, f3)]
    if spec is not None:
        spec = _checked(spec, 'spec', (ntiles, lmax), torch.int32)
    return tiles + windows + factors + [spec], (ncell, ntiles, tile, lmax)


def _check_line_operands(wn_hi, wn_lo, starts, lwn_hi, lwn_lo, f1, f2, f3,
                         spec, lmax, nspec):
    """Operands of the per-line kernels, checked against the limits of
    their instantiations; returns (operands, sizes)."""
    ncell, nlines = f1.shape
    ntiles, tile = wn_hi.shape
    if not 1 <= nspec <= MAX_SPEC:
        raise ValueError(f'nspec = {nspec}: the kernels take 1 to {MAX_SPEC}')
    if nspec > 1 and spec is None:
        raise ValueError('nspec > 1 needs the species index (spec)')
    if not 1 <= ncell <= 65535:
        raise ValueError('1 to 65535 cells per launch')
    if nlines % LINE_ALIGN:
        raise ValueError(f'the line arrays hold {nlines} entries: the '
                         f'kernels take a multiple of {LINE_ALIGN}')
    if not 1 <= lmax <= nlines:
        raise ValueError(f'lmax = {lmax}: a window holds 1 to {nlines} '
                         'lines')
    operands = [_checked(t, 'wn', (ntiles, tile)) for t in (wn_hi, wn_lo)]
    operands.append(_checked(starts, 'starts', (ntiles,), torch.int32))
    operands += [_checked(t, 'lwn', (nlines,)) for t in (lwn_hi, lwn_lo)]
    operands += [_checked(t, 'factor', (ncell, nlines)) for t in (f1, f2, f3)]
    operands.append(None if spec is None else _checked(
        spec, 'spec', (nlines,), torch.int32))
    for t in operands[3:]:
        if t is not None and t.data_ptr() % (4 * LINE_ALIGN):
            raise ValueError('the line arrays must be aligned to 16 bytes')
    return operands, (ncell, ntiles, tile, nlines)


def wing_sigma_lines_cuda(wn_hi, wn_lo, starts, lwn_hi, lwn_lo, c1, y2,
                          inv_ad, spec=None, *, lmax, margin, cutoff,
                          nspec=1):
    """K4 on float32 CUDA operands, per-line factors read by line range
    (same signature and result as wing_sigma_lines_plain): a warp per 16
    points and 16 cells, two points and four cells a thread.  Each
    launch adds one to `wing_sigma_lines_cuda.launches`."""
    operands, (ncell, ntiles, tile, nlines) = _check_line_operands(
        wn_hi, wn_lo, starts, lwn_hi, lwn_lo, c1, y2, inv_ad, spec, lmax,
        nspec)
    lib = _lbl_library()
    out = _empty_out(c1, ncell, ntiles, tile, spec, nspec)
    err = lib.pbt_lbl_wing_lines(
        *[None if t is None else t.data_ptr() for t in operands],
        out.data_ptr(), ncell, ntiles, tile, int(lmax), nlines, nspec,
        float(margin), float(cutoff),
        torch.cuda.current_stream(c1.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f'lbl wing (lines) kernel launch failed: CUDA error {err}')
    wing_sigma_lines_cuda.launches += 1
    return out


def core_sigma_lines_cuda(wn_hi, wn_lo, starts, lwn_hi, lwn_lo, scale, y,
                          inv_ad, spec=None, *, lmax, margin, nspec=1):
    """K5 on float32 CUDA operands, per-line factors read by line range
    (same signature and result as core_sigma_lines_plain): a thread per
    point and two cells, over the point's own in-margin lines.  Each
    launch adds one to `core_sigma_lines_cuda.launches`."""
    operands, (ncell, ntiles, tile, nlines) = _check_line_operands(
        wn_hi, wn_lo, starts, lwn_hi, lwn_lo, scale, y, inv_ad, spec, lmax,
        nspec)
    lib = _lbl_library()
    length, coeffs = _weideman_coeffs(_CORE_TERMS)
    coeffs = (ctypes.c_float * _CORE_TERMS)(*np.asarray(coeffs, float))
    out = _empty_out(scale, ncell, ntiles, tile, spec, nspec)
    err = lib.pbt_lbl_core_lines(
        *[None if t is None else t.data_ptr() for t in operands],
        out.data_ptr(), ncell, ntiles, tile, int(lmax), nlines, nspec,
        float(margin), float(length), coeffs, _CORE_TERMS,
        torch.cuda.current_stream(scale.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f'lbl core (lines) kernel launch failed: CUDA error {err}')
    core_sigma_lines_cuda.launches += 1
    return out


def _launch_wing(counter, group, wn_hi, wn_lo, lwn_hi, lwn_lo, c1, y2,
                 inv_ad, spec, margin, cutoff, nspec, split=None):
    operands, (ncell, ntiles, tile, lmax) = _check_operands(
        wn_hi, wn_lo, lwn_hi, lwn_lo, c1, y2, inv_ad, spec, nspec)
    if group * tile > 1024:
        raise ValueError(f'{group} x {tile} points exceed one block')
    lib = _lbl_library()
    out = _empty_out(c1, ncell, ntiles, tile, spec, nspec)
    err = lib.pbt_lbl_wing(
        *[None if t is None else t.data_ptr() for t in operands],
        out.data_ptr(), ncell, ntiles, tile, lmax, group, nspec,
        float(margin), float(cutoff), -1 if split is None else int(split),
        torch.cuda.current_stream(c1.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'lbl wing kernel launch failed: CUDA error {err}')
    counter.launches += 1
    return out


def wing_sigma_grouped_cuda(wn_hi, wn_lo, lwn_hi, lwn_lo, c1, y2, inv_ad,
                            spec=None, *, margin, cutoff, nspec=1):
    """K4 on float32 CUDA operands (same signature and result as
    wing_sigma_grouped_plain): blocks of 128 // tile_pts fine sub-tiles,
    one thread per output point.  Each launch adds one to
    `wing_sigma_grouped_cuda.launches`."""
    group = max(1, 128 // wn_hi.shape[1])
    return _launch_wing(wing_sigma_grouped_cuda, group, wn_hi, wn_lo,
                        lwn_hi, lwn_lo, c1, y2, inv_ad, spec, margin,
                        cutoff, nspec)


def wing_sigma_cuda(wn_hi, wn_lo, lwn_hi, lwn_lo, c1, y2, inv_ad,
                    spec=None, *, margin, cutoff, nspec=1, split=None):
    """K6 on float32 CUDA operands (same signature and result as
    wing_sigma_plain): a warp per 16 points of a tile and 16 cells, two
    points and four cells a thread, over the run of the tile's window
    its points reach.  A launch with few warps for the card splits each
    warp's run over a block's four warps; `split` (True or False)
    forces the choice.  Each launch adds one to
    `wing_sigma_cuda.launches`."""
    return _launch_wing(wing_sigma_cuda, 1, wn_hi, wn_lo, lwn_hi, lwn_lo,
                        c1, y2, inv_ad, spec, margin, cutoff, nspec, split)


def core_sigma_cuda(wn_hi, wn_lo, lwn_hi, lwn_lo, scale, y, inv_ad,
                    spec=None, *, margin, nspec=1):
    """K5 on float32 CUDA operands (same signature and result as
    core_sigma_plain): one thread per output point.  Each launch adds
    one to `core_sigma_cuda.launches`."""
    operands, (ncell, ntiles, tile, lmax) = _check_operands(
        wn_hi, wn_lo, lwn_hi, lwn_lo, scale, y, inv_ad, spec, nspec)
    lib = _lbl_library()
    length, coeffs = _weideman_coeffs(_CORE_TERMS)
    coeffs = (ctypes.c_float * _CORE_TERMS)(*np.asarray(coeffs, float))
    out = _empty_out(scale, ncell, ntiles, tile, spec, nspec)
    err = lib.pbt_lbl_core(
        *[None if t is None else t.data_ptr() for t in operands],
        out.data_ptr(), ncell, ntiles, tile, lmax, nspec, float(margin),
        float(length), coeffs, _CORE_TERMS,
        torch.cuda.current_stream(scale.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'lbl core kernel launch failed: CUDA error {err}')
    core_sigma_cuda.launches += 1
    return out


wing_sigma_lines_cuda.launches = 0
core_sigma_lines_cuda.launches = 0
wing_sigma_grouped_cuda.launches = 0
wing_sigma_cuda.launches = 0
core_sigma_cuda.launches = 0


def wing_sigma_lines(wn_hi, wn_lo, starts, lwn_hi, lwn_lo, c1, y2, inv_ad,
                     spec=None, *, lmax, margin, cutoff, nspec=1):
    """Grouped wing pass (K4) on per-line factors: fine sub-tiles
    [ntiles, tile_pts], each with the window [starts[t], starts[t] +
    lmax) of the line arrays; the kernel for CUDA tensors, the plain
    version otherwise."""
    fn = wing_sigma_lines_cuda if c1.is_cuda else wing_sigma_lines_plain
    return fn(wn_hi, wn_lo, starts, lwn_hi, lwn_lo, c1, y2, inv_ad, spec,
              lmax=lmax, margin=margin, cutoff=cutoff, nspec=nspec)


def core_sigma_lines(wn_hi, wn_lo, starts, lwn_hi, lwn_lo, scale, y, inv_ad,
                     spec=None, *, lmax, margin, nspec=1):
    """Core pass (K5) on per-line factors over fine [ntiles, tile_core]
    tiles; the kernel for CUDA tensors, the plain version otherwise."""
    fn = core_sigma_lines_cuda if scale.is_cuda else core_sigma_lines_plain
    return fn(wn_hi, wn_lo, starts, lwn_hi, lwn_lo, scale, y, inv_ad, spec,
              lmax=lmax, margin=margin, nspec=nspec)


def wing_sigma_grouped(wn_hi, wn_lo, lwn_hi, lwn_lo, c1, y2, inv_ad,
                       spec=None, *, margin, cutoff, nspec=1):
    """Grouped wing pass (K4): fine sub-tiles [ntiles, tile_pts], each
    with its own window; the kernel for CUDA tensors, the plain version
    otherwise."""
    fn = wing_sigma_grouped_cuda if c1.is_cuda else wing_sigma_grouped_plain
    return fn(wn_hi, wn_lo, lwn_hi, lwn_lo, c1, y2, inv_ad, spec,
              margin=margin, cutoff=cutoff, nspec=nspec)


def wing_sigma(wn_hi, wn_lo, lwn_hi, lwn_lo, c1, y2, inv_ad, spec=None, *,
               margin, cutoff, nspec=1):
    """Lane-tiled wing pass (K6) over [ntiles, tile] tiles; the kernel
    for CUDA tensors, the plain version otherwise."""
    fn = wing_sigma_cuda if c1.is_cuda else wing_sigma_plain
    return fn(wn_hi, wn_lo, lwn_hi, lwn_lo, c1, y2, inv_ad, spec,
              margin=margin, cutoff=cutoff, nspec=nspec)


def core_sigma(wn_hi, wn_lo, lwn_hi, lwn_lo, scale, y, inv_ad, spec=None,
               *, margin, nspec=1):
    """Core pass (K5) over fine [ntiles, tile_core] tiles; the kernel for
    CUDA tensors, the plain version otherwise."""
    fn = core_sigma_cuda if scale.is_cuda else core_sigma_plain
    return fn(wn_hi, wn_lo, lwn_hi, lwn_lo, scale, y, inv_ad, spec,
              margin=margin, nspec=nspec)
