"""Transit RT: the hand-written CUDA kernels, their wrappers and their
plain PyTorch versions; also the build and the ctypes loader of the one
kernel library (every csrc/*.cu, the emission kernel included).

The ensemble kernel K1 (csrc/transit_rt.cu) replaces the Pallas TPU
kernel pyratbay_tpu/spectrum/ensemble_pallas.py::_ensemble_kernel; the
one-chain kernel K2 (csrc/transit_one.cu, `transit_one_cuda`) replaces
rt_pallas.py::_transit_kernel with all of transit_spectrum_fused around
it (the fold of the chord matrix and the per-chain scalars), one launch
a spectrum.  They are compiled with nvcc for sm_90a into a plain-C
shared library at the first launch, under
pyratbay_tpu_torch/_build/<hash of the sources>/, and bound with
ctypes.  Importing this module needs neither nvcc nor a GPU.

Like the Pallas kernel it takes the line-sampled opacity either as a
dense [B, l, W] part or as the operands ls_w [B, K2, l] and ls_tab
[K2, l, W], contracted inside the kernel; `ls_in_kernel` is the static
size rule, per RT path, by which the forwards pick between the two, and
`fit_operands` the one that keeps the other operands within what the
kernels take (C5 of ROADMAP.md).

Both functions of K1 run the chord product on the tensor cores, three
TF32 products a step summed in float32.  Up to 64 layers the kernel
holds a table slab in shared memory and every depth of its columns in
registers (`chord_layout` packs its chord matrix).  Above 64 layers the
kernel launched is a second function of the same file
(transit_rt_tall_kernel: the depths of a pass of TALL_ROWS rows; the
chord rows and the live line-sample table rows streamed through a ring
in shared memory; `tall_layout` packs its chord matrix).

`transit_spectrum_ensemble` hands one chain's raw operands to K2 (on
the CPU its plain version, `transit_one_plain`); more chains it prepares
in torch (the pair-sum fold of the chord matrix and prep_chain's scalars
and radius columns, all small) for K1 or its plain version.  CPU tensors
take the plain versions and CUDA tensors the kernels; a CUDA tensor
never falls back to a plain version.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

from .. import constants as pc
from .. import tracing

__all__ = [
    'transit_spectrum_ensemble', 'transit_spectrum_fused', 'prep_chains',
    'transit_rt_plain', 'transit_rt_cuda', 'transit_one_plain',
    'transit_one_cuda', 'one_max_layers', 'one_staged_max_layers',
    'build_library', 'ls_in_kernel',
    'fit_operands', 'extinction_plain', 'assembly_operands', 'chord_layout',
    'tall_layout', 'tall_max_layers', 'chains_per_sm', 'MAX_PARTS',
    'MAX_R1', 'MAX_CIA', 'MAX_LAYERS',
]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, 'csrc')
_BUILD = os.path.join(_PKG, '_build')
# What both RT kernels take (csrc/rt_common.cuh): dense parts, rank-1
# terms, CIA table rows; and the layer count of the transit kernel's
# chord product with the depths in registers (above it, the tall function).
MAX_PARTS = 4
MAX_R1 = 4
MAX_CIA = 32
MAX_LAYERS = 64
# Rows of a pass of the tall function (above MAX_LAYERS), whose depths it
# keeps in registers: six m-tiles of the tensor cores' 16 rows.
TALL_ROWS = 96
# The kernels hold the line-sample table of one 64-column wave tile in
# shared memory; a slab up to this size leaves room for the warps'
# own operands beside it (232,448 bytes a block in all).
LS_TILE = 64
LS_SLAB_MAX = 147456
# Above MAX_LAYERS the transit kernel reads the live rows of the table
# from device memory; a team stages the chain's weights [rows, K2], which
# up to this size leave room for the other operands beside them.
TALL_LS_WEIGHTS_MAX = 32768
# Warps of a block of the one-chain kernel K2 (csrc/transit_one.cu
# ONE_WARPS).
ONE_WARPS = 16
NVCC_FLAGS = [
    '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
    '-Xcompiler', '-fPIC', '-Xptxas', '-v',
]


def ls_in_kernel(n_k, nlayers, rt_path):
    """Whether a line-sample table of n_k (species x temperature) rows
    by nlayers goes into the RT kernel of `rt_path` as ls_w / ls_tab or
    stays a dense part made by an einsum.  On an NVIDIA H100 the
    in-kernel route measured faster (PERF.md), so it is taken whenever
    the kernel takes the table:

    * transit up to MAX_LAYERS layers, and emission up to MAX_LAYERS
      layers: the table's wave-tile slab fits the shared memory beside
      the warps' operands;
    * transit above MAX_LAYERS layers (the tall function, which streams
      the live table rows): a chain's weights fit TALL_LS_WEIGHTS_MAX;
    * emission above MAX_LAYERS layers: never.
    """
    if rt_path in pc.TRANSMISSION_RT and nlayers > MAX_LAYERS:
        return _round4(n_k) * _round4(nlayers) * 4 <= TALL_LS_WEIGHTS_MAX
    return (nlayers <= MAX_LAYERS
            and n_k * nlayers * LS_TILE * 4 <= LS_SLAB_MAX)


def _round4(n):
    return -(-n // 4) * 4


def _round8(n):
    return -(-n // 8) * 8


def fit_operands(ec_parts, cia_w=None, cia_tab=None, r1_cols=None,
                 r1_rows=None, ls_w=None, ls_tab=None):
    """The extinction operands as the RT kernels take them, by a static
    rule on their shapes (which a model fixes when its forward is built;
    no launch is tried):

    * rank-1 terms beyond MAX_R1 are summed into the last dense part
      (the elementwise one of the forwards), or become a dense part;
    * CIA table rows beyond MAX_CIA become a dense [B, l, W] part
      through one product, as the JAX package's XLA route makes its CIA
      parts;
    * dense parts beyond MAX_PARTS are summed in torch into the last.

    The line sample is decided apart, by `ls_in_kernel`.  Returns the
    keyword operands of transit_spectrum_ensemble and
    emission_flux_ensemble (ec_parts, cia_w, cia_tab, r1_cols, r1_rows,
    ls_w, ls_tab), whose sum equals that of the input.
    """
    parts = list(ec_parts)
    if r1_cols is not None and r1_cols.shape[1] > MAX_R1:
        extra = torch.einsum('brl,brw->blw', r1_cols[:, MAX_R1:],
                             r1_rows[:, MAX_R1:])
        if parts:
            parts[-1] = parts[-1] + extra
        else:
            parts.append(extra)
        r1_cols, r1_rows = r1_cols[:, :MAX_R1], r1_rows[:, :MAX_R1]
    if cia_w is not None and cia_w.shape[2] > MAX_CIA:
        parts.append(cia_w[:, :, MAX_CIA:] @ cia_tab[MAX_CIA:])
        cia_w, cia_tab = cia_w[:, :, :MAX_CIA], cia_tab[:MAX_CIA]
    if len(parts) > MAX_PARTS:
        rest = parts[MAX_PARTS - 1]
        for part in parts[MAX_PARTS:]:
            rest = rest + part
        parts = parts[:MAX_PARTS - 1] + [rest]
    return dict(ec_parts=parts, cia_w=cia_w, cia_tab=cia_tab,
                r1_cols=r1_cols, r1_rows=r1_rows, ls_w=ls_w, ls_tab=ls_tab)


def _nvcc():
    for path in (
            shutil.which('nvcc'),
            os.path.join(os.environ.get('CUDA_HOME', ''), 'bin', 'nvcc'),
            '/usr/local/cuda/bin/nvcc'):
        if path and os.path.isfile(path):
            return path
    raise RuntimeError('nvcc not found: the CUDA kernels cannot be built')


def build_library():
    """Compile csrc/*.cu (once per source hash) and return the .so path.

    One nvcc per source, all started together, then one link into a
    single library.  The compilers' resource reports (-Xptxas -v) are
    kept beside the library as build.log.
    """
    sources = sorted(
        os.path.join(_CSRC, name) for name in os.listdir(_CSRC)
        if name.endswith(('.cu', '.cuh')))
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in sources:
        with open(path, 'rb') as f:
            digest.update(f.read())
    outdir = os.path.join(_BUILD, digest.hexdigest()[:16])
    lib = os.path.join(outdir, 'libpbt_kernels.so')
    if os.path.isfile(lib):
        return lib
    nvcc = _nvcc()
    os.makedirs(outdir, exist_ok=True)
    tmpdir = tempfile.mkdtemp(dir=outdir)
    compiles = []
    for src in sources:
        if not src.endswith('.cu'):
            continue
        obj = os.path.join(tmpdir, os.path.basename(src)[:-3] + '.o')
        cmd = [nvcc, *NVCC_FLAGS, '-c', '-o', obj, src]
        compiles.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    tmp = os.path.join(tmpdir, 'libpbt_kernels.so')
    link = [nvcc, *NVCC_FLAGS, '-shared', '-o', tmp,
            *[obj for _, obj, _ in compiles]]
    log, failed = [], []
    for cmd, _, proc in compiles:
        out, err = proc.communicate()
        log.append(' '.join(cmd) + '\n' + out + err)
        if proc.returncode != 0:
            failed.append(f'{cmd[-1]} ({proc.returncode}):\n{err}')
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        log.append(' '.join(link) + '\n' + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f'link ({proc.returncode}):\n{proc.stderr}')
    with open(os.path.join(outdir, 'build.log'), 'w') as f:
        f.write('\n'.join(log))
    if failed:
        shutil.rmtree(tmpdir, ignore_errors=True)
        raise RuntimeError('nvcc failed: ' + '\n'.join(failed))
    os.replace(tmp, lib)
    shutil.rmtree(tmpdir, ignore_errors=True)
    return lib


@functools.lru_cache(maxsize=1)
def _library():
    with tracing.span('pbt.setup.kernel_library', always=True):
        lib = ctypes.CDLL(build_library())
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    fptr, cfloat = ctypes.POINTER(ctypes.c_float), ctypes.c_float
    assembly = [ptr] * 4 + [cint] + [ptr, cint] + [ptr, ptr, cint] * 2
    lib.pbt_transit_rt.argtypes = (
        assembly + [ptr] * 4 + [cint] * 6 + [cfloat, ptr])
    lib.pbt_transit_rt.restype = cint
    lib.pbt_emission_rt.argtypes = (
        assembly + [ptr] * 3 + [fptr, fptr, cint, cfloat, cfloat, ptr]
        + [cint] * 5 + [cfloat, ptr])
    lib.pbt_emission_rt.restype = cint
    lib.pbt_transit_rt_tall.argtypes = lib.pbt_transit_rt.argtypes
    lib.pbt_transit_rt_tall.restype = cint
    for fn in (lib.pbt_transit_rt_warps, lib.pbt_emission_rt_warps,
               lib.pbt_transit_rt_tall_warps,
               lib.pbt_transit_rt_chains_per_sm):
        fn.argtypes = [cint] * 5
        fn.restype = cint
    lib.pbt_emission_rt_max_mu.argtypes = []
    lib.pbt_emission_rt_max_mu.restype = cint
    lib.pbt_transit_one.argtypes = (
        [ptr] * 4 + [cint] + [ptr, ptr, cint]
        + [ptr, ctypes.c_longlong, cint, ptr, cint] + [ptr, ptr, cint]
        + [ptr, ptr, ctypes.POINTER(ptr), ctypes.POINTER(cint),
           ctypes.POINTER(cint), ctypes.POINTER(ctypes.c_double), cint, ptr,
           ptr]
        + [cint] * 3 + [cfloat, ptr])
    lib.pbt_transit_one.restype = cint
    lib.pbt_transit_one_mode.argtypes = [cint] * 5
    lib.pbt_transit_one_mode.restype = cint
    lib.pbt_transit_one_scratch.argtypes = [cint] * 3
    lib.pbt_transit_one_scratch.restype = ctypes.c_longlong
    return lib


def prep_chains(path, radius, rstar, itop, ibottom,
                deck_itop=None, deck_rsurf=None):
    """Per-chain kernel operands (rt_pallas.py prep_chain, batched).

    path [B, l, l-1]; radius [B, l] (same normalization as rstar);
    itop, ibottom, deck_itop [B] integers; deck_rsurf [B] or None.
    Returns path2 [B, l, l] (the pair-sum fold), scal [B, 8] =
    (itop, ibottom, deck_row, apply_deck, w_surf, 1/rstar^2,
    r_itop^2, 0), and the radius, h_j and h_{j-1} columns [B, l].
    """
    nb, nlayers = radius.shape
    dt, dev = radius.dtype, radius.device
    path2 = F.pad(path, (1, 0)) + F.pad(path, (0, 1))
    h = radius[:, 1:] - radius[:, :-1]               # negative
    itop = torch.as_tensor(itop, device=dev).expand(nb)
    ibottom = torch.as_tensor(ibottom, device=dev).expand(nb)
    itop_f = itop.to(dt)
    if deck_rsurf is not None:
        j = deck_itop - 1
        r_j = torch.gather(radius, 1, j.clamp(0, nlayers - 1)[:, None])[:, 0]
        r_j1 = torch.gather(
            radius, 1, (j + 1).clamp(0, nlayers - 1)[:, None])[:, 0]
        w_surf = (r_j - deck_rsurf) / (r_j - r_j1)
        apply_deck = (deck_itop.to(dt) > itop_f).to(dt)
        h_j = torch.gather(h, 1, j.clamp(0, nlayers - 2)[:, None])[:, 0]
        h = torch.where(
            torch.arange(nlayers - 1, device=dev)[None, :] == j[:, None],
            torch.where(apply_deck > 0.5, deck_rsurf - r_j, h_j)[:, None],
            h,
        )
        deck_row = deck_itop.to(dt)
    else:
        w_surf = torch.zeros(nb, dtype=dt, device=dev)
        apply_deck = torch.zeros(nb, dtype=dt, device=dev)
        deck_row = torch.full((nb,), -1.0, dtype=dt, device=dev)
    h_col = F.pad(h, (0, 1))
    hprev_col = F.pad(h, (1, 0))
    r_itop2 = torch.gather(
        radius, 1, itop.clamp(0, nlayers - 1)[:, None])[:, 0] ** 2
    # rstar filled on the device (no copy from the host):
    inv_rstar2 = torch.full((nb,), 1.0, dtype=dt, device=dev) / torch.full(
        (nb,), float(rstar), dtype=dt, device=dev) ** 2
    scal = torch.stack([
        itop_f, ibottom.to(dt), deck_row, apply_deck, w_surf,
        inv_rstar2, r_itop2, torch.zeros(nb, dtype=dt, device=dev),
    ], dim=1)
    return path2, scal, radius, h_col, hprev_col


def extinction_plain(ec_parts, cia_w, cia_tab, r1_cols, r1_rows, ls_w,
                     ls_tab, like):
    """The summed extinction [B, l, W] in the kernels' order: dense
    parts, rank-1 terms, CIA, line sample.  `like` [B, l] gives the
    batch, the layers, the dtype and the device."""
    ec = None
    for part in ec_parts:
        ec = part if ec is None else ec + part
    if ec is None:
        nwave = _nwave(ec_parts, r1_rows, cia_tab, ls_tab)
        ec = torch.zeros((*like.shape, nwave), dtype=like.dtype,
                         device=like.device)
    if r1_cols is not None:
        for r in range(r1_cols.shape[1]):
            ec = ec + r1_cols[:, r, :, None] * r1_rows[:, r, None, :]
    if cia_w is not None:
        ec = ec + cia_w @ cia_tab
    if ls_w is not None:
        ec = ec + torch.einsum('bkl,klw->blw', ls_w, ls_tab)
    return ec


def _nwave(ec_parts, r1_rows, cia_tab, ls_tab):
    for operand in (*ec_parts, r1_rows, cia_tab, ls_tab):
        if operand is not None:
            return operand.shape[-1]
    raise ValueError('No extinction operand: the spectrum has no width')


def transit_rt_plain(ec_parts, path2, scal, rad, h, hprev,
                     cia_w=None, cia_tab=None, r1_cols=None, r1_rows=None,
                     ls_w=None, ls_tab=None, maxdepth=np.inf):
    """Plain PyTorch version of the kernel on prepared operands.

    ec_parts: list of [B, l, W]; r1_cols [B, n_r1, l] with r1_rows
    [B, n_r1, W]; cia_w [B, l, K] with cia_tab [K, W]; ls_w [B, K2, l]
    with ls_tab [K2, l, W].  Returns [B, W].  Same summation order as
    the kernel (extinction_plain); then the chord product and
    chain_rt_epilogue.
    """
    nb, nlayers = rad.shape
    ec = extinction_plain(
        ec_parts, cia_w, cia_tab, r1_cols, r1_rows, ls_w, ls_tab, rad)
    depth = path2 @ ec

    (itop, ibottom, deck_row, apply_deck, w_surf, inv_rstar2,
     r_itop2) = (scal[:, i, None, None] for i in range(7))
    rows = torch.arange(nlayers, dtype=rad.dtype,
                        device=rad.device)[None, :, None]
    in_range = (rows >= itop) & (rows < ibottom)
    exceeded = in_range & (depth > maxdepth)
    first = torch.min(
        torch.where(exceeded, rows, torch.full_like(rows, nlayers)),
        dim=1, keepdim=True).values
    ideep = torch.where(first < nlayers, first, ibottom - 1.0)

    integ = torch.exp(-depth) * rad[:, :, None]
    zero = torch.zeros_like(integ)
    integ_j = torch.sum(torch.where(rows == deck_row - 1.0, integ, zero),
                        dim=1, keepdim=True)
    integ_j1 = torch.sum(torch.where(rows == deck_row, integ, zero),
                         dim=1, keepdim=True)
    integ_surf = integ_j * (1.0 - w_surf) + integ_j1 * w_surf
    integ = torch.where((rows == deck_row) & (apply_deck > 0.5),
                        integ_surf, integ)

    m = in_range & (rows < ideep)
    mp = (rows >= itop + 1.0) & (rows <= ideep)
    coef = 0.5 * (h[:, :, None] * m + hprev[:, :, None] * mp)
    integral = torch.sum(integ * coef, dim=1)
    return (r_itop2[:, :, 0] + 2.0 * integral) * inv_rstar2[:, :, 0]


def _checked(t, name, shape, dtype=torch.float32, strided=False):
    """t as a kernel reads it: of `dtype` on the card and of `shape`;
    contiguous, or with `strided` (the kernel takes the strides of the
    leading dimensions) contiguous in its last."""
    if not t.is_cuda or t.dtype != dtype:
        raise TypeError(f'{name}: expected a {str(dtype)[6:]} CUDA tensor')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: shape {tuple(t.shape)} != {shape}')
    return t if strided and t.stride(-1) == 1 else t.contiguous()


def _pad_to(t, *sizes):
    """Zero-pad the trailing dimensions of t up to `sizes` (a new,
    contiguous tensor even when nothing is added)."""
    pad = []
    for have, want in zip(reversed(t.shape[-len(sizes):]), reversed(sizes)):
        pad += [0, want - have]
    out = F.pad(t, pad).contiguous()
    # The kernels copy 16 bytes at a time: a view into the middle of
    # another tensor's storage may not be aligned.
    return out if out.data_ptr() % 16 == 0 else out.clone()


def assembly_operands(ec_parts, cia_w, cia_tab, r1_cols, r1_rows, ls_w,
                      ls_tab, nb, nlayers, rows):
    """The extinction operands both kernels share, checked (float32 CUDA
    tensors of matching shapes) and laid out as the kernels stage them:
    the per-chain weights zero-padded to `rows` layers and to a multiple
    of 4 (line sample, transposed to [B, rows, K2P]) or to KP = 16 or 32
    (CIA, [B, rows, KP]) weights a layer, so that a warp copies a
    chain's block 16 bytes at a time.  Returns (tensors kept alive,
    leading C arguments, rank-1 columns [B, n_r1, l] or None, nwave,
    (n_r1, n_cia, n_ls, n_parts))."""
    nwave = _nwave(ec_parts, r1_rows, cia_tab, ls_tab)
    if len(ec_parts) > MAX_PARTS:
        raise ValueError(f'At most {MAX_PARTS} dense extinction parts')
    parts = [_checked(p, 'ec_part', (nb, nlayers, nwave)) for p in ec_parts]
    n_r1 = n_cia = n_ls = 0
    if r1_cols is not None:
        n_r1 = r1_cols.shape[1]
        if n_r1 > MAX_R1:
            raise ValueError(f'At most {MAX_R1} rank-1 extinction terms')
        r1_cols = _checked(r1_cols, 'r1_cols', (nb, n_r1, nlayers))
        r1_rows = _checked(r1_rows, 'r1_rows', (nb, n_r1, nwave))
    if cia_w is not None:
        n_cia = cia_w.shape[2]
        if n_cia > MAX_CIA:
            raise ValueError(f'At most {MAX_CIA} CIA table rows')
        cia_w = _pad_to(_checked(cia_w, 'cia_w', (nb, nlayers, n_cia)),
                        rows, 16 if n_cia <= 16 else 32)
        cia_tab = _checked(cia_tab, 'cia_tab', (n_cia, nwave))
    if ls_w is not None:
        n_ls = ls_w.shape[1]
        ls_w = _pad_to(
            _checked(ls_w, 'ls_w', (nb, n_ls, nlayers)).transpose(1, 2),
            rows, -(-n_ls // 4) * 4)
        ls_tab = _checked(ls_tab, 'ls_tab', (n_ls, nlayers, nwave))
    ptr = lambda t: None if t is None else t.data_ptr()
    part_ptrs = [p.data_ptr() for p in parts] + [None] * (
        MAX_PARTS - len(parts))
    args = [*part_ptrs, len(parts), ptr(r1_rows), n_r1,
            ptr(cia_w), ptr(cia_tab), n_cia, ptr(ls_w), ptr(ls_tab), n_ls]
    keep = (parts, r1_rows, cia_w, cia_tab, ls_w, ls_tab)
    return keep, args, r1_cols, nwave, (n_r1, n_cia, n_ls, len(parts))


def chord_layout(nlayers):
    """How the transit kernel holds a chain's chord matrix: (nt, index)
    with nt = ceil(l / 8), the tiles of 8 rows and the steps of 8 layers
    of its tensor-core chord product, and `index` the gather that packs
    path2 [l * l] (plus one trailing zero) for it.  Each step s holds,
    for each n-tile n >= s (the matrix is zero above its diagonal), the
    64 floats of its mma.sync m16n8k8 B fragment: lane 4 g + t's pair
    (path2[8 n + g, 8 s + t], path2[8 n + g, 8 s + t + 4]) at 2 (4 g +
    t), zero past the last row or layer."""
    if not 2 <= nlayers <= MAX_LAYERS:
        raise ValueError(
            f'The tensor-core chord product of the transit kernel takes 2 '
            f'to {MAX_LAYERS} layers, not {nlayers}')
    nt = -(-nlayers // 8)
    g, t = np.arange(32)[:, None] // 4, np.arange(32)[:, None] % 4
    pieces = []
    for s in range(nt):
        for n in range(s, nt):
            i, j = 8 * n + g, 8 * s + np.hstack([t, t + 4])
            pieces.append(np.where((i < nlayers) & (j < nlayers),
                                   i * nlayers + j, nlayers * nlayers).ravel())
    return nt, np.concatenate(pieces)


@functools.lru_cache(maxsize=8)
def _chord_index(nlayers, device):
    nt, index = chord_layout(nlayers)
    return nt, torch.as_tensor(index, device=device)


def transit_rt_cuda(ec_parts, path2, scal, rad, h, hprev,
                    cia_w=None, cia_tab=None, r1_cols=None, r1_rows=None,
                    ls_w=None, ls_tab=None, maxdepth=np.inf):
    """Launch the CUDA kernel on prepared float32 CUDA operands (same
    signature and result as transit_rt_plain).  Each launch adds one
    to `transit_rt_cuda.launches`; one of the tensor-core chord product
    at up to MAX_LAYERS layers also to `transit_rt_cuda.mma_launches`,
    one of the tall function (more layers) to
    `transit_rt_cuda.tall_launches`.  (The wrappers hand one chain to
    K2, transit_one_cuda.)"""
    nb, nlayers = rad.shape
    if nlayers > MAX_LAYERS:
        return _transit_rt_tall(ec_parts, path2, scal, rad, h, hprev, cia_w,
                                cia_tab, r1_cols, r1_rows, ls_w, ls_tab,
                                maxdepth)
    nt, index = _chord_index(nlayers, rad.device)
    rows = 8 * nt
    keep, assembly, r1_cols, nwave, sizes = assembly_operands(
        ec_parts, cia_w, cia_tab, r1_cols, r1_rows, ls_w, ls_tab, nb,
        nlayers, rows)
    # The chord matrix packed as the fragments of its product, and the
    # layer columns (radius, h, h_prev, rank-1 columns) as one
    # [B, 3 + n_r1, rows] block:
    path2 = _checked(path2, 'path2', (nb, nlayers, nlayers))
    packed = F.pad(path2.reshape(nb, -1), (0, 1))[:, index]
    scal = _checked(scal, 'scal', (nb, 8))
    cols = [_checked(t, name, (nb, nlayers))[:, None] for t, name in (
        (rad, 'radius'), (h, 'h'), (hprev, 'hprev'))]
    if r1_cols is not None:
        cols.append(r1_cols)
    cols = _pad_to(torch.cat(cols, dim=1), rows)
    lib = _library()
    if lib.pbt_transit_rt_warps(nlayers, *sizes) < 1:
        raise ValueError(
            f'No transit kernel for a line-sample slab of {sizes[2]} x '
            f'{nlayers} x {LS_TILE} floats beside the other operands: it '
            'exceeds the shared memory of one block')
    out = torch.empty((nb, nwave), dtype=torch.float32, device=rad.device)
    err = lib.pbt_transit_rt(
        *assembly, packed.data_ptr(), cols.data_ptr(), scal.data_ptr(),
        out.data_ptr(), nb, nlayers, nwave, nt, packed.shape[1],
        cols.shape[1], float(maxdepth),
        torch.cuda.current_stream(rad.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f'transit_rt kernel launch failed: CUDA error {err}')
    transit_rt_cuda.launches += 1
    transit_rt_cuda.mma_launches += 1
    return out


def tall_layout(nlayers):
    """How the tall function holds a chain's chord matrix: the gather
    that packs path2 [l * l] (plus one trailing zero) for it.  The rows
    go in passes of TALL_ROWS, whose depths the kernel keeps in
    registers; pass p holds, for each layer j below min(round8(l),
    TALL_ROWS (p + 1)), the TALL_ROWS values path2[TALL_ROWS p + r, j]
    (zero past the last row or layer; the matrix is zero above its
    diagonal, so a pass needs no layer below its last row)."""
    if nlayers < 2:
        raise ValueError(f'The tall function takes 2 layers or more, not '
                         f'{nlayers}')
    pieces = []
    for r0 in range(0, nlayers, TALL_ROWS):
        j = np.arange(min(_round8(nlayers), r0 + TALL_ROWS))[:, None]
        i = r0 + np.arange(TALL_ROWS)[None, :]
        pieces.append(np.where((i < nlayers) & (j < nlayers),
                               i * nlayers + j, nlayers * nlayers).ravel())
    return np.concatenate(pieces)


@functools.lru_cache(maxsize=8)
def _tall_index(nlayers, device):
    return torch.as_tensor(tall_layout(nlayers), device=device)


def tall_max_layers(n_r1, n_cia, n_ls, n_parts):
    """The most layers the tall function takes with these operand
    counts: one chain's weights, layer columns and ring must fit a
    block's shared memory."""
    lib = _library()
    top = MAX_LAYERS
    while lib.pbt_transit_rt_tall_warps(
            top + 1, n_r1, n_cia, n_ls, n_parts) > 0:
        top += 1
    return top


def chains_per_sm(nlayers, n_r1, n_cia, n_ls, n_parts):
    """Chains the transit kernel keeps in flight on one SM with these
    operand counts, in the function it takes at this layer count (the
    tall one above MAX_LAYERS): blocks an SM by the CUDA runtime's
    occupancy rule, times the teams of two warps a block."""
    return _library().pbt_transit_rt_chains_per_sm(
        nlayers, n_r1, n_cia, n_ls, n_parts)


def _transit_rt_tall(ec_parts, path2, scal, rad, h, hprev, cia_w, cia_tab,
                     r1_cols, r1_rows, ls_w, ls_tab, maxdepth):
    """transit_rt_cuda above MAX_LAYERS layers: the tall function, the
    chord matrix packed by passes of rows (tall_layout), the line-sample
    table's rows padded to a multiple of four floats."""
    nb, nlayers = rad.shape
    rows = _round8(nlayers)
    keep, assembly, r1_cols, nwave, sizes = assembly_operands(
        ec_parts, cia_w, cia_tab, r1_cols, r1_rows, ls_w, ls_tab, nb,
        nlayers, rows)
    lib = _library()
    if lib.pbt_transit_rt_tall_warps(nlayers, *sizes) < 1:
        n_r1, n_cia, n_ls, n_parts = sizes
        raise ValueError(
            f'The transit kernel takes at most '
            f'{tall_max_layers(*sizes)} layers with {n_r1} rank-1 terms, '
            f'{n_cia} CIA rows, {n_ls} line-sample rows and {n_parts} '
            f'dense parts, not {nlayers}: one chain\'s weights, layer '
            'columns and ring must fit the shared memory of one block')
    # The kernel copies the table's rows 16 bytes at a time, padded to a
    # multiple of four floats:
    ls_stride = _round4(nwave)
    if ls_tab is not None:
        ls_tab = _pad_to(keep[5], ls_stride)
        assembly[11] = ls_tab.data_ptr()
    path2 = _checked(path2, 'path2', (nb, nlayers, nlayers))
    packed = F.pad(path2.reshape(nb, -1), (0, 1))[
        :, _tall_index(nlayers, rad.device)]
    scal = _checked(scal, 'scal', (nb, 8))
    cols = [_checked(t, name, (nb, nlayers))[:, None] for t, name in (
        (rad, 'radius'), (h, 'h'), (hprev, 'hprev'))]
    if r1_cols is not None:
        cols.append(r1_cols)
    cols = _pad_to(torch.cat(cols, dim=1), rows)
    out = torch.empty((nb, nwave), dtype=torch.float32, device=rad.device)
    err = lib.pbt_transit_rt_tall(
        *assembly, packed.data_ptr(), cols.data_ptr(), scal.data_ptr(),
        out.data_ptr(), nb, nlayers, nwave, ls_stride, packed.shape[1],
        cols.shape[1], float(maxdepth),
        torch.cuda.current_stream(rad.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f'transit_rt tall kernel launch failed: CUDA error {err}')
    transit_rt_cuda.launches += 1
    transit_rt_cuda.tall_launches += 1
    return out


transit_rt_cuda.launches = 0
# Launches of the tensor-core chord product at up to MAX_LAYERS layers:
transit_rt_cuda.mma_launches = 0
# Launches of the tall function (more than MAX_LAYERS layers):
transit_rt_cuda.tall_launches = 0


def transit_one_plain(ec_parts, path, radius, rstar, itop, ibottom,
                      deck_itop=None, deck_rsurf=None, cia_w=None,
                      cia_tab=None, r1_cols=None, r1_rows=None, ls_w=None,
                      ls_tab=None, maxdepth=np.inf):
    """K2's plain version: prep_chains and transit_rt_plain on the raw
    operands of transit_spectrum_ensemble (same signature and result as
    transit_one_cuda).  The per-chain scalars may also be host numbers."""
    nb = radius.shape[0]
    dev = radius.device
    chains = lambda v, **kw: None if v is None else torch.as_tensor(
        v, device=dev, **kw).reshape(-1).expand(nb)
    operands = prep_chains(
        path, radius, rstar, chains(itop), chains(ibottom),
        chains(deck_itop), chains(deck_rsurf, dtype=radius.dtype))
    return transit_rt_plain(
        list(ec_parts), *operands, cia_w=cia_w, cia_tab=cia_tab,
        r1_cols=r1_cols, r1_rows=r1_rows, ls_w=ls_w, ls_tab=ls_tab,
        maxdepth=maxdepth)


def _one_scalar(value, nb, device, index, keep):
    """One per-chain scalar of K2 as (pointer, element bytes, stride,
    host value): a CUDA tensor of one element or one a chain by pointer
    (nothing is read back to the host), anything else as a number."""
    if value is None:
        return None, 0, 0, 0.0
    if torch.is_tensor(value) and value.is_cuda:
        kinds = (torch.int32, torch.int64) if index \
            else (torch.float32, torch.float64)
        if value.dtype not in kinds or value.device != device:
            raise TypeError(
                f'a per-chain scalar on the card must be one of {kinds} on '
                f'{device}, not {value.dtype} on {value.device}')
        if value.numel() not in (1, nb):
            raise ValueError(f'a per-chain scalar has {value.numel()} '
                             f'elements for {nb} chains')
        value = value.contiguous()
        keep.append(value)
        return (value.data_ptr(), value.element_size(),
                int(value.numel() > 1), 0.0)
    if torch.is_tensor(value) and value.numel() != 1:
        raise ValueError('a per-chain scalar on the host takes one value')
    return None, 0, 0, float(value)


def one_max_layers(n_r1, n_cia, n_ls, n_parts):
    """The most layers K2 takes with these operand counts: streamed, a
    block's radius, heights and live line-sample rows of each layer must
    fit its shared memory."""
    lib = _library()
    top = 1
    while lib.pbt_transit_one_mode(top + 1, n_r1, n_cia, n_ls, n_parts) >= 0:
        top += 1
    return top


def one_staged_max_layers(n_r1, n_cia, n_ls, n_parts):
    """The most layers whose block K2 holds wholly in shared memory (its
    folded chord matrix, extinction, depths and staged operands) with
    these operand counts; above them it streams ec and the depths
    through device memory."""
    lib = _library()
    top = 1
    while lib.pbt_transit_one_mode(top + 1, n_r1, n_cia, n_ls, n_parts) == 0:
        top += 1
    return top


def transit_one_cuda(ec_parts, path, radius, rstar, itop, ibottom,
                     deck_itop=None, deck_rsurf=None, cia_w=None,
                     cia_tab=None, r1_cols=None, r1_rows=None, ls_w=None,
                     ls_tab=None, maxdepth=np.inf):
    """K2 (csrc/transit_one.cu) on the raw float32 CUDA operands of
    transit_spectrum_ensemble: one launch, nothing prepared in torch.
    The wrappers hand it one chain; more chains (B blocks of columns
    each) it takes too.  itop, ibottom, deck_itop (int32 / int64) and
    deck_rsurf, rstar (float32 / float64) go in by pointer as CUDA
    tensors of one element or one a chain, or as host numbers.  Above
    one_staged_max_layers it streams through a scratch it allocates.
    Raises before any launch on operand counts beyond fit_operands'
    limits or above one_max_layers.  Each launch adds one to
    `transit_one_cuda.launches`, a streamed one also to
    `transit_one_cuda.streamed_launches`."""
    nb, nlayers = radius.shape
    nwave = _nwave(ec_parts, r1_rows, cia_tab, ls_tab)
    if len(ec_parts) > MAX_PARTS:
        raise ValueError(f'At most {MAX_PARTS} dense extinction parts')
    parts = [_checked(p, 'ec_part', (nb, nlayers, nwave)) for p in ec_parts]
    radius = _checked(radius, 'radius', (nb, nlayers))
    path = _checked(path, 'path', (nb, nlayers, nlayers - 1))
    n_r1 = n_cia = n_ls = 0
    if r1_cols is not None:
        n_r1 = r1_cols.shape[1]
        if n_r1 > MAX_R1:
            raise ValueError(f'At most {MAX_R1} rank-1 extinction terms')
        r1_cols = _checked(r1_cols, 'r1_cols', (nb, n_r1, nlayers))
        r1_rows = _checked(r1_rows, 'r1_rows', (nb, n_r1, nwave))
    if cia_w is not None:
        n_cia = cia_w.shape[2]
        if n_cia > MAX_CIA:
            raise ValueError(f'At most {MAX_CIA} CIA table rows')
        # A view of the first weights of longer rows (fit_operands')
        # goes in as it is:
        cia_w = _checked(cia_w, 'cia_w', (nb, nlayers, n_cia), strided=True)
        cia_tab = _checked(cia_tab, 'cia_tab', (n_cia, nwave))
    if ls_w is not None:
        n_ls = ls_w.shape[1]
        ls_w = _checked(ls_w, 'ls_w', (nb, n_ls, nlayers))
        ls_tab = _checked(ls_tab, 'ls_tab', (n_ls, nlayers, nwave))
    keep = []
    scalars = [_one_scalar(v, nb, radius.device, index, keep)
               for v, index in ((itop, True), (ibottom, True),
                                (deck_itop, True), (deck_rsurf, False),
                                (rstar, False))]
    lib = _library()
    sizes = (n_r1, n_cia, n_ls, len(parts))
    mode = lib.pbt_transit_one_mode(nlayers, *sizes)
    if mode < 0:
        raise ValueError(
            f'The one-chain transit kernel takes at most '
            f'{one_max_layers(*sizes)} layers with {n_r1} rank-1 terms, '
            f'{n_cia} CIA rows, {n_ls} line-sample rows and {len(parts)} '
            f'dense parts, not {nlayers}: a block\'s radius, heights and '
            'live line-sample rows must fit its shared memory')
    scratch = None if mode == 0 else torch.empty(
        lib.pbt_transit_one_scratch(nb, nlayers, nwave),
        dtype=torch.float32, device=radius.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    part_ptrs = [p.data_ptr() for p in parts] + [None] * (
        MAX_PARTS - len(parts))
    column = lambda ctype, i: (ctype * 5)(*[s[i] for s in scalars])
    out = torch.empty((nb, nwave), dtype=torch.float32, device=radius.device)
    cia_strides = (0, 0) if cia_w is None else cia_w.stride()[:2]
    err = lib.pbt_transit_one(
        *part_ptrs, len(parts), ptr(r1_rows), ptr(r1_cols), n_r1,
        ptr(cia_w), *cia_strides, ptr(cia_tab), n_cia, ptr(ls_w),
        ptr(ls_tab), n_ls,
        path.data_ptr(), radius.data_ptr(), column(ctypes.c_void_p, 0),
        column(ctypes.c_int, 1), column(ctypes.c_int, 2),
        column(ctypes.c_double, 3), int(deck_rsurf is not None),
        ptr(scratch), out.data_ptr(), nb, nlayers, nwave, float(maxdepth),
        torch.cuda.current_stream(radius.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f'transit_one kernel launch failed: CUDA error {err}')
    transit_one_cuda.launches += 1
    transit_one_cuda.streamed_launches += mode
    return out


transit_one_cuda.launches = 0
# Launches of the streamed layout (more than one_staged_max_layers):
transit_one_cuda.streamed_launches = 0


def transit_spectrum_ensemble(
        ec_parts, path, radius, rstar, itop, ibottom,
        deck_itop=None, deck_rsurf=None, cia_w=None, cia_tab=None,
        r1_cols=None, r1_rows=None, ls_w=None, ls_tab=None,
        maxdepth=np.inf):
    """Batched transit (Rp/Rs)^2 spectra [B, W].

    ec_parts: list of [B, l, W] extinction contributions (summed in the
    kernel); path [B, l, l-1] chord matrices; radius [B, l] normalized
    like rstar; itop, ibottom [B] integers (ibottom = deck_itop + 1
    with a deck); deck_itop [B] / deck_rsurf [B] or None; cia_w
    [B, l, K] with cia_tab [K, W]; r1_cols [B, n_r1, l] with r1_rows
    [B, n_r1, W]; ls_w [B, K2, l] with ls_tab [K2, l, W] (the
    line-sample weights and table, contracted in the kernel).  One
    chain goes to K2 as it is (transit_one_cuda, one launch), more to
    K1 after prep_chains; CPU tensors take the plain versions.
    """
    kw = dict(cia_w=cia_w, cia_tab=cia_tab, r1_cols=r1_cols,
              r1_rows=r1_rows, ls_w=ls_w, ls_tab=ls_tab, maxdepth=maxdepth)
    if radius.shape[0] == 1:
        one = transit_one_cuda if radius.is_cuda else transit_one_plain
        return one(list(ec_parts), path, radius, rstar, itop, ibottom,
                   deck_itop, deck_rsurf, **kw)
    operands = prep_chains(
        path, radius, rstar, itop, ibottom, deck_itop, deck_rsurf)
    rt = transit_rt_cuda if radius.is_cuda else transit_rt_plain
    return rt(list(ec_parts), *operands, **kw)


def transit_spectrum_fused(ec, path, radius, rstar, itop, ibottom,
                           deck_itop=None, deck_rsurf=None,
                           maxdepth=np.inf):
    """One chain's spectrum [W] (pyratbay_tpu's transit_spectrum_fused):
    ec [l, W] or a list of them, path [l, l-1], radius [l]; itop,
    ibottom, deck_itop and deck_rsurf host numbers or tensors of one
    element.  K2 on CUDA tensors (one launch), its plain version on the
    CPU."""
    parts = list(ec) if isinstance(ec, (list, tuple)) else [ec]
    one = transit_one_cuda if radius.is_cuda else transit_one_plain
    return one([p[None] for p in parts], path[None], radius[None], rstar,
               itop, ibottom, deck_itop, deck_rsurf, maxdepth=maxdepth)[0]
