"""Ensemble transit RT: the hand-written CUDA kernel, its wrapper and
its plain PyTorch version; also the build and the ctypes loader of the
one kernel library (every csrc/*.cu, the emission kernel included).

The kernel (csrc/transit_rt.cu) replaces the Pallas TPU kernels
pyratbay_tpu/spectrum/ensemble_pallas.py::_ensemble_kernel and, at
B = 1, rt_pallas.py::_transit_kernel.  It is compiled with nvcc for
sm_90a into a plain-C shared library at its first launch, under
pyratbay_tpu_torch/_build/<hash of the sources>/, and bound with
ctypes.  Importing this module needs neither nvcc nor a GPU.

`transit_spectrum_ensemble` prepares the per-chain operands in torch
(the pair-sum fold of the chord matrix and prep_chain's scalars and
radius columns, all small), then takes the plain version for CPU
tensors and the kernel for CUDA tensors; a CUDA tensor never falls
back to the plain version.
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

__all__ = [
    'transit_spectrum_ensemble', 'transit_spectrum_fused', 'prep_chains',
    'transit_rt_plain', 'transit_rt_cuda', 'build_library',
]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, 'csrc')
_BUILD = os.path.join(_PKG, '_build')
_MAX_PARTS = 4
NVCC_FLAGS = [
    '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
    '-Xcompiler', '-fPIC', '-Xptxas', '-v',
]


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
    lib = ctypes.CDLL(build_library())
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    lib.pbt_transit_rt.argtypes = (
        [ptr] * 4 + [cint] + [ptr, ptr, cint] + [ptr, ptr, cint]
        + [ptr] * 6 + [cint, cint, cint, ctypes.c_float, ptr])
    lib.pbt_transit_rt.restype = cint
    lib.pbt_transit_rt_smem_bytes.argtypes = [cint, cint, cint]
    lib.pbt_transit_rt_smem_bytes.restype = cint
    fptr, cfloat = ctypes.POINTER(ctypes.c_float), ctypes.c_float
    lib.pbt_emission_rt.argtypes = (
        [ptr] * 4 + [cint] + [ptr, ptr, cint] + [ptr, ptr, cint]
        + [ptr] * 4 + [fptr, fptr, cint, cfloat, cfloat, ptr]
        + [cint, cint, cint, cfloat, ptr])
    lib.pbt_emission_rt.restype = cint
    lib.pbt_emission_rt_smem_bytes.argtypes = [cint, cint, cint]
    lib.pbt_emission_rt_smem_bytes.restype = cint
    lib.pbt_emission_rt_max_mu.argtypes = []
    lib.pbt_emission_rt_max_mu.restype = cint
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
    inv_rstar2 = torch.full(
        (nb,), 1.0, dtype=dt, device=dev) / torch.as_tensor(
            rstar, dtype=dt, device=dev) ** 2
    scal = torch.stack([
        itop_f, ibottom.to(dt), deck_row, apply_deck, w_surf,
        inv_rstar2, r_itop2, torch.zeros(nb, dtype=dt, device=dev),
    ], dim=1)
    return path2, scal, radius, h_col, hprev_col


def transit_rt_plain(ec_parts, path2, scal, rad, h, hprev,
                     cia_w=None, cia_tab=None, r1_cols=None, r1_rows=None,
                     maxdepth=np.inf):
    """Plain PyTorch version of the kernel on prepared operands.

    ec_parts: list of [B, l, W]; r1_cols [B, n_r1, l] with r1_rows
    [B, n_r1, W]; cia_w [B, l, K] with cia_tab [K, W].  Returns
    [B, W].  Same summation order as the kernel: dense parts, rank-1
    terms, CIA; then the chord product and chain_rt_epilogue.
    """
    nb, nlayers = rad.shape
    ec = None
    for part in ec_parts:
        ec = part if ec is None else ec + part
    if ec is None:
        nwave = (r1_rows if r1_rows is not None else cia_tab).shape[-1]
        ec = torch.zeros((nb, nlayers, nwave), dtype=rad.dtype,
                         device=rad.device)
    if r1_cols is not None:
        for r in range(r1_cols.shape[1]):
            ec = ec + r1_cols[:, r, :, None] * r1_rows[:, r, None, :]
    if cia_w is not None:
        ec = ec + cia_w @ cia_tab
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


def _checked(t, name, shape, dtype=torch.float32):
    if not t.is_cuda or t.dtype != dtype:
        raise TypeError(f'{name}: expected a {str(dtype)[6:]} CUDA tensor')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: shape {tuple(t.shape)} != {shape}')
    return t.contiguous()


def transit_rt_cuda(ec_parts, path2, scal, rad, h, hprev,
                    cia_w=None, cia_tab=None, r1_cols=None, r1_rows=None,
                    maxdepth=np.inf):
    """Launch the CUDA kernel on prepared float32 CUDA operands (same
    signature and result as transit_rt_plain).  Each launch adds one
    to `transit_rt_cuda.launches`."""
    nb, nlayers = rad.shape
    if r1_rows is not None:
        nwave = r1_rows.shape[-1]
    elif ec_parts:
        nwave = ec_parts[0].shape[-1]
    else:
        nwave = cia_tab.shape[-1]
    if len(ec_parts) > _MAX_PARTS:
        raise ValueError(f'At most {_MAX_PARTS} dense extinction parts')
    if nb > 65535:
        raise ValueError('At most 65535 chains per launch')
    parts = [_checked(p, 'ec_part', (nb, nlayers, nwave)) for p in ec_parts]
    path2 = _checked(path2, 'path2', (nb, nlayers, nlayers))
    scal = _checked(scal, 'scal', (nb, 8))
    rad = _checked(rad, 'radius', (nb, nlayers))
    h = _checked(h, 'h', (nb, nlayers))
    hprev = _checked(hprev, 'hprev', (nb, nlayers))
    n_r1 = n_cia = 0
    if r1_cols is not None:
        n_r1 = r1_cols.shape[1]
        r1_cols = _checked(r1_cols, 'r1_cols', (nb, n_r1, nlayers))
        r1_rows = _checked(r1_rows, 'r1_rows', (nb, n_r1, nwave))
    if cia_w is not None:
        n_cia = cia_w.shape[2]
        cia_w = _checked(cia_w, 'cia_w', (nb, nlayers, n_cia))
        cia_tab = _checked(cia_tab, 'cia_tab', (n_cia, nwave))
    lib = _library()
    if lib.pbt_transit_rt_smem_bytes(nlayers, n_r1, n_cia) > 232448:
        raise ValueError('Operands exceed the shared memory of one block')
    out = torch.empty((nb, nwave), dtype=torch.float32, device=rad.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    part_ptrs = [p.data_ptr() for p in parts] + [None] * (
        _MAX_PARTS - len(parts))
    err = lib.pbt_transit_rt(
        *part_ptrs, len(parts),
        ptr(r1_cols), ptr(r1_rows), n_r1,
        ptr(cia_w), ptr(cia_tab), n_cia,
        path2.data_ptr(), scal.data_ptr(), rad.data_ptr(),
        h.data_ptr(), hprev.data_ptr(), out.data_ptr(),
        nb, nlayers, nwave, float(maxdepth),
        torch.cuda.current_stream(rad.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f'transit_rt kernel launch failed: CUDA error {err}')
    transit_rt_cuda.launches += 1
    return out


transit_rt_cuda.launches = 0


def transit_spectrum_ensemble(
        ec_parts, path, radius, rstar, itop, ibottom,
        deck_itop=None, deck_rsurf=None, cia_w=None, cia_tab=None,
        r1_cols=None, r1_rows=None, maxdepth=np.inf):
    """Batched transit (Rp/Rs)^2 spectra [B, W].

    ec_parts: list of [B, l, W] extinction contributions (summed in the
    kernel); path [B, l, l-1] chord matrices; radius [B, l] normalized
    like rstar; itop, ibottom [B] integers (ibottom = deck_itop + 1
    with a deck); deck_itop [B] / deck_rsurf [B] or None; cia_w
    [B, l, K] with cia_tab [K, W]; r1_cols [B, n_r1, l] with r1_rows
    [B, n_r1, W].  CPU tensors take the plain version, CUDA tensors
    the kernel.
    """
    operands = prep_chains(
        path, radius, rstar, itop, ibottom, deck_itop, deck_rsurf)
    rt = transit_rt_cuda if radius.is_cuda else transit_rt_plain
    return rt(list(ec_parts), *operands, cia_w=cia_w, cia_tab=cia_tab,
              r1_cols=r1_cols, r1_rows=r1_rows, maxdepth=maxdepth)


def transit_spectrum_fused(ec, path, radius, rstar, itop, ibottom,
                           deck_itop=None, deck_rsurf=None,
                           maxdepth=np.inf):
    """One chain's spectrum [W] (the per-chain K2 interface): ec [l, W]
    or a list of them, path [l, l-1], radius [l]; the ensemble kernel
    at B = 1."""
    parts = list(ec) if isinstance(ec, (list, tuple)) else [ec]
    dev = radius.device
    one = lambda v: None if v is None else torch.as_tensor(
        v, device=dev).reshape(1)
    return transit_spectrum_ensemble(
        [p[None] for p in parts], path[None], radius[None], rstar,
        one(itop), one(ibottom), one(deck_itop),
        None if deck_rsurf is None else torch.as_tensor(
            deck_rsurf, dtype=radius.dtype, device=dev).reshape(1),
        maxdepth=maxdepth,
    )[0]
