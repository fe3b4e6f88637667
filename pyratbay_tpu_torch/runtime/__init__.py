"""Native host runtime (C++): multithreaded HITRAN parsing, TLI range
extraction and the parity line-by-line engine's grouping and scatter,
loaded through ctypes.

A copy of pyratbay_tpu/runtime with its own build: `pbt_runtime.cpp`
beside this file is compiled with g++ at the first call, with the JAX
package's Makefile flags, into
pyratbay_tpu_torch/_build/<hash of source, flags and target>/.  Unlike
the JAX package, a failed build raises with the compiler's log instead
of handing the caller back to numpy.

Each native entry point counts its calls in `.calls`.  The `_plain`
functions are the JAX package's numpy fallbacks, kept as the plain
versions the tests hold the native ones against.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

__all__ = [
    'build_library', 'parse_hitran_records', 'tli_extract_range',
    'lbl_group', 'lbl_scatter', 'parse_hitran_records_plain',
    'tli_extract_range_plain', 'lbl_group_plain', 'lbl_scatter_plain',
]

_HERE = os.path.dirname(os.path.realpath(__file__))
_SOURCE = os.path.join(_HERE, 'pbt_runtime.cpp')
_BUILD = os.path.join(os.path.dirname(_HERE), '_build')
# pyratbay_tpu/runtime/Makefile's flags, so that the two libraries agree
# bit for bit on one host.  Under them g++ contracts lbl_scatter's
# `row[j] += k * prof[...]` into one FMA (one rounding where numpy's
# `ktmp += k * window` rounds twice): native and plain scatter differ by
# about an ulp of each add.
CXX_FLAGS = ('-O3', '-march=native', '-fPIC', '-shared', '-std=c++17',
             '-pthread')
NTHREADS = min(os.cpu_count() or 1, 8)

# The last byte the parser reads of a .par record (g', bytes 146-153):
_PAR_FIELDS_END = 153
_HITRAN_ISO_MAP = {
    '1': 0, '2': 1, '3': 2, '4': 3, '5': 4, '6': 5,
    '7': 6, '8': 7, '9': 8, '0': 9, 'A': 10, 'B': 11,
}


def _cxx():
    path = shutil.which(os.environ.get('CXX') or 'g++')
    if path is None:
        raise RuntimeError('g++ not found: the native runtime cannot be '
                           'built')
    return path


def _target(cxx):
    """What -march=native resolves to on this host (the library is built
    for it, so it is part of the build's hash)."""
    proc = subprocess.run([cxx, '-march=native', '-Q', '--help=target'],
                          capture_output=True, text=True)
    return proc.stdout + proc.stderr


def build_library():
    """Compile pbt_runtime.cpp (once per source, flags and target) and
    return the .so path.  The library is written in a temporary directory
    and moved into place, so processes that build at once never load a
    half-written file."""
    cxx = _cxx()
    with open(_SOURCE, 'rb') as f:
        digest = hashlib.sha256(f.read())
    digest.update(' '.join([cxx, *CXX_FLAGS]).encode())
    digest.update(_target(cxx).encode())
    outdir = os.path.join(_BUILD, digest.hexdigest()[:16])
    lib = os.path.join(outdir, 'libpbt_runtime.so')
    if os.path.isfile(lib):
        return lib
    os.makedirs(outdir, exist_ok=True)
    tmpdir = tempfile.mkdtemp(dir=outdir)
    tmp = os.path.join(tmpdir, 'libpbt_runtime.so')
    cmd = [cxx, *CXX_FLAGS, _SOURCE, '-o', tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        shutil.rmtree(tmpdir, ignore_errors=True)
        raise RuntimeError(f'g++ failed ({proc.returncode}): '
                           f'{" ".join(cmd)}\n{proc.stdout}{proc.stderr}')
    os.replace(tmp, lib)
    shutil.rmtree(tmpdir, ignore_errors=True)
    return lib


@functools.lru_cache(maxsize=1)
def _library():
    lib = ctypes.CDLL(build_library())
    ptr, i32, i64, f64 = (ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
                          ctypes.c_double)
    lib.parse_hitran_par.argtypes = ([ctypes.c_char_p, i64, i32] + [ptr] * 5
                                   + [i32])
    lib.parse_hitran_par.restype = ctypes.c_int
    lib.tli_extract_range.argtypes = [ptr] * 5 + [i32, f64, f64] + [ptr] * 4
    lib.tli_extract_range.restype = i64
    lib.lbl_group.argtypes = [ptr] * 3 + [i64, f64, ptr]
    lib.lbl_group.restype = i64
    lib.lbl_scatter.argtypes = [i64] + [ptr] * 6 + [i64] + [ptr] * 3 + [i64]
    lib.lbl_scatter.restype = None
    return lib


def _ptr(arr):
    return arr.ctypes.data_as(ctypes.c_void_p)


def parse_hitran_records(raw, recsize, nthreads=None):
    """Parse HITRAN .par bytes (nrec records of `recsize` bytes) in
    `nthreads` threads: (wn, a21, g2, elow, iso) arrays.  Blank fields
    read as 0 and an isotope character outside 0-9, A-Z as -1."""
    if recsize < _PAR_FIELDS_END:
        raise ValueError(f'HITRAN records of {recsize} bytes: the .par '
                         f'fields end at byte {_PAR_FIELDS_END}')
    lib = _library()
    parse_hitran_records.calls += 1
    nrec = len(raw) // recsize
    wn, a21, g2, elow = (np.empty(nrec) for _ in range(4))
    iso = np.empty(nrec, np.int32)
    status = lib.parse_hitran_par(
        raw, nrec, recsize, _ptr(wn), _ptr(a21), _ptr(g2), _ptr(elow),
        _ptr(iso), nthreads or NTHREADS)
    if status != 0:
        raise RuntimeError(f'parse_hitran_par returned {status}')
    return wn, a21, g2, elow, iso


def parse_hitran_records_plain(raw, recsize):
    """The numpy parse of parse_hitran_records (blank fields and
    isotope characters other than 0-9, A, B raise)."""
    nlines = len(raw) // recsize
    rec = np.frombuffer(raw, dtype=f'S{recsize}', count=nlines)
    view = rec.view('S1').reshape(nlines, recsize)

    def col(lo, hi, dtype=float):
        text = view[:, lo:hi].view(f'S{hi-lo}').ravel()
        return np.char.strip(text.astype(str)).astype(dtype)

    wn = col(3, 15)
    iso_char = view[:, 2].astype(str)
    a21 = col(25, 35)
    elow = col(45, 55)
    g2 = col(146, 153)
    iso = np.array([_HITRAN_ISO_MAP[ch] for ch in iso_char])
    return wn, a21, g2, elow, iso


def tli_extract_range(wn, iso, elow, gf, seg_counts, wn_low, wn_high):
    """The [wn_low, wn_high] transitions of TLI arrays sorted by isotope
    segment (`seg_counts` transitions each) then wavenumber, by a binary
    search a segment: (wn, iso, elow, gf)."""
    wn = np.ascontiguousarray(wn, np.float64)
    iso = np.ascontiguousarray(iso, np.int16)
    elow = np.ascontiguousarray(elow, np.float64)
    gf = np.ascontiguousarray(gf, np.float64)
    seg_counts = np.ascontiguousarray(seg_counts, np.int32)
    n = len(wn)
    if not (len(iso) == len(elow) == len(gf) == n
            and np.all(seg_counts >= 0) and seg_counts.sum() <= n):
        raise ValueError('TLI arrays of unequal length, or segments '
                         'beyond them')
    lib = _library()
    tli_extract_range.calls += 1
    out_wn, out_elow, out_gf = np.empty(n), np.empty(n), np.empty(n)
    out_iso = np.empty(n, np.int16)
    kept = lib.tli_extract_range(
        _ptr(wn), _ptr(iso), _ptr(elow), _ptr(gf), _ptr(seg_counts),
        len(seg_counts), float(wn_low), float(wn_high),
        _ptr(out_wn), _ptr(out_iso), _ptr(out_elow), _ptr(out_gf))
    return out_wn[:kept], out_iso[:kept], out_elow[:kept], out_gf[:kept]


def tli_extract_range_plain(wn, iso, elow, gf, seg_counts, wn_low,
                            wn_high):
    """The numpy mask of tli_extract_range."""
    keep = np.zeros(len(wn), bool)
    start = 0
    for count in seg_counts:
        seg = slice(start, start + count)
        keep[seg] = (wn[seg] >= wn_low) & (wn[seg] <= wn_high)
        start += count
    return wn[keep], iso[keep], elow[keep], gf[keep]


def lbl_group(awavn, aiso, anchor_cand, ownstep):
    """The parity engine's greedy co-adding groups of the (isotope, then
    wavenumber sorted) active lines: a group ends where the isotope
    changes or a line falls `ownstep` or more from the group's anchor
    (`anchor_cand` of its first line).  Returns (group_id int32 [n],
    ngroups)."""
    awavn = np.ascontiguousarray(awavn, np.float64)
    aiso = np.ascontiguousarray(aiso, np.int32)
    anchor_cand = np.ascontiguousarray(anchor_cand, np.float64)
    if not len(awavn) == len(aiso) == len(anchor_cand):
        raise ValueError('lbl_group arrays of unequal length')
    lib = _library()
    lbl_group.calls += 1
    group_id = np.empty(len(awavn), np.int32)
    ngroups = lib.lbl_group(_ptr(awavn), _ptr(aiso), _ptr(anchor_cand),
                            len(awavn), float(ownstep), _ptr(group_id))
    return group_id, int(ngroups)


def lbl_group_plain(awavn, aiso, anchor_cand, ownstep):
    """lbl_group as a Python loop over scalars."""
    wavn, iso, cand = awavn.tolist(), aiso.tolist(), anchor_cand.tolist()
    group_id = [0] * len(wavn)
    if not wavn:
        return np.asarray(group_id, int), 0
    gid = 0
    anchor_wn, anchor_iso = cand[0], iso[0]
    for j in range(1, len(wavn)):
        if not (iso[j] == anchor_iso and abs(wavn[j] - anchor_wn) < ownstep):
            gid += 1
            anchor_wn, anchor_iso = cand[j], iso[j]
        group_id[j] = gid
    return np.asarray(group_id, int), gid + 1


def lbl_scatter(strong, g_spec, minj, maxj, pindex, offset, ofactor,
                k_group, profile, ktmp):
    """Add each strong group's strided profile window, k_group[g] *
    profile[pindex - offset + ofactor * j] for j in [minj, maxj), to its
    species' row of ktmp [nspec, dnwn], in group order (in place)."""
    strong = np.ascontiguousarray(strong, np.uint8)
    g_spec = np.ascontiguousarray(g_spec, np.int32)
    minj, maxj, pindex, offset = (np.ascontiguousarray(a, np.int64)
                                  for a in (minj, maxj, pindex, offset))
    k_group = np.ascontiguousarray(k_group, np.float64)
    profile = np.ascontiguousarray(profile, np.float64)
    if not (ktmp.flags.c_contiguous and ktmp.dtype == np.float64):
        raise ValueError('ktmp must be a C-contiguous float64 array')
    # The windows the library reads and writes, inside the arrays:
    sel = strong.astype(bool) & (maxj > minj)
    start = pindex[sel] - offset[sel] + ofactor * minj[sel]
    last = start + ofactor * (maxj[sel] - minj[sel] - 1)
    if not (len(g_spec) == len(minj) == len(maxj) == len(pindex)
            == len(offset) == len(strong) == len(k_group)
            and np.all(minj[sel] >= 0) and np.all(maxj[sel] <= ktmp.shape[1])
            and np.all((g_spec[sel] >= 0) & (g_spec[sel] < ktmp.shape[0]))
            and np.all(start >= 0) and np.all(last < len(profile))):
        raise ValueError('lbl_scatter windows outside ktmp or profile')
    lib = _library()
    lbl_scatter.calls += 1
    lib.lbl_scatter(
        len(k_group), _ptr(strong), _ptr(g_spec), _ptr(minj), _ptr(maxj),
        _ptr(pindex), _ptr(offset), int(ofactor), _ptr(k_group),
        _ptr(profile), _ptr(ktmp), ktmp.shape[1])


def lbl_scatter_plain(strong, g_spec, minj, maxj, pindex, offset, ofactor,
                      k_group, profile, ktmp):
    """lbl_scatter as a Python loop over the strong groups (numpy adds
    of each window: the product and the add round apart)."""
    rows = list(ktmp)
    sel = np.nonzero(strong & (maxj > minj))[0]
    start = pindex[sel] + ofactor * minj[sel] - offset[sel]
    for spec, j0, j1, kg, st in zip(
            g_spec[sel].tolist(), minj[sel].tolist(), maxj[sel].tolist(),
            k_group[sel].tolist(), start.tolist()):
        rows[spec][j0:j1] += kg * profile[st:st + (j1 - j0) * ofactor:ofactor]


for _fn in (parse_hitran_records, tli_extract_range, lbl_group,
            lbl_scatter):
    _fn.calls = 0
