"""The port's native host runtime (pyratbay_tpu_torch/runtime) against
the JAX package's native runtime and against its own numpy (plain)
versions.

* The build: g++ into _build/<hash>/ once (six processes that build at
  once all load one library), and a failed build raises with the
  compiler's log.
* parse_hitran_records at 1 and 8 threads, tli_extract_range, lbl_group
  and lbl_scatter equal the JAX package's native functions exactly;
  parse, range and group equal their plain versions exactly, the scatter
  is within 1e-12 relative of the plain loop (g++ contracts its
  multiply-add into one FMA, numpy rounds the product and the sum
  apart).  Each call adds one to the function's `calls`.
* The parity line-by-line engine's _sample_layer through the native
  group and scatter agrees with the plain loops (1e-12) and equals the
  JAX package's native path.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest

pytest.importorskip('torch')

from pyratbay_tpu import runtime as jruntime  # noqa: E402
from pyratbay_tpu.model import Model as JModel  # noqa: E402
from pyratbay_tpu_torch import benchmark, runtime  # noqa: E402
from pyratbay_tpu_torch.driver import run  # noqa: E402
from pyratbay_tpu_torch.model import Model  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCATTER_RTOL = 1e-12


def jax_native_runtime():
    """The JAX package's native runtime, loaded.  Its loader builds the
    library in place with make and takes a failed load (another process
    writing the file at that moment) as 'no library' for the rest of the
    process; retry, so that its numpy fallback never stands in for it."""
    for _ in range(5):
        if jruntime.load_runtime() is not None:
            return jruntime
        jruntime._load_failed = False
        time.sleep(2.0)
    raise AssertionError("the JAX package's native runtime did not load")


@pytest.fixture(scope='module')
def par(tmp_path_factory):
    """A synthetic HITRAN .par file's bytes and record size."""
    jax_native_runtime()
    path = str(tmp_path_factory.mktemp('par') / 'h2o.par')
    benchmark._synthetic_hitran(path, 900, seed=4)
    with open(path, 'rb') as f:
        raw = f.read()
    return raw, raw.index(b'\n') + 1


def test_build_is_cached_under_build_dir():
    lib = runtime.build_library()
    assert os.path.dirname(os.path.dirname(lib)) == os.path.join(
        REPO, 'pyratbay_tpu_torch', '_build')
    assert os.path.basename(lib) == 'libpbt_runtime.so'
    assert runtime.build_library() == lib


_BUILD_IN = """
import sys
from pyratbay_tpu_torch import runtime
runtime._BUILD = sys.argv[1]
print(runtime.build_library())
print(runtime.lbl_group([1.0, 1.1, 5.0], [0, 0, 0], [1.0, 1.0, 5.0], 1.0))
"""


def test_six_processes_build_at_once(tmp_path):
    """Six processes that find no library build at once; each loads a
    whole one, and they name the same file."""
    procs = [subprocess.Popen(
        [sys.executable, '-c', _BUILD_IN, str(tmp_path)], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for _ in range(6)]
    outs = [proc.communicate(timeout=300) for proc in procs]
    for proc, (out, err) in zip(procs, outs):
        assert proc.returncode == 0, err
    libs = {out.splitlines()[0] for out, _ in outs}
    assert len(libs) == 1 and libs.pop().startswith(str(tmp_path))
    assert {out.splitlines()[1] for out, _ in outs} == {
        '(array([0, 0, 1], dtype=int32), 2)'}
    outdir, = os.listdir(tmp_path)
    assert os.listdir(tmp_path / outdir) == ['libpbt_runtime.so']


def test_failed_build_raises_with_the_compiler_log(tmp_path, monkeypatch):
    broken = tmp_path / 'pbt_runtime.cpp'
    broken.write_text('extern "C" int parse_hitran_par( {\n')
    monkeypatch.setattr(runtime, '_SOURCE', str(broken))
    monkeypatch.setattr(runtime, '_BUILD', str(tmp_path / 'build'))
    with pytest.raises(RuntimeError, match='g[+][+] failed') as err:
        runtime.build_library()
    assert 'pbt_runtime.cpp' in str(err.value)
    assert 'error' in str(err.value)
    outdir, = os.listdir(tmp_path / 'build')
    assert os.listdir(tmp_path / 'build' / outdir) == []


@pytest.mark.parametrize('nthreads', [1, 8])
def test_parse_hitran_matches_jax_and_plain(par, nthreads):
    raw, recsize = par
    calls = runtime.parse_hitran_records.calls
    got = runtime.parse_hitran_records(raw, recsize, nthreads)
    assert runtime.parse_hitran_records.calls == calls + 1
    want = jruntime.parse_hitran_records(raw, recsize, nthreads)
    plain = runtime.parse_hitran_records_plain(raw, recsize)
    assert len(got[0]) == 900
    for g, w, p in zip(got, want, plain):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p)


@pytest.mark.parametrize('wn_range', [
    (6000.0, 7000.0), (5800.0, 9200.0), (100.0, 200.0), (7000.0, 6000.0)])
def test_tli_extract_range_matches_jax_and_plain(wn_range):
    rng = np.random.default_rng(5)
    counts = np.array([40, 0, 33, 70])
    wn = np.concatenate([np.sort(rng.uniform(5800.0, 9200.0, n))
                         for n in counts])
    iso = np.repeat(np.arange(4), counts).astype(np.int16)
    elow, gf = rng.uniform(0, 1e4, len(wn)), rng.lognormal(-8, 3, len(wn))
    calls = runtime.tli_extract_range.calls
    got = runtime.tli_extract_range(wn, iso, elow, gf, counts, *wn_range)
    assert runtime.tli_extract_range.calls == calls + 1
    want = jruntime.tli_extract_range(wn, iso, elow, gf, counts, *wn_range)
    plain = runtime.tli_extract_range_plain(wn, iso, elow, gf, counts,
                                            *wn_range)
    for g, w, p in zip(got, want, plain):
        assert g.dtype == w.dtype == p.dtype
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p)


def _groups_input(seed=6, n=3000):
    rng = np.random.default_rng(seed)
    aiso = np.repeat(np.arange(3), [n // 2, n // 3, n - n // 2 - n // 3])
    awavn = np.concatenate([np.sort(rng.uniform(6000.0, 6010.0, c))
                            for c in np.bincount(aiso)])
    ownstep = 0.01
    anchor = np.round(awavn / ownstep) * ownstep
    return awavn, aiso, anchor, ownstep


def test_lbl_group_matches_jax_and_plain():
    args = _groups_input()
    calls = runtime.lbl_group.calls
    group_id, ngroups = runtime.lbl_group(*args)
    assert runtime.lbl_group.calls == calls + 1
    jgroup_id, jngroups = jruntime.lbl_group(*args)
    pgroup_id, pngroups = runtime.lbl_group_plain(*args)
    assert ngroups == jngroups == pngroups
    assert 100 < ngroups < len(args[0])
    np.testing.assert_array_equal(group_id, jgroup_id)
    np.testing.assert_array_equal(group_id, pgroup_id)
    assert runtime.lbl_group_plain(np.zeros(0), np.zeros(0, int),
                                   np.zeros(0), 0.01)[1] == 0
    assert runtime.lbl_group(np.zeros(0), np.zeros(0, int), np.zeros(0),
                             0.01)[1] == 0


def test_lbl_scatter_matches_jax_and_plain():
    rng = np.random.default_rng(7)
    ngroups, nspec, dnwn, ofactor = 500, 2, 4000, 3
    profile = rng.uniform(0.0, 1.0, 200_000)
    minj = rng.integers(-50, dnwn, ngroups)
    maxj = minj + rng.integers(-5, 300, ngroups)
    minj, maxj = np.maximum(minj, 0), np.minimum(maxj, dnwn)
    offset = rng.integers(-1000, 1000, ngroups)
    pindex = 2000 + offset - ofactor * minj + rng.integers(0, 1000, ngroups)
    args = (rng.uniform(size=ngroups) > 0.2, rng.integers(0, nspec, ngroups),
            minj, maxj, pindex, offset, ofactor,
            rng.lognormal(-20, 2, ngroups), profile)
    got, want, plain = (np.zeros((nspec, dnwn)) for _ in range(3))
    calls = runtime.lbl_scatter.calls
    runtime.lbl_scatter(*args, got)
    assert runtime.lbl_scatter.calls == calls + 1
    jruntime.lbl_scatter(*args, want)
    runtime.lbl_scatter_plain(*args, plain)
    assert np.count_nonzero(got) > dnwn
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, plain, rtol=SCATTER_RTOL, atol=0)


@pytest.fixture(scope='module')
def engines(tmp_path_factory):
    """(port, JAX) parity engines of a small TLI model: 2,000 synthetic
    HITRAN H2O lines, 1.1-1.2 um at 1 cm-1, 5 layers, a 10 x 10 profile
    grid."""
    jax_native_runtime()
    workdir = str(tmp_path_factory.mktemp('sample_layer'))
    _, tli_cfg, opacity_cfg = benchmark.make_lbl_flagship(
        workdir, nlines=2000, seed=2, nlayers=5, wl_low=1.1, wl_high=1.2)
    run(tli_cfg, device='cpu')
    with open(opacity_cfg, 'a') as f:
        f.write('ndop = 10\nnlor = 10\n')
    return (Model(opacity_cfg, device='cpu').opacity_models[0][1],
            JModel(opacity_cfg).opacity_models[0][1])


@pytest.mark.parametrize('skip', [(), ('H2O',)])
def test_sample_layer_native_matches_loop_and_jax(engines, monkeypatch,
                                                 skip):
    lbl, jlbl = engines
    temp, dens = 1700.0, np.array([3e17, 5e16, 1e14])
    pf = lbl.iso_pf(np.array([temp]))[:, 0]
    counts = runtime.lbl_group.calls, runtime.lbl_scatter.calls
    lbl._group_cache.clear()
    got, ofactor, dnwn = lbl._sample_layer(temp, dens, pf, skip)
    if skip:
        assert not got.any()
        return
    assert (runtime.lbl_group.calls, runtime.lbl_scatter.calls) == (
        counts[0] + 1, counts[1] + 1)
    want = jlbl._sample_layer(temp, dens, pf, skip)
    np.testing.assert_array_equal(got, want[0])
    assert (ofactor, dnwn) == want[1:]
    monkeypatch.setattr(runtime, 'lbl_group', runtime.lbl_group_plain)
    monkeypatch.setattr(runtime, 'lbl_scatter', runtime.lbl_scatter_plain)
    lbl._group_cache.clear()
    plain = lbl._sample_layer(temp, dens, pf, skip)[0]
    lbl._group_cache.clear()
    assert np.count_nonzero(got) > 0.5 * got.size
    np.testing.assert_allclose(got, plain, rtol=SCATTER_RTOL, atol=0)


@pytest.mark.parametrize('case', ['short_records', 'segments_beyond',
                                  'unequal_groups', 'window_beyond'])
def test_native_calls_refuse_out_of_bounds_operands(case):
    """The wrappers check what the library would read or write out of
    bounds before they pass it any pointer, and count no call."""
    fn = {'short_records': runtime.parse_hitran_records,
          'segments_beyond': runtime.tli_extract_range,
          'unequal_groups': runtime.lbl_group,
          'window_beyond': runtime.lbl_scatter}[case]
    calls = fn.calls
    one = np.ones(3)
    with pytest.raises(ValueError):
        if case == 'short_records':
            fn(b' ' * 300, 100)
        elif case == 'segments_beyond':
            fn(one, np.zeros(3, np.int16), one, one, [2, 2], 0.0, 2.0)
        elif case == 'unequal_groups':
            fn(one, np.zeros(2, int), one, 0.1)
        else:
            fn([True], [0], [0], [5], [0], [0], 2, [1.0], np.ones(8),
               np.zeros((1, 10)))
    assert fn.calls == calls
