"""Port parity, opacity: setup tables, runtime weights and contractions
of the flagship sources, float64 on the CPU, against pyratbay_tpu.

Setup tables are numpy copies and must agree to rtol 1e-10 (they are
computed by the same code); runtime contractions to rtol 1e-10 as
well (same formulas, summation order differing only in the last
bits).
"""
import os
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

from pyratbay_tpu import benchmark as jbench  # noqa: E402
from pyratbay_tpu.opacity import alkali as jalkali  # noqa: E402
from pyratbay_tpu.opacity import cia as jcia  # noqa: E402
from pyratbay_tpu.opacity import clouds as jclouds  # noqa: E402
from pyratbay_tpu.opacity import line_sample as jls  # noqa: E402
from pyratbay_tpu_torch import benchmark as bench  # noqa: E402
from pyratbay_tpu_torch.opacity import alkali, cia, clouds  # noqa: E402
from pyratbay_tpu_torch.opacity import line_sample  # noqa: E402
from pyratbay_tpu_torch.ops.interp import interp  # noqa: E402

RTOL = 1e-10
F64 = dict(dtype=torch.float64, device='cpu')
T = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(scope='module')
def tables(tmp_path_factory):
    """Synthetic H2O and H2-H2 tables written by both packages' writers
    from the same seeds."""
    root = tmp_path_factory.mktemp('tables')
    press = np.logspace(-6, 2, 15)
    wn = np.arange(1.0 / 1.3e-4, 1.0 / 1.1e-4, 4.0)
    paths = {}
    for name, mod in (('jax', jbench), ('port', bench)):
        paths[name] = (
            mod._synthetic_cs_table(str(root / f'{name}_h2o.npz'), wn, press),
            mod._synthetic_cia_table(str(root / f'{name}_cia.dat')),
        )
    return press, wn, paths


def test_table_writers_are_identical(tables):
    _, _, paths = tables
    with open(paths['jax'][1], 'rb') as fj, open(paths['port'][1], 'rb') as fp:
        assert fj.read() == fp.read()
    # npz archives carry write timestamps; their array members must be
    # byte-identical:
    with zipfile.ZipFile(paths['jax'][0]) as zj, \
            zipfile.ZipFile(paths['port'][0]) as zp:
        assert zj.namelist() == zp.namelist()
        for name in zj.namelist():
            assert zj.read(name) == zp.read(name), name


def test_line_sample_setup_and_extinction(tables):
    press_tab, wn, paths = tables
    cs_file = paths['jax'][0]
    # Resampled in pressure and temperature (log-space interpolation):
    press = np.logspace(-5.5, 1.8, 11)
    temps = np.linspace(400.0, 2600.0, 8)
    kw = dict(pressure=press, temperature=temps, min_wn=wn[3],
              max_wn=wn[-4])
    ref = jls.LineSample(cs_file, **kw)
    got = line_sample.LineSample(cs_file, **kw).to('cpu', torch.float64)
    np.testing.assert_allclose(got.cs_table, ref.cs_table, rtol=RTOL)
    np.testing.assert_array_equal(got.wn, ref.wn)

    rng = np.random.default_rng(3)
    temp = rng.uniform(300.0, 2900.0, (4, 11))
    temp[0, :3] = temps[:3]          # exact grid hits
    dens = rng.lognormal(30.0, 2.0, (4, 11, 1))
    ext = got.extinction(T(temp), T(dens)).numpy()
    for b in range(4):
        want = np.asarray(ref.extinction(jnp.asarray(temp[b]),
                                         jnp.asarray(dens[b])))
        np.testing.assert_allclose(ext[b], want, rtol=RTOL)
    tlo, w_hi = got._t_weights(T(temp))
    jtlo, jw = ref._t_weights(jnp.asarray(temp[1]))
    np.testing.assert_array_equal(tlo[1].numpy(), np.asarray(jtlo))
    np.testing.assert_allclose(w_hi[1].numpy(), np.asarray(jw), rtol=RTOL)


def test_cia_setup_weights_and_extinction(tables):
    _, wn, paths = tables
    ref = jcia.CIA(paths['jax'][1], wn=wn)
    got = cia.CIA(paths['jax'][1], wn=wn).to('cpu', torch.float64)
    np.testing.assert_allclose(
        got.tab_cs_amagat, ref.tab_cs_amagat, rtol=RTOL)
    np.testing.assert_array_equal(got.temps, ref.temps)

    rng = np.random.default_rng(5)
    temp = rng.uniform(30.0, 3500.0, (3, 9))     # includes clamping
    dens = rng.lognormal(40.0, 1.0, (3, 9, 2))
    weights = got.kernel_weights(T(temp), T(dens))
    assert weights.shape == (3, 9, ref.ntemp)
    ext = got.extinction(T(temp), T(dens)).numpy()
    for b in range(3):
        want = np.asarray(ref.extinction(jnp.asarray(temp[b]),
                                         jnp.asarray(dens[b])))
        np.testing.assert_allclose(ext[b], want, rtol=RTOL, atol=1e-300)


@pytest.mark.parametrize('wl_range, active', [
    ((1.1, 1.7), []),           # the flagship grid: Na D pruned
    ((0.5, 1.0), [0, 1]),       # Na D at 0.589 um: both lines active
])
def test_alkali_pruning_and_extinction(wl_range, active):
    wn = np.arange(1e4 / wl_range[1], 1e4 / wl_range[0], 5.0)
    press = np.logspace(-6, 2, 13)
    ref = jalkali.SodiumVdW(press, wn)
    got = alkali.SodiumVdW(press, wn).to('cpu', torch.float64)
    assert got.active_lines == ref.active_lines == active

    rng = np.random.default_rng(6)
    temp = rng.uniform(800.0, 2500.0, (2, 13))
    dens = rng.lognormal(25.0, 1.0, (2, 13))
    ext = got.extinction(T(temp), T(dens)).numpy()
    for b in range(2):
        want = np.asarray(ref.extinction(jnp.asarray(temp[b]),
                                         jnp.asarray(dens[b])))
        np.testing.assert_allclose(ext[b], want, rtol=RTOL, atol=1e-300)
    if active:
        assert ext.max() > 0


def test_lecavelier_rank1():
    press = np.logspace(-6, 2, 13)
    wn = np.linspace(6000.0, 9000.0, 50)
    ref = jclouds.Lecavelier(press, wn)
    got = clouds.Lecavelier(press, wn).to('cpu', torch.float64)
    temp = np.linspace(900.0, 1800.0, 13)[None] * [[1.0], [1.2]]
    pars = np.array([[0.0, -4.0], [1.3, -2.5]])
    col, row = got.ec_rank1(T(temp), T(pars))
    ext = got.extinction(T(temp), T(pars)).numpy()
    for b in range(2):
        jcol, jrow = ref.ec_rank1(jnp.asarray(temp[b]), jnp.asarray(pars[b]))
        np.testing.assert_allclose(col[b].numpy(), np.asarray(jcol),
                                   rtol=RTOL)
        np.testing.assert_allclose(row[b].numpy(), np.asarray(jrow),
                                   rtol=RTOL)
        np.testing.assert_allclose(ext[b], np.asarray(ref.extinction(
            jnp.asarray(temp[b]), jnp.asarray(pars[b]))), rtol=RTOL)


def test_deck_surface_edges():
    press = np.logspace(-6, 2, 17)
    ref = jclouds.Deck(press, np.ones(3))
    got = clouds.Deck(press, np.ones(3)).to('cpu', torch.float64)
    log_p = np.array([-7.0, -6.0, -5.5, np.log10(press[4]), 0.3, 2.0, 3.0])
    nb = len(log_p)
    radius = np.linspace(1.2, 1.0, 17)[None] * (1 + 0.01 * np.arange(nb))[:, None]
    temp = np.linspace(800.0, 1700.0, 17)[None] + 10.0 * np.arange(nb)[:, None]
    itop, rsurf, tsurf = got.surface(T(radius), T(temp), T(log_p[:, None]))
    for b in range(nb):
        jitop, jr, jt = ref.surface(
            jnp.asarray(radius[b]), jnp.asarray(temp[b]),
            jnp.asarray([log_p[b]]))
        assert int(itop[b]) == int(jitop), b
        np.testing.assert_allclose(float(rsurf[b]), float(jr), rtol=RTOL)
        np.testing.assert_allclose(float(tsurf[b]), float(jt), rtol=RTOL)
    assert itop.min() == 1 and itop.max() == 16


def test_interp_matches_jnp_with_end_clamps():
    xp = np.logspace(-6, 2, 9)
    fp = np.random.default_rng(7).random((6, 9))
    x = np.array([1e-7, 1e-6, 3e-4, xp[5], 99.0, 1e3])
    got = interp(T(x), T(xp), T(fp)).numpy()
    want = [float(jnp.interp(x[b], xp, fp[b])) for b in range(6)]
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert got[0] == fp[0, 0] and got[-1] == fp[-1, -1]


def test_flagship_inputs_identical(tmp_path):
    """The port's make_flagship writes the JAX package's files."""
    jbench.make_flagship(str(tmp_path / 'j'), nlayers=11, wl_low=1.1,
                         wl_high=1.15, wnstep=8.0)
    bench.make_flagship(str(tmp_path / 'p'), nlayers=11, wl_low=1.1,
                        wl_high=1.15, wnstep=8.0, device='cpu')
    for name in ('flagship.atm', 'flagship_cia.dat'):
        with open(tmp_path / 'j' / name, 'rb') as fj, \
                open(tmp_path / 'p' / name, 'rb') as fp:
            assert fj.read() == fp.read(), name
    cfg_j = (tmp_path / 'j' / 'flagship.cfg').read_text()
    cfg_p = (tmp_path / 'p' / 'flagship.cfg').read_text()
    assert cfg_j.replace(str(tmp_path / 'j'), '') \
        == cfg_p.replace(str(tmp_path / 'p'), '')
    with np.load(os.path.join(tmp_path, 'j', 'flagship_h2o.npz')) as fj, \
            np.load(os.path.join(tmp_path, 'p', 'flagship_h2o.npz')) as fp:
        for key in ('temperature', 'pressure', 'wavenumber', 'opacity'):
            np.testing.assert_array_equal(fj[key], fp[key])
