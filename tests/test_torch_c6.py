"""The JAX package's keywords that the port took last (ROADMAP C6),
each against pyratbay_tpu on the CPU in float64, inputs from a numpy
seed:

* ops.cumtrapz(y, x, axis, initial): along axis 0 and 1 of a [7, 9] y,
  1-D, from `initial`; the port's 1-D x along `axis` of a batch: 1e-14.
* profiles.guillot_tp / get_tmodel with gravity (scalar, per layer):
  1e-12; gaussian_filter1d's mode; TMODEL_NPARS.
* chem.equilibrium_vmr(n_iter=) at 40 and 120 steps on a network of
  tests/test_chem.py: 1e-10 on VMRs above 1e-30.
* LineSample.extinction(per_mol=True) by species, and its sum against
  per_mol=False: 1e-10 (tests/test_torch_opacity.py's bound).
* Model.extinction(lbl_engine='parity' and 'direct') on a small TLI
  model: 1e-10 (tests/test_torch_lbl_retrieval.py's bound).
* driver.run(with_log=False), and a log file that cannot be opened.
* benchmark.make_flagship(resolution=2000): the same grid and table
  files, and the batched forward of 4 chains at 1e-8
  (tests/test_torch_forward.py's bound).
"""
import os
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pyratbay_tpu import benchmark as jbench  # noqa: E402
from pyratbay_tpu.atmosphere import chem as jchem  # noqa: E402
from pyratbay_tpu.atmosphere import profiles as jprofiles  # noqa: E402
from pyratbay_tpu.model import Model as JModel  # noqa: E402
from pyratbay_tpu.opacity import line_sample as jls  # noqa: E402
from pyratbay_tpu.ops import integrate as jintegrate  # noqa: E402
from pyratbay_tpu.retrieval.batched import (  # noqa: E402
    build_forward_batched as jbuild_forward_batched,
)
from pyratbay_tpu_torch import benchmark as bench  # noqa: E402
from pyratbay_tpu_torch import driver  # noqa: E402
from pyratbay_tpu_torch.atmosphere import chem, profiles  # noqa: E402
from pyratbay_tpu_torch.model import Model  # noqa: E402
from pyratbay_tpu_torch.opacity import line_sample  # noqa: E402
from pyratbay_tpu_torch.ops import integrate  # noqa: E402
from pyratbay_tpu_torch.retrieval.batched import (  # noqa: E402
    build_forward_batched,
)

T = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)


# ----------------------------------------------------------------------
# ops.cumtrapz

def _cumtrapz_pair(y, x, **kw):
    return (integrate.cumtrapz(T(y), T(x), **kw).numpy(),
            np.asarray(jintegrate.cumtrapz(jnp.asarray(y), jnp.asarray(x),
                                           **kw)))


@pytest.mark.parametrize('axis, x_shape, initial', [
    (0, (7, 9), 0.0),
    (0, (7, 9), 2.5),
    (0, (7, 1), 0.0),
    (1, (9, 7), 2.5),    # x against y moved: [9, 7]
    (1, (9, 1), 0.0),
    (-1, (9, 7), 0.0),
])
def test_cumtrapz_axis_matches_jax(axis, x_shape, initial):
    rng = np.random.default_rng(11)
    y = rng.standard_normal((7, 9))
    x = np.cumsum(rng.uniform(0.1, 1.0, x_shape), axis=0)
    got, want = _cumtrapz_pair(y, x, axis=axis, initial=initial)
    assert got.shape == (7, 9)
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14)
    assert np.all(np.take(got, 0, axis=axis) == initial)


def test_cumtrapz_1d_and_batched_grid():
    rng = np.random.default_rng(12)
    x = np.cumsum(rng.uniform(0.1, 1.0, 13))
    y = rng.standard_normal((4, 13))
    for initial in (0.0, 2.5):
        got, want = _cumtrapz_pair(y[0], x, initial=initial)
        np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14)
    # The port's batched callers: a 1-D x along the last axis of [B, n].
    got = integrate.cumtrapz(T(y), T(x), axis=-1).numpy()
    for b in range(4):
        want = np.asarray(jintegrate.cumtrapz(jnp.asarray(y[b]),
                                              jnp.asarray(x)))
        np.testing.assert_allclose(got[b], want, rtol=1e-14, atol=1e-14)


def test_cumtrapz_x_that_does_not_broadcast_raises():
    """An x of y's shape along axis 1 does not broadcast against the
    moved y in either package."""
    y = np.ones((7, 9))
    with pytest.raises(ValueError):
        integrate.cumtrapz(T(y), T(y), axis=1)
    with pytest.raises(ValueError):
        jintegrate.cumtrapz(jnp.asarray(y), jnp.asarray(y), axis=1)


# ----------------------------------------------------------------------
# atmosphere/profiles.py

TPARS = np.array([[-4.67, -0.8, -0.8, 0.5, 1486.0, 100.0],
                  [-2.0, -1.2, 0.3, 0.1, 900.0, 250.0],
                  [-5.5, 0.4, -0.6, 0.9, 2200.0, 50.0]])


@pytest.mark.parametrize('gravity', ['none', 'scalar', 'per_layer'])
@pytest.mark.parametrize('factory', ['guillot_tp', 'get_tmodel'])
def test_guillot_gravity_matches_jax(factory, gravity):
    press = np.logspace(-6, 2, 21)
    grav = {'none': None, 'scalar': 2479.0,
            'per_layer': np.linspace(1800.0, 2600.0, 21)}[gravity]
    if factory == 'guillot_tp':
        fn = profiles.guillot_tp(press, grav)
        jfn = jprofiles.guillot_tp(press, grav)
    else:
        fn = profiles.get_tmodel('guillot', press, gravity=grav)
        jfn = jprofiles.get_tmodel('guillot', press, gravity=grav)
    got = fn(T(TPARS)).numpy()
    for b, pars in enumerate(TPARS):
        np.testing.assert_allclose(got[b], np.asarray(jfn(pars)),
                                   rtol=1e-12)
    if gravity != 'none':
        # Gravity changes the profile: tau = kappa' p / g.
        assert not np.allclose(got, profiles.guillot_tp(press)(
            T(TPARS)).numpy(), rtol=1e-6)


def test_gaussian_filter1d_mode():
    rng = np.random.default_rng(13)
    y = rng.uniform(500.0, 2500.0, 30)
    got = profiles.gaussian_filter1d(T(y[None]), 2.3, mode='nearest')
    want = jprofiles.gaussian_filter1d(jnp.asarray(y), 2.3, mode='nearest')
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-12)
    with pytest.raises(ValueError, match='Unsupported mode reflect'):
        profiles.gaussian_filter1d(T(y[None]), 2.3, mode='reflect')
    with pytest.raises(ValueError, match='Unsupported mode reflect'):
        jprofiles.gaussian_filter1d(jnp.asarray(y), 2.3, mode='reflect')


def test_tmodel_npars():
    assert profiles.TMODEL_NPARS == jprofiles.TMODEL_NPARS
    assert 'TMODEL_NPARS' in profiles.__all__
    assert all(profiles.TMODEL_NPARS[name] == len(names)
               for name, names in profiles.TMODEL_PNAMES.items())


# ----------------------------------------------------------------------
# chem.equilibrium_vmr(n_iter=)

@pytest.mark.parametrize('n_iter', [40, 120])
def test_equilibrium_vmr_n_iter_matches_jax(n_iter):
    """tests/test_chem.py's C/N/O network (H2O, CH4, CO, CO2, NH3, HCN,
    N2, H2, H, He) over 16 layers."""
    species = 'H2O CH4 CO CO2 NH3 HCN N2 H2 H He'.split()
    press = np.logspace(-8, 3, 16)
    temp = np.linspace(900.0, 2400.0, 16)
    net = chem.Network(press, temp, species, e_source='asplund_2009')
    b = net._element_b(net.metallicity, net.e_abundances, net.e_scale,
                       net.e_ratio)
    g0 = net.gibbs_at(temp)
    lnp = np.log(press)
    bl = np.broadcast_to(b, (len(press), len(b))).copy()
    got = chem.equilibrium_vmr(T(g0), T(lnp), T(bl), T(net._stoich_full),
                               n_iter=n_iter).numpy()
    want = np.asarray(jchem.equilibrium_vmr(
        jnp.asarray(g0), jnp.asarray(lnp), jnp.asarray(bl),
        jnp.asarray(net._stoich_full), n_iter=n_iter))
    live = want > 1e-30
    np.testing.assert_allclose(got[live], want[live], rtol=1e-10)
    if n_iter == 120:
        np.testing.assert_array_equal(
            got, chem.equilibrium_vmr(T(g0), T(lnp), T(bl),
                                      T(net._stoich_full)).numpy())


# ----------------------------------------------------------------------
# LineSample.extinction(per_mol=)

def test_line_sample_per_mol_matches_jax(tmp_path):
    press = np.logspace(-6, 2, 9)
    wn = np.arange(1.0 / 1.3e-4, 1.0 / 1.1e-4, 8.0)
    files = [jbench._synthetic_cs_table(
        str(tmp_path / f'{spec}.npz'), wn, press, species=spec, seed=seed)
        for spec, seed in (('H2O', 5), ('CO', 6))]
    ref = jls.LineSample(files, pressure=press)
    got = line_sample.LineSample(files, pressure=press).to(
        'cpu', torch.float64)
    assert got.nspec == 2
    rng = np.random.default_rng(14)
    temp = rng.uniform(300.0, 2900.0, (3, 9))
    dens = rng.lognormal(30.0, 2.0, (3, 9, 2))
    per_mol = got.extinction(T(temp), T(dens), per_mol=True).numpy()
    assert per_mol.shape == (3, 2, 9, len(wn))
    for b in range(3):
        want = np.asarray(ref.extinction(jnp.asarray(temp[b]),
                                         jnp.asarray(dens[b]), per_mol=True))
        np.testing.assert_allclose(per_mol[b], want, rtol=1e-10)
    summed = got.extinction(T(temp), T(dens)).numpy()
    np.testing.assert_allclose(per_mol.sum(axis=1), summed, rtol=1e-10)


# ----------------------------------------------------------------------
# Model.extinction(lbl_engine=)

TLI_KEYS = """rt_path = transit
tmodel = isothermal
tpars = 1200.0
rstar = 1.27 rsun
tstar = 5800.0
rplanet = 1.0 rjup
mplanet = 0.6 mjup
refpressure = 0.1 bar
radmodel = hydro_m
smaxis = 0.045 au
ndop = 4
nlor = 4
"""


@pytest.fixture(scope='module')
def tli_models(tmp_path_factory):
    """tests/test_torch_lbl_retrieval.py's TLI model (3000 synthetic
    HITRAN H2O lines, 1.10-1.14 um, 6 layers) as a spectrum config, in
    both packages."""
    workdir = str(tmp_path_factory.mktemp('c6_tli'))
    _, tli_cfg, opacity_cfg = bench.make_lbl_flagship(
        workdir, nlines=3000, seed=0, nlayers=6, wl_low=1.1, wl_high=1.14)
    driver.run(tli_cfg, device='cpu')
    with open(opacity_cfg) as f:
        body = f.read().replace('runmode = opacity', 'runmode = spectrum')
    body = '\n'.join(ln for ln in body.splitlines() if not ln.startswith(
        ('sampled_cross_sec', 'tmin', 'tmax', 'tstep')))
    cfg = os.path.join(workdir, 'tli_spectrum.cfg')
    with open(cfg, 'w') as f:
        f.write(body + '\n' + TLI_KEYS)
    return Model(cfg, device='cpu'), JModel(cfg)


@pytest.mark.parametrize('engine', ['parity', 'direct'])
def test_model_extinction_lbl_engine_matches_jax(tli_models, engine):
    model, jmodel = tli_models
    temp = np.linspace(900.0, 1500.0, model.nlayers)
    dens = model.base_vmr * (model.press[:, None] * 1e6
                             / (1.380649e-16 * temp[:, None]))
    radius = np.linspace(1.1, 1.0, model.nlayers) * 7.1492e9
    ec, _, _ = model.extinction(T(temp), T(radius), T(dens),
                                lbl_engine=engine)
    jec, _, _ = jmodel.extinction(jnp.asarray(temp), jnp.asarray(radius),
                                  jnp.asarray(dens), lbl_engine=engine)
    assert ec.shape == (model.nlayers, model.nwave)
    np.testing.assert_allclose(ec.numpy(), np.asarray(jec), rtol=1e-10)
    assert float(ec.max()) > 0


def test_model_extinction_engines_differ_and_others_raise(tli_models):
    """'parity' is the default; the direct engine computes each line's
    exact Voigt profile, not the parity engine's profile grid, so the two
    differ; any other engine name raises."""
    model, _ = tli_models
    temp = torch.full((model.nlayers,), 1200.0, dtype=torch.float64)
    dens = T(model.base_vmr * (model.press[:, None] * 1e6
                               / (1.380649e-16 * 1200.0)))
    radius = torch.ones(model.nlayers, dtype=torch.float64)
    parity = model.extinction(temp, radius, dens)[0]
    assert torch.equal(parity, model.extinction(
        temp, radius, dens, lbl_engine='parity')[0])
    direct = model.extinction(temp, radius, dens, lbl_engine='direct')[0]
    assert not torch.allclose(parity, direct, rtol=1e-10, atol=0)
    with pytest.raises(ValueError, match='lbl_engine'):
        model.extinction(temp, radius, dens, lbl_engine='pallas')


# ----------------------------------------------------------------------
# benchmark.make_flagship(resolution=) and driver.run(with_log=)

@pytest.fixture(scope='module')
def constant_r(tmp_path_factory):
    root = tmp_path_factory.mktemp('c6_flagship')
    jdir, pdir = str(root / 'jax'), str(root / 'port')
    jobjs = jbench.make_flagship(jdir, nlayers=11, resolution=2000.0)
    pobjs = bench.make_flagship(pdir, nlayers=11, resolution=2000.0,
                                device='cpu')
    return jdir, jobjs, pdir, pobjs


def test_make_flagship_resolution_grid_and_files(constant_r):
    jdir, (jmodel, *_), pdir, (model, *_) = constant_r
    np.testing.assert_array_equal(np.asarray(model.wn), np.asarray(jmodel.wn))
    ratio = model.wn[1:] / model.wn[:-1]
    # Constant R: one ratio between neighbours, about 1 + 1/R.
    np.testing.assert_allclose(ratio, ratio[0], rtol=1e-12)
    assert abs((ratio[0] - 1.0) * 2000.0 - 1.0) < 1e-3
    for name in ('flagship_cia.dat', 'flagship.atm'):
        with open(os.path.join(jdir, name), 'rb') as fj, \
                open(os.path.join(pdir, name), 'rb') as fp:
            assert fj.read() == fp.read(), name
    with zipfile.ZipFile(os.path.join(jdir, 'flagship_h2o.npz')) as zj, \
            zipfile.ZipFile(os.path.join(pdir, 'flagship_h2o.npz')) as zp:
        assert zj.namelist() == zp.namelist()
        for name in zj.namelist():
            assert zj.read(name) == zp.read(name), name
    with open(os.path.join(jdir, 'flagship.cfg')) as fj, \
            open(os.path.join(pdir, 'flagship.cfg')) as fp:
        jtext, ptext = fj.read(), fp.read()
    assert ptext.replace(pdir, jdir) == jtext
    assert 'resolution = 2000.0' in ptext and 'wnstep' not in ptext


def test_make_flagship_resolution_forward_matches_jax(constant_r):
    _, (jmodel, jobs, jret, _, p0), _, (model, obs, ret, _, _) = constant_r
    rng = np.random.default_rng(15)
    pb = np.tile(p0, (4, 1)) + 0.05 * rng.standard_normal((4, len(p0)))
    want = jax.jit(jbuild_forward_batched(jmodel, jobs, jret))(
        jnp.asarray(pb))
    got = build_forward_batched(model, obs, ret)(pb)
    np.testing.assert_allclose(got['spectrum'].numpy(),
                               np.asarray(want['spectrum']), rtol=1e-8)
    np.testing.assert_allclose(got['bandflux'].numpy(),
                               np.asarray(want['bandflux']), rtol=1e-8)


def _run_copy(constant_r, tmp_path, logfile, verb, runmode='spectrum'):
    """The port's flagship config with another logfile and verb; as a
    retrieval (8 chains x 4 generations on data from its forward at the
    config's parameters), when `runmode` says so."""
    _, _, pdir, (_, obs, _, forward, p0) = constant_r
    with open(os.path.join(pdir, 'flagship.cfg')) as f:
        lines = f.read().splitlines()
    lines = [f'logfile = {logfile}' if ln.startswith('logfile') else
             f'verb = {verb}' if ln.startswith('verb') else
             f'runmode = {runmode}' if ln.startswith('runmode') else ln
             for ln in lines]
    if runmode == 'retrieval':
        band = forward(p0)['bandflux'].numpy()
        lines += [
            'data = ' + ' '.join(f'{d:.10e}' for d in band),
            'uncert = ' + ' '.join(['3.0e-05'] * len(band)),
            'filters =',
            *[f'    tophat {b.wl0:.4f} {b.half_width}' for b in obs.filters],
            'nchains = 8', 'nsamples = 32', 'burnin = 1']
    cfg = tmp_path / 'run.cfg'
    cfg.write_text('\n'.join(lines) + '\n')
    return str(cfg)


@pytest.mark.parametrize('runmode', ['spectrum', 'retrieval'])
def test_run_with_log_false_writes_no_log(constant_r, tmp_path, runmode):
    """No log file, also not the one run_retrieval opens when it is
    called on a Model with a screen log of its own."""
    logfile = tmp_path / 'run.log'
    cfg = _run_copy(constant_r, tmp_path, logfile, -1, runmode)
    model = driver.run(cfg, device='cpu', with_log=False)
    assert not logfile.exists()
    if runmode == 'retrieval':
        assert np.all(np.isfinite(model.posterior))
        assert (tmp_path / 'run.npz').exists()
        return
    assert model.spectrum.shape == (model.nwave,)
    driver.run(cfg, device='cpu')
    assert logfile.exists() and 'Run mode: spectrum' in logfile.read_text()


def test_run_log_file_that_cannot_open_warns(constant_r, tmp_path, capsys):
    missing = tmp_path / 'no_such_dir' / 'run.log'
    cfg = _run_copy(constant_r, tmp_path, missing, 1)
    model = driver.run(cfg, device='cpu')
    err = capsys.readouterr().err
    assert f'Could not open log file {str(missing)!r}' in err
    assert not missing.parent.exists()
    assert model.spectrum.shape == (model.nwave,)
