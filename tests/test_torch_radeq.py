"""Two-stream emission, the convective flux and radiative equilibrium of
the port against pyratbay_tpu, float64 on the CPU.

* spectrum/rt.py two_stream and internal_flux against the JAX package's
  (rtol 1e-12), with a column whose layer optical depths are 0 (the
  guards before exp1 and in the source gradient), and over a batch.
* Model.run with rt_path = emission_two_stream / eclipse_two_stream and
  a two-stream batched forward (the JAX package's vmap fallback) at
  1e-8.
* spectrum/convection.py against the JAX package's.
* radiative_equilibrium on benchmark.make_radeq(nlayers=30): 10
  iterations, then a warm restart of 5, against the JAX package's host
  loop at 1e-10 (radiative, convective, and with equilibrium
  chemistry solved at each iteration's profile).
* runmode = radeq through the driver: its .npz and .atm files.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pyratbay_tpu import driver as jdriver  # noqa: E402
from pyratbay_tpu.benchmark import make_radeq as jmake_radeq  # noqa: E402
from pyratbay_tpu.model import Model as JModel  # noqa: E402
from pyratbay_tpu.observation import Observation as JObservation  # noqa: E402
from pyratbay_tpu.ops.planck import blackbody_wn as jblackbody  # noqa: E402
from pyratbay_tpu.retrieval import RetrievalParams as JRetrievalParams  # noqa: E402
from pyratbay_tpu.retrieval.batched import (  # noqa: E402
    build_forward_batched as jbuild_forward_batched,
)
from pyratbay_tpu.spectrum import convection as jconvection  # noqa: E402
from pyratbay_tpu.spectrum import rt as jrt  # noqa: E402
from pyratbay_tpu.spectrum.radeq import (  # noqa: E402
    radiative_equilibrium as jradiative_equilibrium,
)
from pyratbay_tpu_torch import driver  # noqa: E402
from pyratbay_tpu_torch.benchmark import make_radeq  # noqa: E402
from pyratbay_tpu_torch.model import Model  # noqa: E402
from pyratbay_tpu_torch.observation import Observation  # noqa: E402
from pyratbay_tpu_torch.retrieval.batched import build_forward_batched  # noqa: E402
from pyratbay_tpu_torch.retrieval.params import RetrievalParams  # noqa: E402
from pyratbay_tpu_torch.spectrum import convection, rt  # noqa: E402
from pyratbay_tpu_torch.spectrum.radeq import radiative_equilibrium  # noqa: E402

RTOL_RT = 1e-12
RTOL_SLICE = 1e-8
RTOL_RADEQ = 1e-10
NLAYERS = 30
T = torch.as_tensor


# ----------------------------------------------------------------------
# Two-stream pieces

def _columns(nb=3, nlayers=12, nwave=40, seed=4):
    """Depths, Planck grids and boundaries for nb chains; chain 0 has
    three layers of zero optical depth (dtau = 0) and a transparent
    top."""
    rng = np.random.default_rng(seed)
    dtau = rng.lognormal(-2.0, 1.5, (nb, nlayers - 1, nwave))
    dtau[0, 2:5] = 0.0
    dtau[0, :, :3] = 0.0
    depth = np.concatenate(
        [np.zeros((nb, 1, nwave)), np.cumsum(dtau, axis=1)], axis=1)
    wn = np.linspace(1000.0, 9000.0, nwave)
    temp = np.linspace(900.0, 2200.0, nlayers)[None] \
        + rng.uniform(-50, 50, (nb, nlayers))
    bbody = np.stack([np.asarray(jblackbody(wn, t[:, None])) for t in temp])
    fdown = rng.uniform(0.0, 1e4, nwave)
    return depth, bbody, wn, fdown


@pytest.mark.parametrize('tint', [100.0, 0.0])
def test_internal_flux(tint):
    wn = np.linspace(500.0, 12000.0, 300)
    got = rt.internal_flux(T(wn), tint).numpy()
    want = np.asarray(jrt.internal_flux(wn, tint))
    np.testing.assert_allclose(got, want, rtol=RTOL_RT, atol=0)


def test_two_stream_with_zero_depth_layers():
    depth, bbody, wn, fdown = _columns()
    f_int = np.array(jrt.internal_flux(wn, 150.0))
    up, down = rt.two_stream(T(depth), T(bbody), T(wn), T(fdown),
                             T(f_int))
    assert up.shape == down.shape == depth.shape
    assert torch.isfinite(up).all() and torch.isfinite(down).all()
    for b in range(depth.shape[0]):
        jup, jdown = jrt.two_stream(
            jnp.asarray(depth[b]), jnp.asarray(bbody[b]), jnp.asarray(wn),
            jnp.asarray(fdown), jnp.asarray(f_int))
        np.testing.assert_allclose(up[b].numpy(), np.asarray(jup),
                                   rtol=RTOL_RT)
        np.testing.assert_allclose(down[b].numpy(), np.asarray(jdown),
                                   rtol=RTOL_RT)


def test_two_stream_transparent_column():
    """Every layer transparent: the down flux keeps the top's value and
    the up flux is the bottom's down flux plus the internal flux."""
    depth, bbody, wn, fdown = _columns(nb=1)
    depth = np.zeros_like(depth)
    f_int = np.full(len(wn), 7.0)
    up, down = rt.two_stream(T(depth), T(bbody), T(wn), T(fdown),
                             T(f_int))
    np.testing.assert_allclose(down[0].numpy(),
                               np.broadcast_to(fdown, depth[0].shape),
                               rtol=RTOL_RT)
    np.testing.assert_allclose(up[0].numpy(),
                               np.broadcast_to(fdown + 7.0, depth[0].shape),
                               rtol=RTOL_RT)


def test_convective_flux():
    rng = np.random.default_rng(9)
    nl = 20
    press = np.logspace(-2, 8, nl)            # barye
    temp = 800.0 * (press / press[0])**0.33   # super-adiabatic at 3.5 R
    temp[:5] = 800.0
    cp = np.full(nl, 3.5) * 1.380649e-16 / 1.66053906660e-24
    gravity = 2000.0 + rng.uniform(0, 100, nl)
    mu = np.full(nl, 2.3)
    rho = press * mu * 1.66053906660e-24 / (1.380649e-16 * temp)
    got = convection.convective_flux(
        T(press), T(temp), T(cp), T(gravity), T(mu), T(rho)).numpy()
    want = np.asarray(jconvection.convective_flux(
        press, temp, cp, gravity, mu, rho))
    assert np.any(want > 0) and np.all(want[:5] == 0)
    np.testing.assert_allclose(got, want, rtol=RTOL_RT, atol=0)
    gamma = cp / (cp - 1.380649e-16 / 1.66053906660e-24)
    np.testing.assert_allclose(
        convection.super_adiabatic_gradient(T(press), T(temp),
                                            T(gamma)).numpy(),
        np.asarray(jconvection.super_adiabatic_gradient(press, temp, gamma)),
        rtol=RTOL_RT, atol=0)


# ----------------------------------------------------------------------
# Model.run and the batched forward

@pytest.fixture(scope='module')
def radeq_models(tmp_path_factory):
    jdir = str(tmp_path_factory.mktemp('jax_radeq'))
    pdir = str(tmp_path_factory.mktemp('port_radeq'))
    jmodel = jmake_radeq(jdir, nlayers=NLAYERS)
    model = make_radeq(pdir, nlayers=NLAYERS, device='cpu')
    return (jdir, jmodel), (pdir, model)


def _variant(tmp_path, src_dir, name, replace=(), extra=''):
    with open(src_dir + '/radeq.cfg') as f:
        text = f.read()
    for old, new in replace:
        assert old in text
        text = text.replace(old, new)
    path = tmp_path / f'{name}.cfg'
    path.write_text(text + extra)
    return str(path)


@pytest.mark.parametrize('rt_path', ['emission_two_stream',
                                     'eclipse_two_stream'])
def test_two_stream_model_run(radeq_models, tmp_path, rt_path):
    (jdir, _), _ = radeq_models
    cfg = _variant(tmp_path, jdir, rt_path, [(
        'rt_path = emission_two_stream', f'rt_path = {rt_path}')])
    jmodel, model = JModel(cfg), Model(cfg, device='cpu')
    want = jmodel.run()
    got = model.run()
    for key in ('spectrum', 'fplanet', 'flux_up', 'flux_down', 'depth',
                'bbody'):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=RTOL_SLICE, err_msg=key)
    np.testing.assert_array_equal(got['ideep'].numpy(),
                                  np.asarray(want['ideep']))
    np.testing.assert_allclose(model.spectrum, jmodel.spectrum,
                               rtol=RTOL_SLICE)


class _ObsCfg:
    data = None
    uncert = None
    filters = [f'tophat {wl0:.2f} 0.2' for wl0 in (1.0, 2.0, 4.0, 8.0)]
    obsfile = None
    dunits = None
    offset_inst = None
    uncert_scaling = None


def test_two_stream_batched_forward(radeq_models, tmp_path):
    """The eclipse two-stream forward of 3 chains (one rejected) with
    the Guillot parameters retrieved, against the JAX package's vmap
    fallback."""
    (jdir, _), _ = radeq_models
    cfg = _variant(
        tmp_path, jdir, 'ts_retrieval',
        [('rt_path = emission_two_stream', 'rt_path = eclipse_two_stream'),
         ('runmode = radeq', 'runmode = spectrum')],
        'retrieval_params =\n'
        "    log_kappa'   -4.67  -9.0  5.0  0.3\n"
        '    T_irr      1486.0  100.0 3000.0 50.0\n')
    jmodel, model = JModel(cfg), Model(cfg, device='cpu')
    jobs = JObservation(_ObsCfg, jmodel.wn)
    obs = Observation(_ObsCfg, model.wn)
    jret, ret = JRetrievalParams(jmodel, jobs), RetrievalParams(model, obs)
    pb = np.array([[-4.67, 1486.0], [-3.9, 1700.0], [-4.0, 1.0e5]])
    jforward = jbuild_forward_batched(jmodel, jobs, jret)
    assert getattr(jforward, 'is_fallback', False)
    want = jax.jit(jforward)(jnp.asarray(pb))
    got = build_forward_batched(model, obs, ret)(pb)
    good = np.asarray(want['good'])
    np.testing.assert_array_equal(got['good'].numpy(), good)
    assert good[:2].all() and not good[2]
    np.testing.assert_allclose(got['spectrum'].numpy(),
                               np.asarray(want['spectrum']), rtol=RTOL_SLICE)
    band = got['bandflux'].numpy()
    np.testing.assert_allclose(band[good], np.asarray(want['bandflux'])[good],
                               rtol=RTOL_SLICE)


# ----------------------------------------------------------------------
# Radiative equilibrium

def _steep_profile(press):
    """A profile super-adiabatic below 1 bar (T ~ p^0.3 against
    grad_ad = 2/7 at cp/R = 3.5), so the convective branch acts."""
    press = np.asarray(press)
    return np.where(press < 1.0, 1200.0, 1200.0 * press**0.3)[None]


@pytest.mark.parametrize('case', ['radiative', 'convective'])
def test_radiative_equilibrium_matches_host_loop(radeq_models, case):
    (_, jmodel), (_, model) = radeq_models
    kw = dict(tmin=100.0, tmax=5900.0)
    if case == 'convective':
        kw.update(convection=True, radeq_temps=_steep_profile(model.press))
    want = jradiative_equilibrium(jmodel, nsamples=10, use_scan=False, **kw)
    got = radiative_equilibrium(model, nsamples=10, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL_RADEQ)
    np.testing.assert_allclose(model._dt_scale, np.asarray(jmodel._dt_scale),
                               rtol=RTOL_RADEQ)
    # The warm restart, whose sign history restarts as zeros:
    kw.pop('radeq_temps', None)
    want2 = jradiative_equilibrium(
        jmodel, nsamples=5, use_scan=False, radeq_temps=jmodel.radeq_temps,
        dt_scale=jmodel._dt_scale, **kw)
    got2 = radiative_equilibrium(
        model, nsamples=5, radeq_temps=model.radeq_temps,
        dt_scale=model._dt_scale, **kw)
    assert got2.shape == (len(got) + 5, NLAYERS)
    np.testing.assert_array_equal(got2[:len(got)], got)
    np.testing.assert_allclose(got2, want2, rtol=RTOL_RADEQ)
    if case == 'convective':
        # The convective flux moved the profile off the radiative one:
        radiative = radiative_equilibrium(
            model, nsamples=10, tmin=100.0, tmax=5900.0,
            radeq_temps=_steep_profile(model.press))
        assert np.abs(radiative[-1] - want[-1]).max() > 1.0


def test_radiative_equilibrium_with_the_network(radeq_models, tmp_path):
    """chemistry = equilibrium: the network solved at each iteration's
    profile, against the JAX package's host loop."""
    (jdir, _), _ = radeq_models
    cfg = _variant(tmp_path, jdir, 'radeq_chem', [('bulk = H2 He', (
        'chemistry = equilibrium\n'
        'species = H2 He H H2O CH4 CO CO2 Na K'))])
    jmodel, model = JModel(cfg), Model(cfg, device='cpu')
    want = jradiative_equilibrium(jmodel, nsamples=4, use_scan=False,
                                  tmin=100.0, tmax=5900.0)
    got = radiative_equilibrium(model, nsamples=4, tmin=100.0, tmax=5900.0)
    np.testing.assert_allclose(got, want, rtol=RTOL_RADEQ)


def test_radeq_requires_two_stream(tmp_path, radeq_models):
    (jdir, _), _ = radeq_models
    cfg = _variant(tmp_path, jdir, 'pp', [(
        'rt_path = emission_two_stream', 'rt_path = emission')])
    with pytest.raises(ValueError, match='two_stream'):
        radiative_equilibrium(Model(cfg, device='cpu'), nsamples=1)


def test_radeq_runmode_by_the_driver(tmp_path, radeq_models):
    (jdir, _), _ = radeq_models
    files = {}
    for tag in ('jax', 'port'):
        workdir = tmp_path / tag
        workdir.mkdir()
        cfg = _variant(workdir, jdir, 'radeq', [(
            f'logfile = {jdir}/radeq.log', f'logfile = {workdir}/radeq.log')],
            'nsamples = 6\n')
        if tag == 'jax':
            jdriver.run(cfg, with_log=False)
        else:
            driver.run(cfg, device='cpu')
        files[tag] = str(workdir / 'radeq')
    want, got = np.load(files['jax'] + '.npz'), np.load(files['port'] + '.npz')
    assert got['temps'].shape == (7, NLAYERS)
    np.testing.assert_array_equal(got['pressure'], want['pressure'])
    np.testing.assert_allclose(got['temps'], want['temps'], rtol=RTOL_RADEQ)
    with open(files['jax'] + '.atm') as f, open(files['port'] + '.atm') as g:
        assert g.read() == f.read()
