"""The port's nested sampler (sampler = multinest) against pyratbay_tpu's,
float64 on the CPU.

* identify_modes and _bootstrap_logz_err equal the JAX functions on the
  same inputs.
* Injected draws: the JAX sampler's PRNG splits are reproduced here
  (key -> (key, k_init); split(key, n_scan); per scan step (k_pick,
  k_walk); split(k_walk, nsteps_walk); per walk step (k1, k2), k1 the
  normal), and the draws fed to the port's sample_nested must give every
  result key of the JAX run: at rtol 1e-10 (the modes and n_iter
  exactly) on analytic likelihoods, and on the test-size flagship's
  log-posterior (the port's batched one against the JAX package's
  per-chain one under its vmap) at the forward's bound, rtol 1e-8, on
  the keys that carry log-likelihoods (tests/test_torch_forward.py).
* With its own generator the port passes the analytic cases of
  tests/test_nested.py: a Gaussian's evidence within 0.5 of -3 ln 10, a
  0.8 correlation, and both modes of a bimodal posterior.
* run_retrieval with sampler = multinest writes logz, logz_err, the
  posterior and the post-processing files (the run cut to a few hundred
  dead points by wrapping sample_nested), and --post reads them back;
  sampler = demc runs the snooker DEMC, with the posterior of
  sampler = snooker for the same seed.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import random  # noqa: E402

from pyratbay_tpu.benchmark import make_flagship as jmake_flagship  # noqa: E402
from pyratbay_tpu.retrieval import nested as jnested  # noqa: E402
from pyratbay_tpu.retrieval.forward import (  # noqa: E402
    build_log_posterior as jbuild_log_posterior,
)
from pyratbay_tpu_torch.model import Model  # noqa: E402
from pyratbay_tpu_torch.observation import Observation  # noqa: E402
from pyratbay_tpu_torch.retrieval import driver as rdriver  # noqa: E402
from pyratbay_tpu_torch.retrieval import nested  # noqa: E402
from pyratbay_tpu_torch.retrieval.batched import (  # noqa: E402
    build_log_posterior_batched,
)
from pyratbay_tpu_torch.retrieval.params import RetrievalParams  # noqa: E402

RTOL = 1e-10
FORWARD_RTOL = 1e-8     # the port's forward against the JAX package's
EXACT = ('modes', 'n_iter')


def jax_draws(key, nlive, ndim, nsteps_walk, batch, n_scan):
    """The draws of a JAX sample_nested run, from its PRNG key."""
    key, k_init = random.split(key)
    src, normal = [], []
    for k in random.split(key, n_scan):
        k_pick, k_walk = random.split(k)
        src.append(np.asarray(random.randint(
            k_pick, (batch,), 0, nlive - batch)))
        normal.append(np.stack([
            np.asarray(random.normal(random.split(k_step)[0], (batch, ndim)))
            for k_step in random.split(k_walk, nsteps_walk)]))
    return {'live_u': np.asarray(random.uniform(k_init, (nlive, ndim))),
            'src': np.stack(src), 'normal': np.stack(normal)}


def assert_results_equal(got, want, rtol=RTOL, like_rtol=RTOL):
    """Every result key of the JAX run: the modes and n_iter exactly, the
    unit-cube-derived keys at rtol, those carrying log-likelihoods at
    like_rtol."""
    assert got.keys() == want.keys()
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.shape == b.shape, key
        if key in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=key)
        elif key in ('samples', 'posterior', 'efficiency', 'log_weights'):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=0, err_msg=key)
        else:
            np.testing.assert_allclose(a, b, rtol=like_rtol, atol=0,
                                       err_msg=key)


def run_both(jax_like, torch_like, transform, ndim, nlive, max_iter,
             nsteps_walk, seed):
    """The JAX run and the port's on the JAX run's draws."""
    key = random.PRNGKey(seed)
    want = jnested.sample_nested(
        jax_like, transform, ndim, nlive=nlive, key=key, max_iter=max_iter,
        nsteps_walk=nsteps_walk)
    batch = min(max(1, nlive // 16), nlive // 2)
    n_scan = -(-max_iter // batch)
    draws = jax_draws(key, nlive, ndim, nsteps_walk, batch, n_scan)
    got = nested.sample_nested(
        torch_like, transform, ndim, nlive=nlive, max_iter=max_iter,
        nsteps_walk=nsteps_walk, draws=draws)
    return got, want


# ----------------------------------------------------------------------
# Host functions

def test_identify_modes_and_bootstrap_match_jax():
    rng = np.random.default_rng(3)
    samples = np.concatenate([
        rng.normal(0.3, 0.02, (300, 2)), rng.normal(0.7, 0.03, (200, 2)),
        rng.uniform(0.0, 1.0, (100, 2))])
    weights = np.concatenate([
        rng.uniform(0.5, 1.0, 300), rng.uniform(0.2, 0.9, 200),
        rng.uniform(0.0, 1e-6, 100)])
    got = nested.identify_modes(samples, weights)
    want = jnested.identify_modes(samples, weights)
    np.testing.assert_array_equal(got, want)
    assert got.max() >= 1
    dead = np.sort(rng.normal(-20.0, 5.0, 250))
    live = rng.normal(-2.0, 0.5, 40)
    for n_use in (0, 97, 250):
        assert nested._bootstrap_logz_err(dead, live, 40, 3, n_use) == \
            jnested._bootstrap_logz_err(dead, live, 40, 3, n_use)


# ----------------------------------------------------------------------
# Injected draws against the JAX sampler

MU = np.array([0.3, -0.2, 0.5])
CENTERS = np.array([[0.3, 0.3], [0.7, 0.65]])


def _gauss_jax(theta):
    return -0.5 * jnp.sum(((theta - MU) / 0.4)**2)


def _gauss_torch(theta):
    return -0.5 * torch.sum(((theta - torch.as_tensor(MU)) / 0.4)**2, dim=1)


def _bimodal_jax(theta):
    d2 = jnp.sum((theta[None] - CENTERS)**2, axis=1)
    return jax.scipy.special.logsumexp(-0.5 * d2 / 0.05**2)


def _bimodal_torch(theta):
    d2 = torch.sum((theta[:, None] - torch.as_tensor(CENTERS))**2, dim=2)
    return torch.logsumexp(-0.5 * d2 / 0.05**2, dim=1)


@pytest.mark.parametrize('case', ['gaussian_3d', 'bimodal_2d'])
def test_injected_draws_match_jax(case):
    if case == 'gaussian_3d':
        like = (_gauss_jax, _gauss_torch, lambda u: 4.0 * u - 2.0, 3)
    else:
        like = (_bimodal_jax, _bimodal_torch, lambda u: u, 2)
    jax_like, torch_like, transform, ndim = like
    got, want = run_both(jax_like, torch_like, transform, ndim, nlive=32,
                         max_iter=256, nsteps_walk=6, seed=5)
    assert_results_equal(got, want)
    # The run was truncated at stop_dlogz, and the walks moved:
    assert 0 < got['n_iter'] <= 256
    assert 0.0 < got['efficiency'] < 1.0
    if case == 'bimodal_2d':
        assert len(got['mode_logz']) >= 2


@pytest.fixture(scope='module')
def flagship(tmp_path_factory):
    """The flagship at test size (21 layers, 1.1-1.3 um, wnstep 4), set
    up by both packages from the same files, with synthetic data."""
    workdir = str(tmp_path_factory.mktemp('torch_nested'))
    jmodel, jobs, jret, jforward, p0 = jmake_flagship(
        workdir, nlayers=21, wl_low=1.1, wl_high=1.3, wnstep=4.0)
    band = np.asarray(jforward(jnp.asarray(p0))['bandflux'])
    data = band * (1 + 1e-4 * np.sin(np.arange(len(band))))
    uncert = np.full(len(band), 3e-5)
    jobs.data, jobs.uncert = data, uncert
    model = Model(workdir + '/flagship.cfg', device='cpu')
    filters = [f'tophat {band.wl0:.4f} {band.half_width}'
               for band in jobs.filters]

    class _ObsCfg:
        obsfile = dunits = offset_inst = uncert_scaling = None

    _ObsCfg.data, _ObsCfg.uncert, _ObsCfg.filters = data, uncert, filters
    obs = Observation(_ObsCfg, model.wn)
    return workdir, (jmodel, jobs, jret), (model, obs, RetrievalParams(
        model, obs)), filters


def test_flagship_log_posterior_injected_draws_match_jax(flagship):
    """Two scan steps over the flagship's 7 parameters: the port's
    batched log-posterior against the JAX package's per-chain one, the
    prior transforms of both packages' drivers."""
    _, (jmodel, jobs, jret), (model, obs, ret), _ = flagship
    free = np.asarray(jret.ifree)
    base = jnp.asarray(jret.params)
    lo = jnp.asarray(jret.pmin[free])
    span = jnp.asarray(jret.pmax[free] - jret.pmin[free])
    jlog_post = jax.jit(jbuild_log_posterior(jmodel, jobs, jret))
    jtransform = lambda u: base.at[jnp.asarray(free)].set(lo + span * u)
    port_transform = rdriver.unit_cube_prior(ret, torch.device('cpu'))

    def transform(u):
        if isinstance(u, torch.Tensor):
            return port_transform(u)
        return jtransform(u)

    nlive, nsteps_walk = 32, 3
    got, want = run_both(
        lambda p: jlog_post(p), build_log_posterior_batched(model, obs, ret),
        transform, len(free), nlive=nlive, max_iter=4,
        nsteps_walk=nsteps_walk, seed=7)
    assert_results_equal(got, want, like_rtol=FORWARD_RTOL)
    assert len(got['log_like']) == got['n_iter'] + nlive
    # Rejected chains (-inf) and accepted ones both:
    assert np.isfinite(got['log_like']).any()
    assert not np.isfinite(got['log_like']).all()


# ----------------------------------------------------------------------
# The port's own generator: the analytic cases of tests/test_nested.py

def test_own_generator_gaussian_evidence():
    """Unit Gaussian in a [-5, 5]^3 box: logZ = -3 ln 10."""
    d = 3

    def log_like(theta):
        return -0.5 * torch.sum(theta**2, dim=1) - 0.5 * d * np.log(
            2 * np.pi)

    res = nested.sample_nested(
        log_like, lambda u: 10.0 * u - 5.0, d, nlive=400, max_iter=6000,
        nsteps_walk=40, generator=torch.Generator().manual_seed(1))
    assert abs(res['logz'] + d * np.log(10.0)) < 0.5
    post = res['posterior']
    assert np.all(np.abs(post.mean(axis=0)) < 0.15)
    assert np.all(np.abs(post.std(axis=0) - 1.0) < 0.15)
    assert res['n_iter'] > 1000
    assert 0.05 < res['efficiency'] < 0.95


def test_own_generator_correlated_posterior():
    """A correlated 2-D Gaussian's correlation, 0.8."""
    icov = torch.as_tensor(np.linalg.inv([[1.0, 0.8], [0.8, 1.0]]))

    def log_like(theta):
        return -0.5 * torch.sum((theta @ icov) * theta, dim=1)

    res = nested.sample_nested(
        log_like, lambda u: 8.0 * u - 4.0, 2, nlive=300, max_iter=5000,
        generator=torch.Generator().manual_seed(2))
    corr = np.corrcoef(res['posterior'].T)[0, 1]
    assert abs(corr - 0.8) < 0.1


def test_own_generator_bimodal_posterior():
    """Both modes of a well-separated bimodal posterior stay populated,
    and the evidence is 2 pi sigma^2."""
    sigma = 0.05
    centers = torch.as_tensor([[0.3, 0.3], [0.7, 0.7]])

    def log_like(theta):
        d2 = torch.sum((theta[:, None] - centers)**2, dim=2)
        return torch.logsumexp(-0.5 * d2 / sigma**2, dim=1) - np.log(2.0)

    res = nested.sample_nested(
        log_like, lambda u: u, 2, nlive=400,
        generator=torch.Generator().manual_seed(4))
    post = res['posterior']
    for center in ([0.3, 0.3], [0.7, 0.7]):
        assert np.mean(np.linalg.norm(post - center, axis=1) < 0.2) > 0.2
    logz_true = np.log(2 * np.pi * sigma**2)
    assert abs(res['logz'] - logz_true) < 5 * res['logz_err'] + 0.2


# ----------------------------------------------------------------------
# Through the driver

def _retrieval_cfg(flagship, name, extra):
    workdir, _, _, filters = flagship
    with open(os.path.join(workdir, 'flagship.cfg')) as f:
        text = f.read()
    obs = flagship[2][1]
    text = text.replace('runmode = spectrum', 'runmode = retrieval')
    text = text.replace(f'logfile = {workdir}/flagship.log',
                        f'logfile = {workdir}/{name}.log')
    text += '\n'.join([
        'data = ' + ' '.join(f'{d:.10e}' for d in obs.data),
        'uncert = ' + ' '.join(f'{u:.10e}' for u in obs.uncert),
        'filters =', *[f'    {entry}' for entry in filters], *extra]) + '\n'
    cfg = os.path.join(workdir, f'{name}.cfg')
    with open(cfg, 'w') as f:
        f.write(text)
    return cfg


def test_multinest_through_the_driver(flagship, monkeypatch):
    """sampler = multinest through the CLI's driver on the CPU, cut to
    2 x 40 + 40 dead points by wrapping sample_nested: logz and logz_err
    in <logfile>.npz and on the model, the posterior inside the prior
    box, the post-processing files; then --post from that .npz."""
    from pyratbay_tpu_torch.driver import run
    workdir = flagship[0]
    cfg = _retrieval_cfg(flagship, 'nested',
                         ['sampler = multinest', 'nlive = 40'])
    calls = []
    real = rdriver.sample_nested

    def cut(*a, **kw):
        calls.append(kw)
        return real(*a, max_iter=80, nsteps_walk=4, **kw)

    monkeypatch.setattr(rdriver, 'sample_nested', cut)
    monkeypatch.setattr(rdriver, '_plots', lambda *a: None)   # time
    model = run(cfg, device='cpu', seed=3)
    assert len(calls) == 1 and calls[0]['nlive'] == 40
    out = np.load(os.path.join(workdir, 'nested.npz'))
    for key in ('logz', 'logz_err', 'posterior', 'bestp', 'best_log_post',
                'spec_best', 'bandflux_best'):
        assert np.all(np.isfinite(out[key])), key
    assert float(out['logz']) == model.logz
    assert float(out['logz_err']) == model.logz_err > 0
    ret = model.ret
    post = out['posterior']
    assert post.shape[1] == len(ret.params)
    assert np.all((post >= ret.pmin) & (post <= ret.pmax))
    fixed = np.setdiff1d(np.arange(len(ret.params)), ret.ifree)
    np.testing.assert_array_equal(post[:, fixed], np.broadcast_to(
        np.asarray(ret.params)[fixed], post[:, fixed].shape))
    assert not hasattr(model, 'grfactor')
    for suffix in ('_temperature_posterior.npz', '_spectrum_posterior.npz',
                   '_median.atm', '_band_contribution.npz'):
        assert os.path.isfile(os.path.join(workdir, 'nested' + suffix)), \
            suffix
    with open(os.path.join(workdir, 'nested.log')) as f:
        assert 'multinest sampler' in f.read()

    again = rdriver.posterior_post_processing(cfg, suffix='_post',
                                              device='cpu')
    np.testing.assert_array_equal(again.posterior, post)
    with np.load(os.path.join(workdir, 'nested_post_spectrum_posterior'
                                       '.npz')) as a, np.load(os.path.join(
            workdir, 'nested_spectrum_posterior.npz')) as b:
        np.testing.assert_array_equal(a['median'], b['median'])


def test_demc_sampler_runs_snooker(flagship, monkeypatch):
    """sampler = demc is the snooker DEMC, as in the JAX package: the
    same seed gives the same posterior as sampler = snooker."""
    monkeypatch.setattr(rdriver, '_plots', lambda *a: None)   # time
    posteriors = {}
    for sampler in ('snooker', 'demc'):
        cfg = _retrieval_cfg(flagship, f'demc_{sampler}', [
            f'sampler = {sampler}', 'nchains = 10', 'nsamples = 60',
            'burnin = 1'])
        model = Model(cfg, device='cpu')
        results = rdriver.run_retrieval(model, seed=4)
        posteriors[sampler] = results['posterior']
        assert 'logz' not in results
    assert posteriors['demc'].shape == (50, 7)
    np.testing.assert_array_equal(posteriors['demc'], posteriors['snooker'])
