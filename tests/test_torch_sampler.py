"""The port's snooker DEMC against pyratbay_tpu's sampler.

* Injected draws: the JAX sampler's own PRNG splits are reproduced
  here, and the draws fed to the port's _propose_de,
  _propose_snooker and generation must reproduce the JAX moves and
  the JAX chain history at rtol 1e-12 (float64, same arithmetic).
* Statistics: a flagship-size-reduced retrieval recovers the truth,
  with Gelman-Rubin < 1.5 (the pattern of tests/test_retrieval.py).
* run_retrieval end to end writes a finite results .npz.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402
from jax import random  # noqa: E402

from pyratbay_tpu.retrieval import samplers as jsamplers  # noqa: E402
from pyratbay_tpu_torch.benchmark import make_flagship  # noqa: E402
from pyratbay_tpu_torch.retrieval import samplers  # noqa: E402
from pyratbay_tpu_torch.retrieval.batched import (  # noqa: E402
    build_log_posterior_batched,
)

RTOL = 1e-12
NCHAINS, NPARS = 12, 4
MU = np.array([0.3, -1.0, 2.0, 0.0])
SIG = np.array([0.5, 1.0, 0.2, 1.0])
PSTEP = np.array([0.1, 0.2, 0.05, 0.0])      # last parameter fixed
T = lambda a: torch.as_tensor(np.array(a))


def _jax_draws(key, n, npars):
    """The draws of one JAX generation, from its PRNG key."""
    k_choice, k_de, k_snook, k_accept = random.split(key, 4)
    key_r1, key_r2, key_e = random.split(k_de, 3)
    kz, kr1, kr2, kg = random.split(k_snook, 4)
    draw = lambda x: torch.as_tensor(np.array(x))
    return {
        'choice': draw(random.uniform(k_choice, (n, 1))),
        'de_r1': draw(random.randint(key_r1, (n,), 0, n - 1)),
        'de_r2': draw(random.randint(key_r2, (n,), 0, n - 1)),
        'de_normal': draw(random.normal(key_e, (n, npars))),
        'sn_z': draw(random.randint(kz, (n,), 0, n - 1)),
        'sn_r1': draw(random.randint(kr1, (n,), 0, n)),
        'sn_r2': draw(random.randint(kr2, (n,), 0, n)),
        'sn_gamma': draw(random.uniform(
            kg, (n, 1), minval=1.2, maxval=2.2)),
        'accept': draw(random.uniform(k_accept, (n,))),
    }


def _chains(seed=0):
    rng = np.random.default_rng(seed)
    return MU + SIG * rng.standard_normal((NCHAINS, NPARS))


def test_proposals_match_jax():
    chains = _chains()
    free = (PSTEP > 0).astype(float)
    eps = 1e-4 * PSTEP
    key = random.PRNGKey(11)
    k_de, k_sn = random.split(key)

    # DE move from the JAX key splits of _propose_de:
    key_r1, key_r2, key_e = random.split(k_de, 3)
    jprop, jmh = jsamplers._propose_de(
        k_de, jnp.asarray(chains), 0.7, jnp.asarray(eps),
        jnp.asarray(free))
    prop, mh = samplers._propose_de(
        T(chains), 0.7, T(eps), T(free),
        T(random.randint(key_r1, (NCHAINS,), 0, NCHAINS - 1)),
        T(random.randint(key_r2, (NCHAINS,), 0, NCHAINS - 1)),
        T(random.normal(key_e, (NCHAINS, NPARS))))
    np.testing.assert_allclose(prop.numpy(), np.asarray(jprop), rtol=RTOL)
    np.testing.assert_array_equal(mh.numpy(), np.asarray(jmh))

    kz, kr1, kr2, kg = random.split(k_sn, 4)
    jprop, jmh = jsamplers._propose_snooker(
        k_sn, jnp.asarray(chains), jnp.asarray(free))
    prop, mh = samplers._propose_snooker(
        T(chains), T(free),
        T(random.randint(kz, (NCHAINS,), 0, NCHAINS - 1)),
        T(random.randint(kr1, (NCHAINS,), 0, NCHAINS)),
        T(random.randint(kr2, (NCHAINS,), 0, NCHAINS)),
        T(random.uniform(kg, (NCHAINS, 1), minval=1.2, maxval=2.2)))
    np.testing.assert_allclose(prop.numpy(), np.asarray(jprop), rtol=RTOL)
    np.testing.assert_allclose(mh.numpy(), np.asarray(jmh), rtol=RTOL)
    # draw_generation makes the same set of draws as the JAX generation:
    assert set(_jax_draws(key, NCHAINS, NPARS)) == set(
        samplers.draw_generation(torch.Generator(), NCHAINS, NPARS,
                                 torch.float64, 'cpu'))


def test_generations_match_jax_sampler():
    """Twelve generations (the gamma = 1 one included) with the JAX
    sampler's draws reproduce its chain history."""
    ngen = 12
    chains0 = _chains(1)
    key = random.PRNGKey(5)

    def jlog_post(p):
        return -0.5 * jnp.sum(((p - MU) / SIG)**2)

    ref = jsamplers.sample_demc(
        jlog_post, chains0, nsamples=NCHAINS * ngen, key=key,
        pstep=PSTEP)
    assert 0 < float(ref['acceptance_rate']) < 1

    log_post_b = lambda p: -0.5 * torch.sum(((p - T(MU)) / T(SIG))**2, 1)
    chains = T(chains0)
    logp = log_post_b(chains)
    free = T((PSTEP > 0).astype(float))
    gamma0 = 2.38 / np.sqrt(2.0 * free.sum().item())
    keys = random.split(key, ngen)
    for igen in range(ngen):
        gamma = 1.0 if igen % 10 == 9 else gamma0
        chains, logp, _ = samplers.generation(
            chains, logp, gamma, 1e-4 * T(PSTEP), free,
            _jax_draws(keys[igen], NCHAINS, NPARS), log_post_b)
        np.testing.assert_allclose(
            chains.numpy(), np.asarray(ref['chain_history'])[igen],
            rtol=RTOL, err_msg=f'generation {igen}')
    np.testing.assert_array_equal(chains[:, -1].numpy(), chains0[:, -1])


@pytest.mark.parametrize('adapt, target, moves', [
    (False, 0.234, 0),
    (True, 0.0, 1),         # acceptance above target: the step grows
    (True, 1.0, -1),        # acceptance below target: the step shrinks
])
def test_adapt_gamma_moves_toward_target(adapt, target, moves):
    """adapt_gamma rescales the DE step after every chunk_gens
    generations by exp(clip(acceptance - target, -0.25, 0.25))."""
    log_post_b = lambda p: -0.5 * torch.sum(((p - T(MU)) / T(SIG))**2, 1)
    results = samplers.sample_demc(
        log_post_b, T(_chains(2)), nsamples=NCHAINS * 20,
        generator=torch.Generator().manual_seed(4), pstep=PSTEP,
        chunk_gens=5, adapt_gamma=adapt, target_acceptance=target,
    )
    gamma0 = 2.38 / np.sqrt(2.0 * np.sum(PSTEP > 0))
    ratio = results['gamma_final'] / gamma0
    assert np.sign(np.log(ratio)) == moves
    # Four chunks, each factor within exp(+-0.25):
    assert np.exp(-1.0) - 1e-12 <= ratio <= np.exp(1.0) + 1e-12


@pytest.fixture(scope='module')
def retrieval(tmp_path_factory):
    """Flagship at test size with 30 ppm synthetic data."""
    workdir = str(tmp_path_factory.mktemp('torch_sampler'))
    model, obs, ret, forward, p0 = make_flagship(
        workdir, nlayers=15, wl_low=1.1, wl_high=1.3, wnstep=8.0,
        device='cpu')
    band = forward(p0)['bandflux'].numpy()
    rng = np.random.default_rng(1)
    obs.data = band + rng.normal(0, 3e-5, len(band))
    obs.uncert = np.full(len(band), 3e-5)
    return workdir, model, obs, ret, p0


def test_demc_recovers_truth(retrieval):
    """T_irr, log_H2O and R_planet free (the opacity scale and the
    cloud parameters fixed, which the 20 bands barely constrain)."""
    _, model, obs, ret, truth = retrieval
    log_post_b = build_log_posterior_batched(model, obs, ret)
    assert np.isfinite(log_post_b(truth[None]).item())
    pstep = ret.pstep.copy()
    pstep[[0, 4, 5]] = 0.0
    results = samplers.sample_demc(
        log_post_b, ret.params, nsamples=20 * 900,
        generator=torch.Generator().manual_seed(3), nchains=20,
        pstep=pstep, pmin=ret.pmin, pmax=ret.pmax, burnin=450,
    )
    assert 0.05 < results['acceptance_rate'] < 0.95
    posterior = results['posterior']
    for ipar in (1, 2, 3):          # T_irr, log_H2O, R_planet
        lo, hi = np.percentile(posterior[:, ipar], [0.5, 99.5])
        assert lo - 0.5 <= truth[ipar] <= hi + 0.5, ipar
    for ipar in (0, 4, 5, 6):       # fixed parameters do not move
        assert np.ptp(posterior[:, ipar]) == 0.0
    gr = samplers.gelman_rubin(results['chain_history'][450:])
    assert np.all(gr[pstep > 0] < 1.5), gr


def test_run_retrieval_writes_results(retrieval):
    from pyratbay_tpu_torch.retrieval.driver import run_retrieval
    workdir, model, obs, _, _ = retrieval
    cfg = model.cfg
    cfg.data, cfg.uncert = obs.data, obs.uncert
    cfg.filters = [f'tophat {wl0:.4f} 0.01'
                   for wl0 in np.linspace(1.13, 1.27, len(obs.data))]
    cfg.nsamples, cfg.nchains, cfg.burnin = 200, 10, 5
    results = run_retrieval(model, seed=2)
    out = np.load(os.path.join(workdir, 'flagship.npz'))
    for key in ('posterior', 'bestp', 'best_log_post', 'spec_best',
                'bandflux_best'):
        assert np.all(np.isfinite(out[key])), key
    assert out['posterior'].shape == (10 * 15, 7)
    assert out['spec_best'].shape == (model.nwave,)
    np.testing.assert_array_equal(out['bestp'], results['bestp'])
