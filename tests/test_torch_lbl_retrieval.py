"""A retrieval of a line-by-line (TLI) model in the port against
pyratbay_tpu, float64 on the CPU.

The batched forward computes the TLI model's extinction with the direct
engine (DirectLBL.extinction_fn: per-line factors, then the plain
versions of K4 and K5 on the CPU), as the JAX package's forward does
(lbl_engine='direct', under vmap: its XLA path on the CPU, the plain
reference of its Pallas kernels).

* The batched forward and the log-posterior at B = 4 against the JAX
  package's vmap(build_forward) and its batched log-posterior (a vmap
  fallback for a TLI model): rtol 1e-10, the bound of
  tests/test_torch_lbl.py::test_extinction_fn_matches_jax, both in
  float64.
* A chain outside the TLI's temperature range is rejected as the JAX
  package rejects it (a zero spectrum, infinite band fluxes, -inf).
* extinction_fn's budget block gives what block = 4 gives, and the
  block follows the budget.
* run_retrieval (DEMC, a few generations) of the TLI model writes finite
  results and its post-processing files.

At test size: make_lbl_flagship's 3000 synthetic HITRAN H2O lines over
1.10-1.14 um at 1 cm-1 (318 points), 6 layers, a transit with an
isothermal T(p), the water abundance and the radius retrieved.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pyratbay_tpu.model import Model as JModel  # noqa: E402
from pyratbay_tpu.observation import Observation as JObservation  # noqa: E402
from pyratbay_tpu.retrieval.batched import (  # noqa: E402
    build_log_posterior_batched as jbuild_log_posterior_batched,
)
from pyratbay_tpu.retrieval.forward import (  # noqa: E402
    build_forward as jbuild_forward,
)
from pyratbay_tpu.retrieval.params import (  # noqa: E402
    RetrievalParams as JRetrievalParams,
)
from pyratbay_tpu_torch import benchmark  # noqa: E402
from pyratbay_tpu_torch.driver import run  # noqa: E402
from pyratbay_tpu_torch.model import Model  # noqa: E402
from pyratbay_tpu_torch.observation import Observation  # noqa: E402
from pyratbay_tpu_torch.opacity import lbl_direct  # noqa: E402
from pyratbay_tpu_torch.retrieval import driver as rdriver  # noqa: E402
from pyratbay_tpu_torch.retrieval.batched import (  # noqa: E402
    build_forward_batched, build_log_posterior_batched,
)
from pyratbay_tpu_torch.retrieval.params import RetrievalParams  # noqa: E402

RTOL = 1e-10
NLAYERS = 6

RETRIEVAL_KEYS = """rt_path = transit
tmodel = isothermal
tpars = 1200.0
vmr_vars = log_H2O -3.4
bulk = H2 He
rstar = 1.27 rsun
tstar = 5800.0
rplanet = 1.0 rjup
mplanet = 0.6 mjup
refpressure = 0.1 bar
radmodel = hydro_m
smaxis = 0.045 au
ndop = 4
nlor = 4
retrieval_params =
    T_iso      1200.0  300.0 2800.0 50.0
    log_H2O      -3.4   -9.0 -1.0  0.3
    R_planet      1.0    0.5  1.5  0.02
"""


class _ObsCfg:
    data = uncert = obsfile = dunits = offset_inst = uncert_scaling = None
    filters = [f'tophat {wl0:.4f} 0.002'
               for wl0 in np.linspace(1.103, 1.137, 8)]


@pytest.fixture(scope='module')
def lbl_retrieval(tmp_path_factory):
    """The TLI file, a retrieval config that reads it, and the Models,
    Observations and parameter spaces of both packages, with synthetic
    data from the JAX forward at the config's parameters."""
    workdir = str(tmp_path_factory.mktemp('lbl_retrieval'))
    _, tli_cfg, opacity_cfg = benchmark.make_lbl_flagship(
        workdir, nlines=3000, seed=0, nlayers=NLAYERS, wl_low=1.1,
        wl_high=1.14)
    run(tli_cfg, device='cpu')
    with open(opacity_cfg) as f:
        body = f.read().replace('runmode = opacity', 'runmode = retrieval')
    body = '\n'.join(ln for ln in body.splitlines() if not ln.startswith(
        ('sampled_cross_sec', 'tmin', 'tmax', 'tstep')))
    cfg = os.path.join(workdir, 'lbl_retrieval.cfg')
    with open(cfg, 'w') as f:
        f.write(body + '\n' + RETRIEVAL_KEYS)
    jmodel = JModel(cfg)
    jobs = JObservation(_ObsCfg, jmodel.wn)
    jret = JRetrievalParams(jmodel, jobs)
    band = np.asarray(jbuild_forward(jmodel, jobs, jret)(
        jnp.asarray(jret.params))['bandflux'])
    data = band * (1 + 2e-4 * np.sin(np.arange(len(band))))
    uncert = np.full(len(band), 5e-5)
    model = Model(cfg, device='cpu')
    obs = Observation(_ObsCfg, model.wn)
    for o in (jobs, obs):
        o.data, o.uncert = data, uncert
    return dict(workdir=workdir, cfg=cfg, jax=(jmodel, jobs, jret),
                port=(model, obs, RetrievalParams(model, obs)))


def _params(p0, lbl):
    """Four chains around p0: the last above the TLI's temperature
    range."""
    rng = np.random.default_rng(2)
    pb = np.tile(p0, (4, 1)) + [50.0, 0.3, 0.02] * rng.standard_normal(
        (4, len(p0)))
    pb[-1, 0] = lbl.tmax + 100.0
    return pb


def test_batched_forward_and_log_posterior_match_jax(lbl_retrieval):
    jmodel, jobs, jret = lbl_retrieval['jax']
    model, obs, ret = lbl_retrieval['port']
    assert [m[0] for m in model.opacity_models] == ['lbl']
    lbl = model.opacity_models[0][1]
    pb = _params(np.asarray(jret.params), lbl)
    # The JAX package's forward of a TLI model runs the direct engine
    # under vmap (its batched forward falls back to it):
    want = jax.jit(jax.vmap(jbuild_forward(jmodel, jobs, jret)))(
        jnp.asarray(pb))
    got = build_forward_batched(model, obs, ret)(pb)
    good = np.asarray(want['good'])
    np.testing.assert_array_equal(got['good'].numpy(), good)
    assert good[:-1].all() and not good[-1]
    for key in ('spectrum', 'temperature'):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=RTOL, atol=0, err_msg=key)
    band, jband = got['bandflux'].numpy(), np.asarray(want['bandflux'])
    np.testing.assert_array_equal(np.isinf(band), np.isinf(jband))
    np.testing.assert_allclose(band[good], jband[good], rtol=RTOL, atol=0)
    # The rejected chain's spectrum is zero in both:
    assert not got['spectrum'][-1].any()

    lp = build_log_posterior_batched(model, obs, ret)(pb).numpy()
    jlp = np.asarray(jax.jit(jbuild_log_posterior_batched(
        jmodel, jobs, jret))(jnp.asarray(pb)))
    np.testing.assert_array_equal(np.isfinite(lp), good)
    np.testing.assert_array_equal(np.isfinite(jlp), good)
    np.testing.assert_allclose(lp[good], jlp[good], rtol=RTOL, atol=0)


def test_chain_outside_tli_range_rejected(lbl_retrieval):
    """A chain hotter than the TLI's highest temperature (its partition
    functions end at 6000 K; the retrieval sets no thigh, so the TLI
    range is what rejects it) is rejected by both packages."""
    jmodel, jobs, jret = lbl_retrieval['jax']
    model, obs, ret = lbl_retrieval['port']
    lbl = model.opacity_models[0][1]
    assert ret.thigh == np.inf and model.tmax == {'lbl': lbl.tmax}
    pb = np.tile(np.asarray(jret.params), (3, 1))
    pb[1, 0] = lbl.tmax - 10.0
    pb[2, 0] = lbl.tmax + 10.0
    got = build_forward_batched(model, obs, ret)(pb)
    want = jax.jit(jax.vmap(jbuild_forward(jmodel, jobs, jret)))(
        jnp.asarray(pb))
    np.testing.assert_array_equal(got['good'].numpy(), [True, True, False])
    np.testing.assert_array_equal(np.asarray(want['good']),
                                  [True, True, False])
    assert not got['spectrum'][2].any() and np.all(
        np.isinf(got['bandflux'][2].numpy()))
    np.testing.assert_allclose(got['spectrum'][:2].numpy(),
                               np.asarray(want['spectrum'])[:2], rtol=RTOL)
    lp = build_log_posterior_batched(model, obs, ret)(pb).numpy()
    # The second chain lies above the prior's T_iso bound, the third
    # outside the TLI range:
    assert np.isfinite(lp[0]) and lp[1] == lp[2] == -np.inf


def test_extinction_fn_independent_of_block(lbl_retrieval, monkeypatch):
    """The budget block (every cell in one pass at this size) and 4 or 7
    cells a pass give the same extinction; factor_block follows the
    budget."""
    model = lbl_retrieval['port'][0]
    direct = model.direct_lbl(model.opacity_models[0][1])
    nlines = direct.tables()['l_lwn_hi'].shape[0]
    per_cell = lbl_direct._LINE_FACTORS * nlines * 8     # float64
    whole_block = direct.factor_block()
    assert whole_block == min(
        lbl_direct._FACTOR_BUDGET // per_cell, lbl_direct._MAX_CELLS)
    blocks = {}
    for budget in (3 * per_cell + 1, 7 * per_cell, 1):
        monkeypatch.setattr(lbl_direct, '_FACTOR_BUDGET', budget)
        blocks[budget] = direct.factor_block()
    monkeypatch.undo()
    assert list(blocks.values()) == [3, 7, 1]
    rng = np.random.default_rng(4)
    temp = torch.as_tensor(rng.uniform(400.0, 2600.0, (5, NLAYERS)))
    vmr = torch.as_tensor(model.base_vmr)
    dens = vmr * torch.as_tensor(model.press * 1e6)[:, None] / (
        1.380649e-16 * temp[..., None])
    assert whole_block >= temp.numel()
    got = direct.extinction_fn()(temp, dens)
    assert got.shape == (5, NLAYERS, model.nwave)
    assert torch.all(got >= 0) and torch.any(got > 0)
    for block in (4, 7):
        np.testing.assert_allclose(
            direct.extinction_fn(block=block)(temp, dens).numpy(),
            got.numpy(), rtol=1e-13, atol=0, err_msg=f'block {block}')


def test_run_retrieval_of_tli_model(lbl_retrieval, monkeypatch):
    """DEMC over the TLI model through run_retrieval: finite results,
    the post-processing files, the spectrum from the direct engine."""
    monkeypatch.setattr(rdriver, '_plots', lambda *a: None)   # time
    model, obs, _ = lbl_retrieval['port']
    cfg = model.cfg
    cfg.data, cfg.uncert = obs.data, obs.uncert
    cfg.filters = _ObsCfg.filters
    cfg.nsamples, cfg.nchains, cfg.burnin = 24, 8, 1
    results = rdriver.run_retrieval(model, seed=1)
    base = os.path.splitext(cfg.logfile)[0]
    out = np.load(base + '.npz')
    for key in ('posterior', 'bestp', 'best_log_post', 'spec_best',
                'bandflux_best'):
        assert np.all(np.isfinite(out[key])), key
    assert out['posterior'].shape == (8 * 2, 3)
    assert out['spec_best'].shape == (model.nwave,)
    np.testing.assert_array_equal(out['bestp'], results['bestp'])
    for suffix in ('_temperature_posterior.npz', '_spectrum_posterior.npz',
                   '_median.atm', '_band_contribution.npz'):
        assert os.path.isfile(base + suffix), suffix
