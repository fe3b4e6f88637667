"""The plain reference (portbench/reference/) against the program's CPU
path (float64) at a small size: the same inputs give the same spectra,
band fluxes, temperatures, radii and log-posteriors, within what float64
round-off and the program's E_2 series allow."""
import numpy as np
import pytest
import torch

from portbench.models import flagship as fm
from portbench.reference import inputs
from portbench.reference.flagship import tf32
from portbench.tests import small


@pytest.fixture(scope='module', params=[
    {'wnstep': 20.0}, {'wnstep': None, 'resolution': 6000.0}],
    ids=['wnstep', 'resolution'])
def built(request, tmp_path_factory):
    config = small.config(**request.param)
    paths = inputs.write_inputs(config, str(tmp_path_factory.mktemp('in')))
    observed = fm.Observed(config, paths, 7)
    model, obs, ret = fm.build(config, paths, observed, 'cpu')
    return config, paths, observed, model, obs, ret


def _chains(ret, n=24, seed=0):
    rng = np.random.default_rng(seed)
    p = ret.params + 3 * ret.pstep * rng.standard_normal((n, len(ret.params)))
    return np.clip(p, ret.pmin, ret.pmax)


def test_batched_forward_and_log_posterior(built):
    from pyratbay_tpu_torch.retrieval.batched import (
        build_forward_batched, build_log_posterior_batched)
    config, paths, observed, model, obs, ret = built
    params = _chains(ret)
    ref = observed.reference
    want = ref.forward(params)
    got = build_forward_batched(model, obs, ret)(torch.as_tensor(params))
    np.testing.assert_allclose(got['spectrum'].numpy(), want['spectrum'],
                               rtol=1e-10)
    np.testing.assert_allclose(got['bandflux'].numpy(), want['bandflux'],
                               rtol=1e-10)
    np.testing.assert_allclose(got['temperature'].numpy(), want['temp'],
                               rtol=1e-8)
    lp = build_log_posterior_batched(model, obs, ret)(torch.as_tensor(params))
    want_lp = ref.log_post(params, observed.data, observed.uncert)
    assert np.all(np.isfinite(want_lp))
    np.testing.assert_allclose(lp.numpy(), want_lp, rtol=1e-9)


def test_prior_box_gives_minus_infinity(built):
    from pyratbay_tpu_torch.retrieval.batched import (
        build_log_posterior_batched)
    config, paths, observed, model, obs, ret = built
    params = _chains(ret, 4)
    params[0, 1] = ret.pmax[1] + 1.0
    params[1, 0] = ret.pmin[0] - 1.0
    lp = build_log_posterior_batched(model, obs, ret)(torch.as_tensor(params))
    want = observed.reference.log_post(params, observed.data,
                                       observed.uncert)
    assert np.array_equal(np.isfinite(lp.numpy()), np.isfinite(want))
    assert not np.isfinite(want[:2]).any()


def test_model_run_spectrum_temperature_radius(built):
    config, paths, observed, model, obs, ret = built
    params = _chains(ret, 3, seed=1)
    want = observed.reference.forward(params)
    names = [r[0] for r in config['retrieval_params']]
    for i, p in enumerate(params):
        tpars = np.array(config['tpars'], float)
        tpars[0], tpars[4] = p[names.index("log_kappa'")], p[1]
        pars_list = [None if getattr(m, 'npars', 0) == 0 else
                     np.array([p[names.index(n)] for n in m.pnames])
                     for _, m, _ in model.opacity_models]
        model.rplanet = p[names.index('R_planet')] * inputs.RJUP
        model.run(tpars=tpars, vmr_pars=[np.array([p[2]])],
                  pars_list=pars_list)
        np.testing.assert_allclose(model.spectrum, want['spectrum'][i],
                                   rtol=1e-10)
        np.testing.assert_allclose(model.temp, want['temp'][i], rtol=1e-8)
        np.testing.assert_allclose(model.radius, want['radius'][i],
                                   rtol=1e-10)
    model.rplanet = config['planet']['rplanet_rjup'] * inputs.RJUP


def test_tf32_rounding():
    x = np.array([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-10,
                  -3.0e-7, np.inf], np.float32)
    got = tf32(x)
    assert got[0] == 1.0 and got[1] == 1.0        # a tie to even
    assert got[2] == np.float32(1.0 + 2**-9)      # a tie to even, up
    assert got[3] == np.float32(1.0 + 2**-10)
    assert abs(got[4] / x[4] - 1) < 2**-11
    assert got[5] == np.inf


def test_inputs_are_rewritten_when_the_configuration_changes(tmp_path):
    """A checkout's inputs are reused only for the configuration and the
    writers they were written from."""
    config = small.config()
    paths = inputs.write_inputs(config, str(tmp_path))
    first = inputs.read_table(paths['table'])[3]
    stamp = np.load(paths['table'])['opacity'].sum()
    assert inputs.write_inputs(config, str(tmp_path)) == paths
    assert np.load(paths['table'])['opacity'].sum() == stamp
    changed = dict(config, table=dict(config['table'], seed=11))
    inputs.write_inputs(changed, str(tmp_path))
    second = inputs.read_table(paths['table'])[3]
    assert first.shape == second.shape
    assert not np.array_equal(first, second)
    with open(f"{paths['dir']}/complete") as f:
        assert f.read().strip() == inputs.inputs_key(changed)
