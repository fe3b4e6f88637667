"""Whole-slice parity: the port's batched forward and log-posterior
against pyratbay_tpu's, both set up from the same flagship files at
test size (21 layers, 1.1-1.3 um, wnstep 4), float64 on the CPU,
rtol 1e-8 (the bound of tests/test_batched.py's fused-assembly
check), including an out-of-bounds chain.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pyratbay_tpu.benchmark import make_flagship  # noqa: E402
from pyratbay_tpu.retrieval.batched import (  # noqa: E402
    build_forward_batched as jbuild_forward_batched,
    build_log_posterior_batched as jbuild_log_posterior_batched,
)
from pyratbay_tpu_torch import convert  # noqa: E402
from pyratbay_tpu_torch.model import Model  # noqa: E402
from pyratbay_tpu_torch.observation import Observation  # noqa: E402
from pyratbay_tpu_torch.retrieval.batched import (  # noqa: E402
    build_forward_batched, build_log_posterior_batched,
)
from pyratbay_tpu_torch.retrieval.forward import build_forward  # noqa: E402
from pyratbay_tpu_torch.retrieval.params import RetrievalParams  # noqa: E402

RTOL = 1e-8


class _ObsCfg:
    data = None
    uncert = None
    filters = [f'tophat {wl0:.4f} 0.01'
               for wl0 in np.linspace(1.13, 1.27, 20)]
    obsfile = None
    dunits = None
    offset_inst = None
    uncert_scaling = None


def _port_setup(workdir):
    model = Model(workdir + '/flagship.cfg', device='cpu')
    obs = Observation(_ObsCfg, model.wn)
    return model, obs, RetrievalParams(model, obs)


@pytest.fixture(scope='module')
def flagship(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp('torch_forward'))
    jax_objs = make_flagship(
        workdir, nlayers=21, wl_low=1.1, wl_high=1.3, wnstep=4.0)
    return workdir, jax_objs, _port_setup(workdir)


def _params(p0, n=6, seed=0):
    rng = np.random.default_rng(seed)
    pb = np.tile(p0, (n, 1)) + 0.05 * rng.standard_normal((n, len(p0)))
    pb[-1, 1] = 1.0e6     # T_irr blow-up: rejected chain
    return pb


def test_batched_forward_and_log_posterior(flagship):
    _, (jmodel, jobs, jret, jforward, p0), (model, obs, ret) = flagship
    pb = _params(p0)
    ref = jax.jit(jbuild_forward_batched(jmodel, jobs, jret))(
        jnp.asarray(pb))
    got = build_forward_batched(model, obs, ret)(pb)

    good = np.asarray(ref['good'])
    np.testing.assert_array_equal(got['good'].numpy(), good)
    assert good[:-1].all() and not good[-1]
    np.testing.assert_allclose(
        got['spectrum'].numpy(), np.asarray(ref['spectrum']), rtol=RTOL)
    np.testing.assert_allclose(
        got['temperature'].numpy(), np.asarray(ref['temperature']),
        rtol=RTOL)
    band, jband = got['bandflux'].numpy(), np.asarray(ref['bandflux'])
    np.testing.assert_array_equal(np.isinf(band), np.isinf(jband))
    np.testing.assert_allclose(band[good], jband[good], rtol=RTOL)

    # Log-posterior on synthetic data, with one chain out of the
    # prior bounds as well:
    data = jband[0] * (1 + 1e-4 * np.sin(np.arange(len(jband[0]))))
    pb[2, 3] = 5.0                    # R_planet above pmax
    try:
        for o in (jobs, obs):
            o.data = data
            o.uncert = np.full(len(data), 3e-5)
        jlp = np.asarray(jax.jit(jbuild_log_posterior_batched(
            jmodel, jobs, jret))(jnp.asarray(pb)))
        lp = build_log_posterior_batched(model, obs, ret)(pb).numpy()
    finally:
        for o in (jobs, obs):
            o.data = o.uncert = None
    np.testing.assert_array_equal(np.isinf(lp), np.isinf(jlp))
    assert np.isinf(lp[[2, 5]]).all() and (lp[[2, 5]] < 0).all()
    fin = np.isfinite(jlp)
    np.testing.assert_allclose(lp[fin], jlp[fin], rtol=RTOL)

    # The per-chain forward is the batched one at B = 1:
    one = build_forward(model, obs, ret)(pb[0])
    np.testing.assert_allclose(
        one['spectrum'].numpy(), got['spectrum'][0].numpy(), rtol=1e-14)


@pytest.mark.parametrize('route', ['in_kernel', 'dense_part'])
def test_batched_forward_line_sample_routes(flagship, monkeypatch, route):
    """The batched forward hands the line sample to the RT wrapper as
    ls_w / ls_tab when the table's slab fits the kernel (the flagship's
    does) and as a dense part otherwise; both agree with pyratbay_tpu's
    batched forward at the slice's bound."""
    from pyratbay_tpu_torch import model as model_mod
    from pyratbay_tpu_torch.retrieval import batched
    _, (jmodel, jobs, jret, _, p0), (model, obs, ret) = flagship
    if route == 'dense_part':
        monkeypatch.setattr(batched, 'ls_in_kernel',
                            lambda n_k, nl, rt_path: False)
    seen = {}
    real = model_mod.transit_spectrum_ensemble

    def recorder(ec_parts, *args, **kw):
        seen['parts'], seen['kw'] = list(ec_parts), kw
        return real(ec_parts, *args, **kw)

    monkeypatch.setattr(model_mod, 'transit_spectrum_ensemble', recorder)
    pb = _params(p0)[:-1]
    got = build_forward_batched(model, obs, ret)(pb)['spectrum'].numpy()
    ls = model.opacity_models[[m[0] for m in model.opacity_models].index(
        'line_sample')][1]
    if route == 'in_kernel':
        assert not seen['parts']
        assert seen['kw']['ls_w'].shape == (
            len(pb), ls.nspec * ls.ntemp, model.nlayers)
        assert seen['kw']['ls_tab'].shape == (
            ls.nspec * ls.ntemp, model.nlayers, model.nwave)
        # Two-hot along temperature: two weights a layer for one species.
        assert int((seen['kw']['ls_w'] != 0).sum(dim=1).max()) == 2
    else:
        assert len(seen['parts']) == 1 and seen['kw']['ls_w'] is None
    ref = jax.jit(jbuild_forward_batched(jmodel, jobs, jret))(
        jnp.asarray(pb))
    np.testing.assert_allclose(got, np.asarray(ref['spectrum']), rtol=RTOL)


def test_port_state_from_jax_arrays_equals_config_state(flagship):
    workdir, (jmodel, jobs, jret, _, p0), _ = flagship
    from_jax = convert.static_arrays(jmodel, jobs, jret)
    model, obs, ret = _port_setup(workdir)
    from_cfg = convert.static_arrays(model, obs, ret)
    assert from_jax.keys() == from_cfg.keys()
    tj, tc = convert.to_tensors(from_jax, 'cpu'), convert.to_tensors(
        from_cfg, 'cpu')
    for key in tj:
        if tj[key] is None:
            assert tc[key] is None, key
            continue
        assert tj[key].dtype == tc[key].dtype, key
        torch.testing.assert_close(tj[key], tc[key], rtol=1e-12, atol=0,
                                   msg=key)
    # Installing the JAX arrays leaves the port's forward unchanged:
    pb = torch.as_tensor(_params(p0, n=3))
    before = build_forward_batched(model, obs, ret)(pb)['spectrum']
    convert.load_static(model, obs, ret, from_jax)
    after = build_forward_batched(model, obs, ret)(pb)['spectrum']
    torch.testing.assert_close(after, before, rtol=1e-12, atol=0)
