"""Transit above 64 layers: the tall kernel's operand layout and size
rule, its plain version's two line-sample routes, and the 81-layer
batched forward and log-posterior against pyratbay_tpu's, float64 on
the CPU.

The forwards run the flagship's tables on 81 layers at test width
(1.1-1.3 um, wnstep 4), with a deck high in the atmosphere and a
rejected chain; rtol 1e-8, the slice bound of
tests/test_torch_forward.py.  The kernel itself runs only on a GPU:
tests/test_torch_cuda.py holds it against the plain version there.
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
from pyratbay_tpu_torch import model as model_mod  # noqa: E402
from pyratbay_tpu_torch.atmosphere.geometry import (  # noqa: E402
    transit_path_matrix,
)
from pyratbay_tpu_torch.model import Model  # noqa: E402
from pyratbay_tpu_torch.observation import Observation  # noqa: E402
from pyratbay_tpu_torch.retrieval.batched import (  # noqa: E402
    build_forward_batched, build_log_posterior_batched, line_sample_table,
)
from pyratbay_tpu_torch.retrieval.params import RetrievalParams  # noqa: E402
from pyratbay_tpu_torch.spectrum import transit_kernel as tk  # noqa: E402

RTOL = 1e-8
NLAYERS = 81
T = lambda a: torch.as_tensor(np.array(a))


class _ObsCfg:
    data = None
    uncert = None
    filters = [f'tophat {wl0:.4f} 0.01'
               for wl0 in np.linspace(1.13, 1.27, 20)]
    obsfile = None
    dunits = None
    offset_inst = None
    uncert_scaling = None


@pytest.fixture(scope='module')
def flagship(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp('torch_tall'))
    jax_objs = make_flagship(workdir, nlayers=NLAYERS, wl_low=1.1,
                             wl_high=1.3, wnstep=4.0)
    return workdir, jax_objs


def _port(workdir, rt_path='transit'):
    cfg = workdir + '/flagship.cfg'
    if rt_path != 'transit':
        with open(cfg) as f:
            text = f.read().replace('rt_path = transit',
                                    f'rt_path = {rt_path}')
        cfg = workdir + f'/flagship_{rt_path}.cfg'
        with open(cfg, 'w') as f:
            f.write(text)
    model = Model(cfg, device='cpu')
    obs = Observation(_ObsCfg, model.wn)
    return model, obs, RetrievalParams(model, obs)


def _params(p0, n=6, seed=0):
    rng = np.random.default_rng(seed)
    pb = np.tile(p0, (n, 1)) + 0.05 * rng.standard_normal((n, len(p0)))
    pb[1, 4] = -2.0       # a deck high in the atmosphere
    pb[-1, 1] = 1.0e6     # T_irr blow-up: rejected chain
    return pb


def test_batched_forward_and_log_posterior_81_layers(flagship, monkeypatch):
    """The 81-layer transit forward hands the line sample to the RT
    wrapper as ls_w / ls_tab (no dense part), and its spectra, band
    fluxes and log-posterior equal pyratbay_tpu's."""
    workdir, (jmodel, jobs, jret, _, p0) = flagship
    model, obs, ret = _port(workdir)
    assert model.nlayers == NLAYERS
    seen = {}
    real = model_mod.transit_spectrum_ensemble

    def recorder(ec_parts, *args, **kw):
        seen['parts'], seen['kw'] = list(ec_parts), kw
        return real(ec_parts, *args, **kw)

    monkeypatch.setattr(model_mod, 'transit_spectrum_ensemble', recorder)
    pb = _params(p0)
    ref = jax.jit(jbuild_forward_batched(jmodel, jobs, jret))(
        jnp.asarray(pb))
    got = build_forward_batched(model, obs, ret)(pb)
    assert not seen['parts']
    assert seen['kw']['ls_w'].shape == (len(pb), 10, NLAYERS)
    assert seen['kw']['ls_tab'].shape == (10, NLAYERS, model.nwave)

    good = np.asarray(ref['good'])
    np.testing.assert_array_equal(got['good'].numpy(), good)
    assert good[:-1].all() and not good[-1]
    np.testing.assert_allclose(
        got['spectrum'].numpy(), np.asarray(ref['spectrum']), rtol=RTOL)
    band, jband = got['bandflux'].numpy(), np.asarray(ref['bandflux'])
    np.testing.assert_array_equal(np.isinf(band), np.isinf(jband))
    np.testing.assert_allclose(band[good], jband[good], rtol=RTOL)

    # Data a few sigma off the first chain's bands, so that no log-
    # posterior is a sum of residuals at the forwards' rounding:
    data = jband[0] * (1 + 1e-2 * np.sin(np.arange(len(jband[0]))))
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
    assert fin.sum() >= 3
    np.testing.assert_allclose(lp[fin], jlp[fin], rtol=RTOL)


def test_line_sample_rule_per_rt_path(flagship):
    """ls_in_kernel and line_sample_table per RT path: above 64 layers
    the transit kernel takes the table (up to its weights' budget),
    the emission kernel does not; up to 64 layers both take it when the
    wave-tile slab fits."""
    for rt_path in ('transit', 'eclipse', 'emission'):
        assert tk.ls_in_kernel(10, 51, rt_path)
        assert tk.ls_in_kernel(8, 64, rt_path)
        assert not tk.ls_in_kernel(20, 51, rt_path)
    assert tk.ls_in_kernel(10, 65, 'transit')
    assert tk.ls_in_kernel(10, 81, 'transit')
    assert tk.ls_in_kernel(10, 250, 'transit')
    assert not tk.ls_in_kernel(10, 81, 'eclipse')
    assert not tk.ls_in_kernel(10, 81, 'emission')
    assert not tk.ls_in_kernel(10, 65, 'f_lambda')
    # A chain's weights beyond the tall function's budget stay a dense
    # part: 100 rows x 84 padded layers x 4 bytes > 32 KB.
    assert tk.ls_in_kernel(96, 81, 'transit')
    assert not tk.ls_in_kernel(100, 81, 'transit')
    workdir, _ = flagship
    transit, _, _ = _port(workdir)
    table = line_sample_table(transit)
    assert table is not None
    assert table.shape == (10, NLAYERS, transit.nwave)
    eclipse, _, _ = _port(workdir, 'eclipse')
    assert line_sample_table(eclipse) is None


def _plain_operands(nb, nlayers, nwave, seed):
    rng = np.random.default_rng(seed)
    radius = np.sort(
        rng.uniform(1.0, 1.1, (nb, nlayers)), axis=1)[:, ::-1].copy()
    ec = rng.lognormal(-4.0, 1.5, (nb, nlayers, nwave)) \
        * np.exp(np.linspace(0.0, 7.0, nlayers))[:, None]
    ls_w = np.zeros((nb, 10, nlayers))
    tlo = rng.integers(0, 9, (nb, nlayers))
    frac = rng.random((nb, nlayers))
    b, j = np.meshgrid(np.arange(nb), np.arange(nlayers), indexing='ij')
    ls_w[b, tlo, j] = 1 - frac
    ls_w[b, tlo + 1, j] = frac
    ls_tab = rng.lognormal(-3.0, 2.0, (10, nlayers, nwave)) \
        * np.exp(np.linspace(0.0, 7.0, nlayers))[None, :, None]
    return radius, ec, ls_w, ls_tab


@pytest.mark.parametrize('nlayers', [65, 81])
@pytest.mark.parametrize('with_deck', [True, False])
def test_plain_line_sample_routes_agree_above_64_layers(nlayers, with_deck):
    """The plain version takes ls_w / ls_tab at any layer count: the
    in-kernel route's operands give the spectrum of the dense part the
    einsum makes, rtol 1e-12, with the deck, a lowered top and a
    rejected chain (its top beyond the layers)."""
    nb, nwave = 4, 60
    radius, ec, ls_w, ls_tab = _plain_operands(nb, nlayers, nwave, seed=3)
    itop = np.array([0, 2, 0, 10**6])
    path = transit_path_matrix(T(radius), T(np.clip(itop, 0, nlayers - 1)))
    if with_deck:
        deck_itop = np.array([nlayers - 1, 30, 50, 40])
        rsurf = radius[np.arange(nb), deck_itop] + 0.3 * (
            radius[np.arange(nb), deck_itop - 1]
            - radius[np.arange(nb), deck_itop])
        deck = dict(deck_itop=T(deck_itop), deck_rsurf=T(rsurf))
        ibottom = deck_itop + 1
    else:
        deck, ibottom = {}, np.full(nb, nlayers)
    args = (path, T(radius), 12.0, T(itop), T(ibottom))
    got = tk.transit_spectrum_ensemble(
        [T(ec)], *args, ls_w=T(ls_w), ls_tab=T(ls_tab), maxdepth=10.0,
        **deck).numpy()
    dense = np.einsum('bkl,klw->blw', ls_w, ls_tab)
    want = tk.transit_spectrum_ensemble(
        [T(ec), T(dense)], *args, maxdepth=10.0, **deck).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert np.all(np.isfinite(got))


@pytest.mark.parametrize('nlayers', [65, 81, 100, 250])
def test_tall_layout_reproduces_the_chord_product(nlayers):
    """The tall function's packed chord matrix, read the way the kernel
    reads it (pass p of TALL_ROWS rows from TALL_ROWS * TALL_ROWS *
    p (p + 1) / 2, TALL_ROWS floats a layer, layers up to the pass's last
    row rounded up to 8), gives path2 @ ec; the rows and layers past the
    last hold zeros."""
    rng = np.random.default_rng(nlayers)
    radius = np.sort(rng.uniform(1.0, 1.1, (1, nlayers)), axis=1)[:, ::-1]
    path = transit_path_matrix(T(radius.copy()), T(np.array([1])))
    path2 = tk.prep_chains(path, T(radius.copy()), 10.0, T(np.array([1])),
                           T(np.array([nlayers])))[0][0].numpy()
    assert np.all(np.triu(path2, 1) == 0)
    nr = tk.TALL_ROWS
    npass = -(-nlayers // nr)
    rows = -(-nlayers // 8) * 8
    packed = np.append(path2.ravel(), 0.0)[tk.tall_layout(nlayers)]
    assert len(packed) == sum(nr * min(rows, nr * (p + 1))
                              for p in range(npass))
    ec = rng.lognormal(0.0, 1.0, nlayers)
    depth = np.zeros(npass * nr)
    for p in range(npass):
        offset = nr * nr * p * (p + 1) // 2
        for j in range(min(rows, nr * (p + 1))):
            col = packed[offset + j * nr:offset + (j + 1) * nr]
            if j < nlayers:
                depth[p * nr:(p + 1) * nr] += col * ec[j]
            else:
                assert np.all(col == 0)
    np.testing.assert_allclose(depth[:nlayers], path2 @ ec, rtol=1e-13)
    assert np.all(depth[nlayers:] == 0)
