"""The emission/eclipse slice of the port against pyratbay_tpu, float64
on the CPU.

* K3: the emission kernel's plain version against the per-chain
  rt.plane_parallel_depth + plane_parallel_intensity route (rtol 1e-12)
  and against the Pallas kernel in interpret mode (rtol 1e-10: the
  Pallas kernel's depth is a matrix product and its Planck uses
  exp - 1 where the port uses expm1); with the line-sample operands
  (ls_w, ls_tab) against the einsum's dense part (1e-12) and the Pallas
  kernel's in-kernel contraction.
* The plain RT pieces against pyratbay_tpu's (rtol 1e-12).
* The eclipse flagship at test size (21 layers, 1.1-1.3 um, wnstep 4):
  batched forward and log-posterior against the JAX package at rtol
  1e-8 (the bound of tests/test_batched.py's fused-assembly check),
  including rejected and out-of-bounds chains, and the emission,
  f_lambda and T_eff/f_dilution variants.

The CUDA kernel itself runs only on a GPU: tests/test_torch_cuda.py
holds it against this plain version there.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pyratbay_tpu.benchmark import make_flagship  # noqa: E402
from pyratbay_tpu.model import Model as JModel  # noqa: E402
from pyratbay_tpu.observation import Observation as JObservation  # noqa: E402
from pyratbay_tpu.ops.planck import blackbody_wn as jblackbody  # noqa: E402
from pyratbay_tpu.retrieval import RetrievalParams as JRetrievalParams  # noqa: E402
from pyratbay_tpu.retrieval.batched import (  # noqa: E402
    build_forward_batched as jbuild_forward_batched,
    build_log_posterior_batched as jbuild_log_posterior_batched,
)
from pyratbay_tpu.spectrum import rt as jrt  # noqa: E402
from pyratbay_tpu.spectrum.emission_pallas import (  # noqa: E402
    emission_flux_ensemble as jemission,
)
from pyratbay_tpu_torch import convert  # noqa: E402
from pyratbay_tpu_torch.model import Model  # noqa: E402
from pyratbay_tpu_torch.observation import Observation  # noqa: E402
from pyratbay_tpu_torch.ops.planck import blackbody_wn  # noqa: E402
from pyratbay_tpu_torch.retrieval.batched import (  # noqa: E402
    build_forward_batched, build_log_posterior_batched,
)
from pyratbay_tpu_torch.retrieval.forward import build_forward  # noqa: E402
from pyratbay_tpu_torch.retrieval.params import RetrievalParams  # noqa: E402
from pyratbay_tpu_torch.spectrum import emission_kernel as ek  # noqa: E402
from pyratbay_tpu_torch.spectrum import rt  # noqa: E402

RTOL_RT = 1e-12
RTOL_PALLAS = 1e-10
RTOL_SLICE = 1e-8
T = lambda a: torch.as_tensor(np.array(a))


# ----------------------------------------------------------------------
# K3 module parity

def _setup(nb=5, nlayers=40, nwave=300, seed=0):
    """test_emission_pallas.py::_setup's operands, float64."""
    rng = np.random.default_rng(seed)
    radius = np.linspace(7.2e9, 7.0e9, nlayers)
    radius = np.broadcast_to(radius, (nb, nlayers)).copy()
    radius *= (1 + 0.01 * rng.standard_normal((nb, 1)))
    temp = 1200 + 500 * rng.random((nb, nlayers))
    ec = rng.lognormal(-25.0, 2.0, (nb, nlayers, nwave))
    ec *= np.exp(np.linspace(0, 10, nlayers))[None, :, None]
    wn = np.linspace(2000.0, 9000.0, nwave)
    return rng, ec, radius, temp, wn


def _raygrid(angles=(0.0, 20.0, 40.0, 60.0, 80.0)):
    """Model._setup_quadrature's raygrid angles and weights."""
    raygrid = np.deg2rad(angles)
    bounds = np.linspace(0, 0.5 * np.pi, len(raygrid) + 1)
    bounds[1:-1] = 0.5 * (raygrid[:-1] + raygrid[1:])
    return np.cos(raygrid), np.pi * (
        np.sin(bounds[1:])**2 - np.sin(bounds[:-1])**2)


def _reference_one(ec, radius, temp, wn, mu, weights, maxdepth,
                   rtop, ibottom, deck_itop=None, deck_tsurf=None):
    """pyratbay_tpu Model._run_emission's math for one chain
    (test_emission_pallas.py::_reference_one)."""
    depth, ideep = jrt.plane_parallel_depth(
        jnp.asarray(ec), jnp.asarray(radius), maxdepth, rtop, ibottom)
    bbody = jblackbody(jnp.asarray(wn), jnp.asarray(temp)[:, None])
    if deck_itop is not None:
        bbody = bbody.at[deck_itop].set(
            jblackbody(jnp.asarray(wn), deck_tsurf))
        ideep = jnp.clip(ideep, 0, deck_itop)
    intensity = jrt.plane_parallel_intensity(depth, bbody, mu, ideep, rtop)
    return np.asarray(
        jnp.sum(intensity * jnp.asarray(weights)[:, None], axis=0))


_CASES = {
    'maxdepth_inf': dict(maxdepth=np.inf),
    'maxdepth_10': dict(maxdepth=10.0),
    'maxdepth_1': dict(maxdepth=1.0),
    'raised_itop': dict(maxdepth=8.0, itop=[0, 2, 5, 1, 3]),
    'two_parts': dict(maxdepth=8.0, two_parts=True),
    'deck': dict(maxdepth=10.0, itop=[0, 2, 0, 1, 3],
                 deck_itop=[25, 30, 20, 35, 2],
                 deck_tsurf=[1500.0, 1300.0, 1700.0, 1400.0, 1600.0]),
    'cia': dict(maxdepth=5.0, cia=True),
    'rank1': dict(maxdepth=6.0, rank1=True),
    'gauss4_all': dict(maxdepth=4.0, nquad=4, itop=[0, 1, 0, 3, 0],
                       two_parts=True, cia=True, rank1=True,
                       deck_itop=[38, 39, 10, 30, 25],
                       deck_tsurf=[1450.0, 1350.0, 1650.0, 1250.0, 1550.0]),
}


@pytest.mark.parametrize('case', list(_CASES))
def test_plain_matches_rt_route_and_pallas(case):
    opts = _CASES[case]
    rng, ec, radius, temp, wn = _setup(seed=len(case))
    nb, nlayers, nwave = ec.shape
    maxdepth = opts['maxdepth']
    if 'nquad' in opts:
        mu, weights = rt.gauss_quadrature(opts['nquad'])
    else:
        mu, weights = _raygrid()
    itop = np.array(opts.get('itop', np.zeros(nb, int)))
    deck_itop = opts.get('deck_itop')
    deck_tsurf = opts.get('deck_tsurf')
    if deck_itop is not None:
        deck_itop, deck_tsurf = np.array(deck_itop), np.array(deck_tsurf)
        ibottom = deck_itop + 1
    else:
        ibottom = np.full(nb, nlayers)
    parts = [0.3 * ec, 0.7 * ec] if opts.get('two_parts') else [ec]
    cia_w = cia_tab = r1c = r1r = None
    ec_total = ec.copy()
    if opts.get('cia'):
        cia_w = rng.lognormal(-28.0, 1.0, (nb, nlayers, 6))
        cia_tab = rng.lognormal(0.0, 1.0, (6, nwave))
        ec_total += cia_w @ cia_tab
    if opts.get('rank1'):
        r1c = rng.lognormal(-24.0, 1.0, (nb, 2, nlayers))
        r1r = rng.lognormal(0.0, 1.0, (nb, 2, nwave))
        ec_total += np.einsum('brl,brw->blw', r1c, r1r)

    got = ek.emission_flux_ensemble(
        [T(p) for p in parts], T(radius), T(temp), wn, mu, weights,
        T(itop), T(ibottom),
        deck_itop=None if deck_itop is None else T(deck_itop),
        deck_tsurf=None if deck_tsurf is None else T(deck_tsurf),
        cia_w=None if cia_w is None else T(cia_w),
        cia_tab=None if cia_tab is None else T(cia_tab),
        r1_cols=None if r1c is None else T(r1c),
        r1_rows=None if r1r is None else T(r1r), maxdepth=maxdepth,
    ).numpy()

    ref = np.stack([_reference_one(
        ec_total[b], radius[b], temp[b], wn, mu, weights, maxdepth,
        int(itop[b]), int(ibottom[b]),
        None if deck_itop is None else int(deck_itop[b]),
        None if deck_tsurf is None else float(deck_tsurf[b]),
    ) for b in range(nb)])

    pallas = np.asarray(jemission(
        [jnp.asarray(p) for p in parts], jnp.asarray(radius),
        jnp.asarray(temp), wn, mu, weights, jnp.asarray(itop),
        jnp.asarray(ibottom),
        deck_itop=None if deck_itop is None else jnp.asarray(deck_itop),
        deck_tsurf=None if deck_tsurf is None else jnp.asarray(deck_tsurf),
        cia_w=None if cia_w is None else jnp.asarray(cia_w),
        cia_tab=cia_tab,
        r1_cols=None if r1c is None else jnp.asarray(r1c[..., None]),
        r1_rows=None if r1r is None else jnp.asarray(r1r[:, :, None, :]),
        maxdepth=maxdepth, interpret=True, chain_block=nb,
    ))
    # Each pair's largest relative difference by chain, so that a failure
    # tells which of the three routes moved:
    report = {name: np.max(np.abs(a / b - 1), axis=1).tolist()
              for name, (a, b) in {'port/jax': (got, ref),
                                   'port/pallas': (got, pallas),
                                   'jax/pallas': (ref, pallas)}.items()}
    np.testing.assert_allclose(got, ref, rtol=RTOL_RT, err_msg=str(report))
    np.testing.assert_allclose(got, pallas, rtol=RTOL_PALLAS,
                               err_msg=str(report))


_STATES = {
    'torch_threads_1': dict(threads=1),
    'torch_threads_3': dict(threads=3),
    'flush_denormal': dict(flush_denormal=True),
    'after_pallas_interpreter': dict(pallas_first=True),
}


@pytest.mark.parametrize('state', list(_STATES))
def test_plain_emission_is_independent_of_process_state(state):
    """The maxdepth_inf case of test_plain_matches_rt_route_and_pallas
    (whose columns reach optical depths of ~1,200, so exp(-tau/mu)
    passes through subnormals) under process state that earlier tests
    of an xdist worker may leave behind: another torch thread count
    (which moves the split between the vectorised body and the scalar
    tail of torch's CPU kernels), flush-to-zero of subnormals, and a
    Pallas interpretation of the same case run first in the process.
    The port's result is the same to the last bit and stays within
    rtol 1e-12 of the per-chain JAX route.  (This case has been seen off
    by 4.8e-9 on one chain, twice, in runs of the whole suite under
    several workers; these states do not reproduce that, see ROADMAP.md
    section C.)"""
    opts = _STATES[state]
    case = 'maxdepth_inf'
    _, ec, radius, temp, wn = _setup(seed=len(case))
    nb, nlayers, _ = ec.shape
    mu, weights = _raygrid()
    itop, ibottom = np.zeros(nb, int), np.full(nb, nlayers)

    def port():
        return ek.emission_flux_ensemble(
            [T(ec)], T(radius), T(temp), wn, mu, weights, T(itop),
            T(ibottom), maxdepth=np.inf).numpy()

    before = port()
    threads = torch.get_num_threads()
    try:
        if 'threads' in opts:
            torch.set_num_threads(opts['threads'])
        if opts.get('flush_denormal'):
            assert torch.set_flush_denormal(True)
        if opts.get('pallas_first'):
            np.asarray(jemission(
                [jnp.asarray(ec)], jnp.asarray(radius), jnp.asarray(temp),
                wn, mu, weights, jnp.asarray(itop), jnp.asarray(ibottom),
                maxdepth=np.inf, interpret=True, chain_block=nb))
        got = port()
    finally:
        torch.set_num_threads(threads)
        torch.set_flush_denormal(False)
    np.testing.assert_array_equal(got, before)
    ref = np.stack([_reference_one(
        ec[b], radius[b], temp[b], wn, mu, weights, np.inf, 0, nlayers)
        for b in range(nb)])
    np.testing.assert_allclose(got, ref, rtol=RTOL_RT)


@pytest.mark.parametrize('case', ['beside_a_part', 'with_everything'])
def test_plain_line_sample_operands(case):
    """ls_w / ls_tab in the plain version: equal to the einsum's dense
    part (1e-12) and to the Pallas kernel's in-kernel contraction, run
    as tests/test_emission_pallas.py runs it (interpret mode, the
    operands of its test_emission_ensemble_inkernel_line_sample)."""
    rng, ec, radius, temp, wn = _setup(seed=13)
    nb, nlayers, nwave = ec.shape
    mu, weights = _raygrid()
    nk = 6
    ls_w = rng.lognormal(-2.0, 1.0, (nb, nk, nlayers))
    ls_w[:, ::2] *= (rng.random((nb, nk // 2, nlayers)) < 0.5)  # zeros too
    ls_tab = rng.lognormal(-24.0, 1.5, (nk, nlayers, nwave))
    itop = np.array([0, 1, 0, 3, 0])
    extra, jextra = {}, {}
    ibottom = np.full(nb, nlayers)
    if case == 'with_everything':
        cia_w = rng.lognormal(-28.0, 1.0, (nb, nlayers, 6))
        cia_tab = rng.lognormal(0.0, 1.0, (6, nwave))
        r1c = rng.lognormal(-24.0, 1.0, (nb, 2, nlayers))
        r1r = rng.lognormal(0.0, 1.0, (nb, 2, nwave))
        deck_itop = np.array([38, 39, 10, 30, 25])
        deck_tsurf = np.array([1450.0, 1350.0, 1650.0, 1250.0, 1550.0])
        ibottom = deck_itop + 1
        extra = dict(cia_w=T(cia_w), cia_tab=T(cia_tab), r1_cols=T(r1c),
                     r1_rows=T(r1r), deck_itop=T(deck_itop),
                     deck_tsurf=T(deck_tsurf))
        jextra = dict(cia_w=jnp.asarray(cia_w), cia_tab=cia_tab,
                      r1_cols=jnp.asarray(r1c[..., None]),
                      r1_rows=jnp.asarray(r1r[:, :, None, :]),
                      deck_itop=jnp.asarray(deck_itop),
                      deck_tsurf=jnp.asarray(deck_tsurf))
    common = (T(radius), T(temp), wn, mu, weights, T(itop), T(ibottom))
    got = ek.emission_flux_ensemble(
        [T(ec)], *common, ls_w=T(ls_w), ls_tab=T(ls_tab), maxdepth=6.0,
        **extra).numpy()

    dense = np.einsum('bkl,klw->blw', ls_w, ls_tab)
    ref = ek.emission_flux_ensemble(
        [T(ec), T(dense)], *common, maxdepth=6.0, **extra).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL_RT)

    pallas = np.asarray(jemission(
        [jnp.asarray(ec)], jnp.asarray(radius), jnp.asarray(temp), wn, mu,
        weights, jnp.asarray(itop), jnp.asarray(ibottom),
        ls_w=jnp.asarray(ls_w[..., None]), ls_tab=ls_tab,
        maxdepth=6.0, interpret=True, chain_block=2, **jextra))
    np.testing.assert_allclose(got, pallas, rtol=RTOL_PALLAS)


def test_plain_line_sample_alone_matches_float32_pallas():
    """No dense part: the Pallas kernel then runs in float32 and the
    bound is 1e-5."""
    rng, ec, radius, temp, wn = _setup(seed=21)
    nb, nlayers, nwave = ec.shape
    mu, weights = _raygrid()
    ls_w = rng.lognormal(-2.0, 1.0, (nb, 6, nlayers))
    ls_tab = rng.lognormal(-23.0, 1.5, (6, nlayers, nwave)) \
        * np.exp(np.linspace(0, 10, nlayers))[None, :, None]
    f32 = lambda a: np.asarray(a, np.float32).astype(float)
    radius, temp, ls_w, ls_tab = (f32(a) for a in (radius, temp, ls_w,
                                                   ls_tab))
    args = (T(radius), T(temp), wn, mu, weights, T(np.zeros(nb, int)),
            T(np.full(nb, nlayers)))
    got = ek.emission_flux_ensemble(
        [], *args, ls_w=T(ls_w), ls_tab=T(ls_tab), maxdepth=np.inf).numpy()
    pallas = np.asarray(jemission(
        [], jnp.asarray(radius), jnp.asarray(temp), wn, mu, weights,
        jnp.zeros(nb, int), jnp.full(nb, nlayers),
        ls_w=jnp.asarray(ls_w[..., None], jnp.float32),
        ls_tab=np.asarray(ls_tab, np.float32),
        maxdepth=np.inf, interpret=True, chain_block=2))
    assert pallas.dtype == np.float32
    np.testing.assert_allclose(got, pallas, rtol=1e-5)


def test_rejected_chain_stays_in_its_row():
    """A chain with T <= 0 and a diverged radius yields non-finite
    values only in its own row."""
    _, ec, radius, temp, wn = _setup(nb=3, nlayers=20, nwave=64, seed=4)
    mu, weights = _raygrid()
    temp[1, 3] = -50.0
    radius[1, :2] = np.inf
    got = ek.emission_flux_ensemble(
        [T(ec)], T(radius), T(temp), wn, mu, weights, T(np.zeros(3, int)),
        T(np.full(3, 20)), maxdepth=10.0).numpy()
    assert np.all(np.isfinite(got[[0, 2]]))
    assert not np.all(np.isfinite(got[1]))


def test_wrapper_routes_by_device(monkeypatch):
    """CPU tensors take the plain version and never reach the CUDA
    launcher; the TPU's layer-major operands are refused."""
    calls = []
    monkeypatch.setattr(ek, 'emission_rt_cuda',
                        lambda *a, **k: calls.append(1))
    _, ec, radius, temp, wn = _setup(nb=2, nlayers=12, nwave=16)
    mu, weights = _raygrid()
    args = ([T(ec)], T(radius), T(temp), wn, mu, weights,
            T(np.zeros(2, int)), T(np.full(2, 12)))
    out = ek.emission_flux_ensemble(*args)
    assert out.shape == (2, 16) and not calls
    with pytest.raises(NotImplementedError, match='B1'):
        ek.emission_flux_ensemble(*args, ec_parts_lbw=[T(ec)])


def test_cuda_launcher_rejects_cpu_tensors():
    """The CUDA launcher never computes on CPU tensors: it raises before
    building or launching anything, and counts no launch."""
    _, ec, radius, temp, wn = _setup(nb=2, nlayers=12, nwave=16)
    mu, weights = _raygrid()
    operands = ek.prep_emission_chains(
        T(radius), T(temp), T(np.zeros(2, int)), T(np.full(2, 12)))
    launches = ek.emission_rt_cuda.launches
    with pytest.raises(TypeError, match='CUDA tensor'):
        ek.emission_rt_cuda([T(ec)], *operands, T(wn), mu, weights)
    assert ek.emission_rt_cuda.launches == launches


# ----------------------------------------------------------------------
# Plain RT pieces

def test_blackbody_and_quadrature():
    wn = np.linspace(500.0, 12000.0, 50)
    temps = np.array([[300.0], [1450.0], [5800.0]])
    np.testing.assert_allclose(
        blackbody_wn(T(wn), T(temps)).numpy(),
        np.asarray(jblackbody(jnp.asarray(wn), jnp.asarray(temps))),
        rtol=RTOL_RT)
    for nquad in (1, 4, 7):
        mu, weights = rt.gauss_quadrature(nquad)
        jmu, jweights = jrt.gauss_quadrature(nquad)
        np.testing.assert_allclose(mu, jmu, rtol=RTOL_RT)
        np.testing.assert_allclose(weights, jweights, rtol=RTOL_RT)


@pytest.mark.parametrize('maxdepth', [np.inf, 3.0])
def test_plane_parallel_depth_and_intensity(maxdepth):
    _, ec, radius, temp, wn = _setup(nb=3, nlayers=25, nwave=80, seed=6)
    mu, _ = _raygrid()
    itop, ibottom = np.array([0, 3, 1]), np.array([25, 25, 14])
    depth, ideep = rt.plane_parallel_depth(
        T(ec), T(radius), maxdepth, T(itop), T(ibottom))
    bbody = blackbody_wn(T(wn), T(temp)[:, :, None])
    inten = rt.plane_parallel_intensity(depth, bbody, mu, ideep, T(itop))
    for b in range(3):
        jdepth, jideep = jrt.plane_parallel_depth(
            jnp.asarray(ec[b]), jnp.asarray(radius[b]), maxdepth,
            int(itop[b]), int(ibottom[b]))
        np.testing.assert_array_equal(ideep[b].numpy(), np.asarray(jideep))
        np.testing.assert_allclose(depth[b].numpy(), np.asarray(jdepth),
                                   rtol=RTOL_RT)
        jinten = jrt.plane_parallel_intensity(
            jdepth, jnp.asarray(bbody[b].numpy()), mu, jideep, int(itop[b]))
        np.testing.assert_allclose(inten[b].numpy(), np.asarray(jinten),
                                   rtol=RTOL_RT)
        # One chain without the batch axis gives the same:
        d1, i1 = rt.plane_parallel_depth(
            T(ec[b]), T(radius[b]), maxdepth, int(itop[b]), int(ibottom[b]))
        np.testing.assert_array_equal(i1.numpy(), ideep[b].numpy())
        torch.testing.assert_close(
            rt.plane_parallel_intensity(d1, bbody[b], mu, i1, int(itop[b])),
            inten[b], rtol=RTOL_RT, atol=0)


# ----------------------------------------------------------------------
# The eclipse flagship at test size

class _ObsCfg:
    data = None
    uncert = None
    filters = [f'tophat {wl0:.4f} 0.01'
               for wl0 in np.linspace(1.13, 1.27, 20)]
    obsfile = None
    dunits = None
    offset_inst = None
    uncert_scaling = None


def _port_setup(cfg_file):
    model = Model(cfg_file, device='cpu')
    obs = Observation(_ObsCfg, model.wn)
    return model, obs, RetrievalParams(model, obs)


def _jax_setup(cfg_file):
    model = JModel(cfg_file)
    obs = JObservation(_ObsCfg, model.wn)
    return model, obs, JRetrievalParams(model, obs)


@pytest.fixture(scope='module')
def eclipse(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp('torch_eclipse'))
    jmodel, jobs, jret, _, p0 = make_flagship(
        workdir, nlayers=21, wl_low=1.1, wl_high=1.3, wnstep=4.0,
        rt_path='eclipse')
    cfg_file = os.path.join(workdir, 'flagship.cfg')
    return cfg_file, (jmodel, jobs, jret, p0), _port_setup(cfg_file)


def _params(p0, n=6, seed=0):
    rng = np.random.default_rng(seed)
    pb = np.tile(p0, (n, 1)) + 0.05 * rng.standard_normal((n, len(p0)))
    pb[1, 4] = -3.0       # a deck high in the atmosphere
    pb[-1, 1] = 1.0e6     # T_irr blow-up: rejected chain
    return pb


def _assert_forward_matches(got, ref):
    good = np.asarray(ref['good'])
    np.testing.assert_array_equal(got['good'].numpy(), good)
    assert good[:-1].all() and not good[-1]
    np.testing.assert_allclose(
        got['spectrum'].numpy(), np.asarray(ref['spectrum']),
        rtol=RTOL_SLICE)
    np.testing.assert_allclose(
        got['temperature'].numpy(), np.asarray(ref['temperature']),
        rtol=RTOL_SLICE)
    band, jband = got['bandflux'].numpy(), np.asarray(ref['bandflux'])
    np.testing.assert_array_equal(np.isinf(band), np.isinf(jband))
    np.testing.assert_allclose(band[good], jband[good], rtol=RTOL_SLICE)


@pytest.mark.parametrize('route', ['in_kernel', 'dense_part'])
def test_eclipse_forward_line_sample_routes(eclipse, monkeypatch, route):
    """The eclipse forward hands the line sample to the RT wrapper as
    ls_w / ls_tab when the table's slab fits the kernel and as a dense
    part otherwise; both agree with pyratbay_tpu's batched forward."""
    from pyratbay_tpu_torch import model as model_mod
    from pyratbay_tpu_torch.retrieval import batched
    _, (jmodel, jobs, jret, p0), (model, obs, ret) = eclipse
    if route == 'dense_part':
        monkeypatch.setattr(batched, 'ls_in_kernel',
                            lambda n_k, nl, rt_path: False)
    seen = {}
    real = model_mod.emission_flux_ensemble

    def recorder(ec_parts, *args, **kw):
        seen['parts'], seen['kw'] = list(ec_parts), kw
        return real(ec_parts, *args, **kw)

    monkeypatch.setattr(model_mod, 'emission_flux_ensemble', recorder)
    pb = _params(p0)[:-1]
    got = build_forward_batched(model, obs, ret)(pb)['spectrum'].numpy()
    if route == 'in_kernel':
        assert not seen['parts']
        assert seen['kw']['ls_w'].shape[0::2] == (len(pb), model.nlayers)
        assert seen['kw']['ls_tab'].shape[1:] == (model.nlayers, model.nwave)
    else:
        assert len(seen['parts']) == 1 and seen['kw']['ls_w'] is None
    ref = jax.jit(jbuild_forward_batched(jmodel, jobs, jret))(
        jnp.asarray(pb))
    np.testing.assert_allclose(got, np.asarray(ref['spectrum']),
                               rtol=RTOL_SLICE)


def test_eclipse_forward_and_log_posterior(eclipse):
    _, (jmodel, jobs, jret, p0), (model, obs, ret) = eclipse
    assert model.rt_path == 'eclipse' and len(model.quadrature_mu) == 5
    pb = _params(p0)
    ref = jax.jit(jbuild_forward_batched(jmodel, jobs, jret))(
        jnp.asarray(pb))
    got = build_forward_batched(model, obs, ret)(pb)
    _assert_forward_matches(got, ref)
    spec = got['spectrum'].numpy()
    assert np.all(spec[:-1] > 0) and np.all(spec[-1] == 0)

    # Log-posterior on synthetic data, with one chain out of the
    # prior bounds as well:
    jband = np.asarray(ref['bandflux'])
    data = jband[0] * (1 + 1e-3 * np.sin(np.arange(len(jband[0]))))
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
    np.testing.assert_allclose(lp[fin], jlp[fin], rtol=RTOL_SLICE)

    # The per-chain forward is the batched one at B = 1:
    one = build_forward(model, obs, ret)(pb[0])
    np.testing.assert_allclose(
        one['spectrum'].numpy(), got['spectrum'][0].numpy(), rtol=1e-14)


_VARIANTS = {
    'emission': ('rt_path = emission', ''),
    'f_lambda': ('rt_path = f_lambda\ndistance = 47.5 pc', ''),
    'eclipse_teff_dilution': (
        'rt_path = eclipse',
        '    T_eff       5800.0  4000.0  7000.0  50.0\n'
        '    f_dilution     0.9     0.1     1.0  0.05\n'),
}


@pytest.mark.parametrize('variant', list(_VARIANTS))
def test_rt_path_variants(eclipse, tmp_path, variant):
    cfg_file = eclipse[0]
    rt_line, extra_pars = _VARIANTS[variant]
    with open(cfg_file) as f:
        text = f.read()
    text = text.replace('rt_path = eclipse', rt_line)
    text = text.replace('    alpha_ray ', extra_pars + '    alpha_ray ')
    variant_cfg = str(tmp_path / 'variant.cfg')
    with open(variant_cfg, 'w') as f:
        f.write(text)
    jmodel, jobs, jret = _jax_setup(variant_cfg)
    model, obs, ret = _port_setup(variant_cfg)
    if extra_pars:
        assert ret.itstar is not None and ret.idilut is not None
    pb = _params(np.asarray(jret.params), seed=3)
    ref = jax.jit(jbuild_forward_batched(jmodel, jobs, jret))(
        jnp.asarray(pb))
    _assert_forward_matches(build_forward_batched(model, obs, ret)(pb), ref)


def test_eclipse_state_from_jax_arrays(eclipse):
    cfg_file, (jmodel, jobs, jret, p0), _ = eclipse
    from_jax = convert.static_arrays(jmodel, jobs, jret)
    model, obs, ret = _port_setup(cfg_file)
    from_cfg = convert.static_arrays(model, obs, ret)
    assert from_jax.keys() == from_cfg.keys()
    for key in ('starflux', 'quadrature_mu', 'quadrature_weights'):
        assert from_jax[key] is not None, key
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


def test_unported_rt_path_raises(eclipse, tmp_path, monkeypatch):
    """Every rt_path is ported (two-stream emission since
    tests/test_torch_radeq.py's slice), and so is the nested sampler
    (A10): the eclipse flagship built as emission_two_stream with
    sampler = multinest retrieves, the run cut to 16 dead points by
    wrapping sample_nested: a finite evidence, a posterior inside the
    prior box, and best_log_post the log-posterior of bestp."""
    from pyratbay_tpu_torch.retrieval import driver as rdriver
    from pyratbay_tpu_torch.retrieval.forward import build_log_posterior
    workdir = os.path.dirname(eclipse[0])
    with open(eclipse[0]) as f:
        text = f.read().replace(
            'rt_path = eclipse', 'rt_path = emission_two_stream').replace(
            f'logfile = {workdir}/flagship.log',
            f'logfile = {tmp_path}/two_stream.log')
    cfg_file = str(tmp_path / 'two_stream.cfg')
    with open(cfg_file, 'w') as f:
        f.write(text + 'sampler = multinest\nnlive = 16\n')
    model = Model(cfg_file, device='cpu')
    assert model.two_stream
    cfg = model.cfg
    cfg.filters = [f'tophat {wl0:.4f} 0.01'
                   for wl0 in np.linspace(1.13, 1.27, 8)]
    cfg.data, cfg.uncert = np.full(8, 2e4), np.full(8, 5e2)
    real = rdriver.sample_nested
    monkeypatch.setattr(rdriver, 'sample_nested', lambda *a, **kw: real(
        *a, max_iter=16, nsteps_walk=3, **kw))
    monkeypatch.setattr(rdriver, '_plots', lambda *a: None)
    results = rdriver.run_retrieval(model, seed=0)
    assert np.isfinite(model.logz) and model.logz_err >= 0
    ret = model.ret
    assert np.all((results['posterior'] >= ret.pmin)
                  & (results['posterior'] <= ret.pmax))
    lp = build_log_posterior(model, model.obs, ret)(model.bestp)
    np.testing.assert_allclose(float(lp), model.best_log_post, rtol=1e-12)
    with np.load(str(tmp_path / 'two_stream.npz')) as out:
        assert float(out['logz']) == model.logz
