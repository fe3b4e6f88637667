"""The high-resolution channel of the port against pyratbay_tpu, float64
on the CPU.

* instrumental_kernel, inst_convolution and rv_shift equal the JAX
  package's; the batched stage's grouped convolution equals
  scipy.signal.convolve(mode='same').
* Observation's high-res channel: wavenumbers from bare wavelengths and
  from filter files, data and uncertainties, the inst_resolution
  requirement.
* A port of tests/test_batched.py::test_batched_hires_matches_vmap:
  bandflux_hires and the log-posterior of the batched forward, with and
  without a retrieved rv_shift (at +-100 km/s, with data points at and
  beyond the grid's ends), against the JAX package's at rtol 1e-8.
* A retrieval on high-res data alone through run_retrieval, and its
  log-posterior against the JAX package's.

At test size: the transit flagship on 21 layers, 1.1-1.3 um at 2 cm-1.
"""
import os

import numpy as np
import pytest
import scipy.signal

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pyratbay_tpu.benchmark import make_flagship  # noqa: E402
from pyratbay_tpu.observation import Observation as JObservation  # noqa: E402
from pyratbay_tpu.retrieval import RetrievalParams as JRetrievalParams  # noqa: E402
from pyratbay_tpu.retrieval.batched import (  # noqa: E402
    build_forward_batched as jbuild_forward_batched,
    build_log_posterior_batched as jbuild_log_posterior_batched,
)
from pyratbay_tpu.spectrum import hires as jhires  # noqa: E402
from pyratbay_tpu_torch.io import io as pio  # noqa: E402
from pyratbay_tpu_torch.model import Model  # noqa: E402
from pyratbay_tpu_torch.observation import Observation  # noqa: E402
from pyratbay_tpu_torch.retrieval.batched import (  # noqa: E402
    build_forward_batched, build_log_posterior_batched, hires_stage,
)
from pyratbay_tpu_torch.retrieval.driver import run_retrieval  # noqa: E402
from pyratbay_tpu_torch.retrieval.params import RetrievalParams  # noqa: E402
from pyratbay_tpu_torch.spectrum import hires  # noqa: E402

RTOL_SLICE = 1e-8
RV_PAR = '\n    rv_shift   10.0  -120.0  120.0  5.0'


@pytest.fixture(scope='module')
def flagship(tmp_path_factory):
    """The transit flagship and a high-res data file: 40 points over
    1.15-1.25 um plus points at and just beyond the grid's ends."""
    workdir = str(tmp_path_factory.mktemp('hires'))
    jmodel, _, _, _, _ = make_flagship(
        workdir, nlayers=21, wl_low=1.1, wl_high=1.3, wnstep=2.0)
    wl_edges = 1.0 / (jmodel.wn[[-1, 0]] * 1e-4)
    wl_hires = np.concatenate([
        [wl_edges[0] - 2e-4, wl_edges[0], wl_edges[0] + 2e-4],
        np.linspace(1.15, 1.25, 40),
        [wl_edges[1] - 2e-4, wl_edges[1], wl_edges[1] + 2e-4]])
    hires_file = os.path.join(workdir, 'hires_obs.dat')
    rng = np.random.default_rng(4)
    pio.write_observations(
        hires_file, 0.0066 + 1e-5 * rng.standard_normal(len(wl_hires)),
        np.full(len(wl_hires), 1e-5), [f'{wl:.8f}' for wl in wl_hires])
    return dict(workdir=workdir, jmodel=jmodel, hires_file=hires_file,
                nhires=len(wl_hires),
                cfg=os.path.join(workdir, 'flagship.cfg'))


class _Cfg:
    """Observation settings: the flagship's tophats and a high-res
    channel."""
    data = uncert = obsfile = dunits = None
    offset_inst = uncert_scaling = None
    filters = [f'tophat {wl0:.4f} 0.01' for wl0 in np.linspace(
        1.13, 1.27, 20)]
    obsfile_hires = None
    inst_resolution = 20000.0


def _hires_cfg(flagship, bands=True):
    cfg = type('Cfg', (_Cfg,), {})
    cfg.obsfile_hires = flagship['hires_file']
    if not bands:
        cfg.filters = None
    return cfg


# ----------------------------------------------------------------------
# Host pieces and the convolution

@pytest.mark.parametrize('resolution, sampling', [
    (20000.0, 8000.0), (70000.0, 3.1e5), (5000.0, 1.0e5)])
def test_instrumental_kernel_and_convolution(resolution, sampling):
    kernel = hires.instrumental_kernel(resolution, sampling)
    np.testing.assert_array_equal(
        kernel, jhires.instrumental_kernel(resolution, sampling))
    rng = np.random.default_rng(1)
    wn = np.linspace(6000.0, 6100.0, 2001)
    spectra = rng.uniform(0.5, 1.5, (3, len(wn)))
    stage = hires.HiresStage(wn, wn[::7], kernel, torch.device('cpu'),
                             torch.float64)
    conv = stage.convolve(torch.as_tensor(spectra)).numpy()
    for row, spectrum in zip(conv, spectra):
        np.testing.assert_allclose(
            row, scipy.signal.convolve(spectrum, kernel, mode='same'),
            rtol=1e-12)
    wl = 1.0 / (wn * 1e-4)
    np.testing.assert_array_equal(
        hires.inst_convolution(wl, spectra[0], resolution, sampling),
        jhires.inst_convolution(wl, spectra[0], resolution, sampling))
    for vel in (-100.0, 12.0):
        np.testing.assert_array_equal(hires.rv_shift(vel, wn=wn),
                                      jhires.rv_shift(vel, wn=wn))
        np.testing.assert_array_equal(hires.rv_shift(vel, wl=wl),
                                      jhires.rv_shift(vel, wl=wl))


def test_shifted_lerp_matches_np_interp():
    """The per-chain lerp on the shifted grid is np.interp, clamped at
    the grid's ends, at +-100 km/s."""
    rng = np.random.default_rng(2)
    wn = np.linspace(6000.0, 6010.0, 501)
    wn_hires = np.concatenate([[5999.0, 6000.0], rng.uniform(
        5999.5, 6010.5, 60), [6010.0, 6011.0]])
    stage = hires.HiresStage(wn, wn_hires, np.ones(1), torch.device('cpu'),
                             torch.float64)
    spectra = rng.uniform(0.5, 1.5, (3, len(wn)))
    vel = np.array([-100.0, 0.0, 100.0])
    got = stage(torch.as_tensor(spectra),
                torch.as_tensor(vel * 1e5)).numpy()
    for row, v, spectrum in zip(got, vel, spectra):
        np.testing.assert_allclose(
            row, np.interp(wn_hires, hires.rv_shift(v, wn=wn), spectrum),
            rtol=1e-13)
    np.testing.assert_allclose(
        stage(torch.as_tensor(spectra)).numpy()[1], got[1], rtol=1e-13)


def test_observation_hires_channel(flagship, tmp_path):
    model = Model(flagship['cfg'], device='cpu')
    cfg = _hires_cfg(flagship)
    obs = Observation(cfg, model.wn)
    jobs = JObservation(cfg, model.wn)
    for key in ('wn_hires', 'data_hires', 'uncert_hires'):
        np.testing.assert_array_equal(getattr(obs, key), getattr(jobs, key))
    assert len(obs.wn_hires) == flagship['nhires'] and obs.nbands == 20
    # A filter file gives its wl0:
    filt = str(tmp_path / 'narrow.dat')
    wl = np.linspace(1.199, 1.201, 21)
    np.savetxt(filt, np.column_stack([wl, np.exp(-((wl - 1.2) / 4e-4)**2)]))
    hfile = str(tmp_path / 'hires_filter.dat')
    pio.write_observations(hfile, [1.0, 2.0], [0.1, 0.1], [filt, '1.21'])
    cfg.obsfile_hires = hfile
    obs = Observation(cfg, model.wn)
    jobs = JObservation(cfg, model.wn)
    np.testing.assert_array_equal(obs.wn_hires, jobs.wn_hires)
    cfg.inst_resolution = None
    with pytest.raises(ValueError, match='inst_resolution'):
        Observation(cfg, model.wn)


# ----------------------------------------------------------------------
# The batched forward and log-posterior

@pytest.mark.parametrize('with_rv', [True, False])
def test_batched_hires_matches_jax(flagship, with_rv):
    jmodel = flagship['jmodel']
    model = Model(flagship['cfg'], device='cpu')
    base = model.cfg.retrieval_params
    cfg = _hires_cfg(flagship)
    try:
        for m in (model, jmodel):
            m.cfg.retrieval_params = base + (RV_PAR if with_rv else '')
        obs = Observation(cfg, model.wn)
        jobs = JObservation(cfg, jmodel.wn)
        for o in (obs, jobs):
            o.data = np.full(o.nbands, 0.0066)
            o.uncert = np.full(o.nbands, 2e-5)
        ret = RetrievalParams(model, obs)
        jret = JRetrievalParams(jmodel, jobs)
    finally:
        for m in (model, jmodel):
            m.cfg.retrieval_params = base
    assert (ret.irv is not None) == with_rv == (jret.irv is not None)
    pars = np.tile(np.asarray(ret.params), (6, 1))
    if with_rv:
        pars[:, ret.irv] = [10.0, -50.0, 0.0, 75.0, 100.0, -100.0]
    pars[1, 2] += 0.3
    pars[-1, 1] = 1.0e6        # a rejected chain
    ref = jax.jit(jbuild_forward_batched(jmodel, jobs, jret))(
        jnp.asarray(pars))
    forward_b = build_forward_batched(model, obs, ret)
    got = forward_b(pars)
    want = np.asarray(ref['bandflux_hires'])
    flux = got['bandflux_hires'].numpy()
    assert flux.shape == (6, flagship['nhires'])
    np.testing.assert_array_equal(np.isinf(flux), np.isinf(want))
    assert np.isinf(flux[-1]).all() and np.isfinite(flux[:-1]).all()
    np.testing.assert_allclose(flux[:-1], want[:-1], rtol=RTOL_SLICE)
    lp = build_log_posterior_batched(model, obs, ret)(pars).numpy()
    jlp = np.asarray(jax.jit(jbuild_log_posterior_batched(
        jmodel, jobs, jret))(jnp.asarray(pars)))
    np.testing.assert_array_equal(np.isinf(lp), np.isinf(jlp))
    fin = np.isfinite(jlp)
    assert fin.sum() == 5
    np.testing.assert_allclose(lp[fin], jlp[fin], rtol=RTOL_SLICE)
    assert isinstance(forward_b.hires, hires.HiresStage)
    stage = hires_stage(model, obs)
    np.testing.assert_array_equal(stage.kernel.numpy(),
                                  forward_b.hires.kernel.numpy())


def test_hires_only_retrieval(flagship, tmp_path):
    """High-res data without bands: run_retrieval samples, writes its
    posterior and post-processes; the log-posterior equals the JAX
    package's."""
    text = open(flagship['cfg']).read().replace(
        'runmode = spectrum', 'runmode = retrieval').replace(
        f"logfile = {flagship['workdir']}/flagship.log",
        f"logfile = {tmp_path}/hires_only.log")
    cfg_file = str(tmp_path / 'hires_only.cfg')
    assert text.rstrip().splitlines()[-1].startswith('    alpha_ray')
    with open(cfg_file, 'w') as f:
        f.write(text.rstrip() + RV_PAR + '\n'
                f"obsfile_hires = {flagship['hires_file']}\n"
                'inst_resolution = 20000.0\nnchains = 8\nnsamples = 48\n'
                'burnin = 2\n')
    model = Model(cfg_file, device='cpu')
    results = run_retrieval(model, seed=1)
    assert results['posterior'].shape == (8 * 4, 8)
    assert np.all(np.isfinite(model.posterior))
    assert model.bandflux_best.shape == (0,)
    for suffix in ('.npz', '_spectrum_posterior.npz',
                   '_temperature_posterior.npz', '_median.atm'):
        assert os.path.isfile(str(tmp_path / f'hires_only{suffix}'))
    jmodel = flagship['jmodel']
    cfg = _hires_cfg(flagship, bands=False)
    obs = Observation(cfg, model.wn)
    jobs = JObservation(cfg, jmodel.wn)
    assert obs.nbands == jobs.nbands == 0
    ret = RetrievalParams(model, obs)
    base = jmodel.cfg.retrieval_params
    jmodel.cfg.retrieval_params = model.cfg.retrieval_params
    try:
        jret = JRetrievalParams(jmodel, jobs)
    finally:
        jmodel.cfg.retrieval_params = base
    pars = model.posterior[::7]
    lp = build_log_posterior_batched(model, obs, ret)(pars).numpy()
    jlp = np.asarray(jax.jit(jbuild_log_posterior_batched(
        jmodel, jobs, jret))(jnp.asarray(pars)))
    assert np.all(np.isfinite(jlp))
    np.testing.assert_allclose(lp, jlp, rtol=RTOL_SLICE)
