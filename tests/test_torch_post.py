"""Retrieval post-processing: the port's posterior_post_processing (the
`--post` entry), Model.band_contribution and the forward's RT
diagnostics against pyratbay_tpu's, on one saved posterior (a seeded
numpy array around the flagship's parameters), float64 on the CPU,
rtol 1e-8 (the slice bound of tests/test_torch_forward.py).

The flagship at test size (21 layers, 1.1-1.3 um, wnstep 4) as a
transit, an eclipse and a patchy transit retrieval, with six tophat
bands and a filter file.

pyratbay_tpu's own jitted forward gives depths 5.5e-8 apart from its
eager forward at the same parameters (XLA reassociates the chord
products), which puts its band contributions 1.2e-7 apart.  So the
band contributions and diagnostics are held at 1e-8 against
pyratbay_tpu's eager forward, which the port's matches to ~1e-14.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from pyratbay_tpu import plots as jplots  # noqa: E402
from pyratbay_tpu.model import Model as JModel  # noqa: E402
from pyratbay_tpu.observation import Observation as JObservation  # noqa: E402
from pyratbay_tpu.retrieval import driver as jdriver  # noqa: E402
from pyratbay_tpu.retrieval.forward import (  # noqa: E402
    build_forward as jbuild_forward,
)
from pyratbay_tpu.retrieval.params import (  # noqa: E402
    RetrievalParams as JRetrievalParams,
)
from pyratbay_tpu_torch.__main__ import main  # noqa: E402
from pyratbay_tpu_torch.benchmark import make_flagship  # noqa: E402
from pyratbay_tpu_torch.io import io as pio  # noqa: E402
from pyratbay_tpu_torch.model import Model  # noqa: E402
from pyratbay_tpu_torch.retrieval import driver  # noqa: E402
from pyratbay_tpu_torch.retrieval.forward import build_forward  # noqa: E402
from pyratbay_tpu_torch.retrieval.params import RetrievalParams  # noqa: E402

RTOL = 1e-8
NLAYERS = 21
CASES = {
    'transit': ('transit', ''),
    'eclipse': ('eclipse', ''),
    'transit_patchy': ('transit', 'fpatchy = 0.4'),
}
OUTPUTS = {
    '_temperature_posterior.npz': ('press', 'median', 'low1', 'high1',
                                   'low2', 'high2'),
    '_spectrum_posterior.npz': ('wn', 'median', 'low1', 'high1', 'low2',
                                'high2', 'spec_best'),
    '_band_contribution.npz': ('press', 'band_cf', 'band_wl'),
}


@pytest.fixture(scope='module')
def flagship(tmp_path_factory):
    """The flagship's tables and config, a filter file, and the example
    parameters."""
    workdir = str(tmp_path_factory.mktemp('torch_post'))
    model, _, ret, _, p0 = make_flagship(
        workdir, nlayers=NLAYERS, wl_low=1.1, wl_high=1.3, wnstep=4.0,
        device='cpu')
    filter_file = os.path.join(workdir, 'trapezoid_1.25.dat')
    wl = np.linspace(1.22, 1.28, 61)
    np.savetxt(filter_file, np.column_stack(
        [wl, np.clip(np.minimum(wl - 1.22, 1.28 - wl) / 0.015, 0, 1)]))
    return (workdir, filter_file, p0, ret.pstep, ret.pmin, ret.pmax,
            model.nwave)


def write_retrieval(flagship, name, rt_path, extra):
    """A retrieval config over the flagship's files and <logfile>.npz
    with a seeded posterior (300 draws, 60 of them repeats as in a
    chain, the fixed parameter constant)."""
    workdir, filter_file, p0, pstep, pmin, pmax, nwave = flagship
    with open(os.path.join(workdir, 'flagship.cfg')) as f:
        text = f.read()
    text = text.replace('runmode = spectrum', 'runmode = retrieval')
    text = text.replace('rt_path = transit', f'rt_path = {rt_path}')
    text = text.replace(f'logfile = {workdir}/flagship.log',
                        f'logfile = {workdir}/{name}.log')
    filters = [f'tophat {wl0:.4f} 0.01'
               for wl0 in np.linspace(1.12, 1.28, 6)] + [filter_file]
    rng = np.random.default_rng(11)
    depth = 1e-4 if rt_path == 'eclipse' else 0.0108
    data = depth * (1.0 + 0.01 * rng.standard_normal(len(filters)))
    text += '\n'.join([
        extra,
        'data = ' + ' '.join(f'{d:.10e}' for d in data),
        'uncert = ' + ' '.join(f'{0.01 * depth:.10e}' for _ in data),
        'filters =', *[f'    {entry}' for entry in filters], ''])
    cfg_file = os.path.join(workdir, name + '.cfg')
    with open(cfg_file, 'w') as f:
        f.write(text)
    draws = p0 + 0.5 * pstep * rng.standard_normal((240, len(p0)))
    draws = np.clip(draws, pmin, pmax)
    posterior = np.concatenate([draws, draws[rng.integers(0, 240, 60)]])
    np.savez(
        os.path.join(workdir, name + '.npz'), posterior=posterior,
        bestp=p0, best_log_post=-1.0, spec_best=np.full(nwave, depth),
        bandflux_best=data)
    return cfg_file, os.path.join(workdir, name)


def _no_figure(*args, **kwargs):
    pass


def _jax_side(cfg_file):
    jmodel = JModel(cfg_file)
    jobs = JObservation(jmodel.cfg, jmodel.wn,
                        root=os.path.dirname(cfg_file) + '/')
    return jmodel, jobs, JRetrievalParams(jmodel, jobs)


@pytest.fixture(scope='module', params=list(CASES))
def post(request, flagship):
    """Both packages' post-processing of one saved posterior, and
    pyratbay_tpu's eager forward at the best fit (the example
    parameters)."""
    name = request.param
    rt_path, extra = CASES[name]
    cfg_file, base = write_retrieval(flagship, name, rt_path, extra)
    with pytest.MonkeyPatch.context() as mp:
        # The figures (matplotlib, seconds each) are made by the port on
        # the transit case only, and by pyratbay_tpu not at all:
        for fig in ('spectrum', 'posteriors', 'temperature', 'contribution',
                    'abundance'):
            mp.setattr(jplots, fig, _no_figure)
        jdriver.posterior_post_processing(cfg_file, suffix='_jax')
        if name != 'transit':
            mp.setattr(driver, '_plots', _no_figure)
        model = driver.posterior_post_processing(
            cfg_file, suffix='_torch', device='cpu')
    jmodel, jobs, jret = _jax_side(cfg_file)
    jbest = jbuild_forward(jmodel, jobs, jret)(jret.params)
    return name, cfg_file, base, model, (jmodel, jobs, jret, jbest)


def test_post_processing_matches_jax(post):
    name, _, base, _, (jmodel, jobs, _, jbest) = post
    for suffix, keys in OUTPUTS.items():
        with np.load(base + '_jax' + suffix) as ref, \
                np.load(base + '_torch' + suffix) as got:
            ref = dict(ref)
            if 'band_cf' in keys:
                ref['band_cf'] = jmodel.band_contribution(jobs, result=jbest)
            for key in keys:
                np.testing.assert_allclose(
                    got[key], ref[key], rtol=RTOL, atol=1e-300,
                    err_msg=f'{name}{suffix}[{key}]')
    got = pio.read_atm(base + '_torch_median.atm')
    ref = pio.read_atm(base + '_jax_median.atm')
    np.testing.assert_array_equal(got[1], ref[1])       # species
    for got_a, ref_a in zip(got[2:], ref[2:]):
        if ref_a is None:
            assert got_a is None
            continue
        np.testing.assert_allclose(got_a, ref_a, rtol=RTOL)
    if name == 'transit':
        for fig in ('bestfit_spectrum', 'posteriors', 'temperature',
                    'band_contribution', 'abundance'):
            assert os.path.isfile(f'{base}_torch_{fig}.png'), fig


def test_band_contribution_after_run_and_from_forward(post):
    name, _, _, model, (jmodel, jobs, jret, ref) = post
    jmodel.run()
    obs = driver._observation(model)
    model.run()
    np.testing.assert_allclose(
        model.band_contribution(obs), jmodel.band_contribution(jobs),
        rtol=RTOL, err_msg=name)

    # The forward's diagnostics at the example parameters:
    ret = RetrievalParams(model, obs)
    got = build_forward(model, obs, ret)(ret.params, diagnostics=True)
    keys = {'transit': ['depth', 'ideep'],
            'eclipse': ['depth', 'ideep', 'bbody'],
            'transit_patchy': ['depth', 'ideep', 'depth_clear',
                               'ideep_clear', 'clear', 'cloudy',
                               'fpatchy']}[name]
    for key in keys:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=RTOL, atol=1e-300, err_msg=key)
    np.testing.assert_allclose(
        model.band_contribution(obs, result=got),
        jmodel.band_contribution(jobs, result=ref), rtol=RTOL)
    # The per-chain forward without diagnostics returns none of them:
    plain = build_forward(model, obs, ret)(ret.params)
    assert not set(keys) & set(plain)


def test_post_entry_writes_suffixed_files(flagship, monkeypatch):
    monkeypatch.setattr(driver, '_plots', _no_figure)
    cfg_file, base = write_retrieval(flagship, 'cli', 'transit', '')
    assert main(['--post', cfg_file, '--device', 'cpu',
                 '--suffix', '_b']) == 0
    driver.posterior_post_processing(cfg_file, suffix='_c', device='cpu')
    for suffix, keys in OUTPUTS.items():
        with np.load(base + '_b' + suffix) as got, \
                np.load(base + '_c' + suffix) as ref:
            for key in keys:
                np.testing.assert_array_equal(got[key], ref[key])
    with open(base + '_b_median.atm') as got, \
            open(base + '_c_median.atm') as ref:
        assert got.read() == ref.read()
    assert not os.path.exists(base + '_temperature_posterior.npz')


def test_model_band_contribution_needs_a_run(flagship):
    cfg_file, _ = write_retrieval(flagship, 'no_run', 'transit', '')
    model = Model(cfg_file, device='cpu')
    obs = driver._observation(model)
    model.depth = None
    with pytest.raises(ValueError, match='before run'):
        model.band_contribution(obs)
