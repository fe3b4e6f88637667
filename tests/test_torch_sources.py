"""The opacity sources of the spectrum slice in the batched forward, the
static size rule that keeps the RT kernels' operands within their
limits (fault C5 of ROADMAP.md), and the posterior of run_retrieval
(fault C4), against pyratbay_tpu on the CPU in float64.

The forwards run at test size (the flagship's tables, 21 layers,
1.1-1.3 um, wnstep 4) with Rayleigh (H2, He, H, e-), H-, the bundled
H2-He CIA table, a gray cloud beside the Lecavelier haze, and patchy
clouds with f_patchy fixed and retrieved; rtol 1e-8, the slice bound of
tests/test_torch_forward.py.
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
from pyratbay_tpu.retrieval import RetrievalParams as JRetrievalParams  # noqa: E402
from pyratbay_tpu.retrieval.batched import (  # noqa: E402
    build_forward_batched as jbuild_forward_batched,
    build_log_posterior_batched as jbuild_log_posterior_batched,
)
from pyratbay_tpu.retrieval.driver import (  # noqa: E402
    run_retrieval as jrun_retrieval,
)
from pyratbay_tpu_torch import model as model_mod  # noqa: E402
from pyratbay_tpu_torch.io import io as pio  # noqa: E402
from pyratbay_tpu_torch.model import Model  # noqa: E402
from pyratbay_tpu_torch.observation import Observation  # noqa: E402
from pyratbay_tpu_torch.retrieval.batched import (  # noqa: E402
    build_forward_batched, build_log_posterior_batched, line_sample_table,
)
from pyratbay_tpu_torch.retrieval.driver import run_retrieval  # noqa: E402
from pyratbay_tpu_torch.retrieval.params import RetrievalParams  # noqa: E402
from pyratbay_tpu_torch.spectrum import transit_kernel as tk  # noqa: E402

RTOL = 1e-8
SPECIES = ['H2', 'He', 'H', 'Na', 'K', 'H2O', 'CH4', 'CO', 'CO2', 'e-']
VMR = [8.5e-1, 1.49e-1, 1e-6, 3e-6, 5e-8, 4e-4, 1e-4, 5e-4, 1e-7, 1e-6]


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
def workdir(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp('torch_sources'))
    make_flagship(workdir, nlayers=21, wl_low=1.1, wl_high=1.3, wnstep=4.0)
    pio.write_atm(os.path.join(workdir, 'electrons.atm'),
                  np.logspace(-6, 2, 21), np.full(21, 1400.0), SPECIES,
                  np.tile(VMR, (21, 1)), punits='bar')
    return workdir


# Each variant edits the flagship's retrieval config: (old, new) pairs.
VARIANTS = {
    'rayleigh_h_ion_bundled_cia': [
        ('alkali = sodium_vdw', 'alkali = sodium_vdw\n'
         'rayleigh = rayleigh_H2 rayleigh_He rayleigh_H rayleigh_e-\n'
         'h_ion = h_ion_john1988'),
        ('flagship_cia.dat',
         'flagship_cia.dat CIA_Borysow_H2He_0050-3000K_0.3-030um.npz')],
    'ccsgray_six_rank1': [
        ('alkali = sodium_vdw', 'alkali = sodium_vdw\n'
         'rayleigh = rayleigh_H2 rayleigh_He rayleigh_H rayleigh_e-'),
        ('    lecavelier 0.0 -4.0',
         '    lecavelier 0.0 -4.0\n    ccsgray 0.5 -3.0 1.0')],
    'patchy_fixed': [
        ('alkali = sodium_vdw', 'alkali = sodium_vdw\n'
         'rayleigh = rayleigh_H2 rayleigh_He\nfpatchy = 0.4'),
        ('    lecavelier 0.0 -4.0',
         '    lecavelier 0.0 -4.0\n    ccsgray 0.5 -3.0 1.0')],
    'patchy_retrieved': [
        ('alkali = sodium_vdw', 'alkali = sodium_vdw\nfpatchy = 0.4'),
        ('    alpha_ray    -4.0   -6.0  0.0  0.0',
         '    alpha_ray    -4.0   -6.0  0.0  0.0\n'
         '    f_patchy      0.4    0.0  1.0  0.1')],
}


def _setups(workdir, variant, rt_path='transit'):
    with open(os.path.join(workdir, 'flagship.cfg')) as f:
        text = f.read()
    text = text.replace('flagship.atm', 'electrons.atm')
    text = text.replace('rt_path = transit', f'rt_path = {rt_path}')
    for old, new in VARIANTS[variant]:
        assert old in text, old
        text = text.replace(old, new)
    cfg = os.path.join(workdir, f'{variant}_{rt_path}.cfg')
    with open(cfg, 'w') as f:
        f.write(text)
    jmodel = JModel(cfg)
    jobs = JObservation(_ObsCfg, jmodel.wn)
    model = Model(cfg, device='cpu')
    obs = Observation(_ObsCfg, model.wn)
    return ((jmodel, jobs, JRetrievalParams(jmodel, jobs)),
            (model, obs, RetrievalParams(model, obs)))


def _params(p0, n=5, seed=0):
    rng = np.random.default_rng(seed)
    pb = np.tile(p0, (n, 1)) + 0.05 * rng.standard_normal((n, len(p0)))
    pb[1, 4] = -2.0       # a deck high in the atmosphere
    pb[-1, 1] = 1.0e6     # T_irr blow-up: rejected chain
    return pb


@pytest.mark.parametrize('rt_path', ['transit', 'eclipse'])
@pytest.mark.parametrize('variant', list(VARIANTS))
def test_batched_forward_and_log_posterior(workdir, variant, rt_path):
    (jmodel, jobs, jret), (model, obs, ret) = _setups(
        workdir, variant, rt_path)
    assert ret.pnames == jret.pnames
    if variant == 'patchy_retrieved':
        assert ret.ipatchy == jret.ipatchy == 7
    pb = _params(np.asarray(ret.params))
    ref = jax.jit(jbuild_forward_batched(jmodel, jobs, jret))(
        jnp.asarray(pb))
    got = build_forward_batched(model, obs, ret)(pb)
    good = np.asarray(ref['good'])
    np.testing.assert_array_equal(got['good'].numpy(), good)
    assert good[:-1].all() and not good[-1]
    np.testing.assert_allclose(
        got['spectrum'].numpy(), np.asarray(ref['spectrum']), rtol=RTOL)
    band, jband = got['bandflux'].numpy(), np.asarray(ref['bandflux'])
    np.testing.assert_allclose(band[good], jband[good], rtol=RTOL)

    data = jband[0] * (1 + 1e-3 * np.sin(np.arange(len(jband[0]))))
    try:
        for o in (jobs, obs):
            o.data = data
            o.uncert = np.abs(data) * 0.01
        jlp = np.asarray(jax.jit(jbuild_log_posterior_batched(
            jmodel, jobs, jret))(jnp.asarray(pb)))
        lp = build_log_posterior_batched(model, obs, ret)(pb).numpy()
    finally:
        for o in (jobs, obs):
            o.data = o.uncert = None
    np.testing.assert_array_equal(np.isinf(lp), np.isinf(jlp))
    fin = np.isfinite(jlp)
    assert fin.sum() >= 2
    np.testing.assert_allclose(lp[fin], jlp[fin], rtol=RTOL)


def test_patchy_forward_launches_twice(workdir, monkeypatch):
    """A patchy forward launches the RT twice: the cloudy spectrum with
    the cloud part and the deck, the clear one without either and with
    its bottom at nlayers."""
    (_, _, _), (model, obs, ret) = _setups(workdir, 'patchy_fixed')
    calls = []
    real = model_mod.transit_spectrum_ensemble

    def recorder(ec_parts, path, radius, rstar, itop, ibottom, **kw):
        calls.append((len(ec_parts), ibottom.clone(), kw['deck_itop']))
        return real(ec_parts, path, radius, rstar, itop, ibottom, **kw)

    monkeypatch.setattr(model_mod, 'transit_spectrum_ensemble', recorder)
    build_forward_batched(model, obs, ret)(_params(np.asarray(ret.params)))
    (n_cloudy, _, deck), (n_clear, ibottom, no_deck) = calls
    assert n_cloudy == n_clear + 1 and deck is not None and no_deck is None
    assert torch.all(ibottom == model.nlayers)


def _fit_case(case, rng):
    """Operands beyond one limit: 40 CIA rows, 6 rank-1 terms, 5 dense
    parts."""
    nb, nlayers, nwave = 3, 21, 40
    n_cia = 40 if case == 'cia40' else 15
    n_r1 = 6 if case == 'r1_6' else 2
    n_parts = 5 if case == 'parts5' else 1
    t = lambda *shape: torch.as_tensor(rng.lognormal(0.0, 1.0, shape))
    return dict(
        ec_parts=[t(nb, nlayers, nwave) for _ in range(n_parts)],
        cia_w=t(nb, nlayers, n_cia), cia_tab=t(n_cia, nwave),
        r1_cols=t(nb, n_r1, nlayers), r1_rows=t(nb, n_r1, nwave),
        ls_w=t(nb, 10, nlayers), ls_tab=t(10, nlayers, nwave))


@pytest.mark.parametrize('case, parts, r1, cia', [
    ('cia40', 2, 2, tk.MAX_CIA),       # rows 32-39 as a dense part
    ('r1_6', 1, tk.MAX_R1, 15),        # terms 4-5 into the last part
    ('parts5', tk.MAX_PARTS, 2, 15),   # parts 3-4 summed into one
])
def test_size_rule_fits_operands(case, parts, r1, cia):
    """The rule's operands, decided from the shapes, sum to the same
    extinction (the plain route takes any count)."""
    ops = _fit_case(case, np.random.default_rng(7))
    fit = tk.fit_operands(**ops)
    assert len(fit['ec_parts']) == parts
    assert fit['r1_cols'].shape[1] == fit['r1_rows'].shape[1] == r1
    assert fit['cia_w'].shape[2] == fit['cia_tab'].shape[0] == cia
    assert fit['ls_w'] is ops['ls_w'] and fit['ls_tab'] is ops['ls_tab']
    like = ops['r1_cols'][:, 0]
    total = lambda o: tk.extinction_plain(
        o['ec_parts'], o['cia_w'], o['cia_tab'], o['r1_cols'],
        o['r1_rows'], o['ls_w'], o['ls_tab'], like)
    torch.testing.assert_close(total(fit), total(ops), rtol=1e-13, atol=0)
    # Within the limits the operands pass unchanged:
    same = tk.fit_operands(**fit)
    assert all(a is b for a, b in zip(same['ec_parts'], fit['ec_parts']))
    assert same['cia_w'] is fit['cia_w'] and same['r1_cols'] is fit['r1_cols']


def test_size_rule_above_64_layers(workdir):
    """At 81 layers the line sample goes to the transit kernel as
    ls_w / ls_tab (the tall function streams the table; the emission
    kernel would take a dense part), and Model.run's spectrum from the
    kernel's operands equals the one of the summed dense extinction
    (rt.py on its depth and ideep)."""
    from pyratbay_tpu_torch.spectrum import rt
    assert tk.ls_in_kernel(8, 64, 'transit')
    assert tk.ls_in_kernel(8, 65, 'transit')
    assert not tk.ls_in_kernel(8, 65, 'eclipse')
    with open(os.path.join(workdir, 'flagship.cfg')) as f:
        text = f.read()
    cfg = os.path.join(workdir, 'tall.cfg')
    with open(cfg, 'w') as f:
        f.write(text.replace(
            'maxdepth = 10.0',
            'maxdepth = 10.0\nptop = 1e-6 bar\npbottom = 100 bar\n'
            'nlayers = 81'))
    model = Model(cfg, device='cpu')
    assert model.nlayers == 81
    assert line_sample_table(model).shape == (10, 81, model.nwave)
    seen = {}
    real = model_mod.transit_spectrum_ensemble

    def recorder(ec_parts, *args, **kw):
        seen['parts'], seen['kw'] = list(ec_parts), kw
        return real(ec_parts, *args, **kw)

    model_mod.transit_spectrum_ensemble = recorder
    try:
        got = model.run()
    finally:
        model_mod.transit_spectrum_ensemble = real
    assert not seen['parts']
    assert seen['kw']['ls_w'].shape == (1, 10, 81)
    assert seen['kw']['ls_tab'].shape == (10, 81, model.nwave)
    rscale = model._radius_scale
    radius = torch.as_tensor(model.radius) / rscale
    deck = seen['kw']['deck_itop'][0]
    want = rt.transmission_spectrum(
        got['depth'], got['ideep'], radius, model.rstar / rscale, 0,
        deck_rsurf=seen['kw']['deck_rsurf'][0], deck_itop=deck)
    torch.testing.assert_close(got['spectrum'], want, rtol=1e-12, atol=0)


def test_posterior_is_not_thinned(workdir):
    """Fault C4: with thinning = 5 both run_retrievals keep every
    generation after the burn-in, (ngen - burnin) * nchains rows."""
    cfg = os.path.join(workdir, 'flagship.cfg')
    nchains, ngen, burnin = 6, 16, 4
    model = Model(cfg, device='cpu')
    band = build_forward_batched(
        model, Observation(_ObsCfg, model.wn), None)()['bandflux'][0]
    shapes = []
    for model, run in ((JModel(cfg), jrun_retrieval), (model, run_retrieval)):
        c = model.cfg
        c.data, c.uncert = band.numpy(), np.full(len(band), 3e-5)
        c.filters = list(_ObsCfg.filters)
        c.nsamples, c.nchains, c.burnin = nchains * ngen, nchains, burnin
        c.thinning = 5
        c.logfile = None
        shapes.append(np.shape(run(model, seed=1)['posterior']))
    assert shapes[0] == shapes[1] == ((ngen - burnin) * nchains, 7)
