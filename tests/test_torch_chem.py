"""Equilibrium chemistry of the port against pyratbay_tpu, float64 on
the CPU.

* The copied host thermodynamics (element data, solar abundances,
  parse_formula, species_mass, thermo_properties, gibbs_over_rt,
  read_solar_file): exactly equal.
* The batched torch solve (atmosphere/chem.py equilibrium_vmr, through
  Network.thermochemical_equilibrium and equilibrium_fn) on
  tests/test_chem.py's networks: rtol 1e-10 on VMRs above 1e-30 (the
  JAX package solves by Gauss-Jordan, the port by LU: the Newton
  iteration converges to the same point, not along the same digits).
* The [M/H], [X/H], X/Y and hybrid log_X models through Model.eval_vmr,
  and their errors.
* Model.run of tests/test_chem.py's 24-layer config; the flagship at
  test size (21 layers) with the network: the batched forward and
  log-posterior at 1e-8 with a rejected chain; runmode = atmosphere's
  .atm file; the post-processing's median atmosphere.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pyratbay_tpu import driver as jdriver  # noqa: E402
from pyratbay_tpu.atmosphere import chem as jchem  # noqa: E402
from pyratbay_tpu.benchmark import make_flagship  # noqa: E402
from pyratbay_tpu.model import Model as JModel  # noqa: E402
from pyratbay_tpu.observation import Observation as JObservation  # noqa: E402
from pyratbay_tpu.retrieval import RetrievalParams as JRetrievalParams  # noqa: E402
from pyratbay_tpu.retrieval.batched import (  # noqa: E402
    build_forward_batched as jbuild_forward_batched,
    build_log_posterior_batched as jbuild_log_posterior_batched,
)
from pyratbay_tpu_torch import driver  # noqa: E402
from pyratbay_tpu_torch.atmosphere import chem  # noqa: E402
from pyratbay_tpu_torch.benchmark import equilibrium_flagship_cfg  # noqa: E402
from pyratbay_tpu_torch.model import Model  # noqa: E402
from pyratbay_tpu_torch.observation import Observation  # noqa: E402
from pyratbay_tpu_torch.retrieval.batched import (  # noqa: E402
    build_forward_batched, build_log_posterior_batched,
)
from pyratbay_tpu_torch.retrieval.params import RetrievalParams  # noqa: E402

RTOL_VMR = 1e-10
RTOL_SLICE = 1e-8
CPU = torch.device('cpu')


def assert_vmr_close(got, want, rtol=RTOL_VMR):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    live = want > 1e-30
    np.testing.assert_allclose(got[live], want[live], rtol=rtol)


# ----------------------------------------------------------------------
# The copied host thermodynamics

def test_host_thermodynamics_are_copies():
    assert chem.ELEMENT_MASS == jchem.ELEMENT_MASS
    assert chem.SOLAR_ABUNDANCES == jchem.SOLAR_ABUNDANCES
    assert chem.supported_species() == jchem.supported_species()
    np.testing.assert_array_equal(chem._T_GRID, jchem._T_GRID)
    temp = np.array([150.0, 298.15, 900.0, 1000.0, 2500.0, 6000.0])
    for name in jchem.supported_species():
        assert chem.has_thermo(name)
        assert chem.parse_formula(name) == jchem.parse_formula(name)
        assert chem.species_mass(name) == jchem.species_mass(name)
        for got, want in zip(chem.thermo_properties(name, temp),
                             jchem.thermo_properties(name, temp)):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            chem.gibbs_over_rt(name, temp), jchem.gibbs_over_rt(name, temp))
    for name in ('e-', 'Na+', 'H-'):
        assert chem.parse_formula(name) == jchem.parse_formula(name)
    assert not chem.has_thermo('C60')
    with pytest.raises(ValueError, match='Unknown element'):
        chem.parse_formula('Xx2')


def test_read_solar_file(tmp_path):
    path = tmp_path / 'solar.txt'
    path.write_text(
        '# Z  symbol  dex  name  mass\n'
        '1  H  12.00  Hydrogen  1.008\n'
        '2  He  10.93  Helium  4.0026\n'
        '8  O   8.69  Oxygen  15.999\n')
    assert chem.read_solar_file(str(path)) == \
        jchem.read_solar_file(str(path))


# ----------------------------------------------------------------------
# The solver on tests/test_chem.py's networks

_NETWORKS = {
    'pcl_metals': (
        'H2 He H H2O CH4 CO PH3 PO P P2 HCl Cl NaCl KCl Na K Mg MgH Fe FeH',
        np.full(4, 1.0), np.array([500.0, 500.0, 2500.0, 2500.0]),
        'asplund_2021'),
    'cno': ('H2O CH4 CO CO2 NH3 HCN N2 H2 H He', np.logspace(-8, 3, 16),
            np.linspace(900.0, 2400.0, 16), 'asplund_2009'),
    'saha_ions': ('H2 He H Na Na+ K K+ e-', np.full(3, 1e-3),
                  np.array([2000.0, 2500.0, 3000.0]), 'asplund_2009'),
    'hydrides': ('H2 H He Fe FeH Ca CaH Cr CrH', np.logspace(-4, 1, 12),
                 np.full(12, 2000.0), 'asplund_2021'),
    'flagship_species': ('H2 He H H2O CH4 CO CO2 Na K',
                         np.logspace(-8, 2, 24),
                         np.linspace(400.0, 3500.0, 24), 'asplund_2021'),
}


@pytest.mark.parametrize('name', list(_NETWORKS))
def test_network_matches(name):
    species, press, temp, source = _NETWORKS[name]
    species = species.split()
    jnet = jchem.Network(press, temp, species, e_source=source)
    net = chem.Network(press, temp, species, e_source=source)
    assert list(net.species) == list(jnet.species)
    assert list(net.elements) == list(jnet.elements)
    np.testing.assert_array_equal(net._stoich_full, jnet._stoich_full)
    assert_vmr_close(net.thermochemical_equilibrium(),
                     jnet.thermochemical_equilibrium())
    # Overrides: metallicity, an element's dex, its scale and a ratio.
    kw = dict(metallicity=0.7, e_scale={'H': 0.0},
              e_abundances={'He': 10.9}, e_ratio={'C_O': 0.8})
    assert_vmr_close(net.thermochemical_equilibrium(**kw),
                     jnet.thermochemical_equilibrium(**kw))


def test_equilibrium_fn_per_chain():
    """equilibrium_fn over 3 chains, each with its own temperatures,
    [M/H], element offsets and C/O, against the JAX package's
    jit_equilibrium_fn chain by chain."""
    species, press, temp, source = _NETWORKS['cno']
    jnet = jchem.Network(press, temp, species.split(), e_source=source)
    net = chem.Network(press, temp, species.split(), e_source=source)
    jfn = jchem.jit_equilibrium_fn(jnet)
    fn = chem.equilibrium_fn(net, CPU)
    rng = np.random.default_rng(3)
    nb, nel = 3, len(net.elements)
    temps = temp[None] + rng.uniform(-300, 300, (nb, len(temp)))
    metal = np.array([-0.5, 0.0, 1.2])
    escale = rng.uniform(-0.3, 0.3, (nb, nel))
    ratio = np.array([0.3, 0.55, 1.1])
    ic, io = list(net.elements).index('C'), list(net.elements).index('O')
    got = fn(torch.as_tensor(temps), torch.as_tensor(metal),
             torch.as_tensor(escale),
             ((ic, io, torch.as_tensor(ratio)),)).numpy()
    assert got.shape == (nb, len(temp), len(species.split()))
    for b in range(nb):
        want = jfn(jnp.asarray(temps[b]), jnp.asarray(metal[b]),
                   jnp.asarray(escale[b]),
                   ((ic, io, jnp.asarray(ratio[b])),))
        assert_vmr_close(got[b], want)


def test_chemistry_helper(tmp_path):
    species, press, temp, _ = _NETWORKS['flagship_species']
    species = species.split()
    for model in ('free', 'equilibrium'):
        q = np.full(len(species), 0.1) if model == 'free' else None
        got = chem.chemistry(model, press, temp, species, q_uniform=q,
                             atmfile=str(tmp_path / f'{model}.atm'))
        want = jchem.chemistry(model, press, temp, species, q_uniform=q,
                               atmfile=str(tmp_path / f'j{model}.atm'))
        assert list(got[1]) == list(want[1])
        assert_vmr_close(got[2], want[2])
    with pytest.raises(ValueError, match='Invalid chemistry model'):
        chem.chemistry('tea', press, temp, species)


# ----------------------------------------------------------------------
# Model: element models, hybrids, errors, Model.run

_CFG = """[pyrat]
runmode = spectrum
rt_path = transit
wl_low = 1.0 um
wl_high = 2.0 um
resolution = 2000.0
nlayers = 24
ptop = 1e-8 bar
pbottom = 100 bar
tmodel = isothermal
tpars = 1400.0
chemistry = equilibrium
species = H2 He H H2O CH4 CO CO2 Na K
vmr_vars = [M/H] 0.0
rayleigh = rayleigh_H2
alkali = sodium_vdw potassium_vdw
rplanet = 1.0 rjup
mplanet = 0.6 mjup
rstar = 1.0 rsun
refpressure = 0.1 bar
radmodel = hydro_m
"""


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


@pytest.fixture(scope='module')
def chem_models(tmp_path_factory):
    """tests/test_chem.py:318's config in both packages, and its hybrid
    variant with log_H2O, C/O and [Na/H]."""
    tmp = tmp_path_factory.mktemp('torch_chem')
    cfg = _write(tmp, 'eq.cfg', _CFG)
    cfg2 = _write(tmp, 'eq2.cfg', _CFG.replace(
        'vmr_vars = [M/H] 0.0',
        'vmr_vars = [M/H] 0.0\n    log_H2O -5.0\n    C/O 0.9\n'
        '    [Na/H] 0.3'))
    return ((JModel(cfg), Model(cfg, device='cpu')),
            (JModel(cfg2), Model(cfg2, device='cpu')))


def test_model_setup_and_run(chem_models):
    (jmodel, model), _ = chem_models
    assert model.species == jmodel.species
    np.testing.assert_array_equal(model.mol_mass, jmodel.mol_mass)
    assert_vmr_close(model.base_vmr, jmodel.base_vmr)
    np.testing.assert_array_equal(model.base_temp, jmodel.base_temp)
    want = jmodel.run()
    got = model.run()
    np.testing.assert_allclose(got['spectrum'].numpy(),
                               np.asarray(want['spectrum']), rtol=RTOL_SLICE)
    assert_vmr_close(model.vmr, jmodel.vmr)


@pytest.mark.parametrize('pars', [
    'configured', 'metal_1.0', 'set_up_profile', 'hot_profile',
])
def test_eval_vmr_metallicity(chem_models, pars):
    (jmodel, model), _ = chem_models
    temp = None
    vmr_pars = None
    if pars == 'metal_1.0':
        vmr_pars = [np.array([1.0])]
    elif pars == 'set_up_profile':
        vmr_pars = [None]
        temp = jmodel.base_temp
    elif pars == 'hot_profile':
        vmr_pars = [None]
        temp = np.linspace(900.0, 2600.0, jmodel.nlayers)
    want = np.asarray(jmodel.eval_vmr(vmr_pars, temp=temp))
    got = model.eval_vmr(vmr_pars, temp=temp).numpy()
    assert_vmr_close(got, want)
    if pars == 'set_up_profile':
        # No parameters at the set-up profile: the set-up solution.
        np.testing.assert_array_equal(got, model.base_vmr)


@pytest.mark.parametrize('pars', [
    'configured', [0.5, -4.0, 0.4, -0.2], [0.0, 0.0, 0.9, 0.0],
])
def test_eval_vmr_hybrid_ratio_and_element(chem_models, pars):
    """[M/H], a hybrid log_H2O (the last case asks for more H2O than the
    O budget allows: the cap), C/O and [Na/H]."""
    _, (jmodel, model) = chem_models
    vmr_pars = None if pars == 'configured' \
        else [np.array([p]) for p in pars]
    want = np.asarray(jmodel.eval_vmr(vmr_pars))
    got = model.eval_vmr(vmr_pars).numpy()
    assert_vmr_close(got, want)
    if pars != 'configured' and pars[1] == 0.0:
        i_h2o = model.species.index('H2O')
        assert got[12, i_h2o] < 2e-3


@pytest.mark.parametrize('vmr_vars, match', [
    ('[Ti/H] 0.0', "element 'Ti' is not in the atmosphere"),
    ('C/Ti 0.5', 'elements are not in the atmosphere'),
    ('log_TiO -5.0', 'species TiO is not in the atmosphere'),
    ('scale_H2O 0.5', 'only log_X free models combine'),
    ('Foo 1.0', 'Unrecognized VMR model'),
])
def test_vmr_vars_errors(tmp_path, vmr_vars, match):
    cfg = _write(tmp_path, 'bad.cfg', _CFG.replace(
        'vmr_vars = [M/H] 0.0', f'vmr_vars = {vmr_vars}'))
    with pytest.raises(ValueError, match=match):
        JModel(cfg)
    with pytest.raises(ValueError, match=match):
        Model(cfg, device='cpu')


def test_element_models_need_equilibrium(tmp_path):
    text = _CFG.replace('chemistry = equilibrium',
                        'chemistry = free\nuniform_vmr = ' + ' '.join(
                            ['0.1'] * 9))
    cfg = _write(tmp_path, 'free.cfg', text)
    with pytest.raises(ValueError, match='requires chemistry=equilibrium'):
        JModel(cfg)
    with pytest.raises(ValueError, match='requires chemistry=equilibrium'):
        Model(cfg, device='cpu')


def test_species_without_thermo_are_dropped(tmp_path):
    cfg = _write(tmp_path, 'drop.cfg', _CFG.replace(
        'species = H2 He H H2O CH4 CO CO2 Na K',
        'species = H2 He H H2O CH4 CO CO2 Na K C60'))
    jmodel, model = JModel(cfg), Model(cfg, device='cpu')
    assert 'C60' not in model.species
    assert model.species == jmodel.species
    assert model.chem_model.dropped_species == ['C60']


# ----------------------------------------------------------------------
# The flagship with the network: batched forward and log-posterior

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
def eq_flagship(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp('torch_chem_flagship'))
    make_flagship(workdir, nlayers=21, wl_low=1.1, wl_high=1.3, wnstep=4.0)
    cfg = equilibrium_flagship_cfg(workdir + '/flagship.cfg',
                                   workdir + '/equilibrium.cfg')
    jmodel = JModel(cfg)
    jobs = JObservation(_ObsCfg, jmodel.wn)
    model = Model(cfg, device='cpu')
    obs = Observation(_ObsCfg, model.wn)
    return (jmodel, jobs, JRetrievalParams(jmodel, jobs)), \
        (model, obs, RetrievalParams(model, obs)), cfg


def test_flagship_forward_and_log_posterior(eq_flagship):
    (jmodel, jobs, jret), (model, obs, ret), _ = eq_flagship
    assert model.chem_model is not None
    assert list(ret.pnames) == list(jret.pnames)
    assert '[M/H]' in ret.pnames and 'C/O' in ret.pnames
    p0 = np.asarray(ret.params)
    rng = np.random.default_rng(0)
    pb = np.tile(p0, (5, 1)) + 0.05 * rng.standard_normal((5, len(p0)))
    pb[:, 3] = [0.3, 0.55, 0.8, 1.2, 0.55]      # C/O
    pb[-1, 1] = 1.0e6                          # rejected chain (T_irr)
    ref = jax.jit(jbuild_forward_batched(jmodel, jobs, jret))(
        jnp.asarray(pb))
    forward_b = build_forward_batched(model, obs, ret)
    got = forward_b(pb)
    good = np.asarray(ref['good'])
    np.testing.assert_array_equal(got['good'].numpy(), good)
    assert good[:-1].all() and not good[-1]
    np.testing.assert_allclose(got['spectrum'].numpy(),
                               np.asarray(ref['spectrum']), rtol=RTOL_SLICE)
    band, jband = got['bandflux'].numpy(), np.asarray(ref['bandflux'])
    np.testing.assert_array_equal(np.isinf(band), np.isinf(jband))
    np.testing.assert_allclose(band[good], jband[good], rtol=RTOL_SLICE)

    # The state re-solves the network for every chain:
    vmr = forward_b.state(torch.as_tensor(pb))['vmr'].numpy()
    for b in range(len(pb) - 1):
        want = jmodel.eval_vmr(
            [np.array([pb[b, 2]]), np.array([pb[b, 3]])],
            temp=np.asarray(ref['temperature'])[b])
        assert_vmr_close(vmr[b], want, rtol=RTOL_SLICE)

    data = jband[0] * (1 + 1e-4 * np.sin(np.arange(len(jband[0]))))
    pb[2, 2] = 5.0                     # [M/H] above pmax
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
    assert np.isinf(lp[[2, 4]]).all()
    fin = np.isfinite(jlp)
    np.testing.assert_allclose(lp[fin], jlp[fin], rtol=RTOL_SLICE)


def test_atmosphere_runmode_writes_the_network(tmp_path, eq_flagship):
    """runmode = atmosphere with the network: the .atm of both drivers
    (the set-up profile's equilibrium, as the JAX package writes it)."""
    with open(eq_flagship[2]) as f:
        text = f.read()
    text = text.replace('runmode = spectrum', 'runmode = atmosphere')
    files = {}
    for tag in ('jax', 'port'):
        files[tag] = str(tmp_path / f'{tag}.atm')
        cfg = _write(tmp_path, f'{tag}.cfg', text + f'output_atmfile = '
                     f'{files[tag]}\n')
        if tag == 'jax':
            jdriver.run(cfg, with_log=False)
        else:
            driver.run(cfg, device='cpu')
    from pyratbay_tpu_torch.io import io as pio
    got, want = pio.read_atm(files['port']), pio.read_atm(files['jax'])
    assert list(got[1]) == list(want[1])
    for g, w in zip(got[2:], want[2:]):
        if w is None:
            assert g is None
        else:
            np.testing.assert_allclose(g, w, rtol=1e-9)


def test_post_processing_with_the_network(tmp_path, eq_flagship,
                                          monkeypatch):
    """The port's posterior_post_processing of an equilibrium retrieval:
    its _median.atm holds the network's VMRs at the posterior median's
    temperature (what pyratbay_tpu's eval_vmr gives there; 7 digits are
    written, so 2e-6), and the envelopes are finite."""
    from pyratbay_tpu.retrieval.forward import (
        build_forward as jbuild_forward)
    from pyratbay_tpu_torch.io import io as pio
    from pyratbay_tpu_torch.retrieval import driver as rdriver
    (jmodel, jobs, jret), (model, _, ret), cfg = eq_flagship
    with open(cfg) as f:
        text = f.read().replace('runmode = spectrum', 'runmode = retrieval')
    base = str(tmp_path / 'eq_post')
    text = text.replace(f'logfile = {os.path.dirname(cfg)}/flagship.log',
                        f'logfile = {base}.log')
    filters = [f'tophat {wl0:.4f} 0.01' for wl0 in np.linspace(1.13, 1.27, 6)]
    text += '\n'.join([
        'data = ' + ' '.join(['1.08e-02'] * 6),
        'uncert = ' + ' '.join(['1.0e-04'] * 6),
        'filters =', *[f'    {entry}' for entry in filters], ''])
    ret_cfg = _write(tmp_path, 'eq_post.cfg', text)
    rng = np.random.default_rng(12)
    p0 = np.asarray(ret.params)
    posterior = np.clip(p0 + 0.3 * ret.pstep * rng.standard_normal(
        (40, len(p0))), ret.pmin, ret.pmax)
    np.savez(base + '.npz', posterior=posterior, bestp=p0,
             best_log_post=-1.0, spec_best=np.full(model.nwave, 0.0108),
             bandflux_best=np.full(6, 0.0108))
    monkeypatch.setattr(rdriver, '_plots', lambda *a, **k: None)
    rdriver.posterior_post_processing(ret_cfg, suffix='_torch',
                                      device='cpu')
    with np.load(base + '_torch_spectrum_posterior.npz') as spost:
        assert np.all(np.isfinite(spost['median']))
    _, species, _, temp, vmr, _ = pio.read_atm(base + '_torch_median.atm')
    assert list(species) == model.species
    median_temp = np.asarray(jbuild_forward(jmodel, jobs, jret)(
        np.median(posterior, axis=0))['temperature'])
    np.testing.assert_allclose(temp, median_temp, atol=5e-4)
    want = np.asarray(jmodel.eval_vmr(temp=median_temp))
    assert_vmr_close(vmr, want, rtol=2e-6)


# ----------------------------------------------------------------------
# The solve kernel's size limit and the solve's span, on the CPU

@pytest.mark.parametrize('sizes', [(25, 6, 0), (9, 16, 0), (9, 6, 5)],
                         ids=['species', 'columns', 'ratios'])
def test_kernel_size_limit_names_itself(sizes):
    """Above CHEM_MAX_SPECIES species, CHEM_MAX_COLS element columns or
    CHEM_MAX_RATIOS ratios the card's solve raises ValueError naming the
    limit (checked before any launch); at the limits it passes."""
    with pytest.raises(ValueError, match='CHEM_MAX_'):
        chem.check_kernel_size(*sizes)
    chem.check_kernel_size(chem.CHEM_MAX_SPECIES, chem.CHEM_MAX_COLS,
                           chem.CHEM_MAX_RATIOS)
    # Every network the tests build fits:
    assert 20 <= chem.CHEM_MAX_SPECIES and 11 <= chem.CHEM_MAX_COLS


def test_the_solve_records_its_span_and_systems(chem_models):
    """While torch.profiler records, a batched VMR evaluation with the
    network records pbt.state.chem inside the span open around it, with
    pbt.chem.systems = chains x layers; off, nothing."""
    from torch.profiler import ProfilerActivity, profile
    from pyratbay_tpu_torch import tracing
    (_, model), _ = chem_models
    nb = 3
    temp = torch.full((nb, model.nlayers), 1400.0, dtype=torch.float64)
    pars = [torch.zeros((nb, 1), dtype=torch.float64)]     # [M/H]
    rec = tracing.RECORDER
    n0 = len(rec.spans)
    model.eval_vmr_batched(pars, temp)
    assert len(rec.spans) == n0
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span('pbt.state.vmr'):
            model.eval_vmr_batched(pars, temp)
    solve, = [s for s in rec.spans[n0:] if s.name == 'pbt.state.chem']
    assert solve.parent.name == 'pbt.state.vmr'
    assert solve.counts == {'pbt.chem.systems': nb * model.nlayers}
