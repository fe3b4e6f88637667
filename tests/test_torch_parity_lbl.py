"""The parity line-by-line engine of the port against pyratbay_tpu,
float64 on the CPU.

* The Voigt-profile machinery (pierluissi_voigt, voigt_binned_profile,
  VoigtGrid) and the width bounds (min_widths, max_widths) equal the
  JAX package's.
* LineByLine.cross_section (per species, one layer or all) and
  extinction, with and without a skipped species, exactly (both
  packages group and scatter the lines in their native runtimes, built
  from one source with one compiler and flags).
* Model.compute_opacity()'s default engine and the table that
  `runmode = opacity` writes through the CLI's driver, against the JAX
  package's, exactly.
* Model.run from a TLI file (runmode = spectrum, transit and eclipse)
  against the JAX package's eager Model.run at rtol 1e-8, and the
  per-model diagnostic Model.get_ec.
* The batched forward of a line-by-line model runs through the direct
  engine, as the JAX package's forward does, at rtol 1e-10 against it.

At test size: 3000 synthetic HITRAN H2O lines (~670 in the window),
1.1-1.2 um at 1 cm-1 (758 points), 21 layers, a 10 x 10 profile grid.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from pyratbay_tpu import driver as jdriver  # noqa: E402
from pyratbay_tpu.model import Model as JModel  # noqa: E402
from pyratbay_tpu.ops import special as jspecial  # noqa: E402
from pyratbay_tpu.opacity import voigt_grid as jvoigt  # noqa: E402
from pyratbay_tpu_torch import benchmark  # noqa: E402
from pyratbay_tpu_torch.driver import run  # noqa: E402
from pyratbay_tpu_torch.io import io as pio  # noqa: E402
from pyratbay_tpu_torch.model import Model  # noqa: E402
from pyratbay_tpu_torch.ops import special  # noqa: E402
from pyratbay_tpu_torch.opacity import voigt_grid  # noqa: E402
from pyratbay_tpu_torch.retrieval.batched import (  # noqa: E402
    build_forward_batched,
)

from test_torch_runtime import jax_native_runtime  # noqa: E402

RTOL = 1e-10
RUN_RTOL = 1e-8
PARITY_RTOL = 0     # the parity engine's own output: native = native
NLAYERS = 21

SPECTRUM_KEYS = """rt_path = {rt_path}
tmodel = isothermal
tpars = 1200.0
rstar = 1.27 rsun
tstar = 5800.0
rplanet = 1.0 rjup
mplanet = 0.6 mjup
refpressure = 0.1 bar
radmodel = hydro_m
smaxis = 0.045 au
specfile = {specfile}
"""


@pytest.fixture(scope='module')
def workflow(tmp_path_factory):
    """make_lbl_flagship at test size, its TLI file, and runmode =
    spectrum configs (transit, eclipse) that read it."""
    jax_native_runtime()
    workdir = str(tmp_path_factory.mktemp('parity'))
    _, tli_cfg, opacity_cfg = benchmark.make_lbl_flagship(
        workdir, nlines=3000, seed=0, nlayers=NLAYERS, wl_low=1.1,
        wl_high=1.2)
    run(tli_cfg, device='cpu')
    with open(opacity_cfg, 'a') as f:
        f.write('ndop = 10\nnlor = 10\n')
    with open(opacity_cfg) as f:
        text = f.read()
    spectrum = {}
    for rt_path in ('transit', 'eclipse'):
        cfg = os.path.join(workdir, f'{rt_path}.cfg')
        body = text.replace('runmode = opacity', 'runmode = spectrum')
        body = '\n'.join(ln for ln in body.splitlines()
                         if not ln.startswith('sampled_cross_sec'))
        with open(cfg, 'w') as f:
            f.write(body + '\n' + SPECTRUM_KEYS.format(
                rt_path=rt_path,
                specfile=os.path.join(workdir, f'{rt_path}_spec.dat')))
        spectrum[rt_path] = cfg
    return dict(workdir=workdir, opacity_cfg=opacity_cfg, **spectrum)


@pytest.fixture(scope='module')
def models(workflow):
    """(port, JAX) Models of the opacity config and their lbl models."""
    model = Model(workflow['opacity_cfg'], device='cpu')
    jmodel = JModel(workflow['opacity_cfg'])
    return model, jmodel, model.opacity_models[0][1], \
        jmodel.opacity_models[0][1]


def layer_state(model, temp=1350.0):
    """An isothermal profile with its number densities [l, nspecies]."""
    temps = np.linspace(0.6, 1.4, model.nlayers) * temp
    dens = model.base_vmr * (model.press[:, None] * 1e6
                             / (1.380649e-16 * temps[:, None]))
    return temps, dens


# ----------------------------------------------------------------------
# Voigt profiles and their grid

def test_voigt_profiles_match_jax():
    x = np.linspace(0.0, 12.0, 997)
    for y in (0.01, 0.5, 1.7, 3.0, 7.0):
        np.testing.assert_allclose(
            voigt_grid.pierluissi_voigt(x, y, 0.02),
            jvoigt.pierluissi_voigt(x, y, 0.02), rtol=1e-14, atol=0)
    for psize, dwn, alor, adop in ((40, 0.01, 0.05, 0.02),
                                   (400, 0.001, 0.002, 0.03),
                                   (60000, 0.0004, 0.1, 0.02)):
        np.testing.assert_array_equal(
            voigt_grid.voigt_binned_profile(psize, dwn, alor, adop),
            jvoigt.voigt_binned_profile(psize, dwn, alor, adop))
    args = (300.0, 3000.0, 8000.0, 18.0, 1.6e-8, 1e-6)
    assert special.min_widths(*args) == jspecial.min_widths(*args)
    assert special.max_widths(*args) == jspecial.max_widths(*args)


def test_voigt_grid_matches_jax(models):
    _, _, lbl, jlbl = models
    for attr in ('doppler', 'lorentz', 'size', 'index', 'profile', 'dmin',
                 'dmax', 'lmin', 'lmax'):
        np.testing.assert_array_equal(getattr(lbl.voigt, attr),
                                      getattr(jlbl.voigt, attr), attr)
    assert str(lbl.voigt) == str(jlbl.voigt)
    assert str(lbl) == str(jlbl)
    # One grid a process for equal arguments:
    model2 = Model(models[0].cfg.config_file, device='cpu')
    assert model2.opacity_models[0][1].voigt is lbl.voigt


# ----------------------------------------------------------------------
# The engine

@pytest.mark.parametrize('layer', [None, 7])
def test_cross_section_matches_jax(models, layer):
    model, _, lbl, jlbl = models
    temps, dens = layer_state(model)
    got = lbl.cross_section(temps, dens, layer=layer, per_mol=True)
    want = jlbl.cross_section(temps, dens, layer=layer, per_mol=True)
    assert got.shape == (1, model.nlayers, model.nwave)
    np.testing.assert_allclose(got, want, rtol=PARITY_RTOL, atol=0)
    assert np.count_nonzero(got) > 0
    np.testing.assert_allclose(lbl.cross_section(temps, dens),
                               jlbl.cross_section(temps, dens),
                               rtol=PARITY_RTOL, atol=0)


@pytest.mark.parametrize('skip', [(), ('H2O',)])
def test_extinction_matches_jax(models, skip):
    model, _, lbl, jlbl = models
    temps, dens = layer_state(model, temp=2100.0)
    got = lbl.extinction(temps, dens, skip=skip)
    want = jlbl.extinction(temps, dens, skip=skip)
    np.testing.assert_allclose(got, want, rtol=PARITY_RTOL, atol=0)
    assert (np.count_nonzero(got) == 0) == bool(skip)


def test_compute_opacity_default_engine_matches_jax(workflow, models):
    model, jmodel, _, _ = models
    table = model.compute_opacity()
    jtable = jmodel.compute_opacity()
    assert table.shape == (10, NLAYERS, model.nwave)
    np.testing.assert_allclose(table, jtable, rtol=PARITY_RTOL, atol=0)


def test_cli_opacity_matches_jax(workflow, tmp_path):
    """runmode = opacity through both drivers: the written tables."""
    with open(workflow['opacity_cfg']) as f:
        text = f.read()
    files = {}
    for name in ('port', 'jax'):
        files[name] = str(tmp_path / f'{name}_table.npz')
        cfg = str(tmp_path / f'{name}.cfg')
        with open(cfg, 'w') as f:
            f.write(text.replace(
                os.path.join(workflow['workdir'], 'flagship_h2o_lbl.npz'),
                files[name]).replace('tstep = 300', 'tstep = 900'))
        if name == 'port':
            run(cfg, device='cpu')
        else:
            jdriver.run(cfg)
    with np.load(files['port']) as got, np.load(files['jax']) as want:
        for key in ('species', 'temperature', 'pressure', 'wavenumber'):
            np.testing.assert_array_equal(got[key], want[key])
        assert got['opacity'].shape == (4, NLAYERS, len(got['wavenumber']))
        np.testing.assert_allclose(got['opacity'], want['opacity'],
                                   rtol=PARITY_RTOL, atol=0)


# ----------------------------------------------------------------------
# Model.run and get_ec from a TLI file

@pytest.mark.parametrize('rt_path', ['transit', 'eclipse'])
def test_model_run_from_tli_matches_jax(workflow, rt_path):
    model = run(workflow[rt_path], device='cpu')
    jmodel = JModel(workflow[rt_path])
    jmodel.run()
    assert [m[0] for m in model.opacity_models] == ['lbl']
    np.testing.assert_allclose(model.spectrum, jmodel.spectrum,
                               rtol=RUN_RTOL, atol=0)
    np.testing.assert_allclose(model.depth.numpy(),
                               np.asarray(jmodel.depth), rtol=RUN_RTOL,
                               atol=1e-300)
    _, spec = pio.read_spectrum(model.cfg.specfile)
    np.testing.assert_allclose(spec, model.spectrum, rtol=1e-8)


@pytest.mark.parametrize('layer', [3, 15])
def test_get_ec_matches_jax(workflow, layer):
    text = open(workflow['transit']).read() + 'clouds = deck 0.0\n' \
        + 'continuum_cross_sec = CIA_Borysow_H2H2_0060-7000K_0.6-500um.npz\n'
    cfg = os.path.join(workflow['workdir'], 'get_ec.cfg')
    with open(cfg, 'w') as f:
        f.write(text)
    ec, labels = Model(cfg, device='cpu').get_ec(layer)
    jec, jlabels = JModel(cfg).get_ec(layer)
    assert list(labels) == list(jlabels) == ['H2O', 'CIA H2-H2', 'deck']
    np.testing.assert_allclose(ec.numpy(), np.asarray(jec), rtol=RTOL,
                               atol=0)


def test_batched_forward_of_lbl_model_raises(workflow):
    """The batched forward of a TLI model runs (A12): through the direct
    engine on the model's device, as the JAX package's forward does
    (lbl_engine = 'direct'), at rtol 1e-10 against it; Model.run keeps
    the parity engine, that package's default."""
    from pyratbay_tpu.retrieval.forward import build_forward as jforward
    model = Model(workflow['transit'], device='cpu')
    jmodel = JModel(workflow['transit'])
    got = build_forward_batched(model)()['spectrum'][0].numpy()
    # Eager: under jit XLA folds the float32 Lorentz constants another
    # way (~5e-10; tests/test_torch_lbl.py):
    want = np.asarray(jforward(jmodel)()['spectrum'])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    lbl = model.opacity_models[0][1]
    assert list(model._direct_lbl) == [(id(lbl), 'cpu')]
    # Model.run's parity engine differs from the direct engine by its
    # profile grid's quantization:
    parity = model.run()['spectrum'].numpy()
    assert not np.allclose(parity, want, rtol=RTOL, atol=0)
