"""runmode = spectrum and runmode = atmosphere: the port's Model.run and
driver against pyratbay_tpu's, set up from the same files at test size
(the flagship's tables, 21 layers, 1.1-1.3 um, wnstep 4), float64 on
the CPU, rtol 1e-8 (the slice bound of tests/test_torch_forward.py).

The models carry the opacity sources that ordinary configs name beside
the flagship's: Rayleigh scattering of H2, He, H and e-, the Lecavelier
haze and a gray cloud (six rank-1 terms, more than the kernels take),
H- bound-free/free-free, the bundled H2-He CIA table by basename (35 CIA
rows with the flagship's, more than the kernels take), a deck, and
patchy clouds.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402

from pyratbay_tpu import driver as jdriver  # noqa: E402
from pyratbay_tpu.benchmark import make_flagship  # noqa: E402
from pyratbay_tpu.io import io as jio  # noqa: E402
from pyratbay_tpu.model import Model as JModel  # noqa: E402
from pyratbay_tpu_torch import driver  # noqa: E402
from pyratbay_tpu_torch import model as model_mod  # noqa: E402
from pyratbay_tpu_torch.io import io as pio  # noqa: E402
from pyratbay_tpu_torch.model import Model  # noqa: E402
from pyratbay_tpu_torch.spectrum import transit_kernel as tk  # noqa: E402

RTOL = 1e-8
SPECIES = ['H2', 'He', 'H', 'Na', 'K', 'H2O', 'CH4', 'CO', 'CO2', 'e-']
VMR = [8.5e-1, 1.49e-1, 1e-6, 3e-6, 5e-8, 4e-4, 1e-4, 5e-4, 1e-7, 1e-6]
BUNDLED_H2HE = 'CIA_Borysow_H2He_0050-3000K_0.3-030um.npz'
CLOUDS = """clouds =
    deck {deck}
    lecavelier 0.0 -4.0
    ccsgray 0.5 -3.0 1.0"""


@pytest.fixture(scope='module')
def workdir(tmp_path_factory):
    """The flagship's tables and an atmosphere with free electrons."""
    workdir = str(tmp_path_factory.mktemp('torch_spectrum'))
    make_flagship(workdir, nlayers=21, wl_low=1.1, wl_high=1.3, wnstep=4.0)
    press = np.logspace(-6, 2, 21)
    pio.write_atm(os.path.join(workdir, 'electrons.atm'), press,
                  np.full(21, 1400.0), SPECIES, np.tile(VMR, (21, 1)),
                  punits='bar')
    return workdir


def write_cfg(workdir, name, rt_path='transit', deck=-1.0, extra='',
              runmode='spectrum', layers=''):
    """A spectrum config over the flagship's tables with the sources of
    this slice; returns its path."""
    text = f"""[pyrat]
runmode = {runmode}
verb = -1
logfile = {workdir}/{name}.log
specfile = {workdir}/{name}.dat
rt_path = {rt_path}
atmfile = {workdir}/electrons.atm
{layers}
sampled_cross_sec = {workdir}/flagship_h2o.npz
continuum_cross_sec = {workdir}/flagship_cia.dat {BUNDLED_H2HE}
wl_low = 1.1 um
wl_high = 1.3 um
wnstep = 4.0
rstar = 1.27 rsun
tstar = 5800.0
smaxis = 0.045 au
mplanet = 0.6 mjup
rplanet = 1.0 rjup
refpressure = 0.1 bar
radmodel = hydro_m
maxdepth = 10.0
tmodel = guillot
tpars = -4.67 -0.8 -0.8 0.5 1486.0 100.0
vmr_vars = log_H2O -3.4
bulk = H2 He
alkali = sodium_vdw
rayleigh = rayleigh_H2 rayleigh_He rayleigh_H rayleigh_e-
h_ion = h_ion_john1988
{CLOUDS.format(deck=deck)}
{extra}
"""
    path = os.path.join(workdir, name + '.cfg')
    with open(path, 'w') as f:
        f.write(text)
    return path


CASES = {
    'transit': dict(),
    'transit_patchy': dict(extra='fpatchy = 0.4'),
    'transit_deck_at_bottom': dict(deck=2.0),
    'transit_81_layers': dict(
        layers='ptop = 1e-6 bar\npbottom = 100 bar\nnlayers = 81'),
    'eclipse': dict(rt_path='eclipse'),
    'eclipse_patchy': dict(rt_path='eclipse', extra='fpatchy = 0.4'),
    'emission_81_layers': dict(
        rt_path='emission',
        layers='ptop = 1e-6 bar\npbottom = 100 bar\nnlayers = 81'),
    'f_lambda': dict(rt_path='f_lambda', extra='distance = 50.0 pc'),
}


def _assert_run_matches(got, ref, patchy):
    np.testing.assert_allclose(got['spectrum'].numpy(),
                               np.asarray(ref['spectrum']), rtol=RTOL)
    np.testing.assert_allclose(got['depth'].numpy(),
                               np.asarray(ref['depth']), rtol=RTOL,
                               atol=1e-300)
    np.testing.assert_array_equal(got['ideep'].numpy(),
                                  np.asarray(ref['ideep']))
    for key in ('clear', 'cloudy', 'depth_clear', 'ideep_clear'):
        assert (key in got) == (key in ref), key
        if key in ref:
            np.testing.assert_allclose(
                got[key].numpy(), np.asarray(ref[key]), rtol=RTOL,
                err_msg=key)
    assert ('clear' in got) == patchy


@pytest.mark.parametrize('case', list(CASES))
def test_model_run_matches_jax(workdir, case):
    cfg = write_cfg(workdir, case, **CASES[case])
    jmodel = JModel(cfg)
    ref = jmodel.run()
    model = Model(cfg, device='cpu')
    got = model.run()
    patchy = 'patchy' in case
    _assert_run_matches(got, ref, patchy)
    # The stored results, as the reference stores them:
    np.testing.assert_allclose(model.spectrum, jmodel.spectrum, rtol=RTOL)
    for key in ('temp', 'radius', 'vmr'):
        np.testing.assert_allclose(getattr(model, key),
                                   np.asarray(getattr(jmodel, key)),
                                   rtol=RTOL, err_msg=key)
    if patchy:
        np.testing.assert_allclose(model.clear, jmodel.clear, rtol=RTOL)
        np.testing.assert_allclose(model.cloudy, jmodel.cloudy, rtol=RTOL)
    else:
        assert model.clear is None and model.cloudy is None
    if case.endswith('81_layers'):
        assert model.nlayers == 81 and jmodel.nlayers == 81


def test_model_run_arguments_match_jax(workdir):
    """Explicit T(p) parameters, VMR parameters, opacity parameters, a
    patchy fraction and a skipped source, as keyword arguments."""
    cfg = write_cfg(workdir, 'arguments', extra='fpatchy = 0.4')
    jmodel, model = JModel(cfg), Model(cfg, device='cpu')
    kw = dict(tpars=[-4.0, -0.5, -1.0, 0.3, 1300.0, 150.0],
              vmr_pars=[np.array([-3.0])], fpatchy=0.7,
              skip=('rayleigh_He', 'H2O'))
    jpars = [None if p is None else np.asarray(p) * 1.05
             for p in jmodel.model_pars()]
    ref = jmodel.run(pars_list=jpars, **kw)
    got = model.run(pars_list=jpars, **kw)
    _assert_run_matches(got, ref, patchy=True)


def test_model_run_out_of_bounds(workdir):
    cfg = write_cfg(workdir, 'out_of_bounds')
    hot = np.full(21, 3500.0)
    ref = JModel(cfg).run(temp=hot)
    model = Model(cfg, device='cpu')
    got = model.run(temp=hot)
    assert got['out_of_bounds'] == ref['out_of_bounds'] == [
        'cia', 'line_sample']
    assert not np.any(got['spectrum'].numpy())
    np.testing.assert_array_equal(model.spectrum, np.zeros(model.nwave))


def test_model_run_goes_through_the_size_rule(workdir, monkeypatch):
    """Model.run hands the RT wrapper at most MAX_R1 rank-1 terms and
    MAX_CIA CIA rows (six and 35 before the rule), at B = 1, once."""
    seen = []
    real = model_mod.transit_spectrum_ensemble

    def recorder(ec_parts, *args, **kw):
        seen.append((list(ec_parts), kw))
        return real(ec_parts, *args, **kw)

    monkeypatch.setattr(model_mod, 'transit_spectrum_ensemble', recorder)
    Model(write_cfg(workdir, 'rule'), device='cpu').run()
    (parts, kw), = seen
    assert kw['r1_cols'].shape == (1, tk.MAX_R1, 21)
    assert kw['cia_w'].shape == (1, 21, tk.MAX_CIA)
    assert kw['ls_w'] is not None
    # H- with the two rank-1 terms beyond the limit, and the CIA rows
    # beyond it:
    assert [p.shape for p in parts] == [(1, 21, len(kw['r1_rows'][0, 0]))] * 2


@pytest.mark.parametrize('rt_path', ['transit', 'eclipse'])
def test_driver_writes_the_spectrum_file(workdir, rt_path):
    """python -m pyratbay_tpu_torch's runmode = spectrum writes the
    spec file that pyratbay_tpu's driver writes."""
    cfg = write_cfg(workdir, f'driver_{rt_path}', rt_path=rt_path)
    specfile = os.path.join(workdir, f'driver_{rt_path}.dat')
    jdriver.run(cfg)
    jwn, jspec = jio.read_spectrum(specfile)
    model = driver.run(cfg, device='cpu')
    wn, spec = pio.read_spectrum(specfile)
    np.testing.assert_allclose(wn, jwn, rtol=1e-12)
    np.testing.assert_allclose(spec, jspec, rtol=1e-8)
    np.testing.assert_allclose(spec, model.spectrum, rtol=1e-8)


@pytest.mark.parametrize('tmodel', ['guillot', 'madhu', 'read'])
def test_driver_writes_the_atmosphere_file(workdir, tmodel):
    """runmode = atmosphere: the input atmosphere interpolated onto a
    calculated 33-layer grid, the T(p) model (or the read temperature)
    and hydro_m radii, written to output_atmfile as pyratbay_tpu writes
    it."""
    cfg = write_cfg(
        workdir, f'atm_{tmodel}', runmode='atmosphere',
        layers='ptop = 1e-5 bar\npbottom = 50 bar\nnlayers = 33',
        extra=f'output_atmfile = {workdir}/atm_{tmodel}_{{}}.atm')
    with open(cfg) as f:
        text = f.read()
    if tmodel == 'madhu':
        text = text.replace(
            'tmodel = guillot\ntpars = -4.67 -0.8 -0.8 0.5 1486.0 100.0',
            'tmodel = madhu\ntpars = -4.5 -2.0 0.5 0.8 0.6 1300.0')
        assert 'madhu' in text
    elif tmodel == 'read':
        text = text.replace(
            'tmodel = guillot\ntpars = -4.67 -0.8 -0.8 0.5 1486.0 100.0', '')
    outputs = []
    for who, run in (('jax', jdriver.run), ('port', driver.run)):
        who_cfg = cfg.replace('.cfg', f'_{who}.cfg')
        with open(who_cfg, 'w') as f:
            f.write(text.replace('{}', who))
        kw = {} if who == 'jax' else dict(device='cpu')
        run(who_cfg, **kw)
        outputs.append(jio.read_atm(f'{workdir}/atm_{tmodel}_{who}.atm'))
    (junits, jspecies, jpress, jtemp, jvmr, jradius), \
        (units, species, press, temp, vmr, radius) = outputs
    assert units == junits and list(species) == list(jspecies)
    assert len(press) == 33
    # Equal to the digits the file keeps:
    np.testing.assert_allclose(press, jpress, rtol=1e-6)
    np.testing.assert_allclose(temp, jtemp, atol=2e-3)
    np.testing.assert_allclose(vmr, jvmr, rtol=1e-6)
    np.testing.assert_allclose(radius, jradius, rtol=1e-8)
    assert np.all(np.isfinite(radius))
