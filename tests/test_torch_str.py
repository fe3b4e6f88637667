"""What users see of a model: every public object's printed summary,
the setup log, Model.timestamps and the plots of pyratbay_tpu_torch
against pyratbay_tpu's, on the flagship at test size (21 layers,
1.1-1.3 um, wnstep 4: tests/test_str_full.py's set-up at half its
points), float64 on the CPU.

The summaries are equal letter for letter; a Model's first line names
its package, and its timestamps differ by nature, so a Model's text is
compared from its second line to the timestamps block.
"""
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from pyratbay_tpu import benchmark as jbench  # noqa: E402
from pyratbay_tpu import logger as jlogger  # noqa: E402
from pyratbay_tpu import opacity as jop  # noqa: E402
from pyratbay_tpu.model import Model as JModel  # noqa: E402
from pyratbay_tpu.observation import Observation as JObservation  # noqa: E402
from pyratbay_tpu.spectrum import passbands as jpass  # noqa: E402
from pyratbay_tpu_torch import benchmark  # noqa: E402
from pyratbay_tpu_torch import logger  # noqa: E402
from pyratbay_tpu_torch import opacity as op  # noqa: E402
from pyratbay_tpu_torch.model import Model  # noqa: E402
from pyratbay_tpu_torch.observation import Observation  # noqa: E402
from pyratbay_tpu_torch.spectrum import passbands  # noqa: E402

SIZE = dict(nlayers=21, wl_low=1.1, wl_high=1.3, wnstep=4.0)
RUN_KEYS = ('setup spectrum', 'setup atmosphere', 'setup opacity',
            'atmosphere', 'extinction', 'spectrum')


def model_text(model):
    """A Model's summary from its second line to the timestamps."""
    return str(model).split('Last-run timestamps')[0].split('\n', 1)[1]


@pytest.fixture(scope='module')
def flagships(tmp_path_factory):
    """(JAX, port) make_flagship results from the same written inputs."""
    tmp = tmp_path_factory.mktemp('torch_str')
    jflag = jbench.make_flagship(str(tmp / 'jax'), **SIZE)
    flag = benchmark.make_flagship(str(tmp / 'port'), device='cpu', **SIZE)
    return jflag, flag


@pytest.fixture(scope='module')
def eclipse_flagships(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('torch_str_eclipse')
    jflag = jbench.make_flagship(str(tmp / 'jax'), rt_path='eclipse', **SIZE)
    flag = benchmark.make_flagship(str(tmp / 'port'), rt_path='eclipse',
                                   device='cpu', **SIZE)
    return jflag, flag


def _opacity(model, kind, name=None):
    for mtype, m, _ in model.opacity_models:
        if mtype == kind and (name is None or m.name == name):
            return m
    raise KeyError(kind)


@pytest.mark.parametrize('kind, name', [
    ('line_sample', None), ('cia', None), ('alkali', None),
    ('cloud', 'deck'), ('cloud', 'lecavelier'),
])
def test_opacity_summaries_equal(flagships, kind, name):
    (jmodel, *_), (model, *_) = flagships
    text = str(_opacity(model, kind, name))
    assert text == str(_opacity(jmodel, kind, name))
    assert not text.startswith('<')


def test_observation_and_retrieval_summaries_equal(flagships):
    (_, jobs, jret, *_), (_, obs, ret, *_) = flagships
    assert str(obs) == str(jobs)
    assert str(ret) == str(jret)
    assert str(ret).startswith('Retrieval parameters:\n')


def test_observation_with_data_summary_equal(flagships):
    """An Observation with data and uncertainties (numpy's print
    options inside the summary) and the high-res-free band list."""
    (jmodel, *_), (model, *_) = flagships

    class Cfg:
        data = list(np.linspace(0.0101, 0.0109, 9))
        uncert = [3e-5] * 9
        filters = [f'tophat {wl:.4f} 0.01'
                   for wl in np.linspace(1.13, 1.27, 9)]
        obsfile = dunits = offset_inst = uncert_scaling = None

    text = str(Observation(Cfg, model.wn))
    assert text == str(JObservation(Cfg, jmodel.wn))
    assert 'Data (data):' in text


@pytest.mark.parametrize('species', ['H2', 'He', 'H', 'e-'])
def test_rayleigh_summary_equal(flagships, species):
    (jmodel, *_), _ = flagships
    wn = np.asarray(jmodel.wn)
    text = str(op.Rayleigh(species, wn))
    assert text == str(jop.Rayleigh(species, wn))
    assert 'Cross section range:' in text


def test_rayleigh_summary_is_the_same_on_a_float32_model(flagships):
    """A summary formats from the host float64 set-up arrays, so a
    model whose tables are float32 tensors prints the same text."""
    (jmodel, *_), _ = flagships
    wn = np.asarray(jmodel.wn)
    model = op.Rayleigh('H2', wn).to('cpu', torch.float32)
    assert str(model) == str(jop.Rayleigh('H2', wn))


def test_h_ion_ccsgray_cia_summaries_equal(flagships):
    (jmodel, *_), _ = flagships
    wn, press = np.asarray(jmodel.wn), np.asarray(jmodel.press)
    assert str(op.HydrogenIon(wn)) == str(jop.HydrogenIon(wn))
    assert str(op.CCSgray(press, wn)) == str(jop.CCSgray(press, wn))
    from pyratbay_tpu import data as jdata
    cia_file = jdata.cia_file('H2He')
    assert str(op.CIA(cia_file, wn=wn)) == str(jop.CIA(cia_file, wn=wn))


def test_passband_summaries_equal(flagships, tmp_path):
    """A tophat and a passband from a filter file, set on a grid."""
    wn = np.arange(7700.0, 9090.0, 4.0)
    assert str(passbands.Tophat(1.2, 0.02, wn=wn)) \
        == str(jpass.Tophat(1.2, 0.02, wn=wn))
    wl = np.linspace(1.15, 1.25, 41)
    response = np.exp(-0.5 * ((wl - 1.2) / 0.02)**2)
    filter_file = str(tmp_path / 'gauss_band.dat')
    np.savetxt(filter_file, np.column_stack([wl, response]))
    text = str(passbands.PassBand(filter_file, wn=wn))
    assert text == str(jpass.PassBand(filter_file, wn=wn))
    assert 'Name (name): gauss_band' in text


@pytest.mark.parametrize('path', ['transit', 'eclipse'])
def test_model_summary_equal_before_and_after_run(
        flagships, eclipse_flagships, path):
    """A Model's summary from its second line to the timestamps: the
    set-up, then the last run's optical-depth block."""
    (jmodel, *_), (model, *_) = flagships if path == 'transit' \
        else eclipse_flagships
    assert str(model).startswith(
        'Radiative-transfer model (pyratbay_tpu_torch):\n')
    assert model_text(model) == model_text(jmodel)
    assert 'Optical depth (last run):' not in str(model)
    jmodel.run()
    model.run()
    assert 'Optical depth (last run):' in model_text(model)
    assert model_text(model) == model_text(jmodel)


def test_timestamps_after_run(flagships):
    (jmodel, *_), (model, *_) = flagships
    model.run()
    assert tuple(model.timestamps) == RUN_KEYS
    assert all(t >= 0 for t in model.timestamps.values())
    jmodel.run()
    assert tuple(jmodel.timestamps) == RUN_KEYS
    text = str(model).split('Last-run timestamps (s):\n')[1]
    assert [line.rsplit(' ', 1)[0].strip()
            for line in text.splitlines()] == list(RUN_KEYS)


def test_setup_and_run_log_lines_equal(flagships, tmp_path):
    """The set-up summary a Model logs, and the run's closing line but
    for its seconds."""
    (jmodel, *_), (model, *_) = flagships
    texts = {}
    for name, cls, log_mod, cfg in (
            ('jax', JModel, jlogger, jmodel.cfg),
            ('port', Model, logger, model.cfg)):
        logname = str(tmp_path / f'{name}.log')
        log = log_mod.Log(logname=logname, verb=-1)
        kw = {} if name == 'jax' else {'device': 'cpu'}
        cls(cfg, log=log, **kw).run()
        log.close()
        with open(logname) as f:
            texts[name] = f.read().splitlines()
    assert texts['port'][:-1] == texts['jax'][:-1]
    assert texts['port'][0].startswith('Run mode: spectrum (transit)')
    seconds = re.compile(r' [0-9]+\.[0-9]{3}s')
    assert seconds.sub(' Xs', texts['port'][-1]) \
        == seconds.sub(' Xs', texts['jax'][-1]) \
        == 'Forward model done: atmosphere Xs, extinction Xs, spectrum Xs'


def test_plots_return_axes(flagships, tmp_path):
    pytest.importorskip('matplotlib')
    _, (model, *_) = flagships
    model.run()
    ax = model.plot_spectrum(filename=str(tmp_path / 'spec.png'))
    assert hasattr(ax, 'plot')
    assert os.path.exists(tmp_path / 'spec.png')
    ax = model.plot_temperature()
    assert hasattr(ax, 'plot')
    with pytest.raises(ValueError, match='requires a retrieval run'):
        model.plot_spectrum(spec='best')
