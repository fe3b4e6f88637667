"""The control of each cell's comparison: the plain reference computed in
TF32 (the precision below the configuration's float32 with TF32 off), put
in the program's place, fails the cell's limits.  On the CPU at a small
size; on the card (marked `cuda`) at the cell's own size through
control.py, where the program's own numbers pass the same limits."""
import numpy as np
import pytest

from portbench import compare
from portbench.models import flagship as fm
from portbench.reference import inputs
from portbench.reference.flagship import Flagship
from portbench.tests import small


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc: run on the card')


@pytest.fixture(scope='module')
def small_model(tmp_path_factory):
    config = small.config()
    paths = inputs.write_inputs(config, str(tmp_path_factory.mktemp('in')))
    return config, paths, fm.Observed(config, paths, 5)


@pytest.mark.parametrize('cell', ['flagship_r115k.demc512'])
def test_tf32_log_posterior_fails_the_limit(cell, small_model):
    config, paths, observed = small_model
    ref = observed.reference
    rng = np.random.default_rng(1)
    pstep = np.array([r[4] for r in config['retrieval_params']])
    chains = np.clip(ref.params0 + pstep * rng.standard_normal((32, 7)),
                     ref.pmin, ref.pmax)
    want = ref.log_post(chains, observed.data, observed.uncert)
    got = Flagship(config, paths, 'tf32').log_post(
        chains, observed.data, observed.uncert)
    assert compare.logp_gap(got, want) > compare.limits(cell)['logp_gap']


@pytest.mark.cuda
@pytest.mark.parametrize('cell', ['flagship_r115k.demc512'])
def test_on_the_card_program_passes_and_control_fails(cell, cuda,
                                                      capsys):
    import json
    from portbench import control
    control.main(['--workload', cell, '--seconds', '2', '--seeds', '17'])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    limits = compare.limits(cell)
    assert row['correct']

    def fails(name, value):
        return (value < limits[name] if name in compare.AT_LEAST
                else value > limits[name])
    assert any(fails(k, v) for k, v in row['control'].items()), row
