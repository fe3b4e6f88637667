"""The port's device policy: an entry point runs on the CUDA device unless
the caller names the CPU, and never falls back to the CPU silently.

These tests run where no CUDA device is available, so the default device
must raise; with a card present the default-device cases are skipped
(tests/test_torch_cuda.py and chip_smoke.py cover that side).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from pyratbay_tpu_torch import __main__ as cli  # noqa: E402
from pyratbay_tpu_torch import benchmark, convert  # noqa: E402
from pyratbay_tpu_torch.device import resolve  # noqa: E402
from pyratbay_tpu_torch.driver import run  # noqa: E402
from pyratbay_tpu_torch.model import Model  # noqa: E402
from pyratbay_tpu_torch.opacity.lbl_direct import DirectLBL  # noqa: E402
from pyratbay_tpu_torch.retrieval.driver import run_retrieval  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is available: the default device works')


@pytest.fixture(scope='module')
def flagship_cfg(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp('torch_device'))
    benchmark.make_flagship(workdir, nlayers=11, wl_low=1.1, wl_high=1.15,
                            wnstep=8.0, device='cpu')
    # The flagship file as a retrieval run (a run mode that run() takes):
    with open(os.path.join(workdir, 'flagship.cfg')) as f:
        lines = ['runmode = retrieval' if ln.startswith('runmode') else ln
                 for ln in f.read().splitlines()]
    cfg_file = os.path.join(workdir, 'retrieval.cfg')
    with open(cfg_file, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return cfg_file


def test_resolve_cpu_is_float64():
    device, dtype = resolve('cpu')
    assert device == torch.device('cpu') and dtype == torch.float64
    assert resolve(torch.device('cpu')) == (device, dtype)
    with pytest.raises(ValueError, match='Unsupported device'):
        resolve('meta')


@pytest.mark.parametrize('device', [None, 'cuda', 'cuda:0'])
def test_resolve_default_is_cuda_and_raises_without_one(no_card, device):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve(device)


def test_cli_device_defaults_to_cuda():
    parser = cli.build_parser()
    assert parser.parse_args(['-c', 'x.cfg']).device == 'cuda'
    assert parser.parse_args(['-c', 'x.cfg', '--device', 'cpu']).device \
        == 'cpu'


def test_cli_without_device_raises_without_a_card(no_card, flagship_cfg):
    proc = subprocess.run(
        [sys.executable, '-m', 'pyratbay_tpu_torch', '-c', flagship_cfg],
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert 'No CUDA device is available' in proc.stderr


@pytest.mark.parametrize('entry', [
    'Model', 'run', 'make_flagship', 'to_tensors', 'DirectLBL'])
def test_entry_points_default_to_the_card(no_card, flagship_cfg, entry,
                                          tmp_path):
    """Model, run(), make_flagship, the converter and the line-by-line
    engine inherit the default: none runs on the CPU unasked."""
    calls = {
        'Model': lambda: Model(flagship_cfg),
        'run': lambda: run(flagship_cfg),
        'make_flagship': lambda: benchmark.make_flagship(
            str(tmp_path), nlayers=11, wl_low=1.1, wl_high=1.15, wnstep=8.0),
        'to_tensors': lambda: convert.to_tensors({'a': np.ones(3)}),
        'DirectLBL': lambda: DirectLBL(benchmark.synthetic_lines(
            np.arange(5882.0, 5982.0, 1.0), 50, seed=0)),
    }
    with pytest.raises(RuntimeError, match='No CUDA device is available'):
        calls[entry]()


def test_named_cpu_runs_the_retrieval_on_the_cpu(flagship_cfg):
    """device='cpu' gives a float64 model on the CPU, and run_retrieval
    follows the model's device."""
    model = Model(flagship_cfg, device='cpu')
    assert model.device == torch.device('cpu')
    assert model.dtype == torch.float64
    assert model._wn.dtype == torch.float64 and not model._wn.is_cuda
    assert run_retrieval.__doc__ and 'model.device' in run_retrieval.__doc__
