"""Importing the port loads neither JAX nor the JAX package, and needs
neither nvcc nor triton nor a GPU (kernels build at first launch)."""
import os
import subprocess
import sys

import pytest

pytest.importorskip('torch')

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = """
import importlib, pkgutil, sys
import pyratbay_tpu_torch
for mod in pkgutil.walk_packages(pyratbay_tpu_torch.__path__,
                                 'pyratbay_tpu_torch.'):
    if mod.name != 'pyratbay_tpu_torch.__main__':
        importlib.import_module(mod.name)
loaded = [m for m in sys.modules
          if m.split('.')[0] in ('jax', 'jaxlib', 'pyratbay_tpu', 'triton')]
print('LOADED', sorted(loaded))
print('SPECTRUM', sorted(
    m for m in sys.modules if m.startswith('pyratbay_tpu_torch.spectrum.')))
print('OPACITY', sorted(
    m for m in sys.modules if m.startswith('pyratbay_tpu_torch.opacity.')))
"""


def test_import_without_jax_nvcc_or_triton():
    env = dict(os.environ)
    env['PATH'] = os.path.dirname(sys.executable)   # no nvcc on PATH
    env.pop('CUDA_HOME', None)
    env['PYTHONPATH'] = REPO
    proc = subprocess.run(
        [sys.executable, '-c', _SCRIPT], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert 'LOADED []' in proc.stdout, proc.stdout
    for name in ('transit_kernel', 'emission_kernel'):
        assert f"'pyratbay_tpu_torch.spectrum.{name}'" in proc.stdout, \
            proc.stdout
    for name in ('lbl_kernel', 'lbl_direct', 'tli'):
        assert f"'pyratbay_tpu_torch.opacity.{name}'" in proc.stdout, \
            proc.stdout


def test_cli_help():
    proc = subprocess.run(
        [sys.executable, '-m', 'pyratbay_tpu_torch', '--help'],
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert '--device' in proc.stdout


_BLOCKED = """
import importlib, sys

class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'pyratbay_tpu'):
            raise ImportError(f'{name} is blocked')
        return None

sys.meta_path.insert(0, _Blocked())
module = importlib.import_module(sys.argv[1])
loaded = [m for m in sys.modules
          if m.split('.')[0] in ('jax', 'jaxlib', 'pyratbay_tpu')]
print('LOADED', sorted(loaded), module.__name__)
"""


@pytest.mark.parametrize('module', [
    'pyratbay_tpu_torch.atmosphere.chem',
    'pyratbay_tpu_torch.spectrum.convection',
    'pyratbay_tpu_torch.spectrum.radeq',
    'pyratbay_tpu_torch.spectrum.rt',
    'pyratbay_tpu_torch.benchmark',
])
def test_chemistry_and_radeq_modules_import_with_jax_blocked(module):
    """The modules of the equilibrium-chemistry, two-stream and radeq
    slice import in a process where importing jax, jaxlib or
    pyratbay_tpu raises, and load none of them."""
    proc = subprocess.run(
        [sys.executable, '-c', _BLOCKED, module],
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert f'LOADED [] {module}' in proc.stdout, proc.stdout


@pytest.mark.parametrize('module', [
    'pyratbay_tpu_torch.runtime',
    'pyratbay_tpu_torch.opacity.linelists',
    'pyratbay_tpu_torch.opacity.partitions',
    'pyratbay_tpu_torch.opacity.tli',
    'pyratbay_tpu_torch.opacity.lbl',
    'pyratbay_tpu_torch.tools',
    'pyratbay_tpu_torch.__main__',
])
def test_line_list_modules_import_with_jax_blocked(module):
    """The modules of the line-list slice (readers, partition sources,
    the native host runtime, the CLI's table tools) import in a process
    where importing jax, jaxlib or pyratbay_tpu raises, and load none of
    them."""
    proc = subprocess.run(
        [sys.executable, '-c', _BLOCKED, module],
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert f'LOADED [] {module}' in proc.stdout, proc.stdout
