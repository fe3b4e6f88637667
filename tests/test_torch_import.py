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
