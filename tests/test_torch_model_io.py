"""Model files: pyratbay_tpu_torch.io.save_model / load_model round
trips, a file that pyratbay_tpu wrote reopened by the port without
importing JAX or the JAX package, and a file naming a class the port
lacks.  The flagship at test size (21 layers, 1.1-1.3 um, wnstep 4),
float64 on the CPU; a reopened JAX model's spectrum against the JAX
run's at rtol 1e-8 (the slice bound of tests/test_torch_forward.py)."""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from pyratbay_tpu import benchmark as jbench  # noqa: E402
from pyratbay_tpu.io import io as jio  # noqa: E402
from pyratbay_tpu_torch import benchmark  # noqa: E402
from pyratbay_tpu_torch import io as pio  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-8
SIZE = dict(nlayers=21, wl_low=1.1, wl_high=1.3, wnstep=4.0)


@pytest.mark.parametrize('rt_path', ['transit', 'eclipse'])
def test_round_trip(tmp_path, rt_path):
    """save_model, load_model, run: the spectrum and every result array
    come back exactly, as numpy."""
    model = benchmark.make_flagship(str(tmp_path / 'flag'), device='cpu',
                                    rt_path=rt_path, **SIZE)[0]
    model.run()
    rng = np.random.default_rng(0)
    model.posterior = rng.random((40, 6))
    model.bestp = torch.as_tensor(rng.random(7))
    model.best_log_post = -12.5
    model.spec_best = rng.random(model.nwave)
    path = str(tmp_path / 'model.pickle')
    pio.save_model(model, path)
    reopened = pio.load_model(path, device='cpu')
    assert reopened.device.type == 'cpu'
    for key in ('spectrum', 'posterior', 'spec_best'):
        value = getattr(reopened, key)
        assert isinstance(value, np.ndarray)
        np.testing.assert_array_equal(value, np.asarray(getattr(model, key)))
    np.testing.assert_array_equal(reopened.bestp, model.bestp.numpy())
    assert float(reopened.best_log_post) == -12.5
    assert reopened.cfg._root == model.cfg._root
    spectrum = model.spectrum
    reopened.run()
    np.testing.assert_array_equal(reopened.spectrum, spectrum)


_REOPEN = """
import sys
import numpy as np
from pyratbay_tpu_torch.io import load_model
model = load_model(sys.argv[1], device='cpu')
restored = np.asarray(model.spectrum)
model.run()
np.savez(sys.argv[2], restored=restored, spectrum=model.spectrum,
         posterior=model.posterior)
loaded = [m for m in sys.modules
          if m.split('.')[0] in ('jax', 'jaxlib', 'pyratbay_tpu')]
print('LOADED', sorted(loaded))
"""


def test_load_a_model_the_jax_package_wrote(tmp_path):
    """pyratbay_tpu.io.save_model in this process; the port reopens the
    file in a process of its own, which loads neither JAX nor the JAX
    package, and runs it."""
    jmodel = jbench.make_flagship(str(tmp_path / 'flag'), **SIZE)[0]
    jmodel.run()
    jmodel.posterior = np.random.default_rng(1).random((30, 6))
    path = str(tmp_path / 'jax_model.pickle')
    jio.save_model(jmodel, path)
    with open(path, 'rb') as f:
        assert b'pyratbay_tpu.config.parser' in f.read()
    out = str(tmp_path / 'reopened.npz')
    proc = subprocess.run(
        [sys.executable, '-c', _REOPEN, path, out],
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert 'LOADED []' in proc.stdout, proc.stdout
    got = np.load(out)
    np.testing.assert_array_equal(got['restored'], jmodel.spectrum)
    np.testing.assert_array_equal(got['posterior'], jmodel.posterior)
    np.testing.assert_allclose(got['spectrum'], jmodel.spectrum, rtol=RTOL)


@pytest.mark.parametrize('module, name', [
    ('pyratbay_tpu.config.parser', 'NoSuchConfig'),
    ('pyratbay_tpu.parallel.sharded', 'ShardedForward'),
])
def test_a_class_the_port_lacks_raises(tmp_path, module, name):
    """A pickle that names a pyratbay_tpu class without a counterpart
    in the port (a missing name, a module the port does not have)."""
    path = str(tmp_path / 'foreign.pickle')
    with open(path, 'wb') as f:
        # Protocol 0: GLOBAL 'module name', then STOP.
        f.write(f'c{module}\n{name}\n.'.encode())
    with pytest.raises(pickle.UnpicklingError, match=f'{module}.{name}'):
        pio.load_model(path, device='cpu')
