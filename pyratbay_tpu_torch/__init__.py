"""pyratbay_tpu_torch: the PyTorch/CUDA port of pyratbay_tpu.

Line lists -> opacities -> 1D atmospheres -> transit, emission and
eclipse spectra -> retrievals, with the radiative transfer and the
line-by-line opacity as hand-written CUDA kernels for Hopper
(spectrum/transit_kernel.py, spectrum/emission_kernel.py,
opacity/lbl_kernel.py; csrc/).  The public names are the JAX package's.

Importing the package needs neither a GPU nor nvcc nor matplotlib: the
kernels build at their first launch on a CUDA tensor, and the plots
import matplotlib when they draw.  Host-side numpy modules are
copies of the JAX package's, never imports of it (pyratbay_tpu loads
JAX when imported).

Dtype policy: float64 on the CPU (the parity tests against the JAX
package), float32 on CUDA.

Spans and counters: tracing.py (PBT_TRACE=<file.json> writes them at
the process's exit).
"""
from . import tracing

with tracing.span('pbt.setup.import', always=True):
    from .version import __version__

    from . import constants
    from . import ops
    from . import atmosphere
    from . import opacity
    from . import spectrum
    from . import io
    from . import tools
    from .driver import run
    from .model import Model

__all__ = [
    '__version__',
    'constants', 'ops', 'atmosphere', 'opacity', 'spectrum', 'io',
    'tools', 'run', 'Model',
]
