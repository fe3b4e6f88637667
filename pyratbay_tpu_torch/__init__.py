"""pyratbay_tpu_torch: the PyTorch/CUDA port of pyratbay_tpu.

Transit-retrieval slice: config file -> setup -> batched log-posterior
-> snooker DEMC -> best-fit spectrum, with the ensemble transit RT as a
hand-written CUDA kernel for Hopper (spectrum/transit_kernel.py,
csrc/transit_rt.cu).

Importing the package needs neither a GPU nor nvcc: the kernel builds
at its first launch on a CUDA tensor.  Host-side numpy modules are
copies of the JAX package's, never imports of it (pyratbay_tpu loads
JAX when imported).

Dtype policy: float64 on the CPU (the parity tests against the JAX
package), float32 on CUDA.
"""
from .version import __version__

__all__ = ['__version__']
