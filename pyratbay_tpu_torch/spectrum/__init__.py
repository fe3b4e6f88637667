"""Spectra: the per-chain transit RT reference, tophat passbands, and
the ensemble transit kernel (transit_kernel.py)."""
from .rt import (
    transit_depth,
    transmission_spectrum,
    plane_parallel_depth,
    plane_parallel_intensity,
    two_stream,
    gauss_quadrature,
)
from .passbands import PassBand, Tophat, bin_spectrum
from .contribution import (
    contribution_function,
    transmittance,
    band_cf,
)
from .starspec import bbflux, read_kurucz
