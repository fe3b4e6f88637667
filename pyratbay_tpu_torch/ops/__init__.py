"""Numerical primitives: spectral grids (numpy), special functions,
interpolation and integration on tensors."""
from .grids import (
    constant_resolution_spectrum,
    wavenumber_grid,
    divisors,
)
from .integrate import (
    trapz_intervals,
    cumtrapz,
    simpson_nonuniform,
)
from .interp import (
    lin_interp_trow,
    second_deriv_ref,
    second_deriv,
    splinterp,
)
from .special import (
    e2,
    wofz_real,
    voigt_profile,
    voigt_ref,
    doppler_hwhm,
    lorentz_hwhm,
    min_widths,
    max_widths,
)
from .planck import blackbody_wn
