"""Physical constants (CGS) and framework registries.

All internal physics is carried in CGS units, matching the conventions of
the reference implementation (pyratbay/constants/astrophysical_constants.py)
so that cross-validation against its golden spectra is exact to float
precision.  Values are taken from scipy.constants (CODATA) and the NASA
planetary fact sheets.
"""
import scipy.constants as sc

__all__ = [
    # Universal constants
    'h', 'k', 'c', 'G', 'sigma_sb',
    # Conversion factors
    'eV', 'A', 'nm', 'um', 'mm', 'cm', 'm', 'km', 'au', 'pc', 'parsec',
    'rearth', 'rjup', 'rsun', 'barye', 'mbar', 'pascal', 'bar', 'atm',
    'gram', 'kg', 'mearth', 'mjup', 'msun', 'amu', 'me', 'kelvin',
    'sec', 'amagat', 'e', 'percent', 'ppt', 'ppm', 'none',
    'C1', 'C2', 'C3', 'N_A',
    # Registries
    'RUN_MODES', 'SAMPLERS', 'TRANSMISSION_RT', 'EMISSION_RT', 'ECLIPSE_RT',
    'RT_PATHS', 'TMODELS', 'CHEM_MODELS', 'RAD_MODELS', 'ALKALI_MODELS',
    'RAYLEIGH_MODELS', 'CLOUD_MODELS', 'H_ION_MODELS', 'DBASES',
]

# Universal constants in CGS units:
h = sc.h * 1e7          # Planck constant (erg s)
k = sc.k * 1e7          # Boltzmann constant (erg K-1)
c = sc.c * 1e2          # Speed of light (cm s-1)
G = sc.G * 1e3          # Gravitational constant (dyne cm2 g-2)
sigma_sb = sc.sigma * 1e3   # Stefan-Boltzmann (erg s-1 cm-2 K-4)
N_A = sc.N_A            # Avogadro number (mol-1)

# Energy:
eV = 8065.49179         # 1 eV in kayser (cm-1)

# Lengths to cm:
A = 1e-8
nm = 1e-7
um = 1e-4
mm = 1e-1
cm = 1.0
m = 1e2
km = 1e5
au = sc.au * 100
pc = parsec = sc.parsec * 100
rearth = 6.3781e8       # Earth equatorial radius (IAU 2015, Prsa et al. 2016)
rjup = 7.1492e9         # Jupiter equatorial radius
rsun = 6.957e10         # Solar radius

# Pressures to barye:
barye = 1.0
mbar = 1e3
pascal = 1e1
bar = 1e6
atm = 1.01e6

# Masses to gram:
gram = 1.0
kg = 1e3
mearth = 5.9724e27
mjup = 1.8982e30
msun = 1.9885e33
amu = sc.physical_constants['unified atomic mass unit'][0] * 1e3
me = sc.m_e * 1e3       # Electron mass

kelvin = 1.0
sec = 1.0

# Loschmidt number (molecules cm-3 at STP):
amagat = sc.physical_constants[
    'Loschmidt constant (273.15 K, 101.325 kPa)'][0] * 1e-6

# Elementary charge in statcoulomb:
e = 4.803205e-10

# Composite constants:
C1 = me * c**2 / (e**2 * sc.pi)  # cm-1
C2 = h * c / k                   # cm K  (second radiation-ish constant)
C3 = sc.pi * e**2 / (me * c**2)  # cm    (pi e^2 / me c^2, line-strength)

percent = 1e-2
ppt = 1e-3
ppm = 1e-6
none = 1

# ---------------------------------------------------------------------------
# Kernel constants (compute-path parity set).
#
# The reference's native kernels hardcode 1986-CODATA values
# (src_c/include/constants.h): KB = 1.380658e-16 vs the current
# 1.380649e-16, H = 6.6260755e-27 vs 6.62607015e-27.  The ~6e-6 relative
# difference in h*c/k is amplified by the Planck exponential to ~1e-4 in
# the Wien tail, which is exactly the published golden-spectrum
# tolerance.  Radiative-transfer kernels therefore use this parity set;
# everything user-facing uses the modern constants above.
KB_KERNEL = 1.380658e-16     # Boltzmann (erg/K), constants.h:13
H_KERNEL = 6.6260755e-27     # Planck (erg s), constants.h:15
LS_KERNEL = 2.99792458e10    # speed of light (cm/s), exact
AMU_KERNEL = 1.66053886e-24  # atomic mass unit (g), constants.h:14
EC_KERNEL = 4.8032068e-10    # electron charge (statC), constants.h:16
ME_KERNEL = 9.1093897e-28    # electron mass (g), constants.h:17
SIGCTE = 3.141592653589793 * EC_KERNEL**2 / LS_KERNEL**2 / ME_KERNEL
EXPCTE = H_KERNEL * LS_KERNEL / KB_KERNEL
C2_KERNEL = 1.4387768775039338      # h*c/k used by the alkali kernel
C3_KERNEL = 8.852821681767784e-13   # pi e^2/(me c^2) used by alkali

# ---------------------------------------------------------------------------
# Model registries (single source of truth of what models exist).
# Mirrors reference pyratbay/constants/code_constants.py:49-165.

RUN_MODES = ['tli', 'atmosphere', 'opacity', 'spectrum', 'radeq', 'retrieval']
SAMPLERS = ['snooker', 'demc', 'multinest']
TRANSMISSION_RT = ['transit']
ECLIPSE_RT = ['eclipse', 'eclipse_two_stream']
EMISSION_RT = ['emission', 'emission_two_stream', 'f_lambda']
RT_PATHS = TRANSMISSION_RT + ECLIPSE_RT + EMISSION_RT
TMODELS = ['isothermal', 'guillot', 'madhu']
CHEM_MODELS = ['free', 'equilibrium']
RAD_MODELS = ['hydro_m', 'hydro_g']
ALKALI_MODELS = ['sodium_vdw', 'potassium_vdw']
RAYLEIGH_MODELS = ['rayleigh_H', 'rayleigh_H2', 'rayleigh_He', 'rayleigh_e-']
CLOUD_MODELS = ['deck', 'ccsgray', 'lecavelier']
H_ION_MODELS = ['h_ion_john1988']
DBASES = ['hitran', 'exomol', 'repack']

# Retrieval flags:
RETFLAGS = [
    'temp', 'rad', 'press', 'mol', 'ray', 'cloud', 'patchy', 'mass', 'tstar',
]

# Unit registry for "value unit" strings in configs:
_UNITS = {
    'A': A, 'nm': nm, 'um': um, 'mm': mm, 'cm': cm, 'm': m, 'km': km,
    'au': au, 'pc': pc, 'rearth': rearth, 'rjup': rjup, 'rsun': rsun,
    'barye': barye, 'mbar': mbar, 'pascal': pascal, 'bar': bar, 'atm': atm,
    'gram': gram, 'kg': kg, 'mearth': mearth, 'mjup': mjup, 'msun': msun,
    'amu': amu, 'me': me, 'kelvin': kelvin, 'sec': sec, 'amagat': amagat,
    'eV': eV, 'percent': percent, 'ppt': ppt, 'ppm': ppm, 'none': none,
    'dex': none,
}


def u(units):
    """Return the conversion factor to CGS for a named unit."""
    if units not in _UNITS:
        raise ValueError(f"Units name '{units}' does not exist")
    return _UNITS[units]


def get_param(value, units=None, gt=None, ge=None):
    """Parse a parameter that may carry units, e.g. '1.27 rsun' -> cm.

    Parameters
    ----------
    value: str, float, or None
        Parameter value, optionally a string "<number> <unit>".
    units: str
        Default unit name applied when value carries none.

    Returns
    -------
    Parameter value in CGS units (float), or None if value is None.
    """
    if value is None:
        return None
    if isinstance(value, str):
        fields = value.split()
        val = float(fields[0])
        if len(fields) == 2:
            units = fields[1]
        elif len(fields) > 2:
            raise ValueError(f"Invalid value '{value}'")
    else:
        val = float(value)
    if units is not None:
        val *= u(units)
    if gt is not None and val <= gt:
        raise ValueError(f'Value {val} must be > {gt}')
    if ge is not None and val < ge:
        raise ValueError(f'Value {val} must be >= {ge}')
    return val
