"""INI configuration parser, key-compatible with the reference framework.

Reads a single-section [pyrat] config file with case-sensitive keys,
typed values, unit-tagged scalars ("1.1 um", "0.6 mjup"), and {ROOT}
path expansion.  Reference behavior: pyratbay/tools/parser.py.
"""
import configparser
import os
import warnings

import numpy as np

from .. import constants as pc

# Renamed config keys (old -> new), warned and remapped at parse time:
_DEPRECATED_KEYS = {
    'extfile': 'sampled_cross_sec',
    'csfile': 'continuum_cross_sec',
    'wllow': 'wl_low',
    'wlhigh': 'wl_high',
    'vextent': 'voigt_extent',
    'vcutoff': 'voigt_cutoff',
    'mol_vars': 'vmr_vars',
}

__all__ = ['parse', 'Config']


def _get_units(value):
    """Extract the unit name from a '<number> <unit>' string, else None."""
    if not isinstance(value, str):
        return None
    fields = value.split()
    if len(fields) == 2 and fields[1] in pc._UNITS:
        return fields[1]
    return None


class Config:
    """Flat namespace of parsed configuration values."""

    def __init__(self, **kwargs):
        self._raw = {}
        for key, val in kwargs.items():
            setattr(self, key, val)

    def __repr__(self):
        keys = [k for k in vars(self) if not k.startswith('_')]
        return f'Config({", ".join(sorted(keys))})'

    def get(self, key, default=None):
        return getattr(self, key, default)


# Option tables: name -> kind
_STR_KEYS = [
    'logfile', 'runmode', 'molfile', 'wlunits', 'atmfile', 'tmodel',
    'runits', 'punits', 'output_atmfile', 'radmodel', 'chemistry',
    'vmr_vars', 'ptfile', 'solar', 'single_isotope', 'isotope_ratios',
    'clouds', 'rt_path', 'dunits', 'obsfile', 'obsfile_hires',
    'offset_inst', 'uncert_scaling', 'sampler', 'retrieval_params',
    'statistics', 'starspec', 'kurucz', 'marcs', 'phoenix', 'mstar',
    'distance', 'rplanet', 'refpressure', 'mplanet', 'mpunits', 'smaxis',
    'specfile', 'rstar', 'wl_low', 'wl_high', 'wlstep', 'ptop', 'pbottom',
    'mcmcfile', 'theme', 'data_color', 'dist_coordinator',
]
_INT_KEYS = [
    'ncpu', 'verb', 'wnosamp', 'wl_thinning', 'nlayers', 'ndop', 'nlor',
    'quadrature', 'nsamples', 'nchains', 'burnin', 'thinning', 'nlive',
    'dist_nprocs', 'dist_procid',
]
_FLOAT_KEYS = [
    'xsolar',
    'wnlow', 'wnhigh', 'wnstep', 'resolution', 'tmin', 'tmax', 'tstep',
    'ethresh', 'voigt_extent', 'voigt_cutoff', 'dmin', 'dmax', 'lmin',
    'lmax', 'dlratio', 'fpatchy', 'alkali_cutoff', 'maxdepth',
    'f_dilution', 'qcap', 'tlow', 'thigh', 'grbreak', 'grnmin',
    'log_gstar', 'gstar', 'tstar', 'gplanet', 'tint', 'beta_irr',
    'inst_resolution', 'dt_retrieval_snapshot',
]
_BOOL_KEYS = ['resume', 'post_processing']
_ARRAY_KEYS = [
    'dblist', 'pflist', 'dbtype', 'tlifile', 'sampled_cross_sec',
    'continuum_cross_sec', 'tpars', 'species', 'uniform_vmr', 'bulk',
    'escale',
    'rayleigh', 'alkali', 'h_ion', 'raygrid', 'data', 'uncert',
    'filters', 'params', 'pstep', 'pmin', 'pmax', 'prior', 'priorlow',
    'priorup', 'logxticks', 'yran',
]
_PATH_KEYS = [
    'logfile', 'atmfile', 'output_atmfile', 'specfile', 'molfile',
    'ptfile', 'obsfile', 'starspec', 'kurucz', 'marcs', 'phoenix',
]
_PATH_ARRAY_KEYS = [
    'tlifile', 'sampled_cross_sec', 'continuum_cross_sec', 'dblist',
    'pflist', 'filters',
]

_STRING_ARRAYS = {
    'dblist', 'pflist', 'dbtype', 'tlifile', 'sampled_cross_sec',
    'continuum_cross_sec', 'species', 'bulk', 'rayleigh', 'alkali',
    'h_ion', 'filters', 'escale',
}

# Numeric-bound validations, matching the reference's get_default /
# get_param checks (tools/parser.py:126-168, 744-1102).  Each entry is
# key -> (description, gt, ge, lt, le); the raised message is the
# reference's '{desc} ({key}) must be > {bound}' format:
_BOUNDS = {
    'verb': ('Verbosity', None, None, 5, None),
    'wnlow': ('Wavenumber lower boundary', 0.0, None, None, None),
    'wnhigh': ('Wavenumber higher boundary', 0.0, None, None, None),
    'wnstep': ('Wavenumber sampling step', 0.0, None, None, None),
    'wnosamp': ('Wavenumber oversampling factor', None, 1, None, None),
    'resolution': ('Spectral resolution', 0.0, None, None, None),
    'wl_thinning': (
        'Wavelength-sampling thinning factor for Line_Sample opacities',
        None, 1, None, None),
    'nlayers': ('Number of atmospheric layers', 1, None, None, None),
    'gplanet': ('Planetary surface gravity (cm s-2)', 0.0, None, None, None),
    'tint': ('Planetary internal temperature', None, 0.0, None, None),
    'tstar': ('Stellar effective temperature (K)', 0.0, None, None, None),
    'voigt_extent': (
        'Voigt profile extent in HWHM', None, 1.0, None, None),
    'voigt_cutoff': (
        'Voigt profile cutoff in cm-1', None, 0.0, None, None),
    'ndop': ('Number of Doppler-width samples', None, 1, None, None),
    'nlor': ('Number of Lorentz-width samples', None, 1, None, None),
    'dmin': ('Minimum Doppler HWHM (cm-1)', 0.0, None, None, None),
    'dmax': ('Maximum Doppler HWHM (cm-1)', 0.0, None, None, None),
    'lmin': ('Minimum Lorentz HWHM (cm-1)', 0.0, None, None, None),
    'lmax': ('Maximum Lorentz HWHM (cm-1)', 0.0, None, None, None),
    'dlratio': (
        'Doppler/Lorentz-width ratio threshold', 0.0, None, None, None),
    'tmin': ('Minimum temperature of opacity grid', 0.0, None, None, None),
    'tmax': ('Maximum temperature of opacity grid', 0.0, None, None, None),
    'tstep': (
        "Opacity grid's temperature sampling step in K",
        0.0, None, None, None),
    'fpatchy': ('Patchy-cloud fraction', None, 0.0, None, 1.0),
    'alkali_cutoff': (
        'Alkali profiles hard cutoff from line center (cm-1)',
        0.0, None, None, None),
    'ethresh': ('Extinction-cofficient threshold', 0.0, None, None, None),
    'maxdepth': ('Maximum optical-depth', None, 0.0, None, None),
    'quadrature': (
        'Number of Gaussian-quadrature points', None, 1, None, None),
    'f_dilution': ('Flux dilution factor', None, 0.0, None, 1.0),
    'qcap': ('Metals volume-mixing-ratio cap', 0.0, None, None, 1.0),
    'nsamples': ('Number of MCMC samples', 0, None, None, None),
    'burnin': ('Number of burn-in samples per chain', 0, None, None, None),
    'thinning': ('MCMC posterior thinning', None, 1, None, None),
    'nchains': ('Number of MCMC parallel chains', None, 1, None, None),
    'ncpu': ('Number of processors', None, 1, None, None),
    'grbreak': (
        'Gelman-Rubin convergence criteria', None, 0, None, None),
    'grnmin': (
        'Gelman-Rubin convergence fraction', 0.0, None, None, None),
    'nlive': (
        'Number of Nested Sampling live points', 0, None, None, None),
    'dt_retrieval_snapshot': (
        'Take a snapshot of the posterior during a retrieval d_time',
        None, 0.0, None, None),
    'inst_resolution': ('Instrumental resolution', 0.0, None, None, None),
}


def _parse_int_value(key, value):
    """Reference parse_int: accept integral float-strings, raise the
    reference's message otherwise (tools/parser.py:238-290)."""
    try:
        val = np.double(value)
    except ValueError:
        raise ValueError(
            f'Invalid data type for {key}, could not convert string '
            f"to integer: '{value}'"
        )
    if not np.isfinite(val) or int(val) != val:
        raise ValueError(
            f'Invalid data type for {key}, could not convert string '
            f"to integer: '{value}'"
        )
    return int(val)


def _parse_float_value(key, value):
    """Reference parse_float message (tools/parser.py:293-330)."""
    try:
        return float(value)
    except ValueError:
        raise ValueError(
            f'Invalid data type for {key}, could not convert string '
            f"to float: '{value}'"
        )


def _parse_bool_value(key, value):
    """Reference parse_bool semantics (tools/parser.py:215-227)."""
    if value.lower() in ('false', '0', 'no'):
        return False
    if value.lower() in ('true', '1', 'yes'):
        return True
    raise ValueError(
        f"Invalid data type for parameter '{key}', could not "
        f"convert string '{value}' to bool"
    )


def _check_bounds(cfg):
    """Apply the _BOUNDS table (reference get_default messages)."""
    for key, (desc, gt, ge, lt, le) in _BOUNDS.items():
        value = cfg.get(key)
        if value is None:
            continue
        if gt is not None and value <= gt:
            raise ValueError(f'{desc} ({key}) must be > {gt}')
        if ge is not None and value < ge:
            raise ValueError(f'{desc} ({key}) must be >= {ge}')
        if lt is not None and lt <= value:
            raise ValueError(f'{desc} ({key}) must be < {lt}')
        if le is not None and le < value:
            raise ValueError(f'{desc} ({key}) must be <= {le}')


def _check_units(desc, key, units):
    """Reference unit-name validation (parser.py:763, 793, 809, ...)."""
    if units is not None and units not in pc._UNITS:
        raise ValueError(f'Invalid {desc} units ({key}): {units}')


def _invalid_choice(desc, key, value, choices):
    return ValueError(
        f"Invalid {desc} ({key}): '{value}'. Select from: {list(choices)}"
    )


def parse_var_vals(info):
    """Parse a multi-line '<name> <val1> <val2> ...' block.

    Returns (names, list-of-parameter-arrays-or-None).
    """
    if info is None:
        return [], []
    names = []
    pars = []
    for line in info.strip().splitlines():
        fields = line.split()
        if not fields:
            continue
        names.append(fields[0])
        if len(fields) > 1:
            pars.append(np.array(fields[1:], float))
        else:
            pars.append(None)
    return names, pars


def parse(cfile, root=None):
    """Parse a configuration file into a Config namespace.

    Parameters
    ----------
    cfile: path to an INI file with a [pyrat] section.
    root: value substituted for '{ROOT}' in paths (default: the config
        file's directory).
    """
    if not os.path.isfile(cfile):
        raise FileNotFoundError(f"Configuration file '{cfile}' not found")
    if root is None:
        root = os.path.dirname(os.path.realpath(cfile)) + '/'

    ini = configparser.ConfigParser()
    ini.optionxform = str  # case-sensitive keys
    ini.read([cfile])
    if 'pyrat' not in ini.sections():
        raise ValueError(
            f"Invalid configuration file: '{cfile}', no [pyrat] section"
        )
    raw = dict(ini.items('pyrat'))

    # Deprecation shims for renamed keys/values (reference
    # parser.py:651-757 warns the same way):
    for old, new in _DEPRECATED_KEYS.items():
        if old in raw:
            warnings.warn(
                f"'{old}' argument is deprecated, use '{new}' instead",
                category=DeprecationWarning,
            )
            raw.setdefault(new, raw.pop(old))
    if raw.get('runmode') == 'mcmc':
        warnings.warn(
            "The 'mcmc' option for the 'runmode' argument is "
            "deprecated, use 'retrieval' instead",
            category=DeprecationWarning,
        )
        raw['runmode'] = 'retrieval'
    if raw.get('tmodel') == 'tcea':
        warnings.warn(
            "The 'tcea' tmodel is deprecated, use 'guillot' instead",
            category=DeprecationWarning,
        )
        raw['tmodel'] = 'guillot'
    if 'mcmcfile' in raw:
        warnings.warn(
            "'mcmcfile' argument is deprecated, output file names are "
            'now based on logfile',
            category=DeprecationWarning,
        )
    if 'gstar' in raw and 'log_gstar' not in raw:
        warnings.warn(
            "'gstar' argument is deprecated, use 'log_gstar' instead",
            category=DeprecationWarning,
        )
        raw['log_gstar'] = str(np.log10(float(raw.pop('gstar'))))

    cfg = Config()
    cfg._raw = raw
    cfg.config_file = cfile
    cfg._root = root

    def expand(path):
        return os.path.expanduser(path.replace('{ROOT}', root))

    for key in _STR_KEYS:
        cfg.__dict__[key] = raw.get(key)
    for key in _INT_KEYS:
        val = raw.get(key)
        cfg.__dict__[key] = (
            None if val is None else _parse_int_value(key, val)
        )
    for key in _FLOAT_KEYS:
        val = raw.get(key)
        cfg.__dict__[key] = (
            None if val is None else _parse_float_value(key, val)
        )
    for key in _BOOL_KEYS:
        val = raw.get(key)
        cfg.__dict__[key] = (
            None if val is None else _parse_bool_value(key, val)
        )
    for key in _ARRAY_KEYS:
        val = raw.get(key)
        if val is None:
            cfg.__dict__[key] = None
            continue
        if key == 'filters':
            # Keep inline 'tophat wl0 half_width' definitions as single
            # entries; file paths may still be listed many per line:
            fields = []
            for line in val.strip().splitlines():
                tokens = line.split()
                if tokens and tokens[0] == 'tophat':
                    fields.append(line.strip())
                else:
                    fields.extend(tokens)
            cfg.__dict__[key] = fields
        elif key in _STRING_ARRAYS:
            cfg.__dict__[key] = val.split()
        else:
            cfg.__dict__[key] = np.array(val.split(), float)

    # Path expansion:
    for key in _PATH_KEYS:
        if cfg.get(key) is not None:
            cfg.__dict__[key] = expand(cfg.__dict__[key])
    for key in _PATH_ARRAY_KEYS:
        if cfg.get(key) is not None:
            cfg.__dict__[key] = [expand(p) for p in cfg.__dict__[key]]

    # ---- Derived values and defaults (reference parser.py:651-1010) ----
    cfg.verb = 2 if cfg.verb is None else cfg.verb
    _check_bounds(cfg)
    if cfg.runmode not in pc.RUN_MODES:
        raise _invalid_choice(
            'running mode', 'runmode', cfg.runmode, pc.RUN_MODES,
        )

    cfg.sampled_cs = cfg.sampled_cross_sec
    cfg.continuum_cs = cfg.continuum_cross_sec

    # Wavelength bounds carry units ('um' default):
    wlunits = cfg.wlunits
    _check_units('wavelength', 'wlunits', wlunits)
    for key in ('wl_low', 'wl_high', 'wlstep'):
        if wlunits is None:
            wlunits = _get_units(raw.get(key))
    if wlunits is None:
        wlunits = 'um'
    cfg.wlunits = wlunits
    for key in ('wl_low', 'wl_high', 'wlstep'):
        val = cfg.get(key)
        cfg.__dict__[key] = pc.get_param(val, wlunits, gt=0.0) \
            if val is not None else None

    cfg.wl_thinning = 1 if cfg.wl_thinning is None else cfg.wl_thinning

    # Radii:
    runits = cfg.runits
    _check_units('radius', 'runits', runits)
    if runits is None:
        runits = _get_units(raw.get('rplanet'))
    cfg.runits = runits
    cfg.rplanet = pc.get_param(cfg.rplanet, runits, gt=0.0)
    cfg.rmodelname = cfg.radmodel
    if cfg.rmodelname is not None and cfg.rmodelname not in pc.RAD_MODELS:
        raise _invalid_choice(
            'Radius-profile model', 'radmodel', cfg.rmodelname,
            pc.RAD_MODELS,
        )

    # Pressures (internally in bar):
    punits = cfg.punits
    _check_units('pressure', 'punits', punits)
    for key in ('pbottom', 'ptop', 'refpressure'):
        if punits is None:
            punits = _get_units(raw.get(key))
    cfg.punits = punits
    for key in ('pbottom', 'ptop', 'refpressure'):
        val = cfg.get(key)
        if val is not None:
            cfg.__dict__[key] = pc.get_param(val, punits, gt=0.0) / pc.bar
        else:
            cfg.__dict__[key] = None

    # Deprecated chemistry shims (reference tools/parser.py:833-861):
    if cfg.chemistry in ('uniform', 'tea'):
        cfg.chemistry = {'uniform': 'free', 'tea': 'equilibrium'}[
            cfg.chemistry]
    if cfg.chemistry is not None and cfg.chemistry not in pc.CHEM_MODELS:
        raise _invalid_choice(
            'Chemical model', 'chemistry', cfg.chemistry, pc.CHEM_MODELS,
        )
    if cfg.get('xsolar') is not None:
        cfg.vmr_vars = (
            (cfg.vmr_vars or '') + f'\n[M/H] {np.log10(cfg.xsolar)}'
        )
    if cfg.get('escale') is not None:
        escale = cfg.escale
        for atom, factor in zip(escale[::2], escale[1::2]):
            cfg.vmr_vars = (
                (cfg.vmr_vars or '')
                + f'\n[{atom}/H] {np.log10(float(factor))}'
            )

    # System parameters (CGS):
    _check_units('planet mass', 'mpunits', cfg.mpunits)
    _check_units('data', 'dunits', cfg.dunits)
    mass_units = cfg.mpunits or _get_units(raw.get('mplanet'))
    cfg.mass_units = mass_units
    cfg.mplanet = pc.get_param(cfg.mplanet, mass_units, gt=0.0)
    cfg.smaxis = pc.get_param(cfg.smaxis, None, gt=0.0)
    cfg.rstar = pc.get_param(cfg.rstar, None, gt=0.0)
    cfg.mstar = pc.get_param(cfg.mstar, None, gt=0.0)
    cfg.distance = pc.get_param(cfg.distance, None, gt=0.0)
    if cfg.gstar is not None and cfg.log_gstar is None:
        cfg.log_gstar = np.log10(cfg.gstar)
    cfg.tint = 100.0 if cfg.tint is None else cfg.tint
    cfg.beta_irr = 0.25 if cfg.beta_irr is None else cfg.beta_irr

    # Voigt / LBL parameters:
    cfg.voigt_extent = 300.0 if cfg.voigt_extent is None else cfg.voigt_extent
    cfg.voigt_cutoff = 25.0 if cfg.voigt_cutoff is None else cfg.voigt_cutoff
    cfg.voigt_ndop = 50 if cfg.ndop is None else cfg.ndop
    cfg.voigt_nlor = 100 if cfg.nlor is None else cfg.nlor
    cfg.voigt_dmin = cfg.dmin
    cfg.voigt_dmax = cfg.dmax
    cfg.voigt_lmin = cfg.lmin
    cfg.voigt_lmax = cfg.lmax
    cfg.voigt_dlratio = 0.1 if cfg.dlratio is None else cfg.dlratio
    cfg.ethresh = 1e-30 if cfg.ethresh is None else cfg.ethresh

    # Opacity model lists:
    if cfg.rayleigh is not None:
        for name in cfg.rayleigh:
            if name not in pc.RAYLEIGH_MODELS:
                raise _invalid_choice(
                    'Rayleigh model', 'rayleigh', name, pc.RAYLEIGH_MODELS,
                )
    if cfg.alkali is not None:
        for name in cfg.alkali:
            if name not in pc.ALKALI_MODELS:
                raise _invalid_choice(
                    'alkali model', 'alkali', name, pc.ALKALI_MODELS,
                )
    cfg.alkali_models = cfg.alkali
    cfg.alkali_cutoff = (
        4500.0 if cfg.alkali_cutoff is None else cfg.alkali_cutoff
    )
    cloud_names, _ = parse_var_vals(cfg.clouds)
    for name in cloud_names:
        if name not in pc.CLOUD_MODELS:
            raise _invalid_choice(
                'cloud model', 'clouds', name, pc.CLOUD_MODELS,
            )
    if cfg.h_ion is not None:
        for name in cfg.h_ion:
            if name not in pc.H_ION_MODELS:
                raise _invalid_choice(
                    'H- opacity model', 'h_ion', name, pc.H_ION_MODELS,
                )
    cfg.h_ion_model = None if cfg.h_ion is None else cfg.h_ion[0]

    # RT:
    if cfg.rt_path is not None and cfg.rt_path not in pc.RT_PATHS:
        raise _invalid_choice(
            'radiative-transfer observing geometry', 'rt_path',
            cfg.rt_path, pc.RT_PATHS,
        )
    cfg.maxdepth = 10.0 if cfg.maxdepth is None else cfg.maxdepth
    if cfg.raygrid is None:
        cfg.raygrid = np.array([0.0, 20.0, 40.0, 60.0, 80.0])

    cfg.tmodelname = cfg.tmodel
    if cfg.tmodelname is not None and cfg.tmodelname not in pc.TMODELS:
        raise _invalid_choice(
            'temperature model', 'tmodel', cfg.tmodelname, pc.TMODELS,
        )
    if cfg.sampler is not None and cfg.sampler not in pc.SAMPLERS:
        raise _invalid_choice(
            'posterior sampler', 'sampler', cfg.sampler, pc.SAMPLERS,
        )

    return cfg
