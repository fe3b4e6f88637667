"""File formats: atmospheric profiles, spectra, opacity tables, CIA
tables, partition functions, observations, species data and model
files (save_model / load_model).

Formats are byte-compatible with the reference framework
(pyratbay/io/io.py) so users can exchange files between the two.
All IO is host-side numpy; the outputs feed static setup only.
"""
import importlib
import os
import pickle

import numpy as np

from .. import constants as pc
from ..tracing import to_host

__all__ = [
    'read_atm', 'write_atm',
    'write_spectrum', 'read_spectrum', 'read_spectra',
    'read_cs', 'write_cs',
    'read_opacity', 'write_opacity',
    'read_pf', 'write_pf',
    'read_molecs', 'species_properties',
    'read_observations', 'write_observations',
    'save_model', 'load_model',
]


# --------------------------------------------------------------------------
# Atmospheric profiles (.atm, plain text)

def read_atm(atmfile):
    """Read an atmospheric profile file.

    Returns (units, species, press, temp, vmr, radius) where units is the
    (punits, tunits, qunits, runits) tuple.  Format reference:
    pyratbay/io/io.py:212-350.
    """
    punits = runits = tunits = vmr_units = None
    species = None
    data_lines = []
    with open(atmfile) as f:
        lines = iter(f.readlines())
    in_data = False
    for line in lines:
        line = line.strip()
        if not in_data:
            if line == '' or line.startswith('#'):
                continue
            if line == '@DATA':
                in_data = True
            elif line == '@PRESSURE':
                punits = next(lines).strip()
            elif line == '@RADIUS':
                runits = next(lines).strip()
            elif line == '@TEMPERATURE':
                tunits = next(lines).strip()
            elif line == '@ABUNDANCE':
                vmr_units = next(lines).strip()
            elif line == '@SPECIES':
                species = np.asarray(next(lines).strip().split())
            else:
                raise ValueError(
                    f"Atmosphere file has unexpected line: \n'{line}'"
                )
        else:
            if line == '' or line.startswith('#'):
                break
            data_lines.append(line.split())

    if punits is None:
        raise ValueError("Atmospheric file does not have '@PRESSURE' header")
    if tunits is None:
        raise ValueError(
            "Atmospheric file does not have '@TEMPERATURE' header"
        )
    has_radius = runits is not None
    has_vmr = species is not None
    nrad = int(has_radius)
    nspecies = len(species) if has_vmr else 0

    data = np.array(data_lines, float)
    if data.shape[1] != 2 + nrad + nspecies:
        raise ValueError(
            f'Inconsistent number of columns ({data.shape[1]}) in @DATA'
        )
    radius = data[:, 0] if has_radius else None
    press = data[:, nrad]
    temp = data[:, nrad + 1]
    vmr = data[:, nrad + 2:] if has_vmr else None
    return (punits, tunits, vmr_units, runits), species, press, temp, vmr, \
        radius


def write_atm(
        atmfile, pressure, temperature, species=None, vmr=None, radius=None,
        punits='bar', runits='km', header=None,
    ):
    """Write an atmospheric file (reference-compatible format).

    pressure in bar, temperature in K, radius in cm (written in runits).
    """
    with open(atmfile, 'w') as f:
        if header is not None:
            f.write(header)
        f.write('# Abundance units (by number or mass):\n@PRESSURE\n')
        f.write(f'{punits}\n@TEMPERATURE\nkelvin\n')
        if vmr is not None:
            f.write('@ABUNDANCE\nvolume\n')
        if radius is not None:
            f.write(f'@RADIUS\n{runits}\n')
        if species is not None:
            f.write('\n@SPECIES\n' + '  '.join(species) + '\n')
        f.write('\n@DATA\n')
        press = np.asarray(pressure) * pc.bar / pc.u(punits)
        for i in range(len(press)):
            row = ''
            if radius is not None:
                row += f'{radius[i]/pc.u(runits):.8e}  '
            row += f'{press[i]:.6e}  {temperature[i]:11.3f}  '
            if vmr is not None:
                row += '  '.join(f'{q:.6e}' for q in vmr[i])
            f.write(row.rstrip() + '\n')


# --------------------------------------------------------------------------
# Spectra (two-column plain text)

_SPEC_TYPES = {
    'transit': ('(Rp/Rs)**2', 'unitless'),
    'eclipse': ('Fp/Fs', 'unitless'),
    'emission': ('Flux', 'erg s-1 cm-2 cm'),
    'f_lambda': ('Flux', 'W m-2 um-1'),
    'filter': ('transmission', 'unitless'),
}


def write_spectrum(wl, spectrum, filename, type):
    """Write a spectrum file: wavelength (um) and signal columns (host
    numpy arrays)."""
    if filename is None:
        return
    if type not in _SPEC_TYPES:
        raise ValueError(
            "Input 'type' argument must be 'transit', 'eclipse', "
            "'emission', 'f_lambda', or 'filter'"
        )
    spectype, specunits = _SPEC_TYPES[type]
    precision = -np.floor(np.log10(np.amin(np.abs(np.ediff1d(wl)))))
    precision = int(np.clip(precision + 1, 5, np.inf))
    buff = precision + 5
    with open(filename, 'w') as f:
        f.write(f'# {"Wavelength":>{buff:d}s}   {spectype:>15s}\n')
        f.write(f"# {'um':>{buff:d}s}   {specunits:>15s}\n")
        for wave, flux in zip(wl, spectrum):
            f.write(f'{wave:>{buff+2:d}.{precision:d}f}   {flux:.9e}\n')


def read_spectrum(filename, wn=True):
    """Read a two-column spectrum file; returns (wave, spectrum), the
    wavelength column (um) as wavenumber (cm-1) if wn is True."""
    wave, spectrum = np.loadtxt(filename, unpack=True)
    if wn:
        wave = 1.0 / (wave * pc.um)
    return wave, spectrum


def read_spectra(filename):
    """Read a temperature-gridded SED file (the reference's @TEMPERATURES
    / @SPECTRA format, pyratbay/io/io.py read_spectra); falls back to a
    plain two-column spectrum.

    Returns (spectra [ntemps, nwave], wn [cm-1], temperatures [K] or
    None for a plain single spectrum).  wn is 1/wavelength in the
    file's row order: a file in ascending wavelength gives a
    descending wn.
    """
    with open(filename) as f:
        lines = [line.strip() for line in f]
    if '@SPECTRA' not in lines:
        wn, spectrum = read_spectrum(filename)
        return spectrum[None, :], wn, None
    lines = [
        line for line in lines
        if line and not line.startswith('#')
    ]
    itemp = lines.index('@TEMPERATURES')
    temperatures = np.array(lines[itemp + 1].split(), float)
    iflux = lines.index('@SPECTRA') + 1
    data = np.array([line.split() for line in lines[iflux:]], float)
    spectra = data[:, 1:].T
    wn = 1.0 / (data[:, 0] * pc.um)
    return spectra, wn, temperatures


# --------------------------------------------------------------------------
# Opacity tables (npz)

def write_opacity(ofile, species, temp, press, wn, opacity):
    """Write a tabulated cross-section file (.npz).

    opacity: [ntemp, nlayers, nwave] cm2 molec-1; press in bar; temp in K.
    """
    if not isinstance(species, str):
        raise ValueError("'species' input must be a string")
    units = {
        'temperature': 'K',
        'pressure': 'bar',
        'wavenumber': 'cm-1',
        'cross section': 'cm2 molecule-1',
    }
    np.savez(
        ofile,
        species=[species], temperature=temp, pressure=press,
        wavenumber=wn, opacity=opacity, units=units,
    )


def read_opacity(ofile, extract='all'):
    """Read a tabulated cross-section file (.npz or petitRADTRANS h5)."""
    if ofile.endswith('petitRADTRANS.h5'):
        import h5py
        with h5py.File(ofile, 'r') as f:
            species = list(f['mol_name'])[0].decode('utf-8')
            temp = np.array(f['t'])
            press = np.array(f['p'])
            wn = np.array(f['bin_edges'])
            opacity = None
            if extract in ('opacity', 'all'):
                opacity = np.swapaxes(np.array(f['xsecarr']), 0, 1)
        units = {
            'temperature': 'K', 'pressure': 'bar',
            'wavenumber': 'cm-1', 'cross section': 'cm2 molecule-1',
        }
    else:
        with np.load(ofile, allow_pickle=True) as f:
            if len(f['species']) > 1:
                raise ValueError('Opacity files must contain a single species')
            species = str(f['species'][0])
            temp = f['temperature']
            press = f['pressure']
            wn = f['wavenumber']
            opacity = None
            if extract in ('opacity', 'all'):
                opacity = f['opacity']
                if np.ndim(opacity) == 4:
                    opacity = opacity[0]
            units = np.ndarray.item(f['units']) if 'units' in f else None
    if units is None:
        # pyratbay < 2.0 files stored pressure in barye:
        press = press / pc.bar
    if extract == 'opacity':
        return opacity
    if extract == 'arrays':
        return species, temp, press, wn
    return (units, species, temp, press, wn, opacity)


# --------------------------------------------------------------------------
# Collision-induced absorption tables

def read_cs(csfile):
    """Read a CIA cross-section file (text format or bundled .npz).

    Returns (absorption [ntemp, nwave], species list, temps [K],
    wn [cm-1]).  The table is in cm-1 amagat-N units (N = len(species)).
    """
    if str(csfile).endswith('.npz'):
        with np.load(csfile) as f:
            return (
                np.asarray(f['cross_section'], float),
                [str(s) for s in f['species']],
                np.asarray(f['temps'], float),
                np.asarray(f['wn'], float),
            )
    species = None
    temps = None
    data = []
    with open(csfile) as f:
        lines = iter(f.readlines())
    in_data = False
    for line in lines:
        strip = line.strip()
        if strip == '' or strip.startswith('#'):
            continue
        if strip.startswith('@SPECIES'):
            species = next(lines).split()
        elif strip.startswith('@TEMPERATURES'):
            temps = np.array(next(lines).split(), float)
        elif strip.startswith('@DATA'):
            in_data = True
        elif in_data:
            data.append(strip.split())
    data = np.array(data, float)
    wn = data[:, 0]
    absorption = data[:, 1:].T.copy()
    return absorption, species, temps, wn


def write_cs(csfile, cs, species, temp, wn, header=None):
    """Write a CIA cross-section file (cm-1 amagat-N units)."""
    with open(csfile, 'w') as f:
        if header is not None:
            f.write(header)
        f.write('@SPECIES\n' + ' '.join(species) + '\n\n')
        f.write('@TEMPERATURES\n        ')
        f.write(''.join(f'{t:10.0f}' for t in temp) + '\n\n')
        f.write('# Wavenumber in cm-1, CIA coefficients in cm-1 '
                f'amagat-{len(species)}:\n')
        f.write('@DATA\n')
        for i, w in enumerate(wn):
            row = ' '.join(f'{val:.3e}' for val in cs[:, i])
            f.write(f'{w:8.1f}  {row}\n')


# --------------------------------------------------------------------------
# Partition functions

def read_pf(pffile):
    """Read a partition-function file.

    Returns (pf [niso, ntemp], isotopes, temps).
    """
    with open(pffile) as f:
        lines = [
            line for line in f.readlines()
            if line.strip() != '' and not line.strip().startswith('#')
        ]
    isotopes = None
    rows = []
    for line in lines:
        if line.startswith('@ISOTOPES'):
            continue
        if isotopes is None:
            isotopes = line.split()
            continue
        if line.startswith('@DATA'):
            continue
        rows.append(line.split())
    data = np.array(rows, float)
    temps = data[:, 0]
    pf = data[:, 1:].T.copy()
    return pf, np.array(isotopes), temps


def write_pf(pffile, pf, isotopes, temp, header=None):
    """Write a partition-function file."""
    with open(pffile, 'w') as f:
        if header is not None:
            f.write(header)
        f.write('@ISOTOPES\n            ' +
                ''.join(f'{iso:>15s}' for iso in isotopes) + '\n\n')
        f.write('# Temperature (K), partition function for each isotope:\n')
        f.write('@DATA\n')
        for i, t in enumerate(temp):
            row = ''.join(f'{val:15.4f}' for val in pf[:, i])
            f.write(f'{t:12.1f}{row}\n')


# --------------------------------------------------------------------------
# Model persistence

_MODEL_RESULT_ATTRS = (
    'spectrum', 'posterior', 'bestp', 'best_log_post',
    'acceptance_rate', 'logz', 'logz_err', 'spec_best',
    'bandflux_best', 'grfactor', 'radeq_temps',
)


def save_model(model, pickle_file):
    """Pickle a Model: its parsed configuration, the configuration's
    root and the result arrays of its last run or retrieval, as host
    numpy.  The tables and the device state are rebuilt on load
    (pyratbay_tpu/io/io.py save_model)."""
    results = {}
    for key in _MODEL_RESULT_ATTRS:
        value = getattr(model, key, None)
        if value is None:
            continue
        if hasattr(value, 'cpu'):         # a tensor
            value = to_host(value).numpy()
        results[key] = np.asarray(value)
    state = {
        'cfg': model.cfg,
        'root': getattr(model.cfg, '_root', None),
        'results': results,
    }
    with open(pickle_file, 'wb') as f:
        pickle.dump(state, f, pickle.HIGHEST_PROTOCOL)


class _ModelUnpickler(pickle.Unpickler):
    """Reads a model file of either package: a class of pyratbay_tpu
    (the JAX package's files name its Config) is taken from the module
    of the same path in pyratbay_tpu_torch, so pyratbay_tpu is never
    imported."""

    def find_class(self, module, name):
        if module == 'pyratbay_tpu' or module.startswith('pyratbay_tpu.'):
            port = 'pyratbay_tpu_torch' + module[len('pyratbay_tpu'):]
            try:
                return getattr(importlib.import_module(port), name)
            except (ImportError, AttributeError):
                raise pickle.UnpicklingError(
                    f'{module}.{name} of the model file has no counterpart '
                    f'in pyratbay_tpu_torch ({port}.{name})') from None
        return super().find_class(module, name)


def load_model(pickle_file, device=None):
    """Rebuild a Model from a save_model file of this package or of
    pyratbay_tpu on `device` (the card by default): the set-up runs
    again from the pickled configuration (the configuration file need
    not exist), then the result arrays are restored as numpy."""
    from ..model import Model
    with open(pickle_file, 'rb') as f:
        state = _ModelUnpickler(f).load()
    model = Model(state['cfg'], device=device, root=state.get('root'))
    for key, value in state.get('results', {}).items():
        setattr(model, key, value)
    return model


# --------------------------------------------------------------------------
# Species physical data

def read_molecs(file=None):
    """Species names, masses (g/mol), and collision radii (Angstrom).

    With no argument, uses the packaged species database; otherwise reads
    a molecules.dat-format text file (name, mass, radius columns).
    Returns (names, masses, radii) arrays.
    """
    if file is None:
        from ..data.species_db import SPECIES
        names = np.array(list(SPECIES.keys()))
        masses = np.array([v[0] for v in SPECIES.values()])
        radii = np.array([v[1] for v in SPECIES.values()])
        return names, masses, radii
    names, masses, radii = [], [], []
    with open(file) as f:
        for line in f:
            if line.startswith('#') or not line.strip():
                continue
            parts = line.split()
            names.append(parts[0])
            masses.append(float(parts[1]))
            radii.append(float(parts[2]))
    return np.array(names), np.array(masses), np.array(radii)


def species_properties(species, molfile=None):
    """Masses (g/mol) and collision radii (cm) for a list of species."""
    names, masses, radii = read_molecs(molfile)
    name_list = list(names)
    missing = [spec for spec in species if spec not in name_list]
    if missing:
        raise ValueError(f'Species {missing} not in the species database')
    idx = [name_list.index(spec) for spec in species]
    return masses[idx], radii[idx] * pc.A


# --------------------------------------------------------------------------
# Observations (band-integrated data points)

def read_observations(obsfile):
    """Read an observations file: filter files / tophats with data.

    Returns a dict with keys 'dunits', 'names', 'data', 'uncert',
    'filters', 'wl', 'half_width' (entries may be None).
    Format: lines of '<data> <uncert> <filter-file>' or
    '<data> <uncert> <wl0> <half_width> [name]', after a '@DEPTH_UNITS'
    block giving the depth units.
    """
    dunits = 'none'
    data = []
    uncert = []
    filters = []
    with open(obsfile) as f:
        lines = [
            line.strip() for line in f.readlines()
            if line.strip() != '' and not line.strip().startswith('#')
        ]
    reading_units = False
    for line in lines:
        if line.startswith('@DEPTH_UNITS'):
            reading_units = True
            continue
        if line.startswith('@DATA'):
            reading_units = False
            continue
        if reading_units:
            dunits = line
            reading_units = False
            continue
        fields = line.split()
        data.append(float(fields[0]))
        uncert.append(float(fields[1]))
        filters.append(' '.join(fields[2:]))
    scale = pc.u(dunits)
    return {
        'dunits': dunits,
        'data': np.array(data) * scale,
        'uncert': np.array(uncert) * scale,
        'filters': filters,
    }


def write_observations(obsfile, data, uncert, filters, dunits='none'):
    """Write an observations file (see read_observations)."""
    scale = pc.u(dunits)
    with open(obsfile, 'w') as f:
        f.write('@DEPTH_UNITS\n' + dunits + '\n\n@DATA\n')
        for d, u, filt in zip(data, uncert, filters):
            f.write(f'{d/scale:.8e}  {u/scale:.8e}  {filt}\n')
