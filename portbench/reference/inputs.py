"""The flagship's inputs, frozen: the wavenumber grids, the synthetic
opacity tables, the atmosphere file and the configuration text that the
program reads, written from a configuration file of portbench/configs/,
and plain readers of those files for the reference.

A copy of pyratbay_tpu_torch/benchmark.py make_flagship's table writers
(_synthetic_cs_table, _synthetic_cia_table), of its cfg text and of the
writers and the grids they call (io.write_opacity, io.write_cs,
io.write_atm, ops/grids.py), so that a change to the program leaves the
inputs as they are.  Plain numpy; imports nothing of the program.
"""
import hashlib
import json
import os

import numpy as np
import scipy.constants as sc

# CGS constants as the program defines them (pyratbay_tpu_torch/constants.py):
K_BOLTZ = sc.k * 1e7
G_GRAV = sc.G * 1e3
N_AVOGADRO = sc.N_A
AMAGAT = sc.physical_constants[
    'Loschmidt constant (273.15 K, 101.325 kPa)'][0] * 1e-6
BAR = 1e6
UM = 1e-4
RJUP = 7.1492e9
RSUN = 6.957e10
MJUP = 1.8982e30
AU = sc.au * 100

# Molar masses (g/mol) of the program's species database:
MASSES = {'H2': 2.016, 'He': 4.002602, 'H': 1.008, 'Na': 22.989769,
          'K': 39.0983, 'H2O': 18.015, 'CH4': 16.043, 'CO': 28.01,
          'CO2': 44.009}
UNITS = {'rjup': RJUP, 'rsun': RSUN, 'mjup': MJUP, 'au': AU, 'bar': BAR}


def wavenumbers(config):
    """The grid of the configuration's table (cm-1, increasing): a
    constant step `wnstep`, or the constant-R geometric series of
    `resolution` (ops/grids.py constant_resolution_spectrum)."""
    wnlow = 1.0 / (config['wl_high_um'] * UM)
    wnhigh = 1.0 / (config['wl_low_um'] * UM)
    if config.get('resolution') is not None:
        f = 0.5 / config['resolution']
        g = (1.0 + f) / (1.0 - f)
        nwave = int(np.ceil(-np.log(wnlow / wnhigh) / np.log(g)))
        return wnlow * g ** np.arange(nwave)
    return np.arange(wnlow, wnhigh, config['wnstep'])


def pressure(config):
    """Layer pressures in bar, top to bottom."""
    return np.logspace(np.log10(config['ptop_bar']),
                       np.log10(config['pbottom_bar']), config['nlayers'])


def cs_table(wn, press, ntemp=10, seed=5, tmin=300.0, tmax=3000.0):
    """The synthetic line-sampled cross sections [ntemp, nlayers, nwave]
    (cm2 molec-1) and their temperatures: a smooth band and pressure-
    broadened pseudo lines (benchmark.py _synthetic_cs_table)."""
    rng = np.random.default_rng(seed)
    temps = np.linspace(tmin, tmax, ntemp)
    nlayers, nwave = len(press), len(wn)
    band = 1e-22 * np.exp(-0.5 * ((wn - wn.mean()) / (0.2 * np.ptp(wn)))**2)
    lines = np.zeros(nwave)
    nlines = min(400, max(nwave // 4, 1))
    line_pos = rng.choice(nwave, nlines, replace=False)
    lines[line_pos] = rng.lognormal(0.0, 1.5, nlines) * 1e-21
    opacity = np.zeros((ntemp, nlayers, nwave))
    for it, temp in enumerate(temps):
        tfac = (temp / 1000.0)**-0.5
        for il, pres in enumerate(press):
            width = 1 + int(3 * np.log10(1 + pres / press[0]))
            smooth = np.convolve(lines, np.ones(width) / width, mode='same')
            opacity[it, il] = tfac * (band + smooth)
    return temps, opacity


def cia_table(seed=7):
    """The synthetic CIA table (cm-1 amagat-2) on its own grid:
    (temps [15], wn [200], cs [15, 200]) (_synthetic_cia_table)."""
    rng = np.random.default_rng(seed)
    temps = np.linspace(60.0, 3000.0, 15)
    wn = np.linspace(20.0, 16000.0, 200)
    base = 1e-7 * np.exp(-0.5 * ((wn - 5000) / 4000)**2)
    cs = np.array([base * (temp / 1000.0)**-0.7
                   * (1 + 0.1 * rng.random(len(wn))) for temp in temps])
    return temps, wn, cs


def _write_atm(path, press, temp, species, vmr):
    """io.write_atm's format, pressure in bar."""
    with open(path, 'w') as f:
        f.write('# Abundance units (by number or mass):\n@PRESSURE\n')
        f.write('bar\n@TEMPERATURE\nkelvin\n@ABUNDANCE\nvolume\n')
        f.write('\n@SPECIES\n' + '  '.join(species) + '\n\n@DATA\n')
        for i in range(len(press)):
            row = f'{press[i]:.6e}  {temp[i]:11.3f}  '
            row += '  '.join(f'{q:.6e}' for q in vmr[i])
            f.write(row.rstrip() + '\n')


def _write_cs(path, cs, species, temps, wn):
    """io.write_cs's CIA text format."""
    with open(path, 'w') as f:
        f.write('@SPECIES\n' + ' '.join(species) + '\n\n')
        f.write('@TEMPERATURES\n        ')
        f.write(''.join(f'{t:10.0f}' for t in temps) + '\n\n')
        f.write('# Wavenumber in cm-1, CIA coefficients in cm-1 '
                f'amagat-{len(species)}:\n')
        f.write('@DATA\n')
        for i, w in enumerate(wn):
            row = ' '.join(f'{val:.3e}' for val in cs[:, i])
            f.write(f'{w:8.1f}  {row}\n')


def cfg_text(config, paths):
    """make_flagship's configuration text for the files in `paths`."""
    sampling = (f"resolution = {config['resolution']}"
                if config.get('resolution') is not None
                else f"wnstep = {config['wnstep']}")
    rows = '\n'.join(f'    {name:10s} {val!r} {lo!r} {hi!r} {step!r}'
                     for name, val, lo, hi, step in config['retrieval_params'])
    planet = config['planet']
    return f"""[pyrat]
runmode = spectrum
verb = -1
logfile = {paths['dir']}/flagship.log
rt_path = {config['rt_path']}
atmfile = {paths['atm']}
sampled_cross_sec = {paths['table']}
continuum_cross_sec = {paths['cia']}
wl_low = {config['wl_low_um']} um
wl_high = {config['wl_high_um']} um
{sampling}
rstar = {planet['rstar_rsun']} rsun
tstar = {planet['tstar']}
smaxis = {planet['smaxis_au']} au
mplanet = {planet['mplanet_mjup']} mjup
rplanet = {planet['rplanet_rjup']} rjup
refpressure = {planet['refpressure_bar']} bar
radmodel = hydro_m
maxdepth = {config['maxdepth']}
tmodel = guillot
tpars = {' '.join(repr(v) for v in config['tpars'])}
vmr_vars = log_H2O {config['log_H2O']!r}
bulk = H2 He
alkali = sodium_vdw
clouds =
    deck {config['log_p_cl']!r}
    lecavelier {config['log_k_ray']!r} {config['alpha_ray']!r}
tlow = {config['tlow']}
thigh = {config['thigh']}
retrieval_params =
{rows}
"""


def inputs_key(config):
    """A digest of what the inputs are written from: the configuration
    and the source of this module."""
    with open(__file__, 'rb') as f:
        source = f.read()
    text = json.dumps(config, sort_keys=True).encode()
    return hashlib.sha256(text + b'\0' + source).hexdigest()


def write_inputs(config, workdir):
    """Write the configuration's atmosphere, tables and cfg into
    `workdir` unless a complete set of the same configuration and
    writers is there (a marker file holding their digest is written
    last); returns the paths."""
    paths = {'dir': workdir,
             'atm': os.path.join(workdir, 'flagship.atm'),
             'table': os.path.join(workdir, 'flagship_h2o.npz'),
             'cia': os.path.join(workdir, 'flagship_cia.dat'),
             'cfg': os.path.join(workdir, 'flagship.cfg')}
    marker = os.path.join(workdir, 'complete')
    key = inputs_key(config)
    if os.path.isfile(marker):
        with open(marker) as f:
            if f.read().strip() == key:
                return paths
        os.remove(marker)
    os.makedirs(workdir, exist_ok=True)
    press = pressure(config)
    nlayers = len(press)
    vmr = np.tile(np.asarray(config['vmr'], float), (nlayers, 1))
    _write_atm(paths['atm'], press, np.full(nlayers, config['temperature']),
               config['species'], vmr)
    tab = config['table']
    temps, opacity = cs_table(wavenumbers(config), press, tab['ntemp'],
                              tab['seed'], tab['tmin'], tab['tmax'])
    units = {'temperature': 'K', 'pressure': 'bar', 'wavenumber': 'cm-1',
             'cross section': 'cm2 molecule-1'}
    with open(paths['table'], 'wb') as f:
        np.savez(f, species=[tab['species']], temperature=temps,
                 pressure=press, wavenumber=wavenumbers(config),
                 opacity=opacity, units=units)
    ctemps, cwn, cs = cia_table(config['cia']['seed'])
    _write_cs(paths['cia'], cs, config['cia']['species'], ctemps, cwn)
    with open(paths['cfg'], 'w') as f:
        f.write(cfg_text(config, paths))
    with open(marker, 'w') as f:
        f.write(key + '\n')
    return paths


def read_atm(path):
    """(species, press [bar], temp, vmr [nlayers, nspecies]) of the
    atmosphere file."""
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    species = lines[lines.index('@SPECIES') + 1].split()
    data = np.array([ln.split() for ln in lines[lines.index('@DATA') + 1:]],
                    float)
    return species, data[:, 0], data[:, 1], data[:, 2:]


def read_table(path):
    """(temps, press, wn, opacity [ntemp, nlayers, nwave]) of the table."""
    with np.load(path) as f:
        return (f['temperature'], f['pressure'], f['wavenumber'],
                f['opacity'])


def read_cia(path):
    """(species, temps, wn, cs [ntemp, nwave]) of the CIA text file."""
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    species = lines[lines.index('@SPECIES') + 1].split()
    temps = np.array(lines[lines.index('@TEMPERATURES') + 1].split(), float)
    rows = [ln.split() for ln in lines[lines.index('@DATA') + 1:] if ln]
    data = np.array(rows, float)
    return species, temps, data[:, 0], data[:, 1:].T.copy()
