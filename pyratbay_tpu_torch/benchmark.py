"""Self-contained flagship model: the synthetic opacity tables and the
config of pyratbay_tpu/benchmark.py::make_flagship, built with the
port; the inputs of the opacity workflow that makes such a table
from a line list (make_lbl_flagship); synthetic line lists of every
format the line-list readers take, with their partition-function files,
and CIA files for the CLI's -cs tool (make_line_lists and the
synthetic_* writers); a synthetic line list that
the direct line-by-line engine reads without a TLI file
(synthetic_lines); the flagship with thermochemical equilibrium in place
of its free VMRs (equilibrium_flagship_cfg); and the
radiative-equilibrium model (make_radeq).

The flagship is an HD 209458 b-like retrieval: line-sampled H2O, H2-H2
CIA, Na alkali, a gray deck and a Lecavelier haze, a Guillot T(p),
hydro_m radii and 7 retrieval parameters, 51 layers x ~3209
wavenumbers at full size, in transit geometry or (rt_path = 'eclipse'
or 'emission') through the plane-parallel emission solver.  The table
writers are copies of the JAX package's, so equal seeds write equal
tables.
"""
import os
import tempfile

import numpy as np

from .io import io as pio

__all__ = ['make_flagship', 'make_lbl_flagship', 'write_opacity_cfg',
           'make_line_lists', 'synthetic_lines', 'equilibrium_flagship_cfg',
           'make_radeq', 'synthetic_exomol', 'synthetic_repack',
           'synthetic_pands', 'synthetic_tioschwenke', 'synthetic_voplez',
           'synthetic_vald', 'synthetic_pf', 'synthetic_kurucz_pf',
           'synthetic_cia_hitran', 'synthetic_cia_borysow']

# The equilibrium flagship's network: the species of the flagship's
# atmosphere file, as pyratbay_tpu's tests/test_chem.py lists them.
EQUILIBRIUM_SPECIES = 'H2 He H H2O CH4 CO CO2 Na K'


def _synthetic_cs_table(path, wn, press, species='H2O', ntemp=10, seed=5):
    """Write a synthetic line-sampled cross-section npz (real format)."""
    rng = np.random.default_rng(seed)
    temps = np.linspace(300.0, 3000.0, ntemp)
    nlayers = len(press)
    nwave = len(wn)
    # Smooth band structure + pseudo lines, pressure-broadened:
    band = 1e-22 * np.exp(
        -0.5 * ((wn - wn.mean()) / (0.2 * np.ptp(wn)))**2
    )
    lines = np.zeros(nwave)
    nlines = min(400, max(nwave // 4, 1))
    line_pos = rng.choice(nwave, nlines, replace=False)
    lines[line_pos] = rng.lognormal(0.0, 1.5, nlines) * 1e-21
    opacity = np.zeros((ntemp, nlayers, nwave))
    for it, temp in enumerate(temps):
        tfac = (temp / 1000.0)**-0.5
        for il, pres in enumerate(press):
            width = 1 + int(3 * np.log10(1 + pres / press[0]))
            smooth = np.convolve(
                lines, np.ones(width) / width, mode='same',
            )
            opacity[it, il] = tfac * (band + smooth)
    pio.write_opacity(path, species, temps, press, wn, opacity)
    return path


def _synthetic_cia_table(path, species=('H2', 'H2'), seed=7):
    """Write a synthetic CIA table in the standard text format."""
    rng = np.random.default_rng(seed)
    temps = np.linspace(60.0, 3000.0, 15)
    wn = np.linspace(20.0, 16000.0, 200)
    base = 1e-7 * np.exp(-0.5 * ((wn - 5000) / 4000)**2)
    cs = np.array([
        base * (temp / 1000.0)**-0.7 * (1 + 0.1 * rng.random(len(wn)))
        for temp in temps
    ])
    pio.write_cs(path, cs, list(species), temps, wn)
    return path


def make_flagship(workdir=None, nlayers=51, wl_low=1.1, wl_high=1.7,
                  wnstep=1.0, resolution=None, device=None,
                  rt_path='transit', cs_file=None):
    """Write the flagship inputs into `workdir` and build the model on
    `device`, with the observing geometry `rt_path`.  Sampling: the
    constant-dnu `wnstep` (default), or the constant-R `resolution`
    when given (wnstep ignored; R = 115,000 gives 50,062 wavenumbers).
    cs_file: an H2O cross-section table to read (one that
    Model.compute_opacity wrote) in place of the synthetic one.

    Returns (model, obs, ret, forward, example_params): forward is the
    per-chain forward (params [npars] -> dict of tensors).
    """
    from .model import Model
    from .observation import Observation
    from .retrieval.forward import build_forward
    from .retrieval.params import RetrievalParams

    if workdir is None:
        workdir = tempfile.mkdtemp(prefix='pbt_flagship_')
    os.makedirs(workdir, exist_ok=True)

    press = np.logspace(-6, 2, nlayers)
    species = ['H2', 'He', 'H', 'Na', 'K', 'H2O', 'CH4', 'CO', 'CO2']
    vmr = np.tile(
        [8.5e-1, 1.49e-1, 1e-6, 3e-6, 5e-8, 4e-4, 1e-4, 5e-4, 1e-7],
        (nlayers, 1),
    )
    temp = np.full(nlayers, 1400.0)
    atmfile = os.path.join(workdir, 'flagship.atm')
    pio.write_atm(atmfile, press, temp, species, vmr, punits='bar')

    if cs_file is None:
        if resolution is not None:
            from .ops.grids import wavenumber_grid
            wn = np.asarray(wavenumber_grid(
                wnlow=1.0 / (wl_high * 1e-4), wnhigh=1.0 / (wl_low * 1e-4),
                resolution=resolution,
            ).wn)
        else:
            wn = np.arange(
                1.0 / (wl_high * 1e-4), 1.0 / (wl_low * 1e-4), wnstep)
        cs_file = os.path.join(workdir, 'flagship_h2o.npz')
        _synthetic_cs_table(cs_file, wn, press)
    cia_file = os.path.join(workdir, 'flagship_cia.dat')
    _synthetic_cia_table(cia_file)

    sampling_key = (
        f'resolution = {resolution}' if resolution is not None
        else f'wnstep = {wnstep}'
    )
    cfg_text = f"""[pyrat]
runmode = spectrum
verb = -1
logfile = {workdir}/flagship.log
rt_path = {rt_path}
atmfile = {atmfile}
sampled_cross_sec = {cs_file}
continuum_cross_sec = {cia_file}
wl_low = {wl_low} um
wl_high = {wl_high} um
{sampling_key}
rstar = 1.27 rsun
tstar = 5800.0
smaxis = 0.045 au
mplanet = 0.6 mjup
rplanet = 1.0 rjup
refpressure = 0.1 bar
radmodel = hydro_m
maxdepth = 10.0
tmodel = guillot
tpars = -4.67 -0.8 -0.8 0.5 1486.0 100.0
vmr_vars = log_H2O -3.4
bulk = H2 He
alkali = sodium_vdw
clouds =
    deck 2.0
    lecavelier 0.0 -4.0
tlow = 300
thigh = 3000
retrieval_params =
    log_kappa'   -4.67  -9.0  5.0  0.3
    T_irr      1486.0  100.0 3000.0 50.0
    log_H2O      -3.4   -9.0 -1.0  0.5
    R_planet      1.0    0.5  4.5  0.03
    log_p_cl      2.0   -6.0  2.0  0.5
    log_k_ray     0.0   -4.0  4.0  0.5
    alpha_ray    -4.0   -6.0  0.0  0.0
"""
    cfg_file = os.path.join(workdir, 'flagship.cfg')
    with open(cfg_file, 'w') as f:
        f.write(cfg_text)

    model = Model(cfg_file, device=device)

    class _ObsCfg:
        data = None
        uncert = None
        filters = [
            f'tophat {wl0:.4f} 0.01'
            for wl0 in np.linspace(wl_low + 0.03, wl_high - 0.03, 20)
        ]
        obsfile = None
        dunits = None
        offset_inst = None
        uncert_scaling = None

    obs = Observation(_ObsCfg, model.wn)
    ret = RetrievalParams(model, obs)
    forward = build_forward(model, obs, ret)
    return model, obs, ret, forward, np.asarray(ret.params)


def equilibrium_flagship_cfg(flagship_cfg, out_cfg):
    """Write the flagship config `flagship_cfg` (make_flagship's, of
    either package) as `out_cfg` with thermochemical equilibrium in
    place of the free H2O VMR: chemistry = equilibrium over
    EQUILIBRIUM_SPECIES, vmr_vars [M/H] = 0.0 and C/O = 0.55, both
    retrieved beside the Guillot parameters (in log_H2O's place, then
    after it), no bulk species.  Returns out_cfg."""
    with open(flagship_cfg) as f:
        lines = f.read().splitlines()
    out = []
    for line in lines:
        if line.startswith(('vmr_vars', 'bulk')):
            continue
        if line.strip().startswith('log_H2O'):
            out.append('    [M/H]         0.0   -1.0  2.0  0.3')
            out.append('    C/O           0.55   0.1  1.5  0.1')
            continue
        out.append(line)
        if line.startswith('radmodel'):
            out += ['chemistry = equilibrium',
                    f'species = {EQUILIBRIUM_SPECIES}',
                    'vmr_vars =', '    [M/H] 0.0', '    C/O 0.55']
    with open(out_cfg, 'w') as f:
        f.write('\n'.join(out) + '\n')
    return out_cfg


def make_radeq(workdir=None, nlayers=40, wl_low=0.6, wl_high=12.0,
               resolution=300.0, device=None):
    """Write the radiative-equilibrium inputs of pyratbay_tpu/benchmark.py
    make_radeq into `workdir` (the same files: the flagship's synthetic
    tables on an emission_two_stream geometry over a broad constant-R
    grid, runmode = radeq) and build the model on `device`."""
    from .model import Model
    from .ops.grids import wavenumber_grid

    if workdir is None:
        workdir = tempfile.mkdtemp(prefix='pbt_radeq_')
    os.makedirs(workdir, exist_ok=True)

    press = np.logspace(-6, 2, nlayers)
    species = ['H2', 'He', 'H', 'Na', 'K', 'H2O', 'CH4', 'CO', 'CO2']
    vmr = np.tile(
        [8.5e-1, 1.49e-1, 1e-6, 3e-6, 5e-8, 4e-4, 1e-4, 5e-4, 1e-7],
        (nlayers, 1),
    )
    temp = np.full(nlayers, 1400.0)
    atmfile = os.path.join(workdir, 'radeq.atm')
    pio.write_atm(atmfile, press, temp, species, vmr, punits='bar')

    wn = np.asarray(wavenumber_grid(
        wnlow=1.0 / (wl_high * 1e-4), wnhigh=1.0 / (wl_low * 1e-4),
        resolution=resolution,
    ).wn)
    cs_file = os.path.join(workdir, 'radeq_h2o.npz')
    _synthetic_cs_table(cs_file, wn, press)
    cia_file = os.path.join(workdir, 'radeq_cia.dat')
    _synthetic_cia_table(cia_file)

    cfg_text = f"""[pyrat]
runmode = radeq
verb = -1
logfile = {workdir}/radeq.log
rt_path = emission_two_stream
atmfile = {atmfile}
sampled_cross_sec = {cs_file}
continuum_cross_sec = {cia_file}
wl_low = {wl_low} um
wl_high = {wl_high} um
resolution = {resolution}
rstar = 1.27 rsun
tstar = 5800.0
smaxis = 0.045 au
mplanet = 0.6 mjup
rplanet = 1.0 rjup
refpressure = 0.1 bar
radmodel = hydro_m
tmodel = guillot
tpars = -4.67 -0.8 -0.8 0.5 1486.0 100.0
bulk = H2 He
tlow = 100
thigh = 5900
"""
    cfg_file = os.path.join(workdir, 'radeq.cfg')
    with open(cfg_file, 'w') as f:
        f.write(cfg_text)
    return Model(cfg_file, device=device)


# HITRAN .par record (160 characters): molecule, isotope, wavenumber,
# intensity, Einstein A, air/self widths, Elow, T exponent, shift,
# quanta, uncertainty codes, references, line-mixing flag, g', g''.
_PAR_RECORD = (
    '{mol:2d}{iso:1d}{wn:12.6f}{sw:10.3E}{a21:10.3E}{gair:5.3f}'
    '{gself:5.3f}{elow:10.4f}{nair:4.2f}{shift:8.5f}{quanta:60s}'
    '{codes:6s}{refs:12s} {gup:7.1f}{glow:7.1f}\n'
)


def _line_draws(nlines, seed, wn_low=5800.0, wn_high=9200.0):
    """Synthetic H2O-like lines: the distributions of the JAX bench's
    synthetic lines (bench.py::_synthetic_lines): centers uniform over
    [wn_low, wn_high] cm-1 (sorted), lognormal gf (mu = -8, sigma = 3),
    Elow uniform up to 15,000 cm-1, the four TIPS isotopes (1-4) and an
    upper-state degeneracy g' = 2J + 1.  Returns (wn, gf, elow, iso,
    gup)."""
    rng = np.random.default_rng(seed)
    wn = np.sort(rng.uniform(wn_low, wn_high, nlines))
    gf = rng.lognormal(-8.0, 3.0, nlines)
    elow = rng.uniform(0.0, 15000.0, nlines)
    iso = rng.integers(1, 5, nlines)
    gup = 2.0 * rng.integers(0, 30, nlines) + 1.0
    return wn, gf, elow, iso, gup


def _a21(gf, gup, wn):
    """Einstein A from gf (Simeckova et al. 2006, eq. 36, inverted)."""
    from . import constants as pc
    return gf * 8.0 * np.pi * pc.c * wn**2 / (gup * pc.C1)


def _synthetic_hitran(path, nlines, seed, wn_low=5800.0, wn_high=9200.0):
    """Write a synthetic H2O line list in the HITRAN .par format: the
    lines of _line_draws, Einstein A from gf and g'."""
    wn, gf, elow, iso, gup = _line_draws(nlines, seed, wn_low, wn_high)
    a21 = _a21(gf, gup, wn)
    with open(path, 'w') as f:
        for i in range(nlines):
            f.write(_PAR_RECORD.format(
                mol=1, iso=int(iso[i]), wn=wn[i], sw=1e-25, a21=a21[i],
                gair=0.07, gself=0.35, elow=max(elow[i], 1e-4), nair=0.7,
                shift=0.0, quanta='', codes='000000', refs='',
                gup=gup[i], glow=gup[i]))
    return path


# The writers below put the lines of _line_draws into the other formats
# the line-list readers take (opacity/linelists.py), and write the
# partition-function and CIA files the CLI's tools read.  They are
# inputs, not a feature: the JAX package reads the same files.

# The HITRAN isotopes 1-4 of H2O in exomol notation (TIPS order):
_H2O_ISO = np.array([116, 118, 117, 126])


def _log_code(values):
    """Kurucz's int16 code of 10^(0.001 (code - 16384))."""
    return np.clip(np.round(1000.0 * np.log10(values)) + 16384, 0, 32767)


def synthetic_exomol(workdir, nlines, seed, nstates=20_000,
                     wn_low=5800.0, wn_high=9200.0):
    """Write the lines of _line_draws as an ExoMol pair,
    workdir/1H2-16O__Synth__05800-09200.trans and its states file
    1H2-16O__Synth.states.bz2, and return the .trans path.

    `nstates` energies uniform up to 15,000 cm-1 above wn_high (ids from
    1, g = 2J + 1); each line joins the state nearest its Elow to the
    state nearest Elow + wn, so its wavenumber lands within a state
    spacing of the draw's.  Einstein A from the draw's gf and the upper
    state's g.  Transitions sorted by wavenumber.
    """
    import bz2
    wn, gf, elow, _, _ = _line_draws(nlines, seed, wn_low, wn_high)
    rng = np.random.default_rng([seed, 1])
    energy = np.sort(rng.uniform(0.0, 15000.0 + wn_high + 100.0, nstates))
    energy[0] = 0.0
    jval = rng.integers(0, 30, nstates)
    gstate = 2 * jval + 1

    def nearest(values):
        idx = np.clip(np.searchsorted(energy, values), 1, nstates - 1)
        return idx - (values - energy[idx - 1] < energy[idx] - values)

    lo = nearest(elow)
    up = nearest(energy[lo] + wn)
    line_wn = energy[up] - energy[lo]
    keep = line_wn > 0
    lo, up, line_wn, gf = lo[keep], up[keep], line_wn[keep], gf[keep]
    order = np.argsort(line_wn, kind='stable')
    lo, up, line_wn, gf = lo[order], up[order], line_wn[order], gf[order]
    a21 = _a21(gf, gstate[up], line_wn)
    base = os.path.join(workdir, '1H2-16O__Synth')
    trans = f'{base}__{int(wn_low):05d}-{int(wn_high):05d}.trans'
    np.savetxt(trans, np.column_stack([up + 1, lo + 1, a21]),
               fmt=['%12d', '%12d', '%10.4e'])
    rows = '\n'.join(
        f'{i + 1:12d} {e:12.6f} {g:6d} {j:7d}'
        for i, (e, g, j) in enumerate(zip(energy, gstate, jval)))
    with bz2.open(base + '.states.bz2', 'wt') as f:
        f.write(rows + '\n')
    return trans


def synthetic_repack(path, nlines, seed, wn_low=5800.0, wn_high=9200.0):
    """Write the lines of _line_draws in the repack binary format: (wn,
    elow, gf, iso) as float64 x 3 and int32 records, sorted by
    wavenumber, isotopes by exomol name.  The reader takes the molecule
    and database from the file name, MOLECULE_DBTYPE_...: name `path`
    so (e.g. H2O_synth_lbl.dat)."""
    wn, gf, elow, iso, _ = _line_draws(nlines, seed, wn_low, wn_high)
    data = np.zeros(nlines, np.dtype([
        ('wn', 'f8'), ('elow', 'f8'), ('gf', 'f8'), ('iso', 'i4')]))
    data['wn'], data['elow'], data['gf'] = wn, elow, gf
    data['iso'] = _H2O_ISO[iso - 1]
    data.tofile(path)
    return path


def synthetic_pands(path, nlines, seed, wn_low=5800.0, wn_high=9200.0):
    """Write the lines of _line_draws in the Partridge & Schwenke (1997)
    binary format: (uint32 log-wavelength index, int16 Elow, int16 gf
    code) records by increasing wavelength, the isotope (0-3) in the
    sign bits of Elow (2) and gf (1); Elow at least 1 cm-1."""
    from . import constants as pc
    from .opacity.linelists import Pands
    wn, gf, elow, iso, _ = _line_draws(nlines, seed, wn_low, wn_high)
    iso = iso - 1
    data = np.zeros(nlines, np.dtype(
        [('iw', '<u4'), ('ielo', '<i2'), ('igf', '<i2')]))
    data['iw'] = np.round(np.log(1.0 / (wn * pc.nm)) / Pands._RATIOLOG)
    sign_elo = np.where(iso & 2, -1, 1)
    sign_gf = np.where(iso & 1, -1, 1)
    data['ielo'] = sign_elo * np.clip(np.round(elow), 1, 32767)
    data['igf'] = sign_gf * np.maximum(_log_code(gf / 4.0), 1)
    data[np.argsort(data['iw'], kind='stable')].tofile(path)
    return path


def synthetic_tioschwenke(path, nlines, seed, wn_low=5800.0,
                          wn_high=9200.0):
    """Write the lines of _line_draws as a Schwenke (1998) TiO binary
    list (Kurucz's 16-byte records: int32 log-wavelength index, int16
    isotope code 8950 + iso with a random sign, int16 Elow and gf codes,
    6 bytes of padding), by increasing wavelength; isotopes 0-3."""
    from . import constants as pc
    from .opacity.linelists import Tioschwenke
    wn, gf, elow, iso, _ = _line_draws(nlines, seed, wn_low, wn_high)
    rng = np.random.default_rng([seed, 2])
    data = np.zeros(nlines, np.dtype([
        ('iw', '<i4'), ('ieli', '<i2'), ('ielo', '<i2'), ('igf', '<i2'),
        ('pad', 'V6')]))
    data['iw'] = np.round(np.log(1.0 / (wn * pc.nm))
                          / Tioschwenke._RATIOLOG)
    data['ieli'] = (8950 + iso - 1) * rng.choice([-1, 1], nlines)
    data['ielo'] = _log_code(np.maximum(elow, 1.0))
    data['igf'] = _log_code(gf)
    data[np.argsort(data['iw'], kind='stable')].tofile(path)
    return path


def synthetic_voplez(path, nlines, seed, wn_low=5800.0, wn_high=9200.0):
    """Write the lines of _line_draws as a Plez (1998) VO ASCII list:
    53-byte records by increasing wavelength, the wavelength in A
    (0-11), lower J (11-21), gf (21-32), the wavenumber (33-43) and Elow
    in eV (44-50)."""
    from . import constants as pc
    wn, gf, elow, _, gup = _line_draws(nlines, seed, wn_low, wn_high)
    with open(path, 'w') as f:
        for i in np.argsort(-wn, kind='stable'):
            f.write(f'{1e8 / wn[i]:11.3f}{(gup[i] - 1) / 2:10.1f}'
                    f'{gf[i]:11.4e} {wn[i]:10.3f} {elow[i] / pc.eV:6.4f}'
                    '  \n')
    return path


def synthetic_vald(path, nlines, seed, ion='Fe', wn_low=5800.0,
                   wn_high=9200.0):
    """Write the lines of _line_draws as a VALD extract of `ion`
    ('ION N', wavenumber, Elow, log gf, ... CSV records) with every
    tenth record of the next ion stage between them, which the reader
    skips.  The reader takes the ion from the file name, ..._ION.dat:
    name `path` so (e.g. VALD_Fe.dat)."""
    wn, gf, elow, _, _ = _line_draws(nlines, seed, wn_low, wn_high)
    with open(path, 'w') as f:
        f.write('# synthetic VALD extract: species, wavenumber (cm-1), '
                'Elow (cm-1), log gf, Rad, Stark, Waals\n')
        for i in range(nlines):
            stage = 2 if i % 10 == 9 else 1
            f.write(f"'{ion} {stage}',{wn[i]:12.4f},{elow[i]:12.4f},"
                    f'{np.log10(gf[i]):8.3f}, 8.000,-5.500,-7.600\n')
    return path


def synthetic_pf(path, isotopes, tmin=100.0, tmax=6000.0, tstep=100.0):
    """Write a partition-function file (io.write_pf) for `isotopes`: a
    power law Q = q0 (T / 296)^1.5, q0 = 25, 50, ... by isotope."""
    temp = np.arange(tmin, tmax + 0.5 * tstep, tstep)
    pf = np.array([25.0 * (i + 1) * (temp / 296.0)**1.5
                   for i in range(len(isotopes))])
    pio.write_pf(path, pf, isotopes, temp)
    return path


def synthetic_kurucz_pf(path, molecule='H2O'):
    """Write a Kurucz partition-function table of H2O (6 header lines,
    4 isotopes) or TiO (1 header line, 5 isotopes): T from 10 to 6000 K
    in steps of 10, then power-law Q columns.  partitions.kurucz takes
    the molecule from the file name: name `path` with h2o or tio in it."""
    header = {'H2O': 6, 'TiO': 1}[molecule]
    niso = {'H2O': 4, 'TiO': 5}[molecule]
    temp = np.arange(10.0, 6001.0, 10.0)
    with open(path, 'w') as f:
        for i in range(header):
            f.write(f'# synthetic Kurucz {molecule} partition function, '
                    f'header line {i + 1}\n')
        for t in temp:
            row = ''.join(f'{30.0 * (i + 1) * (t / 296.0)**1.5:14.4f}'
                          for i in range(niso))
            f.write(f'{t:8.1f}{row}\n')
    return path


def _cia(wn, temp):
    """A smooth positive CIA band in cm5 molec-2: centered at 4,200
    cm-1, growing with temperature."""
    return 1e-45 * np.exp(-((wn - 4200.0) / 3000.0)**2) * (
        0.5 + temp / 2000.0)


def synthetic_cia_hitran(path, pair='H2-H2', temps=None, wn=None):
    """Write a CIA file in the HITRAN format: for each temperature a
    header (pair, wavenumber range, points, temperature, maximum,
    resolution, comments, reference) and `points` (wavenumber, cross
    section in cm5 molec-2) rows.  The defaults: 200-3000 K in steps of
    200, 20-10,000 cm-1 in steps of 10."""
    temps = np.arange(200.0, 3001.0, 200.0) if temps is None else temps
    wn = np.arange(20.0, 10001.0, 10.0) if wn is None else wn
    with open(path, 'w') as f:
        for temp in temps:
            cs = _cia(wn, temp)
            f.write(f'{pair:>20s}{wn[0]:10.3f}{wn[-1]:10.3f}{len(wn):7d}'
                    f'{temp:7.1f}{cs.max():10.3e}{0.0:6.3f}'
                    f'{"synthetic":>27s}{1:3d}\n')
            f.write(''.join(f'{w:10.4f} {c:10.3e}\n'
                            for w, c in zip(wn, cs)))
    return path


def synthetic_cia_borysow(path, temps=None, wn=None):
    """Write a CIA table in Borysow's format: a comment line, the
    temperatures as 'wn 200K 400K ...', a units line, then (wavenumber,
    cross section for each temperature) rows (cm-1 amagat-2)."""
    from . import constants as pc
    temps = np.arange(200.0, 3001.0, 200.0) if temps is None else temps
    wn = np.arange(20.0, 10001.0, 10.0) if wn is None else wn
    with open(path, 'w') as f:
        f.write('# synthetic collision-induced absorption\n')
        f.write('wn ' + ' '.join(f'{t:.0f}K' for t in temps) + '\n')
        f.write('# cm-1, cm-1 amagat-2\n')
        for w in wn:
            row = ' '.join(f'{_cia(w, t) * pc.amagat**2:12.5e}'
                           for t in temps)
            f.write(f'{w:10.2f} {row}\n')
    return path


def make_lbl_flagship(workdir, nlines=50_000, seed=0, nlayers=51,
                      wl_low=1.1, wl_high=1.7, wnstep=1.0):
    """Write the inputs of the flagship's opacity workflow into workdir.

    A synthetic HITRAN H2O line list (`nlines` lines from `seed`), a
    runmode = tli config that compiles it into a TLI file, and a
    runmode = opacity config that tabulates the flagship's H2O cross
    sections from that TLI file: wl_low to wl_high um at wnstep cm-1
    (3209 points at the defaults), `nlayers` layers from 1e-6 to 100
    bar, H2/He/H2O, 10 temperatures from 300 to 3000 K.

    Returns (par_file, tli_cfg, opacity_cfg); the TLI file and the table
    are workdir/flagship_h2o.tli and workdir/flagship_h2o_lbl.npz.
    """
    os.makedirs(workdir, exist_ok=True)
    par_file = _synthetic_hitran(
        os.path.join(workdir, 'flagship_h2o.par'), nlines, seed)
    tli_file = os.path.join(workdir, 'flagship_h2o.tli')
    tli_cfg = os.path.join(workdir, 'flagship_tli.cfg')
    with open(tli_cfg, 'w') as f:
        f.write(f"""[pyrat]
runmode = tli
verb = -1
logfile = {workdir}/flagship_tli.log
dblist = {par_file}
pflist = tips
dbtype = hitran
tlifile = {tli_file}
wl_low = 1.05 um
wl_high = 1.75 um
""")
    opacity_cfg = write_opacity_cfg(
        os.path.join(workdir, 'flagship_opacity.cfg'), tli_file,
        os.path.join(workdir, 'flagship_h2o_lbl.npz'), nlayers=nlayers,
        wl_low=wl_low, wl_high=wl_high, wnstep=wnstep)
    return par_file, tli_cfg, opacity_cfg


def write_opacity_cfg(cfg_file, tli_file, table_file, nlayers=51,
                      wl_low=1.1, wl_high=1.7, wnstep=1.0):
    """Write a runmode = opacity config that tabulates the flagship's H2O
    cross sections from `tli_file` into `table_file`: wl_low to wl_high
    um at wnstep cm-1, `nlayers` layers from 1e-6 to 100 bar, H2/He/H2O,
    10 temperatures from 300 to 3000 K; its log beside the config."""
    workdir = os.path.dirname(cfg_file)
    logfile = os.path.splitext(os.path.basename(cfg_file))[0] + '.log'
    with open(cfg_file, 'w') as f:
        f.write(f"""[pyrat]
runmode = opacity
verb = -1
logfile = {workdir}/{logfile}
tlifile = {tli_file}
sampled_cross_sec = {table_file}
wl_low = {wl_low} um
wl_high = {wl_high} um
wnstep = {wnstep}
nlayers = {nlayers}
ptop = 1e-6 bar
pbottom = 100 bar
chemistry = free
species = H2 He H2O
uniform_vmr = 0.85 0.149 4e-4
tmin = 300
tmax = 3000
tstep = 300
""")
    return cfg_file


LINE_LIST_FORMATS = ('hitran', 'exomol', 'repack', 'pands', 'tioschwenke',
                     'voplez', 'vald')


def make_line_lists(workdir, nlines=1_000_000, nlines_small=200_000,
                    nlines_vald=20_000, nstates=20_000, seed=0,
                    wl_low=1.05, wl_high=1.75):
    """Write a synthetic line list of every format the readers take
    (LINE_LIST_FORMATS) over the flagship's 5800-9200 cm-1, its
    partition functions and a runmode = tli config for it.

    HITRAN, ExoMol and repack hold the `nlines` lines of one draw
    (ExoMol over `nstates` states); P&S, Schwenke TiO and Plez VO
    `nlines_small` each; VALD `nlines_vald` Fe lines.  The pflist
    entries: tips (HITRAN, repack), the file `-pf tips H2O` writes
    (ExoMol), Kurucz tables reformatted by partitions.kurucz (P&S, TiO),
    poly (VO) and a PF file (Fe).  Returns {format: dict(dbfile, pflist,
    dbtype, tli_cfg, tlifile)}; the configs compile wl_low to wl_high um.
    """
    from .opacity import partitions
    os.makedirs(workdir, exist_ok=True)
    path = lambda name: os.path.join(workdir, name)
    pf_tips = path('PF_tips_H2O.dat')
    pf, isotopes, temp = partitions.tips('H2O')
    pio.write_pf(pf_tips, pf, isotopes, temp)
    pf_h2o = path('PF_kurucz_H2O.dat')
    partitions.kurucz(synthetic_kurucz_pf(path('kurucz_h2opartfn.dat')),
                      outfile=pf_h2o)
    pf_tio = path('PF_kurucz_TiO.dat')
    partitions.kurucz(
        synthetic_kurucz_pf(path('kurucz_tiopartfn.dat'), 'TiO'),
        outfile=pf_tio)
    inputs = {
        'hitran': (_synthetic_hitran(path('synth_h2o.par'), nlines, seed),
                   'tips'),
        'exomol': (synthetic_exomol(workdir, nlines, seed, nstates),
                   pf_tips),
        'repack': (synthetic_repack(path('H2O_synth_lbl.dat'), nlines,
                                    seed), 'tips'),
        'pands': (synthetic_pands(path('synth_h2ofastfix.bin'),
                                  nlines_small, seed), pf_h2o),
        'tioschwenke': (synthetic_tioschwenke(path('synth_tioschwenke.bin'),
                                              nlines_small, seed), pf_tio),
        'voplez': (synthetic_voplez(path('synth_vo_plez.dat'), nlines_small,
                                    seed), 'poly'),
        'vald': (synthetic_vald(path('VALD_Fe.dat'), nlines_vald, seed),
                 synthetic_pf(path('PF_Fe.dat'), ['Fe'])),
    }
    out = {}
    for dbtype, (dbfile, pflist) in inputs.items():
        tli_cfg = path(f'{dbtype}_tli.cfg')
        tlifile = path(f'{dbtype}.tli')
        with open(tli_cfg, 'w') as f:
            f.write(f"""[pyrat]
runmode = tli
verb = -1
logfile = {path(dbtype + '_tli.log')}
dblist = {dbfile}
pflist = {pflist}
dbtype = {dbtype}
tlifile = {tlifile}
wl_low = {wl_low} um
wl_high = {wl_high} um
""")
        out[dbtype] = dict(dbfile=dbfile, pflist=pflist, dbtype=dbtype,
                           tli_cfg=tli_cfg, tlifile=tlifile)
    return out


def synthetic_lines(wn, nlines, seed=0, nspec=1, pad=100.0):
    """A synthetic H2O-like line list over the grid `wn`, in the form
    opacity/lbl_direct.py::DirectLBL reads (as LineByLine gives it).

    The JAX bench's distributions (bench.py::_synthetic_lines): centers
    uniform over [wn[0] - pad, wn[-1] + pad], lognormal gf, Elow uniform
    up to 15,000 cm-1, four isotopes with a power-law partition
    function; the atmosphere's species are H2 He H Na K H2O CH4 CO CO2.
    nspec = 2 makes isotopes 2-3 a second species (CH4's slot).
    """
    if nspec not in (1, 2):
        raise ValueError('nspec must be 1 or 2')
    rng = np.random.default_rng(seed)
    wn = np.asarray(wn, float)

    class Lines:
        lwn = np.sort(rng.uniform(wn[0] - pad, wn[-1] + pad, nlines))
        gf = rng.lognormal(-8, 3, nlines)
        elow = rng.uniform(0, 15000, nlines)
        isoid = rng.integers(0, 4, nlines)
        iso_mass = np.array([18.011, 20.015, 19.015, 19.017])
        iso_ratio = np.array([0.997, 2e-3, 3.7e-4, 3.1e-4])
        iso_spec_index = np.array([0, 0, 1, 1]) if nspec == 2 \
            else np.zeros(4, int)
        iso_atm_index = np.array([5, 5, 6, 6]) if nspec == 2 \
            else np.full(4, 5)
        mol_radius = np.array(
            [1.445, 1.4, 1.1, 2.2, 2.8, 1.6, 2.0, 1.9, 1.97]) * 1e-8
        mol_mass = np.array(
            [2.016, 4.003, 1.008, 22.99, 39.098, 18.015, 16.04, 28.01,
             44.01])
        cutoff = 25.0
        tmin = 100.0
        tmax = 3000.0

        @staticmethod
        def iso_pf(t):
            t = np.atleast_1d(t)
            return np.tile(174.0 * (t / 296.0)**1.5, (4, 1))

    Lines.wn = wn
    Lines.nspec = nspec
    return Lines()
