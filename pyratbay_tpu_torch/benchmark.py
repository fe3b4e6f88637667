"""Self-contained flagship model: the synthetic opacity tables and the
config of pyratbay_tpu/benchmark.py::make_flagship, built with the
port.

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

__all__ = ['make_flagship']


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
                  wnstep=1.0, device=None, rt_path='transit'):
    """Write the flagship inputs into `workdir` and build the model on
    `device`, with the observing geometry `rt_path`.

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

    wn = np.arange(1.0 / (wl_high * 1e-4), 1.0 / (wl_low * 1e-4), wnstep)
    cs_file = os.path.join(workdir, 'flagship_h2o.npz')
    _synthetic_cs_table(cs_file, wn, press)
    cia_file = os.path.join(workdir, 'flagship_cia.dat')
    _synthetic_cia_table(cia_file)

    sampling_key = f'wnstep = {wnstep}'
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
