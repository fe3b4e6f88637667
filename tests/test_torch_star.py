"""Stellar spectra from files in the port against pyratbay_tpu, float64
on the CPU.

* io.read_spectra (a temperature-gridded SED and a plain two-column
  spectrum) and starspec.read_kurucz (a .pck grid of four models) on
  files the tests write.
* Model.starflux for starspec (gridded and plain) and kurucz at rtol
  1e-12.  The port sorts each SED by wavenumber before interpolating
  it: a file in descending wavelength (ascending wavenumber) gives the
  JAX package's star, and one in ascending wavelength gives the JAX
  package's star of the reversed file.
* Model.run's eclipse with each star against the JAX package's eager
  Model.run at rtol 1e-8.
* The batched forward and log-posterior with T_eff retrieved on a
  gridded SED, at, between, below and above the grid's temperatures, at
  rtol 1e-8; retrieving T_eff on a fixed stellar spectrum and a Kurucz
  star without log_gstar raise ValueError.

At test size: the eclipse flagship on 21 layers, 1.1-1.3 um at 4 cm-1.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pyratbay_tpu.io import io as jio  # noqa: E402
from pyratbay_tpu.model import Model as JModel  # noqa: E402
from pyratbay_tpu.observation import Observation as JObservation  # noqa: E402
from pyratbay_tpu.retrieval import RetrievalParams as JRetrievalParams  # noqa: E402
from pyratbay_tpu.retrieval.batched import (  # noqa: E402
    build_forward_batched as jbuild_forward_batched,
    build_log_posterior_batched as jbuild_log_posterior_batched,
)
from pyratbay_tpu.spectrum import starspec as jstarspec  # noqa: E402
from pyratbay_tpu_torch import benchmark  # noqa: E402
from pyratbay_tpu_torch.io import io as pio  # noqa: E402
from pyratbay_tpu_torch.model import Model, _interp_sed  # noqa: E402
from pyratbay_tpu_torch.observation import Observation  # noqa: E402
from pyratbay_tpu_torch.retrieval.batched import (  # noqa: E402
    build_forward_batched, build_log_posterior_batched,
)
from pyratbay_tpu_torch.retrieval.params import RetrievalParams  # noqa: E402
from pyratbay_tpu_torch.spectrum import starspec  # noqa: E402

RTOL_STAR = 1e-12
RTOL_SLICE = 1e-8
SED_TEMPS = np.array([5000.0, 5500.0, 6000.0, 6500.0])
KURUCZ_MODELS = ((5500.0, 4.0), (5500.0, 4.5), (6000.0, 4.0), (6000.0, 4.5))


def sed_fluxes(wl_um, temps, seed=3):
    """Blackbodies times a fixed absorption-line pattern from `seed`."""
    rng = np.random.default_rng(seed)
    wn = 1.0 / (wl_um * 1e-4)
    centers = rng.uniform(wn.min(), wn.max(), 40)
    depth = rng.uniform(0.05, 0.4, 40)
    pattern = 1.0 - np.sum(depth[:, None] * np.exp(
        -0.5 * ((wn[None, :] - centers[:, None]) / 3.0)**2), axis=0)
    return np.array([starspec.bbflux(wn, t) * pattern for t in temps])


def write_sed(path, wl_um, temps, fluxes):
    """A starspec file in the @TEMPERATURES / @SPECTRA format, rows in
    the order of wl_um."""
    with open(path, 'w') as f:
        f.write('# A temperature-gridded SED\n@TEMPERATURES\n')
        f.write(' '.join(f'{t:.1f}' for t in temps) + '\n@SPECTRA\n')
        for i, wl in enumerate(wl_um):
            f.write(f'{wl:.8f} ' + ' '.join(
                f'{flux:.10e}' for flux in fluxes[:, i]) + '\n')
    return path


def write_kurucz(path, wl_nm, models):
    """A Kurucz .pck grid: the fixed-column TEFF/GRAVITY headers and
    8 fields of 10 characters a line (intensities, then continua)."""
    lines = ['Kurucz-format test grid', 'END']
    for i in range(0, len(wl_nm), 8):
        lines.append(''.join(f'{w:10.3f}' for w in wl_nm[i:i + 8]))
    wn = 1.0 / (wl_nm * 1e-7)
    for teff, logg in models:
        lines.append(f'TEFF {teff:7.0f}  GRAVITY {logg:7.5f} LTE')
        intensity = starspec.bbflux(wn, teff) / (4.0 * np.pi * 2.99792458e10)
        for block in (intensity, 0.9 * intensity):
            for i in range(0, len(block), 8):
                lines.append(''.join(f'{v:10.4E}' for v in block[i:i + 8]))
    with open(path, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return path


@pytest.fixture(scope='module')
def stars(tmp_path_factory):
    """The eclipse flagship config and star files: a gridded SED in
    descending and in ascending wavelength, a plain SED, a Kurucz grid;
    and a config of each star."""
    workdir = str(tmp_path_factory.mktemp('stars'))
    benchmark.make_flagship(workdir, nlayers=21, wl_low=1.1, wl_high=1.3,
                            wnstep=4.0, device='cpu', rt_path='eclipse')
    with open(os.path.join(workdir, 'flagship.cfg')) as f:
        base = f.read()
    wl = np.linspace(1.6, 0.95, 900)           # descending wavelength
    fluxes = sed_fluxes(wl, SED_TEMPS)
    files = {
        'gridded': write_sed(os.path.join(workdir, 'sed.dat'), wl,
                             SED_TEMPS, fluxes),
        'gridded_ascending': write_sed(
            os.path.join(workdir, 'sed_ascending.dat'), wl[::-1],
            SED_TEMPS, fluxes[:, ::-1]),
        'kurucz': write_kurucz(os.path.join(workdir, 'grid.pck'),
                               np.linspace(900.0, 1500.0, 203),
                               KURUCZ_MODELS),
    }
    files['plain'] = os.path.join(workdir, 'plain.dat')
    np.savetxt(files['plain'], np.column_stack([wl, fluxes[2]]),
               fmt='%.10e')
    cfgs = {}
    for name, path in files.items():
        key = 'kurucz' if name == 'kurucz' else 'starspec'
        extra = f'{key} = {path}\n'
        if name == 'kurucz':
            extra += 'log_gstar = 4.4\n'
        cfgs[name] = os.path.join(workdir, f'{name}.cfg')
        with open(cfgs[name], 'w') as f:
            f.write(base + extra)
    return dict(workdir=workdir, base=base, files=files, cfgs=cfgs)


class _ObsCfg:
    data = uncert = obsfile = dunits = None
    offset_inst = uncert_scaling = None
    filters = [f'tophat {wl0:.4f} 0.01'
               for wl0 in np.linspace(1.13, 1.27, 8)]


# ----------------------------------------------------------------------
# Readers

def test_read_spectra_and_kurucz_match_jax(stars):
    for name in ('gridded', 'gridded_ascending', 'plain'):
        got = pio.read_spectra(stars['files'][name])
        want = jio.read_spectra(stars['files'][name])
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                np.testing.assert_array_equal(g, w)
    spectra, wn, temps = pio.read_spectra(stars['files']['gridded'])
    assert spectra.shape == (4, 900) and np.all(np.diff(wn) > 0)
    np.testing.assert_array_equal(temps, SED_TEMPS)
    path = stars['files']['kurucz']
    for args in ((), (5800.0, 4.4), (5400.0, 4.1)):
        got = starspec.read_kurucz(path, *args)
        want = jstarspec.read_kurucz(path, *args)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    flux, wn, ktemp, klogg = starspec.read_kurucz(path, 5800.0, 4.4)
    assert (ktemp, klogg) == (6000.0, 4.5) and flux.shape == (203,)


# ----------------------------------------------------------------------
# The star of a Model

@pytest.mark.parametrize('star', ['gridded', 'plain', 'kurucz'])
def test_starflux_matches_jax(stars, star):
    model = Model(stars['cfgs'][star], device='cpu')
    jmodel = JModel(stars['cfgs'][star])
    np.testing.assert_allclose(model.starflux, jmodel.starflux,
                               rtol=RTOL_STAR, atol=0)
    assert not model.star_is_blackbody
    if star == 'gridded':
        np.testing.assert_array_equal(model.sed_temps, jmodel.sed_temps)
        np.testing.assert_allclose(model.sed_fluxes, jmodel.sed_fluxes,
                                   rtol=RTOL_STAR, atol=0)
    else:
        assert model.sed_temps is None and jmodel.sed_temps is None


def test_sed_in_ascending_wavelength(stars):
    """A file in ascending wavelength gives the same star as the file
    reversed: the port sorts by wavenumber before interpolating."""
    ascending = Model(stars['cfgs']['gridded_ascending'], device='cpu')
    descending = JModel(stars['cfgs']['gridded'])
    np.testing.assert_allclose(ascending.starflux, descending.starflux,
                               rtol=RTOL_STAR, atol=0)
    np.testing.assert_allclose(ascending.sed_fluxes, descending.sed_fluxes,
                               rtol=RTOL_STAR, atol=0)
    # The SED varies across the grid (its line pattern is resolved):
    assert np.ptp(ascending.starflux / ascending.starflux.mean()) > 0.1


@pytest.mark.parametrize('star', ['gridded', 'plain', 'kurucz'])
def test_model_run_eclipse_matches_jax(stars, star):
    model = Model(stars['cfgs'][star], device='cpu')
    model.run()
    jmodel = JModel(stars['cfgs'][star])
    jmodel.run()
    np.testing.assert_allclose(model.spectrum, jmodel.spectrum,
                               rtol=RTOL_SLICE, atol=0)
    assert np.all(model.spectrum > 0)


# ----------------------------------------------------------------------
# T_eff retrieved on a gridded SED

def _teff_cfg(stars, name):
    text = open(stars['cfgs'][name]).read().replace(
        '    alpha_ray ', '    T_eff     5800.0  4000.0  7500.0  50.0\n'
        '    alpha_ray ')
    path = os.path.join(stars['workdir'], f'teff_{name}.cfg')
    with open(path, 'w') as f:
        f.write(text)
    return path


def test_log_posterior_teff_on_gridded_sed(stars):
    cfg = _teff_cfg(stars, 'gridded')
    model = Model(cfg, device='cpu')
    obs = Observation(_ObsCfg, model.wn)
    ret = RetrievalParams(model, obs)
    jmodel = JModel(cfg)
    jobs = JObservation(_ObsCfg, jmodel.wn)
    jret = JRetrievalParams(jmodel, jobs)
    assert ret.itstar == jret.itstar is not None
    teffs = [5800.0, 5000.0, 6500.0, 4200.0, 7400.0, 6123.4]
    pb = np.tile(np.asarray(ret.params), (len(teffs), 1))
    pb[:, ret.itstar] = teffs
    ref = jax.jit(jbuild_forward_batched(jmodel, jobs, jret))(
        jnp.asarray(pb))
    got = build_forward_batched(model, obs, ret)(pb)
    np.testing.assert_allclose(got['spectrum'].numpy(),
                               np.asarray(ref['spectrum']), rtol=RTOL_SLICE)
    # Off the grid the star is the SED at the nearer end:
    spec = got['spectrum'].numpy()
    np.testing.assert_allclose(spec[3], spec[1], rtol=1e-14)
    np.testing.assert_allclose(spec[4], spec[2], rtol=1e-14)
    data = np.asarray(ref['bandflux'])[0] * 1.001
    for o in (obs, jobs):
        o.data, o.uncert = data, np.full(len(data), 1e-5)
    lp = build_log_posterior_batched(model, obs, ret)(pb).numpy()
    jlp = np.asarray(jax.jit(jbuild_log_posterior_batched(
        jmodel, jobs, jret))(jnp.asarray(pb)))
    assert np.all(np.isfinite(jlp))
    np.testing.assert_allclose(lp, jlp, rtol=RTOL_SLICE)


def test_interp_sed_clips_at_the_grid_ends():
    fluxes = torch.as_tensor(np.arange(12.0).reshape(4, 3))
    temps = torch.as_tensor(SED_TEMPS)
    got = _interp_sed(fluxes, temps, torch.as_tensor(
        [4000.0, 5000.0, 5250.0, 6500.0, 9000.0])).numpy()
    np.testing.assert_array_equal(got[[0, 1]], fluxes[[0, 0]].numpy())
    np.testing.assert_allclose(got[2], [1.5, 2.5, 3.5])
    np.testing.assert_array_equal(got[[3, 4]], fluxes[[3, 3]].numpy())


def test_fixed_star_raises(stars):
    model = Model(_teff_cfg(stars, 'plain'), device='cpu')
    obs = Observation(_ObsCfg, model.wn)
    ret = RetrievalParams(model, obs)
    with pytest.raises(ValueError, match='fixed input stellar spectrum'):
        build_forward_batched(model, obs, ret)
    cfg = os.path.join(stars['workdir'], 'kurucz_no_logg.cfg')
    with open(cfg, 'w') as f:
        f.write(open(stars['cfgs']['kurucz']).read().replace(
            'log_gstar = 4.4\n', ''))
    with pytest.raises(ValueError, match='temperature or gravity'):
        Model(cfg, device='cpu')
