"""Instrument passbands: the port's PassBand (filter files and the bundled
filter library), Tophat, band matrices, bin_spectrum and an Observation
with a mixed `filters` list, against pyratbay_tpu on the same inputs,
rtol 1e-12 (host numpy in both: the same arithmetic).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from pyratbay_tpu import data as jdata  # noqa: E402
from pyratbay_tpu import observation as jobservation  # noqa: E402
from pyratbay_tpu.spectrum import passbands as jpassbands  # noqa: E402
from pyratbay_tpu_torch import data  # noqa: E402
from pyratbay_tpu_torch import observation  # noqa: E402
from pyratbay_tpu_torch.spectrum import passbands  # noqa: E402

RTOL = 1e-12
# A grid over every bundled filter (0.35-32.2 um), uneven from a seed:
_RNG = np.random.default_rng(7)
WIDE_WN = np.sort(np.unique(np.concatenate([
    np.linspace(300.0, 29000.0, 6000), _RNG.uniform(300.0, 29000.0, 2000)])))
NIR_WN = np.arange(1.0 / 1.7e-4, 1.0 / 1.1e-4, 2.0)


def _assert_bands_match(got, ref, nwave):
    np.testing.assert_array_equal(got.idx, ref.idx)
    for key in ('wl0', 'wn0', 'wn', 'wl', 'response', 'height'):
        np.testing.assert_allclose(getattr(got, key), getattr(ref, key),
                                   rtol=RTOL, err_msg=key)
    np.testing.assert_allclose(got.weights(nwave), ref.weights(nwave),
                               rtol=RTOL)


@pytest.fixture(scope='module')
def filter_file(tmp_path_factory):
    """A two-column filter file (wavelength um, response) with a
    trapezoid response and seeded ripples, in the reference's format."""
    path = str(tmp_path_factory.mktemp('passbands') / 'wfc3_like_1.40.dat')
    rng = np.random.default_rng(3)
    wl = np.linspace(1.36, 1.44, 81)
    resp = np.clip(np.minimum(wl - 1.36, 1.44 - wl) / 0.02, 0.0, 1.0)
    resp *= 1.0 + 0.05 * rng.standard_normal(len(wl))
    np.savetxt(path, np.column_stack([wl, np.clip(resp, 0.0, None)]),
               header='Wavelength (um)  response')
    return path


@pytest.mark.parametrize('counting_type', ['photon', 'energy'])
def test_passband_from_file_matches_jax(filter_file, counting_type):
    got = passbands.PassBand(filter_file, wn=NIR_WN,
                             counting_type=counting_type)
    ref = jpassbands.PassBand(filter_file, wn=NIR_WN,
                              counting_type=counting_type)
    assert got.name == ref.name == 'wfc3_like_1.40'
    _assert_bands_match(got, ref, len(NIR_WN))
    spectrum = np.random.default_rng(4).uniform(0.01, 0.02, len(NIR_WN))
    np.testing.assert_allclose(got(spectrum), ref(spectrum), rtol=RTOL)
    # Resampled on a wavelength grid, decreasing:
    wl = np.linspace(1.5, 1.3, 400)
    got.set_sampling(wl=wl)
    ref.set_sampling(wl=wl)
    _assert_bands_match(got, ref, len(wl))


def test_bundled_library_matches_jax():
    assert data.list_filters() == jdata.list_filters()
    assert len(data.list_filters()) == 8
    for name in data.list_filters():
        wl, resp = data.filter_response(name.upper())
        jwl, jresp = jdata.filter_response(name)
        np.testing.assert_array_equal(wl, jwl)
        np.testing.assert_array_equal(resp, jresp)
    with pytest.raises(FileNotFoundError, match='No bundled filter'):
        data.filter_response('hst_wfc3_g141')


@pytest.mark.parametrize('name', [
    'cheops', 'kepler', 'spitzer_irac1', 'spitzer_irac2', 'spitzer_irac3',
    'spitzer_irac4', 'spitzer_mips', 'tess'])
def test_from_arrays_matches_jax(name):
    wl, resp = data.filter_response(name)
    got = passbands.PassBand.from_arrays(wl, resp, name, wn=WIDE_WN)
    ref = jpassbands.PassBand.from_arrays(wl, resp, name, wn=WIDE_WN)
    assert got.filter_file is None and got.name == name
    _assert_bands_match(got, ref, len(WIDE_WN))


def test_tophat_matrices_and_binning_match_jax(filter_file):
    bands, jbands = [], []
    for wl0, hw in [(1.15, 0.01), (1.3, 0.02), (1.6, 0.005)]:
        bands.append(passbands.Tophat(wl0, hw, wn=NIR_WN))
        jbands.append(jpassbands.Tophat(wl0, hw, wn=NIR_WN))
        _assert_bands_match(bands[-1], jbands[-1], len(NIR_WN))
    assert isinstance(bands[0], passbands.PassBand)
    bands.append(passbands.PassBand(filter_file, wn=NIR_WN))
    jbands.append(jpassbands.PassBand(filter_file, wn=NIR_WN))
    for fn in ('band_matrix', 'band_cf_matrix'):
        np.testing.assert_allclose(
            getattr(passbands, fn)(bands, len(NIR_WN)),
            getattr(jpassbands, fn)(jbands, len(NIR_WN)), rtol=RTOL,
            err_msg=fn)

    wl = 1.0 / (NIR_WN * 1e-4)
    spectrum = np.random.default_rng(5).uniform(0.01, 0.02, len(wl))
    bin_wl = np.linspace(1.12, 1.68, 15)
    np.testing.assert_allclose(
        passbands.bin_spectrum(bin_wl, wl, spectrum),
        jpassbands.bin_spectrum(bin_wl, wl, spectrum), rtol=RTOL)
    # A bin off the grid, interpolated over in both:
    gap_wl = np.append(bin_wl, 1.9)
    np.testing.assert_allclose(
        passbands.bin_spectrum(gap_wl, wl, spectrum, gaps='interpolate'),
        jpassbands.bin_spectrum(gap_wl, wl, spectrum, gaps='interpolate'),
        rtol=RTOL)


class _Cfg:
    data = uncert = obsfile = dunits = None
    offset_inst = uncert_scaling = None
    obsfile_hires = inst_resolution = None


def test_observation_with_mixed_filters_matches_jax(filter_file):
    """A filter file, two bundled names (any case) and a tophat."""
    cfg = _Cfg()
    cfg.filters = [filter_file, 'spitzer_irac1', 'Kepler',
                   'tophat 1.5 0.01']
    cfg.data = [1.0, 2.0, 3.0, 4.0]
    cfg.uncert = [0.1, 0.1, 0.1, 0.1]
    got = observation.Observation(cfg, WIDE_WN)
    ref = jobservation.Observation(cfg, WIDE_WN)
    assert got.nbands == ref.nbands == 4
    assert [b.name for b in got.filters] == [b.name for b in ref.filters]
    assert [type(b).__name__ for b in got.filters] == [
        'PassBand', 'PassBand', 'PassBand', 'Tophat']
    np.testing.assert_allclose(got.band_wl, ref.band_wl, rtol=RTOL)
    np.testing.assert_allclose(got._band_matrix, ref._band_matrix,
                               rtol=RTOL)
    # Band integration on tensors gives the matrix product:
    got.to('cpu', torch.float64)
    spectrum = np.random.default_rng(6).uniform(0.0, 1.0, (3, len(WIDE_WN)))
    np.testing.assert_allclose(
        got.band_integrate(torch.as_tensor(spectrum)).numpy(),
        spectrum @ ref._band_matrix.T, rtol=RTOL)


def test_observation_missing_filter_and_hires_raise(tmp_path):
    cfg = _Cfg()
    cfg.filters = [str(tmp_path / 'no_such_filter.dat')]
    with pytest.raises(FileNotFoundError, match='does not exist'):
        observation.Observation(cfg, NIR_WN)
    cfg = _Cfg()
    cfg.filters = ['tophat 1.5 0.01']
    cfg.obsfile_hires = os.path.join(str(tmp_path), 'hires.dat')
    cfg.inst_resolution = 1e5
    with pytest.raises(FileNotFoundError):
        observation.Observation(cfg, NIR_WN)
    cfg.inst_resolution = None
    with pytest.raises(ValueError, match='inst_resolution'):
        observation.Observation(cfg, NIR_WN)
