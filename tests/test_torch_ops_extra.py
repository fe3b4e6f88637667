"""The ops helpers, equilibrium_temp and the opacity objects' public
cross sections of pyratbay_tpu_torch against pyratbay_tpu's on the same
inputs (made from a seed), float64 on the CPU, rtol 1e-8 (the slice
bound of tests/test_torch_forward.py)."""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

from pyratbay_tpu import benchmark as jbench  # noqa: E402
from pyratbay_tpu.atmosphere import hydro as jhydro  # noqa: E402
from pyratbay_tpu.ops import integrate as jintegrate  # noqa: E402
from pyratbay_tpu.ops import interp as jinterp  # noqa: E402
from pyratbay_tpu.ops import special as jspecial  # noqa: E402
from pyratbay_tpu_torch import benchmark  # noqa: E402
from pyratbay_tpu_torch.atmosphere import hydro  # noqa: E402
from pyratbay_tpu_torch.ops import integrate, interp, special  # noqa: E402

RTOL = 1e-8
SIZE = dict(nlayers=21, wl_low=1.1, wl_high=1.3, wnstep=4.0)


def close(got, want, rtol=RTOL, atol=0.0):
    assert torch.is_tensor(got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize('axis', [0, 1])
def test_trapz_intervals(axis):
    rng = np.random.default_rng(1)
    data = rng.random((7, 9))
    intervals = rng.random(data.shape[axis] - 1)
    close(integrate.trapz_intervals(torch.as_tensor(data), intervals, axis),
          jintegrate.trapz_intervals(jnp.asarray(data),
                                     jnp.asarray(intervals), axis))


@pytest.mark.parametrize('n, spacing', [
    (9, 'x'), (10, 'x'), (9, 'dx'), (10, None), (3, 'x'),
    (10, 'zero_width'),
])
def test_simpson_nonuniform(n, spacing):
    """Even and odd interval counts, samples, a step, the unit step and
    a zero-width interval (the guards)."""
    rng = np.random.default_rng(n)
    y = rng.random((n, 4))
    x = np.cumsum(rng.random(n) + 0.1)
    if spacing == 'zero_width':
        x[3] = x[2]
    kw, jkw = {}, {}
    if spacing in ('x', 'zero_width'):
        kw, jkw = dict(x=x), dict(x=jnp.asarray(x))
    elif spacing == 'dx':
        kw = jkw = dict(dx=0.37)
    got = integrate.simpson_nonuniform(torch.as_tensor(y), **kw)
    want = jintegrate.simpson_nonuniform(jnp.asarray(y), **jkw)
    close(got, want)
    assert np.all(np.isfinite(got.numpy()))


def test_simpson_along_axis_1_and_scipy():
    from scipy.integrate import simpson
    rng = np.random.default_rng(4)
    y = rng.random((3, 12))
    x = np.cumsum(rng.random(12) + 0.1)
    got = integrate.simpson_nonuniform(torch.as_tensor(y), x=x, axis=1)
    close(got, jintegrate.simpson_nonuniform(jnp.asarray(y),
                                             x=jnp.asarray(x), axis=1))
    close(got, simpson(y, x=x, axis=1))


def test_second_deriv():
    rng = np.random.default_rng(2)
    x = np.cumsum(rng.random(30) + 0.05)
    y = np.sin(x) + 0.1 * rng.random(30)
    np.testing.assert_allclose(interp.second_deriv(y, x),
                               jinterp.second_deriv(y, x), rtol=RTOL)
    np.testing.assert_allclose(interp.second_deriv_ref(y, x),
                               jinterp.second_deriv_ref(y, x), rtol=RTOL)
    assert not np.allclose(interp.second_deriv(y, x),
                           interp.second_deriv_ref(y, x))


@pytest.mark.parametrize('lo, hi', [(0, None), (3, 40)])
def test_lin_interp_trow(lo, hi):
    """Inside the grid, on a grid point, beyond both ends."""
    rng = np.random.default_rng(3)
    xin = np.linspace(300.0, 3000.0, 10)
    table = rng.random((10, 50))
    dy_dx = np.diff(table, axis=0) / np.diff(xin)[:, None]
    xout = np.array([250.0, 300.0, 1234.5, 2100.0, 3000.0, 3300.0])
    got = interp.lin_interp_trow(table, xin, dy_dx, torch.as_tensor(xout),
                                 lo, hi)
    want = jinterp.lin_interp_trow(table, xin, dy_dx, xout, lo, hi)
    close(got, want)
    assert got.dtype == torch.float64


def test_widths():
    rng = np.random.default_rng(5)
    temp = rng.uniform(300.0, 3000.0, 8)
    close(special.doppler_hwhm(torch.as_tensor(temp), 18.0, 8000.0),
          jspecial.doppler_hwhm(jnp.asarray(temp), 18.0, 8000.0))
    masses = np.array([2.016, 4.003, 18.015])
    radii = np.array([1.445e-8, 1.09e-8, 1.6e-8])
    vmr = np.array([0.85, 0.149, 1e-3])
    for imol in (2, [0, 2]):
        close(special.lorentz_hwhm(1500.0, 0.1, masses, radii, vmr, imol),
              jspecial.lorentz_hwhm(1500.0, 0.1, masses, radii, vmr, imol))
    press = np.logspace(-4, 2, 8)
    close(special.lorentz_hwhm(torch.as_tensor(temp)[:, None],
                               torch.as_tensor(press)[:, None], masses,
                               radii, vmr, [0, 2]),
          jspecial.lorentz_hwhm(temp[:, None], press[:, None], masses,
                                radii, vmr, [0, 2]))


@pytest.mark.parametrize('profile, kw', [
    ('Lorentz', dict(x0=0.3, hwhm=0.7, scale=2.0)),
    ('Gauss', dict(x0=-0.2, hwhm=1.3, scale=0.5)),
    ('Voigt', dict(x0=0.1, hwhm_L=0.05, hwhm_G=1.0, scale=1.5)),
    ('Voigt', dict(x0=0.1, hwhm_L=2.0, hwhm_G=1.0)),
])
def test_profiles(profile, kw):
    """Each profile object called on numpy (a CPU tensor back) and on a
    tensor; the two Voigt cases take either branch of voigt_ref."""
    x = np.linspace(-20.0, 20.0, 401)
    want = getattr(jspecial, profile)(**kw)(x)
    prof = getattr(special, profile)(**kw)
    close(prof(x), want)
    close(prof(torch.as_tensor(x)), want)
    assert prof(x).device.type == 'cpu'


def test_equilibrium_temp():
    got = hydro.equilibrium_temp(5800.0, 1.27 * 6.957e10, 0.045 * 1.496e13,
                                 albedo=0.1, f=2.0 / 3, tstar_unc=50.0,
                                 rstar_unc=1e9, smaxis_unc=1e10)
    want = jhydro.equilibrium_temp(5800.0, 1.27 * 6.957e10,
                                   0.045 * 1.496e13, albedo=0.1, f=2.0 / 3,
                                   tstar_unc=50.0, rstar_unc=1e9,
                                   smaxis_unc=1e10)
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.fixture(scope='module')
def flagships(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('torch_ops_extra')
    jmodel = jbench.make_flagship(str(tmp / 'jax'), **SIZE)[0]
    model = benchmark.make_flagship(str(tmp / 'port'), device='cpu',
                                    **SIZE)[0]
    return jmodel, model


def _opacity(model, kind):
    return next(m for mtype, m, _ in model.opacity_models if mtype == kind)


def test_cia_cross_section(flagships):
    """A scalar, a profile, temperatures beyond the table (clamped);
    float64 on the temperature's device even from a float32 tensor."""
    jmodel, model = flagships
    jcia, cia = _opacity(jmodel, 'cia'), _opacity(model, 'cia')
    temp = np.linspace(40.0, 3500.0, 21)
    close(cia.cross_section(torch.as_tensor(temp)), jcia.cross_section(temp))
    close(cia.cross_section(1234.5), jcia.cross_section(1234.5))
    got = cia.cross_section(torch.as_tensor(temp, dtype=torch.float32))
    assert got.dtype == torch.float64 and got.shape == (21, cia.nwave)
    assert cia.cross_section(torch.as_tensor(temp)[None]).shape \
        == (1, 21, cia.nwave)


def test_h_ion_cross_sections(flagships):
    from pyratbay_tpu.opacity import HydrogenIon as JHydrogenIon
    from pyratbay_tpu_torch.opacity import HydrogenIon
    jmodel, _ = flagships
    wn = np.asarray(jmodel.wn)
    temp = np.linspace(800.0, 4000.0, 9)
    jh = JHydrogenIon(wn)
    h = HydrogenIon(wn).to('cpu', torch.float64)
    close(h.cross_section_bound_free(torch.as_tensor(temp)),
          jh.cross_section_bound_free(temp))
    close(h.cross_section_free_free(torch.as_tensor(temp)),
          jh.cross_section_free_free(temp))


@pytest.mark.parametrize('per_mol', [False, True])
def test_line_sample_cross_section(flagships, per_mol):
    """The port takes the profile with a leading chain axis."""
    jmodel, model = flagships
    jls, ls = _opacity(jmodel, 'line_sample'), _opacity(model, 'line_sample')
    temp = np.linspace(350.0, 2900.0, 21)
    got = ls.cross_section(torch.as_tensor(temp)[None], per_mol=per_mol)
    close(got[0], jls.cross_section(temp, per_mol=per_mol))
