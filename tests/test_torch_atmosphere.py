"""Port parity, atmosphere: special functions, Guillot T(p), free VMR
with bulk balance, hydrostatic radii, gas state and transit chords of
pyratbay_tpu_torch against pyratbay_tpu, float64 on the CPU, rtol
1e-10 (both evaluate the same formulas in the same order; the margin
covers libm differences between XLA and torch)."""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

from pyratbay_tpu import constants as pc  # noqa: E402
from pyratbay_tpu.atmosphere import geometry as jgeo  # noqa: E402
from pyratbay_tpu.atmosphere import hydro as jhydro  # noqa: E402
from pyratbay_tpu.atmosphere import profiles as jprof  # noqa: E402
from pyratbay_tpu.atmosphere import vmr as jvmr  # noqa: E402
from pyratbay_tpu.ops import special as jspecial  # noqa: E402
from pyratbay_tpu_torch.atmosphere import geometry, hydro, profiles  # noqa: E402
from pyratbay_tpu_torch.atmosphere import vmr  # noqa: E402
from pyratbay_tpu_torch.ops import special  # noqa: E402

RTOL = 1e-10
T = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize('name', ['exp1', 'e2'])
def test_exponential_integrals(name):
    x = np.concatenate([
        [0.0, 1e-8, 0.5, 1.0, 1.0 + 1e-12],
        np.geomspace(1e-6, 60.0, 200),
    ])
    got = getattr(special, name)(T(x)).numpy()
    ref = np.asarray(getattr(jspecial, name)(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_wofz_real_regions():
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.uniform(-20, 20, 300), [0.0, 13.9, 14.1]])
    y = np.concatenate([rng.uniform(0, 0.05, 150),
                        rng.uniform(0.05, 20, 153)])
    got = special.wofz_real(T(x), T(y)).numpy()
    ref = np.asarray(jspecial.wofz_real(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-300)


def test_guillot_batched():
    press = np.logspace(-6, 2, 31)
    rng = np.random.default_rng(0)
    pars = np.tile([-4.67, -0.8, -0.8, 0.5, 1486.0, 100.0], (5, 1))
    pars += rng.normal(0, 0.1, pars.shape) * [1, 1, 1, 0.5, 500, 50]
    got = profiles.guillot_tp(press)(T(pars)).numpy()
    jfn = jprof.guillot_tp(press)
    ref = np.stack([np.asarray(jfn(jnp.asarray(p))) for p in pars])
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    iso = profiles.get_tmodel('isothermal', press)(T([[1200.0], [900.0]]))
    np.testing.assert_array_equal(iso.numpy()[:, 0], [1200.0, 900.0])


def test_guillot_on_the_cpu_is_the_plain_profile():
    """On a CPU tensor the profile is the plain torch version (the kernel,
    profiles.guillot_cuda, is the card's and refuses a CPU tensor)."""
    press = np.logspace(-6, 2, 11)
    fn = profiles.guillot_tp(press)
    launches = profiles.guillot_cuda.launches
    pars = T([[-4.67, -0.8, -0.8, 0.5, 1486.0, 100.0]])
    assert fn(pars).shape == (1, 11)
    assert profiles.guillot_cuda.launches == launches
    with pytest.raises(TypeError, match='CUDA'):
        profiles.guillot_cuda(pars, T(press))


def test_free_vmr_with_bulk_balance():
    nlayers = 11
    base = jvmr.uniform_vmr(
        [0.85, 0.149, 1e-6, 3e-6, 4e-4], nlayers)
    ibulk = [0, 1]
    bratio, invsrat = jvmr.bulk_ratio(jnp.asarray(base), ibulk)
    log_vals = np.array([-3.4, -1.0, -6.0])
    got = vmr.vmr_scale(
        T(base), [vmr.iso_vmr(T(log_vals), nlayers)], [4], ibulk,
        *vmr.bulk_ratio(T(base), ibulk)).numpy()
    for b, val in enumerate(log_vals):
        ref = jvmr.vmr_scale(
            base, [jvmr.iso_vmr(val, nlayers)], (4,), np.asarray(ibulk),
            bratio, invsrat)
        np.testing.assert_allclose(got[b], np.asarray(ref), rtol=RTOL)
        np.testing.assert_allclose(got[b].sum(axis=1), 1.0, rtol=1e-14)
    # qcap: a 10% trace abundance trips a 5% cap, the others do not:
    caps = vmr.qcapcheck(T(got), 0.05, ibulk).numpy()
    np.testing.assert_array_equal(caps, [False, True, False])
    assert bool(jvmr.qcapcheck(jnp.asarray(got[1]), 0.05, np.asarray(ibulk)))


@pytest.fixture(scope='module')
def column():
    press = np.logspace(-6, 2, 41)
    rng = np.random.default_rng(1)
    temp = 1300.0 + 200.0 * rng.random((4, 41))
    vmr_b = np.tile([0.85, 0.149, 4e-4], (4, 41, 1))
    vmr_b[..., 2] *= 1 + rng.random((4, 41))
    mass = np.array([2.016, 4.0026, 18.015])
    return press, temp, vmr_b, mass


def test_gas_state(column):
    press, temp, vmr_b, mass = column
    dens = hydro.ideal_gas_density(T(vmr_b), T(press), T(temp)).numpy()
    mm = hydro.mean_weight(T(vmr_b), T(mass)).numpy()
    for b in range(temp.shape[0]):
        np.testing.assert_allclose(dens[b], np.asarray(
            jhydro.ideal_gas_density(vmr_b[b], press, temp[b])), rtol=RTOL)
        np.testing.assert_allclose(mm[b], np.asarray(
            jhydro.mean_weight(vmr_b[b], mass)), rtol=RTOL)


@pytest.mark.parametrize('kind', ['hydro_m', 'hydro_g'])
def test_hydrostatic_radius(column, kind):
    press, temp, vmr_b, mass = column
    mu = np.sum(vmr_b * mass, axis=-1)
    mplanet = np.array([0.6, 0.7, 0.5, 0.05]) * pc.mjup
    rplanet = np.array([1.0, 1.1, 0.9, 2.5]) * pc.rjup
    p0 = 0.1
    if kind == 'hydro_m':
        got = hydro.hydro_m(T(press), T(temp), T(mu), T(mplanet), p0,
                            T(rplanet)).numpy()
        ref = [jhydro.hydro_m(press, temp[b], mu[b], mplanet[b], p0,
                              rplanet[b]) for b in range(4)]
    else:
        grav = pc.G * mplanet / rplanet**2
        got = hydro.hydro_g(T(press), T(temp), T(mu), T(grav), p0,
                            T(rplanet)).numpy()
        ref = [jhydro.hydro_g(press, temp[b], mu[b], grav[b], p0,
                              rplanet[b]) for b in range(4)]
    ref = np.stack([np.asarray(r) for r in ref])
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=RTOL)
    if kind == 'hydro_m':
        # The puffy low-mass chain diverges at the top: +inf layers.
        assert np.isinf(ref[3]).any() and np.isfinite(ref[0]).all()


def test_transit_path_matrix_with_itop():
    rng = np.random.default_rng(2)
    radius = np.sort(rng.uniform(1.0, 1.1, (3, 25)), axis=1)[:, ::-1]
    itop = np.array([0, 3, 7])
    got = geometry.transit_path_matrix(
        T(radius.copy()), torch.as_tensor(itop)).numpy()
    for b in range(3):
        ref = np.asarray(jgeo.transit_path_matrix(radius[b], itop[b]))
        np.testing.assert_allclose(got[b], ref, rtol=RTOL, atol=0)
    assert np.all(got[1, :4] == 0.0) and np.all(got[2][:, :7] == 0.0)
