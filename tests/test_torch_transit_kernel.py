"""The ensemble transit kernel's plain version against pyratbay_tpu's
Pallas kernels in interpret mode (K1 transit_spectrum_ensemble, K2
transit_spectrum_fused) and the per-chain rt.transit_depth +
transmission_spectrum, float64 on the CPU, rtol 1e-12 (the bound of
tests/test_ensemble_pallas.py).

The CUDA kernel itself runs only on a GPU: tests/test_torch_cuda.py
holds it against this plain version there.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

from pyratbay_tpu.atmosphere.geometry import transit_path_matrix  # noqa: E402
from pyratbay_tpu.spectrum import rt as jrt  # noqa: E402
from pyratbay_tpu.spectrum.ensemble_pallas import (  # noqa: E402
    transit_spectrum_ensemble as jensemble,
)
from pyratbay_tpu.spectrum.rt_pallas import (  # noqa: E402
    transit_spectrum_fused as jfused,
)
from pyratbay_tpu_torch.spectrum import rt  # noqa: E402
from pyratbay_tpu_torch.spectrum import transit_kernel as tk  # noqa: E402

RTOL = 1e-12
T = lambda a: torch.as_tensor(np.array(a))


def _operands(nb=4, nlayers=30, nwave=200, ncia=5, nr1=2, seed=0):
    rng = np.random.default_rng(seed)
    radius = np.sort(
        rng.uniform(1.0, 1.1, (nb, nlayers)), axis=1)[:, ::-1].copy()
    # Extinction growing with depth, so finite maxdepth stops bite:
    ec1 = rng.lognormal(-3.0, 2.0, (nb, nlayers, nwave)) \
        * np.exp(np.linspace(0.0, 7.0, nlayers))[:, None]
    ec2 = rng.lognormal(-4.0, 1.5, (nb, nlayers, nwave))
    cia_tab = rng.lognormal(-2.0, 1.0, (ncia, nwave))
    cia_w = rng.lognormal(-1.0, 0.5, (nb, nlayers, ncia))
    r1c = rng.lognormal(-2.0, 1.0, (nb, nr1, nlayers))
    r1r = rng.lognormal(-1.0, 1.0, (nb, nr1, nwave))
    return radius, ec1, ec2, cia_tab, cia_w, r1c, r1r


def _deck(radius, deck_itop, frac=0.4):
    b = np.arange(len(deck_itop))
    return radius[b, deck_itop] + frac * (
        radius[b, deck_itop - 1] - radius[b, deck_itop])


@pytest.mark.parametrize('with_deck', [True, False])
@pytest.mark.parametrize('maxdepth', [8.0, np.inf])
def test_plain_matches_pallas_ensemble(with_deck, maxdepth):
    nb, nlayers = 4, 30
    radius, ec1, ec2, cia_tab, cia_w, r1c, r1r = _operands(nb, nlayers)
    rstar = 12.0
    itop = np.array([0, 1, 0, 4])               # raised itop
    if with_deck:
        deck_itop = np.array([25, 20, 29, 12])
        rsurf = _deck(radius, deck_itop)
        ibottom = deck_itop + 1
    else:
        deck_itop = rsurf = None
        ibottom = np.full(nb, nlayers)
    path = np.stack([np.asarray(transit_path_matrix(radius[b], itop[b]))
                     for b in range(nb)])

    ref = np.asarray(jensemble(
        [jnp.asarray(ec1), jnp.asarray(ec2)], jnp.asarray(path),
        jnp.asarray(radius), rstar, jnp.asarray(itop), jnp.asarray(ibottom),
        deck_itop=None if deck_itop is None else jnp.asarray(deck_itop),
        deck_rsurf=None if rsurf is None else jnp.asarray(rsurf),
        cia_w=jnp.asarray(cia_w), cia_tab=cia_tab,
        r1_cols=jnp.asarray(r1c[..., None]),
        r1_rows=jnp.asarray(r1r[:, :, None, :]),
        maxdepth=maxdepth, interpret=True, chain_block=2,
    ))
    got = tk.transit_spectrum_ensemble(
        [T(ec1), T(ec2)], T(path), T(radius), rstar, T(itop), T(ibottom),
        deck_itop=None if deck_itop is None else T(deck_itop),
        deck_rsurf=None if rsurf is None else T(rsurf),
        cia_w=T(cia_w), cia_tab=T(cia_tab), r1_cols=T(r1c), r1_rows=T(r1r),
        maxdepth=maxdepth,
    ).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL)

    # The same spectra from the per-chain reference (summed ec):
    ec = ec1 + ec2 + cia_w @ cia_tab + np.einsum('brl,brw->blw', r1c, r1r)
    stopped = False
    for b in range(nb):
        depth, ideep = rt.transit_depth(
            T(ec[b]), T(path[b]), maxdepth, int(itop[b]), int(ibottom[b]))
        spec = rt.transmission_spectrum(
            depth, ideep, T(radius[b]), rstar, int(itop[b]),
            deck_rsurf=None if rsurf is None else float(rsurf[b]),
            deck_itop=None if deck_itop is None else int(deck_itop[b]),
        ).numpy()
        np.testing.assert_allclose(got[b], spec, rtol=RTOL)
        jdepth, jideep = jrt.transit_depth(
            jnp.asarray(ec[b]), jnp.asarray(path[b]), maxdepth, itop[b],
            ibottom[b])
        np.testing.assert_array_equal(ideep.numpy(), np.asarray(jideep))
        np.testing.assert_allclose(depth.numpy(), np.asarray(jdepth),
                                   rtol=RTOL)
        stopped |= bool(np.any(ideep.numpy() < ibottom[b] - 1))
    # A finite maxdepth stops some wavelengths inside the column:
    assert stopped == bool(np.isfinite(maxdepth))


def test_plain_matches_fused_at_one_chain():
    radius, ec1, ec2, _, _, _, _ = _operands(1, 30, seed=3)
    path = np.asarray(transit_path_matrix(radius[0], 2))
    deck_itop = 22
    rsurf = float(_deck(radius, np.array([deck_itop]))[0])
    ref = np.asarray(jfused(
        [jnp.asarray(ec1[0]), jnp.asarray(ec2[0])], jnp.asarray(path),
        jnp.asarray(radius[0]), 11.0, 2, deck_itop + 1,
        deck_itop=deck_itop, deck_rsurf=rsurf, maxdepth=8.0,
        interpret=True,
    ))
    got = tk.transit_spectrum_fused(
        [T(ec1[0]), T(ec2[0])], T(path), T(radius[0]), 11.0, 2,
        deck_itop + 1, deck_itop=deck_itop, deck_rsurf=rsurf, maxdepth=8.0,
    ).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_rejected_chain_operands_stay_finite_elsewhere():
    """A chain whose radius diverged (+inf top layers) yields NaN only
    in its own row; the others are unaffected."""
    radius, ec1, _, cia_tab, cia_w, _, _ = _operands(3, 20, 64, seed=5)
    radius[1, :3] = np.inf
    path = np.stack([np.asarray(transit_path_matrix(radius[b]))
                     for b in range(3)])
    got = tk.transit_spectrum_ensemble(
        [T(ec1)], T(path), T(radius), 10.0, T(np.zeros(3, int)),
        T(np.full(3, 20)), cia_w=T(cia_w), cia_tab=T(cia_tab),
        maxdepth=10.0,
    ).numpy()
    assert np.all(np.isfinite(got[[0, 2]]))
    assert not np.all(np.isfinite(got[1]))


def test_wrapper_routes_by_device(monkeypatch):
    """CPU tensors take the plain version and never reach the CUDA
    launcher."""
    calls = []
    monkeypatch.setattr(tk, 'transit_rt_cuda',
                        lambda *a, **k: calls.append(1))
    radius, ec1, _, _, _, _, _ = _operands(2, 12, 16)
    path = np.stack([np.asarray(transit_path_matrix(r)) for r in radius])
    out = tk.transit_spectrum_ensemble(
        [T(ec1)], T(path), T(radius), 10.0, T(np.zeros(2, int)),
        T(np.full(2, 12)))
    assert out.shape == (2, 16) and not calls


def test_cuda_launcher_rejects_cpu_tensors():
    """The CUDA launcher never computes on CPU tensors: it raises
    before building or launching anything, and counts no launch."""
    radius, ec1, _, _, _, _, _ = _operands(2, 12, 16)
    path = np.stack([np.asarray(transit_path_matrix(r)) for r in radius])
    operands = tk.prep_chains(T(path), T(radius), 10.0,
                              T(np.zeros(2, int)), T(np.full(2, 12)))
    launches = tk.transit_rt_cuda.launches
    with pytest.raises(TypeError, match='float32 CUDA tensor'):
        tk.transit_rt_cuda([T(ec1)], *operands)
    assert tk.transit_rt_cuda.launches == launches
