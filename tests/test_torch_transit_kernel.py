"""The transit kernels' plain versions against pyratbay_tpu's Pallas
kernels in interpret mode (K1 transit_spectrum_ensemble, K2
transit_spectrum_fused) and the per-chain rt.transit_depth +
transmission_spectrum, float64 on the CPU, rtol 1e-12 (the bound of
tests/test_ensemble_pallas.py).  With the line-sample operands (ls_w,
ls_tab) the plain version is held against the float64 einsum at 1e-12
and against the Pallas kernel at 1e-5 where that runs in float32 (it
does when no dense part gives it a type).  K2's blocked algorithm
(csrc/transit_one.cu: chunks of four rows split over the warps by the
triangle rule, the block minimum for ideep, partial sums in warp order)
is emulated in plain torch and held against the plain version at 1e-12.

The CUDA kernels themselves run only on a GPU: tests/test_torch_cuda.py
holds them against these plain versions there.
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


def _line_sample(nb, nlayers, nwave, nk=8, seed=23):
    """Two-hot weights [B, K2, l] (a temperature lerp times a density)
    and a table [K2, l, W] that grows with depth."""
    rng = np.random.default_rng(seed)
    tlo = rng.integers(0, nk - 1, (nb, nlayers))
    frac = rng.random((nb, nlayers))
    dens = rng.lognormal(0.0, 1.0, (nb, nlayers))
    b, j = np.meshgrid(np.arange(nb), np.arange(nlayers), indexing='ij')
    ls_w = np.zeros((nb, nk, nlayers))
    ls_w[b, tlo, j] = (1 - frac) * dens
    ls_w[b, tlo + 1, j] = frac * dens
    ls_tab = rng.lognormal(-2.0, 1.5, (nk, nlayers, nwave)) \
        * np.exp(np.linspace(0, 6, nlayers))[None, :, None] * 1e-2
    return ls_w, ls_tab


@pytest.mark.parametrize('case', ['alone', 'with_everything'])
def test_plain_line_sample_operands(case):
    """ls_w / ls_tab in the plain version: equal to the einsum's dense
    part (1e-12) and to the Pallas kernel's in-kernel contraction, run
    as tests/test_ensemble_pallas.py runs it (interpret mode)."""
    nb, nlayers, nwave = 5, 30, 200
    radius, ec1, ec2, cia_tab, cia_w, r1c, r1r = _operands(
        nb, nlayers, nwave, seed=7)
    ls_w, ls_tab = _line_sample(nb, nlayers, nwave)
    itop = np.array([0, 2, 0, 1, 0])
    path = np.stack([np.asarray(transit_path_matrix(radius[b], itop[b]))
                     for b in range(nb)])
    if case == 'alone':
        parts, extra, jextra = [], {}, {}
        deck_itop = rsurf = None
        ibottom = np.full(nb, nlayers)
        rtol = 1e-5          # no dense part: the Pallas side is float32
    else:
        parts = [ec1, ec2]
        deck_itop = np.array([25, 20, 29, 12, 27])
        rsurf = _deck(radius, deck_itop)
        ibottom = deck_itop + 1
        extra = dict(cia_w=T(cia_w), cia_tab=T(cia_tab), r1_cols=T(r1c),
                     r1_rows=T(r1r), deck_itop=T(deck_itop),
                     deck_rsurf=T(rsurf))
        jextra = dict(cia_w=jnp.asarray(cia_w), cia_tab=cia_tab,
                      r1_cols=jnp.asarray(r1c[..., None]),
                      r1_rows=jnp.asarray(r1r[:, :, None, :]),
                      deck_itop=jnp.asarray(deck_itop),
                      deck_rsurf=jnp.asarray(rsurf))
        rtol = RTOL          # float64 parts: the Pallas side is float64
    common = (T(path), T(radius), 12.0, T(itop), T(ibottom))
    got = tk.transit_spectrum_ensemble(
        [T(p) for p in parts], *common, ls_w=T(ls_w), ls_tab=T(ls_tab),
        maxdepth=8.0, **extra).numpy()

    dense = np.einsum('bkl,klw->blw', ls_w, ls_tab)
    ref = tk.transit_spectrum_ensemble(
        [T(p) for p in parts] + [T(dense)], *common, maxdepth=8.0,
        **extra).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL)

    pallas = np.asarray(jensemble(
        [jnp.asarray(p) for p in parts], jnp.asarray(path),
        jnp.asarray(radius), 12.0, jnp.asarray(itop), jnp.asarray(ibottom),
        ls_w=jnp.asarray(ls_w[..., None]), ls_tab=ls_tab,
        maxdepth=8.0, interpret=True, chain_block=2, **jextra))
    np.testing.assert_allclose(got, pallas, rtol=rtol)


def test_line_sample_size_rule():
    """The static rule of the batched forward: the flagship's table
    (10 temperatures x 51 layers) goes into the kernel, one whose
    64-column slab would crowd out the warps' operands does not; above
    64 layers the transit kernel streams the table (it takes it), the
    emission kernel does not."""
    assert tk.ls_in_kernel(10, 51, 'transit')
    assert tk.ls_in_kernel(2 * 4, 64, 'transit')
    assert not tk.ls_in_kernel(20, 51, 'transit')
    assert tk.ls_in_kernel(10, 128, 'transit')
    assert not tk.ls_in_kernel(10, 128, 'eclipse')


@pytest.mark.parametrize('nlayers', range(2, 65))
def test_chord_layout_reproduces_the_chord_product(nlayers):
    """The packed chord matrix, read the way the kernel reads it (for
    each step s of 8 layers and each n-tile n >= s of 8 rows, 64 floats:
    lane 4 g + t's B fragment path2[8 n + g, 8 s + t], path2[8 n + g,
    8 s + t + 4]), gives path2 @ ec for a matrix that is zero above its
    diagonal; the padded rows and layers hold zeros."""
    rng = np.random.default_rng(nlayers)
    radius = np.sort(rng.uniform(1.0, 1.1, (1, nlayers)), axis=1)[:, ::-1]
    path = T(np.asarray(transit_path_matrix(radius[0].copy(), 1)))[None]
    path2 = tk.prep_chains(path, T(radius.copy()), 10.0, T(np.array([1])),
                           T(np.array([nlayers])))[0][0].numpy()
    assert np.all(np.triu(path2, 1) == 0)
    nt, index = tk.chord_layout(nlayers)
    assert nt == -(-nlayers // 8)
    packed = np.append(path2.ravel(), 0.0)[index]
    assert len(packed) == 32 * nt * (nt + 1)
    # Ones in the padded layers: their chord entries must be zero.
    ec = np.append(rng.lognormal(0.0, 1.0, nlayers),
                   np.ones(8 * nt - nlayers))
    depth = np.zeros(8 * nt)
    frags = packed.reshape(-1, 8, 4, 2)     # [pair, g, t, (t, t + 4)]
    pair = 0
    for s in range(nt):
        for n in range(s, nt):
            chord = np.concatenate(
                [frags[pair, :, :, 0], frags[pair, :, :, 1]], axis=1)
            depth[8 * n:8 * n + 8] += chord @ ec[8 * s:8 * s + 8]
            pair += 1
    assert pair == len(frags) == nt * (nt + 1) // 2
    np.testing.assert_allclose(depth[:nlayers], path2 @ ec[:nlayers],
                               rtol=1e-13)
    assert np.all(depth[nlayers:] == 0)
    with pytest.raises(ValueError, match='2 to 64 layers'):
        tk.chord_layout(65)


def test_kernel_operand_layout():
    """_pad_to lays a chain's weights out as the kernels copy them:
    zero-padded, contiguous and 16-byte aligned, also from a view."""
    base = torch.arange(2.0 * 5 * 3).reshape(2, 5, 3)
    out = tk._pad_to(base, 8, 4)
    assert out.shape == (2, 8, 4) and out.is_contiguous()
    assert torch.equal(out[:, :5, :3], base)
    assert float(out[:, 5:].abs().sum() + out[:, :, 3:].abs().sum()) == 0
    # The line-sample weights arrive [B, K2, l] and go in as [B, l, K2P]:
    out = tk._pad_to(base.transpose(1, 2), 4, 8)
    assert out.shape == (2, 4, 8) and out.is_contiguous()
    assert torch.equal(out[:, :3, :5], base.transpose(1, 2))
    view = torch.arange(9.0)[1:]          # not 16-byte aligned
    assert view.data_ptr() % 16 != 0
    same = tk._pad_to(view, 8)
    assert same.data_ptr() % 16 == 0 and torch.equal(same, view)


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


def test_one_chain_route_matches_fused_and_ensemble():
    """transit_spectrum_ensemble at one chain (K2's route; on the CPU
    its plain version) against pyratbay_tpu's transit_spectrum_fused
    with dense parts and a deck, and against its ensemble kernel at one
    chain with CIA, rank-1 and line-sample operands (interpret mode)."""
    radius, ec1, ec2, cia_tab, cia_w, r1c, r1r = _operands(1, 30, seed=13)
    itop, deck_itop = 2, 23
    path = np.asarray(transit_path_matrix(radius[0], itop))
    rsurf = _deck(radius, np.array([deck_itop]))
    ref = np.asarray(jfused(
        [jnp.asarray(ec1[0]), jnp.asarray(ec2[0])], jnp.asarray(path),
        jnp.asarray(radius[0]), 11.0, itop, deck_itop + 1,
        deck_itop=deck_itop, deck_rsurf=float(rsurf[0]), maxdepth=8.0,
        interpret=True))
    one = lambda v: T(np.array([v]))
    common = (T(path[None]), T(radius), 11.0, one(itop))
    got = tk.transit_spectrum_ensemble(
        [T(ec1), T(ec2)], *common, one(deck_itop + 1),
        deck_itop=one(deck_itop), deck_rsurf=T(rsurf), maxdepth=8.0)
    assert got.shape == (1, 200)
    np.testing.assert_allclose(got[0].numpy(), ref, rtol=RTOL)

    ls_w, ls_tab = _line_sample(1, 30, 200)
    ref = np.asarray(jensemble(
        [jnp.asarray(ec1)], jnp.asarray(path[None]), jnp.asarray(radius),
        11.0, jnp.asarray([itop]), jnp.asarray([30]),
        cia_w=jnp.asarray(cia_w), cia_tab=cia_tab,
        r1_cols=jnp.asarray(r1c[..., None]),
        r1_rows=jnp.asarray(r1r[:, :, None, :]),
        ls_w=jnp.asarray(ls_w[..., None]), ls_tab=ls_tab, maxdepth=8.0,
        interpret=True, chain_block=1))
    got = tk.transit_spectrum_ensemble(
        [T(ec1)], *common, one(30), cia_w=T(cia_w), cia_tab=T(cia_tab),
        r1_cols=T(r1c), r1_rows=T(r1r), ls_w=T(ls_w), ls_tab=T(ls_tab),
        maxdepth=8.0).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def _warp_chunks(nlayers, nwarps):
    """The first chunk of four rows of each warp and the end: the
    triangle's chunks split by equal shares of their terms (chunk g has
    4 g + 4 a row), as csrc/transit_one.cu first_chunk splits them."""
    nchunks = (nlayers + 3) // 4
    total = nchunks * (nchunks + 1)
    bounds = []
    for k in range(nwarps + 1):
        g = 0
        while g < nchunks and g * (g + 1) * nwarps < k * total:
            g += 1
        bounds.append(g)
    return bounds


def _one_chain_blocked(ec, path, radius, rstar, itop, ibottom, deck_itop,
                       deck_rsurf, maxdepth, nwarps, streamed=False):
    """K2's algorithm on one chain in plain torch: ec [l, W], path
    [l, l-1], radius [l]; returns [W].  `streamed`: the chord rows of a
    chunk folded as j walks (path[i][j - 1] kept from the step before),
    as the streamed layout reads them, in place of the staged fold."""
    nlayers, nwave = ec.shape
    clamp = lambda v: min(max(int(v), -1), nlayers + 1)
    itop, ibottom = clamp(itop), clamp(ibottom)
    nchunks = (nlayers + 3) // 4
    path2 = torch.zeros((4 * nchunks, nlayers), dtype=ec.dtype)
    path2[:nlayers] = (torch.nn.functional.pad(path, (1, 0))
                       + torch.nn.functional.pad(path, (0, 1)))
    deck_row, apply_deck, w_surf = -1, False, 0.0
    if deck_itop is not None:
        deck_row = clamp(deck_itop)
        apply_deck = deck_row > itop
        jd = deck_row - 1
        r_j = radius[min(max(jd, 0), nlayers - 1)]
        r_j1 = radius[min(max(jd + 1, 0), nlayers - 1)]
        w_surf = (r_j - deck_rsurf) / (r_j - r_j1)

    def height(i):
        return deck_rsurf - radius[i] if apply_deck and i == deck_row - 1 \
            else radius[i + 1] - radius[i]

    h = [height(i) if i < nlayers - 1 else 0.0 for i in range(nlayers)]
    hprev = [height(i - 1) if i > 0 else 0.0 for i in range(nlayers)]
    bounds = _warp_chunks(nlayers, nwarps)
    depth = torch.zeros((nlayers, nwave), dtype=ec.dtype)
    first = torch.full((nwarps, nwave), nlayers)
    for k in range(nwarps):
        for g in range(bounds[k], bounds[k + 1]):
            acc = torch.zeros((4, nwave), dtype=ec.dtype)
            jlo, jend = max(itop, 0), min(4 * g + 4, nlayers)
            rows = [i if i < nlayers else None
                    for i in range(4 * g, 4 * g + 4)]
            prev = [path[i, jlo - 1] if i is not None and 1 <= jlo < jend
                    else 0.0 for i in rows]
            for j in range(jlo, jend):
                if streamed:
                    cur = [path[i, j] if i is not None and j < nlayers - 1
                           else 0.0 for i in rows]
                    fold = torch.tensor([p + c for p, c in zip(prev, cur)],
                                        dtype=ec.dtype)
                    prev = cur
                else:
                    fold = path2[4 * g:4 * g + 4, j]
                acc += fold[:, None] * ec[j]
            for r in range(4):
                i = 4 * g + r
                if i >= nlayers:
                    break
                depth[i] = acc[r]
                hit = (first[k] == nlayers) & (acc[r] > maxdepth)
                if itop <= i < ibottom:
                    first[k] = torch.where(hit, i, first[k])
    low = first.min(dim=0).values
    ideep = torch.where(low < nlayers, low, ibottom - 1)
    partial = []
    for k in range(nwarps):
        i0, i1 = k * nlayers // nwarps, (k + 1) * nlayers // nwarps
        prev = torch.exp(-depth[i0 - 1]) * radius[i0 - 1] \
            if 0 < i0 < i1 else torch.zeros(nwave, dtype=ec.dtype)
        integral = torch.zeros(nwave, dtype=ec.dtype)
        for i in range(i0, i1):
            raw = torch.exp(-depth[i]) * radius[i]
            integ = prev * (1 - w_surf) + raw * w_surf \
                if apply_deck and i == deck_row else raw
            mi = ((i >= itop) & (i < ibottom) & (i < ideep)).to(ec.dtype)
            mp = ((i >= itop + 1) & (i <= ideep)).to(ec.dtype)
            integral = integral + integ * (0.5 * (h[i] * mi + hprev[i] * mp))
            prev = raw
        partial.append(integral)
    total = torch.zeros(nwave, dtype=ec.dtype)
    for integral in partial:
        total = total + integral
    poison = (ec * 0.0).sum(dim=0)
    r_top = radius[min(max(itop, 0), nlayers - 1)]
    return (r_top**2 + 2.0 * total) / rstar**2 + poison


@pytest.mark.parametrize('case', ['deck', 'no_deck', 'maxdepth',
                                  'inf_top_radii'])
@pytest.mark.parametrize('nlayers', [20, 51, 81])
def test_one_chain_blocked_algorithm_matches_plain(nlayers, case):
    """K2's blocked algorithm, emulated in plain torch (the chunks split
    over ONE_WARPS warps by the triangle rule, ideep as the block
    minimum, the rows of the trapezoid split evenly over the warps and
    their partial sums added in warp order), equals the plain
    version (prep_chains + transit_rt_plain) at 1e-12: with and without
    the deck, a finite maxdepth that stops some columns, and a chain
    whose top radii are +inf (NaN where the plain version has it)."""
    radius, ec1, ec2, cia_tab, cia_w, _, _ = _operands(
        1, nlayers, 96, ncia=3, seed=nlayers)
    if case == 'inf_top_radii':
        radius[0, :3] = np.inf
    itop = 0 if case == 'inf_top_radii' else 2
    ec = ec1 + ec2 + cia_w @ cia_tab
    path = np.asarray(transit_path_matrix(radius[0], itop))
    maxdepth = 8.0 if case == 'maxdepth' else np.inf
    deck_itop = rsurf = None
    ibottom = nlayers
    if case in ('deck', 'maxdepth'):
        deck_itop = nlayers - 4
        rsurf = float(_deck(radius, np.array([deck_itop]))[0])
        ibottom = deck_itop + 1
    want = tk.transit_one_plain(
        [T(ec)], T(path[None]), T(radius), 12.0, itop, ibottom, deck_itop,
        rsurf, maxdepth=maxdepth)[0].numpy()
    got = _one_chain_blocked(
        T(ec[0]), T(path), T(radius[0]), 12.0, itop, ibottom, deck_itop,
        rsurf, maxdepth, tk.ONE_WARPS).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    if case == 'inf_top_radii':
        assert not np.any(np.isfinite(want))
    else:
        assert np.all(np.isfinite(want))
    # Every chunk goes to one warp, in order:
    bounds = _warp_chunks(nlayers, tk.ONE_WARPS)
    assert bounds[0] == 0 and bounds[-1] == (nlayers + 3) // 4
    assert bounds == sorted(bounds)


@pytest.mark.parametrize('case', ['deck', 'no_deck', 'inf_top_radii'])
@pytest.mark.parametrize('nlayers', [21, 81, 150])
def test_one_chain_streamed_fold_matches_plain(nlayers, case):
    """K2's streamed layout, emulated: each chunk's chord rows folded
    from `path` as j walks (the sum path[i][j - 1] + path[i][j] taken in
    the staged fold's order), the rest as staged; equal to the staged
    emulation bit for bit and to the plain version at 1e-12."""
    radius, ec1, ec2, cia_tab, cia_w, _, _ = _operands(
        1, nlayers, 48, ncia=3, seed=nlayers + 7)
    if case == 'inf_top_radii':
        radius[0, :3] = np.inf
    itop = 0 if case == 'inf_top_radii' else 3
    ec = ec1 + ec2 + cia_w @ cia_tab
    path = np.asarray(transit_path_matrix(radius[0], itop))
    deck_itop = rsurf = None
    ibottom = nlayers
    if case == 'deck':
        deck_itop = nlayers - 5
        rsurf = float(_deck(radius, np.array([deck_itop]))[0])
        ibottom = deck_itop + 1
    operands = (T(ec[0]), T(path), T(radius[0]), 12.0, itop, ibottom,
                deck_itop, rsurf, np.inf, tk.ONE_WARPS)
    got = _one_chain_blocked(*operands, streamed=True).numpy()
    staged = _one_chain_blocked(*operands).numpy()
    want = tk.transit_one_plain(
        [T(ec)], T(path[None]), T(radius), 12.0, itop, ibottom, deck_itop,
        rsurf)[0].numpy()
    np.testing.assert_array_equal(got, staged)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_one_chain_launcher_rejects_cpu_tensors():
    """K2's launcher never computes on CPU tensors: it raises before
    building or launching anything, and counts no launch."""
    radius, ec1, _, _, _, _, _ = _operands(1, 12, 16)
    path = np.asarray(transit_path_matrix(radius[0]))[None]
    launches = tk.transit_one_cuda.launches
    with pytest.raises(TypeError, match='float32 CUDA tensor'):
        tk.transit_one_cuda([T(ec1)], T(path), T(radius), 10.0, 0, 12)
    assert tk.transit_one_cuda.launches == launches


def test_one_chain_routes_by_device(monkeypatch):
    """One chain on the CPU takes K2's plain version and never reaches
    either CUDA launcher; the fused interface goes the same way."""
    calls = []
    for name in ('transit_rt_cuda', 'transit_one_cuda'):
        monkeypatch.setattr(tk, name, lambda *a, **k: calls.append(1))
    radius, ec1, _, _, _, _, _ = _operands(1, 12, 16)
    path = np.asarray(transit_path_matrix(radius[0]))[None]
    out = tk.transit_spectrum_ensemble(
        [T(ec1)], T(path), T(radius), 10.0, T(np.zeros(1, int)),
        T(np.full(1, 12)))
    fused = tk.transit_spectrum_fused(T(ec1[0]), T(path[0]), T(radius[0]),
                                      10.0, 0, 12)
    assert out.shape == (1, 16) and fused.shape == (16,) and not calls
    np.testing.assert_array_equal(out[0].numpy(), fused.numpy())
