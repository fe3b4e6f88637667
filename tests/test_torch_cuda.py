"""The hand-written CUDA kernels (transit and emission RT, the one-chain
transit kernel, the line-by-line wing and core passes, the equilibrium
solve and the Guillot profile) against their plain PyTorch versions, on a
GPU.

This file imports neither JAX nor pyratbay_tpu, so that it also runs on
a machine without them, where tests/conftest.py (which imports JAX)
must be skipped:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Without a CUDA device the tests skip.  The bounds are those of
tests/test_tpu_hw.py, relative to the row maximum: 2e-5 for transit,
1e-4 for emission (float32 on the card against float32 plain torch on
the card, differing in the order of the sums and, for emission, in the
exponentials' last bits, which exp(-depth/mu) amplifies); 2e-4 for the
line-by-line passes, relative on entries above 1e-6 of the maximum
(float32 sums over windows of up to a few thousand lines, in another
order than the plain version's: a thread walks its lines four at a time,
a small launch splits a window over four warps; the wing kernels on
per-line factors take the hardware's approximate reciprocal, within one
ulp, and the core kernels share one reciprocal among the divisions of
the Weideman function).
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

from pyratbay_tpu_torch.atmosphere.geometry import transit_path_matrix  # noqa: E402
from pyratbay_tpu_torch.benchmark import synthetic_lines  # noqa: E402
from pyratbay_tpu_torch.opacity import lbl_kernel as lk  # noqa: E402
from pyratbay_tpu_torch.opacity.lbl_direct import DirectLBL  # noqa: E402
from pyratbay_tpu_torch.spectrum import emission_kernel as ek  # noqa: E402
from pyratbay_tpu_torch.spectrum import transit_kernel as tk  # noqa: E402

TOL = 2e-5
EMISSION_TOL = 1e-4
LBL_TOL = 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc (run chip_smoke.py)')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _operands(nb, nlayers, nwave, ncia, nr1, seed):
    rng = np.random.default_rng(seed)
    radius = np.sort(
        rng.uniform(1.0, 1.1, (nb, nlayers)), axis=1)[:, ::-1].copy()
    ec1 = rng.lognormal(-3.0, 2.0, (nb, nlayers, nwave)) \
        * np.exp(np.linspace(0.0, 7.0, nlayers))[:, None]
    ec2 = rng.lognormal(-4.0, 1.5, (nb, nlayers, nwave))
    cia_tab = rng.lognormal(-2.0, 1.0, (ncia, nwave))
    cia_w = rng.lognormal(-1.0, 0.5, (nb, nlayers, ncia))
    r1c = rng.lognormal(-2.0, 1.0, (nb, nr1, nlayers))
    r1r = rng.lognormal(-1.0, 1.0, (nb, nr1, nwave))
    return radius, [ec1, ec2], cia_tab, cia_w, r1c, r1r


# The layer counts of the transit kernel's tensor-core chord product
# (2 to 64): the smallest, the edges of its 8-row tiles and of its
# instantiations (32, 56 and 64 rows), and the flagship's 51.
K1_LAYERS = [2, 13, 32, 51, 52, 64]


def _k1_tops(nb, nlayers):
    """Tops [0, 0, 2, 0, 5, 0, ...] of nb chains, and deck rows at the
    shares 0.9, 1.0, 0.6, 0.24, 0.8, 0.4 (repeated) of the depth, below
    each top: the same rows at any layer count from 2."""
    itop = np.minimum(np.resize([0, 0, 2, 0, 5, 0], nb), nlayers - 2)
    share = np.resize([0.9, 1.0, 0.6, 0.24, 0.8, 0.4], nb)
    deck_itop = np.clip(np.round(share * (nlayers - 1)).astype(int),
                        itop + 1, nlayers - 1)
    return itop, deck_itop


def _k1_launches():
    c = tk.transit_rt_cuda
    return c.launches, c.mma_launches, c.tall_launches


def _k1_counted(before, nlayers):
    """The counters after one launch at nlayers layers: one more launch,
    of the tensor-core chord product up to 64 layers, else of the tall
    function."""
    launches, mma, tall = before
    return (launches + 1, mma + (nlayers <= 64), tall + (nlayers > 64))


@pytest.mark.cuda
@pytest.mark.parametrize('ncia', [15, 20])
@pytest.mark.parametrize('nlayers', K1_LAYERS)
@pytest.mark.parametrize('with_deck', [True, False])
def test_cuda_kernel_matches_plain(cuda, with_deck, nlayers, ncia):
    """The kernel against the plain version on two dense parts, a rank-1
    term and CIA rows of either padding (KP 16 and 32), at every layer
    count of its instantiations."""
    nb = 6
    radius, parts, cia_tab, cia_w, r1c, r1r = _operands(
        nb, nlayers, 1000, ncia=ncia, nr1=1, seed=9)
    f32 = lambda a: torch.as_tensor(
        np.asarray(a), dtype=torch.float32, device=cuda)
    i64 = lambda a: torch.as_tensor(np.asarray(a), device=cuda)
    itop, deck_itop = _k1_tops(nb, nlayers)
    rr = f32(radius)
    path = transit_path_matrix(rr, i64(itop))
    if with_deck:
        rsurf = radius[np.arange(nb), deck_itop] + 0.4 * (
            radius[np.arange(nb), deck_itop - 1]
            - radius[np.arange(nb), deck_itop])
        operands = tk.prep_chains(path, rr, 12.0, i64(itop),
                                  i64(deck_itop + 1), i64(deck_itop),
                                  f32(rsurf))
    else:
        operands = tk.prep_chains(path, rr, 12.0, i64(itop),
                                  i64(np.full(nb, nlayers)))
    kw = dict(cia_w=f32(cia_w), cia_tab=f32(cia_tab), r1_cols=f32(r1c),
              r1_rows=f32(r1r), maxdepth=10.0)
    ec = [f32(p) for p in parts]
    before = _k1_launches()
    got = tk.transit_rt_cuda(ec, *operands, **kw)
    want = tk.transit_rt_plain(ec, *operands, **kw)
    torch.cuda.synchronize()
    assert _k1_launches() == _k1_counted(before, nlayers)
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    assert np.all(np.isfinite(got))
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert np.max(np.abs(got - want) / scale) < TOL


def _line_sample(nb, nlayers, nwave, nk, seed, scale=1.0):
    """Two-hot line-sample weights [B, K2, l] and a table [K2, l, W]."""
    rng = np.random.default_rng(seed)
    ls_w = np.zeros((nb, nk, nlayers))
    tlo = rng.integers(0, nk - 1, (nb, nlayers))
    frac = rng.random((nb, nlayers))
    dens = rng.lognormal(0.0, 1.0, (nb, nlayers))
    b, j = np.meshgrid(np.arange(nb), np.arange(nlayers), indexing='ij')
    ls_w[b, tlo, j] = (1 - frac) * dens
    ls_w[b, tlo + 1, j] = frac * dens
    ls_tab = scale * rng.lognormal(-3.0, 2.0, (nk, nlayers, nwave)) \
        * np.exp(np.linspace(0.0, 7.0, nlayers))[None, :, None]
    return ls_w, ls_tab


def _k1_ls_rows(nlayers):
    """Line-sample rows whose slab the kernel takes at nlayers layers:
    the flagship's 10, or 8 where 10 would not fit (64 layers)."""
    return 10 if tk.ls_in_kernel(10, nlayers, 'transit') else 8


@pytest.mark.cuda
@pytest.mark.parametrize('nlayers', [12] + K1_LAYERS)
@pytest.mark.parametrize('case', [
    'ls', 'ls_nodeck', 'ls_beside_parts', 'one_chain', 'odd_group',
    'many_cia', 'parts0_r1_0', 'parts4_r1_4'])
def test_cuda_kernel_line_sample_operands(cuda, case, nlayers):
    """The kernel on ls_w / ls_tab against the plain version: alone,
    beside dense parts, one chain (the per-chain interface), a chain
    count that no chain group divides, more than 16 CIA rows, no dense
    part or rank-1 term and the most of both (4 and 4); at every layer
    count of its instantiations."""
    nb = {'one_chain': 1, 'odd_group': 37}.get(case, 6)
    ncia = 20 if case == 'many_cia' else 15
    n_parts, n_r1 = {'parts0_r1_0': (0, 0), 'parts4_r1_4': (4, 4),
                     'ls_beside_parts': (2, 2)}.get(case, (0, 2))
    nwave = 1000
    radius, parts, cia_tab, cia_w, r1c, r1r = _operands(
        nb, nlayers, nwave, ncia=ncia, nr1=n_r1, seed=11)
    parts = (parts * 2)[:n_parts]
    ls_w, ls_tab = _line_sample(nb, nlayers, nwave, _k1_ls_rows(nlayers),
                                seed=12)
    f32 = lambda a: torch.as_tensor(
        np.asarray(a), dtype=torch.float32, device=cuda)
    i64 = lambda a: torch.as_tensor(np.asarray(a), device=cuda)
    itop = np.minimum(np.arange(nb) % 3, nlayers - 2)
    rr = f32(radius)
    path = transit_path_matrix(rr, i64(itop))
    if case == 'ls_nodeck':
        operands = tk.prep_chains(path, rr, 12.0, i64(itop),
                                  i64(np.full(nb, nlayers)))
    else:
        deck_itop = np.maximum(nlayers - 1 - np.arange(nb) % 7, itop + 1)
        rsurf = radius[np.arange(nb), deck_itop] + 0.4 * (
            radius[np.arange(nb), deck_itop - 1]
            - radius[np.arange(nb), deck_itop])
        operands = tk.prep_chains(path, rr, 12.0, i64(itop),
                                  i64(deck_itop + 1), i64(deck_itop),
                                  f32(rsurf))
    kw = dict(cia_w=f32(cia_w), cia_tab=f32(cia_tab),
              r1_cols=f32(r1c) if n_r1 else None,
              r1_rows=f32(r1r) if n_r1 else None, ls_w=f32(ls_w),
              ls_tab=f32(ls_tab), maxdepth=10.0)
    ec = [f32(p) for p in parts]
    before = _k1_launches()
    got = tk.transit_rt_cuda(ec, *operands, **kw)
    want = tk.transit_rt_plain(ec, *operands, **kw)
    torch.cuda.synchronize()
    assert _k1_launches() == _k1_counted(before, nlayers)
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    assert np.all(np.isfinite(got))
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert np.max(np.abs(got - want) / scale) < TOL


@pytest.mark.cuda
def test_cuda_kernel_on_a_constant_r_grid(cuda):
    """The kernel on the line sample at the width of the flagship's
    range at R = 25,000 (ops.grids.wavenumber_grid: 10,883 columns, 171
    wave tiles), 8 chains with the deck, against the plain version."""
    from pyratbay_tpu_torch.ops.grids import wavenumber_grid
    nwave = len(wavenumber_grid(wnlow=1.0 / 1.7e-4, wnhigh=1.0 / 1.1e-4,
                                resolution=25000.0).wn)
    assert nwave == 10883
    nb, nlayers = 8, 51
    radius, _, cia_tab, cia_w, r1c, r1r = _operands(
        nb, nlayers, nwave, ncia=2, nr1=2, seed=21)
    ls_w, ls_tab = _line_sample(nb, nlayers, nwave, 10, seed=22)
    assert tk.ls_in_kernel(10, nlayers, 'transit')
    f32 = lambda a: torch.as_tensor(
        np.asarray(a), dtype=torch.float32, device=cuda)
    i64 = lambda a: torch.as_tensor(np.asarray(a), device=cuda)
    itop = np.arange(nb) % 3
    rr = f32(radius)
    deck_itop = nlayers - 1 - np.arange(nb) % 7
    rsurf = radius[np.arange(nb), deck_itop] + 0.4 * (
        radius[np.arange(nb), deck_itop - 1]
        - radius[np.arange(nb), deck_itop])
    operands = tk.prep_chains(transit_path_matrix(rr, i64(itop)), rr, 12.0,
                              i64(itop), i64(deck_itop + 1), i64(deck_itop),
                              f32(rsurf))
    kw = dict(cia_w=f32(cia_w), cia_tab=f32(cia_tab), r1_cols=f32(r1c),
              r1_rows=f32(r1r), ls_w=f32(ls_w), ls_tab=f32(ls_tab),
              maxdepth=10.0)
    launches = tk.transit_rt_cuda.launches
    got = tk.transit_rt_cuda([], *operands, **kw)
    want = tk.transit_rt_plain([], *operands, **kw)
    torch.cuda.synchronize()
    assert tk.transit_rt_cuda.launches == launches + 1
    assert got.shape == (nb, nwave)
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    assert np.all(np.isfinite(got))
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert np.max(np.abs(got - want) / scale) < TOL


@pytest.mark.cuda
def test_cuda_kernel_refuses_a_slab_beyond_shared_memory(cuda):
    """A line-sample table whose wave-tile slab leaves no room in a
    block's shared memory raises before any launch."""
    nb, nlayers, nwave = 2, 51, 128
    radius, _, _, _, _, _ = _operands(nb, nlayers, nwave, 1, 1, seed=3)
    ls_w, ls_tab = _line_sample(nb, nlayers, nwave, 20, seed=4)
    assert not tk.ls_in_kernel(20, nlayers, 'transit')
    f32 = lambda a: torch.as_tensor(
        np.asarray(a), dtype=torch.float32, device=cuda)
    rr = f32(radius)
    operands = tk.prep_chains(
        transit_path_matrix(rr), rr, 12.0,
        torch.zeros(nb, dtype=torch.int64, device=cuda),
        torch.full((nb,), nlayers, device=cuda))
    launches = tk.transit_rt_cuda.launches
    with pytest.raises(ValueError, match='shared memory'):
        tk.transit_rt_cuda([], *operands, ls_w=f32(ls_w), ls_tab=f32(ls_tab))
    assert tk.transit_rt_cuda.launches == launches


@pytest.mark.cuda
def test_cuda_wrapper_routes_to_kernel(cuda):
    """transit_spectrum_ensemble on CUDA tensors launches the kernel."""
    radius, parts, _, _, _, _ = _operands(2, 12, 64, 1, 1, seed=1)
    rr = torch.as_tensor(radius, dtype=torch.float32, device=cuda)
    path = transit_path_matrix(rr)
    launches = tk.transit_rt_cuda.launches
    out = tk.transit_spectrum_ensemble(
        [torch.as_tensor(parts[0], dtype=torch.float32, device=cuda)],
        path, rr, 10.0, torch.zeros(2, dtype=torch.int64, device=cuda),
        torch.full((2,), 12, device=cuda))
    torch.cuda.synchronize()
    assert out.is_cuda and out.shape == (2, 64)
    assert tk.transit_rt_cuda.launches == launches + 1


def _one_chain(case, cuda, nb=1, nlayers=None):
    """K2's raw operands for one of its cases: (args, kwargs) of
    transit_spectrum_ensemble at `nb` chains, float32 on the card."""
    if nlayers is None:
        nlayers = 81 if case == 'layers81' else 51
    nwave = 1000
    radius, parts, cia_tab, cia_w, r1c, r1r = _operands(
        nb, nlayers, nwave, ncia=15, nr1=2, seed=31)
    if case == 'inf_top':
        radius[0, :3] = np.inf
    ls_w, ls_tab = _line_sample(nb, nlayers, nwave, 10, seed=32)
    f32 = lambda a: torch.as_tensor(
        np.asarray(a), dtype=torch.float32, device=cuda)
    i64 = lambda a: torch.as_tensor(np.asarray(a), device=cuda)
    itop = np.arange(nb) % 3
    rr = f32(radius)
    kw = dict(cia_w=f32(cia_w), cia_tab=f32(cia_tab), r1_cols=f32(r1c),
              r1_rows=f32(r1r), ls_w=f32(ls_w), ls_tab=f32(ls_tab),
              maxdepth=10.0 if case == 'maxdepth' else np.inf)
    ec = [f32(p) for p in parts]
    if case == 'dense_deck':
        ec.append(f32(np.einsum('bkl,klw->blw', ls_w, ls_tab)))
        kw.update(ls_w=None, ls_tab=None)
    if case == 'cia40_r1_5':
        raw = _overflow_operands('cia40', nb, nlayers, nwave, seed=33)
        (full_ec, full), (fit_ec, fit) = _fitted(
            'cia40', nlayers, 'transit', f32, *raw)
        extra = _overflow_operands('r1_6', nb, nlayers, nwave, seed=34)
        r1c5, r1r5 = f32(extra[3][:, :5]), f32(extra[4][:, :5])
        fit = tk.fit_operands(full_ec, **dict(full, r1_cols=r1c5,
                                              r1_rows=r1r5))
        ec = fit.pop('ec_parts')
        kw.update(fit)
    ibottom = i64(np.full(nb, nlayers))
    if case not in ('no_deck', 'inf_top'):
        deck_itop = nlayers - 1 - np.arange(nb) % 7
        rsurf = radius[np.arange(nb), deck_itop] + 0.4 * (
            radius[np.arange(nb), deck_itop - 1]
            - radius[np.arange(nb), deck_itop])
        kw.update(deck_itop=i64(deck_itop), deck_rsurf=f32(rsurf))
        ibottom = i64(deck_itop + 1)
    path = transit_path_matrix(rr, i64(itop))
    return (ec, path, rr, 12.0, i64(itop), ibottom), kw


_ONE_CASES = ['ls_deck', 'dense_deck', 'no_deck', 'maxdepth', 'cia40_r1_5',
              'layers81', 'inf_top']


def _row_rel_finite(got, want):
    """Largest difference relative to the row maximum; the non-finite
    entries must be the same in both."""
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    rows = np.all(np.isfinite(want), axis=1)
    if not rows.any():
        return 0.0
    scale = np.abs(want[rows]).max(axis=1, keepdims=True)
    return float(np.max(np.abs(got[rows] - want[rows]) / scale))


@pytest.mark.cuda
@pytest.mark.parametrize('case', _ONE_CASES)
def test_cuda_one_chain_kernel_matches_plain(cuda, case):
    """K2 on one chain's raw operands against its plain version on the
    card (prep_chains + transit_rt_plain): the line sample in the kernel
    or as a dense part, no deck, a finite maxdepth, 40 CIA rows and 5
    rank-1 terms through the size rule, 81 layers, +inf top radii."""
    args, kw = _one_chain(case, cuda)
    launches = tk.transit_one_cuda.launches
    k1 = tk.transit_rt_cuda.launches
    got = tk.transit_one_cuda(*args, **kw)
    want = tk.transit_one_plain(*args, **kw)
    torch.cuda.synchronize()
    assert tk.transit_one_cuda.launches == launches + 1
    assert tk.transit_rt_cuda.launches == k1
    assert _row_rel_finite(got, want) < TOL
    assert bool(torch.isfinite(got).all()) == (case != 'inf_top')


@pytest.mark.cuda
def test_cuda_one_chain_kernel_takes_several_chains(cuda):
    """K2 with 12 chains (a block of columns each) against the plain
    version, and the pointer scalars of one element for every chain."""
    args, kw = _one_chain('ls_deck', cuda, nb=12)
    got = tk.transit_one_cuda(*args, **kw)
    want = tk.transit_one_plain(*args, **kw)
    assert _row_rel_finite(got, want) < TOL
    rstar = torch.full((1,), 12.0, device=cuda, dtype=torch.float64)
    itop = args[4][:1].to(torch.int32)
    one = (args[0], args[1], args[2], rstar, itop, args[5])
    got = tk.transit_one_cuda(*one, **kw)
    want = tk.transit_one_plain(*one, **kw)
    assert _row_rel_finite(got, want) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['ls_deck', 'cia40_r1_5'])
def test_cuda_one_chain_call_is_one_launch(cuda, case):
    """transit_spectrum_ensemble at one chain and transit_spectrum_fused
    are one kernel launch each on the card (torch.profiler), K2's; also
    on the size rule's operands, whose CIA weights are a view of the
    first 32 of each layer's 40."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    args, kw = _one_chain(case, cuda)
    if case == 'cia40_r1_5':
        assert not kw['cia_w'].is_contiguous()
    ec = [p[0] for p in args[0]]
    fused_args = (ec, args[1][0], args[2][0], 12.0, int(args[4][0]),
                  int(args[5][0]))
    fused_kw = dict(deck_itop=int(kw['deck_itop'][0]),
                    deck_rsurf=float(kw['deck_rsurf'][0]))
    calls = [lambda: tk.transit_spectrum_ensemble(*args, **kw)]
    if case == 'ls_deck':
        calls.append(lambda: tk.transit_spectrum_fused(*fused_args,
                                                       **fused_kw))
    for fn in calls:
        fn()
        torch.cuda.synchronize()
        launches = tk.transit_one_cuda.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU]
        assert sum(e.count for e in kernels) == 1, [e.key for e in kernels]
        assert 'transit_one_kernel' in kernels[0].key
        assert tk.transit_one_cuda.launches == launches + 1
    if case != 'ls_deck':
        return
    fused = tk.transit_spectrum_fused(*fused_args, **fused_kw)
    want = tk.transit_one_plain(
        [p[None] for p in ec], args[1][:1], args[2][:1], 12.0,
        args[4][:1], args[5][:1], **fused_kw)
    assert _row_rel_finite(fused[None], want) < TOL


@pytest.mark.cuda
def test_cuda_one_chain_refuses_layers_beyond_shared_memory(cuda):
    """K2 raises before any launch when even its streamed block (the
    radius, heights and live line-sample rows of each layer) exceeds the
    shared memory, and names the most layers it takes with those
    operands (a dense part and a line sample of two rows); below that it
    runs, streamed."""
    nlayers = tk.one_max_layers(0, 0, 2, 1) + 1
    radius, parts, _, _, _, _ = _operands(1, nlayers, 64, 1, 1, seed=5)
    ls_w, ls_tab = _line_sample(1, nlayers, 64, 2, seed=6)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    rr, ec = f32(radius), [f32(parts[0])]
    ls_w, ls_tab = f32(ls_w), f32(ls_tab)
    launches = tk.transit_one_cuda.launches
    with pytest.raises(ValueError, match=f'at most {nlayers - 1} layers'):
        tk.transit_spectrum_ensemble(
            ec, transit_path_matrix(rr), rr, 10.0, 0, nlayers, ls_w=ls_w,
            ls_tab=ls_tab)
    assert tk.transit_one_cuda.launches == launches
    streamed = tk.transit_one_cuda.streamed_launches
    out = tk.transit_spectrum_ensemble(
        [p[:, 1:] for p in ec], transit_path_matrix(rr[:, 1:]), rr[:, 1:],
        10.0, 0, nlayers - 1, ls_w=ls_w[..., 1:],
        ls_tab=ls_tab[:, 1:].contiguous())
    torch.cuda.synchronize()
    assert tk.transit_one_cuda.launches == launches + 1
    assert tk.transit_one_cuda.streamed_launches == streamed + 1
    assert bool(torch.isfinite(out).all())


@pytest.mark.cuda
@pytest.mark.parametrize('sizes', [(0, 0, 0, 1), (1, 15, 10, 0),
                                   (2, 15, 10, 2), (4, 32, 0, 3)])
def test_cuda_one_chain_takes_the_tall_functions_layers(cuda, sizes):
    """Every layer count the ensemble kernel's tall function takes at
    one chain (what B = 1 calls ran on before K2), K2 takes too, with
    the operand counts of the retrieval, the tests and the spectrum
    path."""
    assert tk.one_max_layers(*sizes) >= tk.tall_max_layers(*sizes)
    assert tk.one_staged_max_layers(*sizes) < tk.one_max_layers(*sizes)


@pytest.mark.cuda
@pytest.mark.parametrize('where', ['staged_top', 'streamed', 'layers1100'])
def test_cuda_one_chain_streams_beyond_shared_memory(cuda, where):
    """At the most layers whose block K2 holds in shared memory it runs
    staged; above them streamed (ec and the depths through device
    memory, the chord rows folded as they are read): one launch either
    way, within TOL of the plain version."""
    top = tk.one_staged_max_layers(2, 15, 10, 2)
    nlayers = {'staged_top': top, 'streamed': top + 1,
               'layers1100': 1100}[where]
    args, kw = _one_chain('ls_deck', cuda, nlayers=nlayers)
    launches = tk.transit_one_cuda.launches
    streamed = tk.transit_one_cuda.streamed_launches
    got = tk.transit_spectrum_ensemble(*args, **kw)
    want = tk.transit_one_plain(*args, **kw)
    torch.cuda.synchronize()
    assert tk.transit_one_cuda.launches == launches + 1
    assert tk.transit_one_cuda.streamed_launches == streamed + (
        where != 'staged_top')
    assert bool(torch.isfinite(got).all())
    assert _row_rel_finite(got, want) < TOL


def _emission_operands(nb, nlayers, nwave, seed):
    rng = np.random.default_rng(seed)
    radius = np.linspace(7.2e9, 7.0e9, nlayers)[None, :] * (
        1 + 0.01 * rng.standard_normal((nb, 1)))
    temp = 1200 + 500 * rng.random((nb, nlayers))
    ec = rng.lognormal(-25.0, 2.0, (nb, nlayers, nwave)) \
        * np.exp(np.linspace(0, 10, nlayers))[None, :, None]
    wn = np.linspace(2000.0, 9000.0, nwave)
    cia_w = rng.lognormal(-28.0, 1.0, (nb, nlayers, 15))
    cia_tab = rng.lognormal(0.0, 1.0, (15, nwave))
    r1c = rng.lognormal(-24.0, 1.0, (nb, 1, nlayers))
    r1r = rng.lognormal(0.0, 1.0, (nb, 1, nwave))
    return radius, temp, [0.4 * ec, 0.6 * ec], wn, cia_w, cia_tab, r1c, r1r


@pytest.mark.cuda
@pytest.mark.parametrize('with_deck', [True, False])
def test_cuda_emission_kernel_matches_plain(cuda, with_deck):
    nb, nlayers = 6, 51
    radius, temp, parts, wn, cia_w, cia_tab, r1c, r1r = _emission_operands(
        nb, nlayers, 1000, seed=9)
    f32 = lambda a: torch.as_tensor(
        np.asarray(a), dtype=torch.float32, device=cuda)
    i64 = lambda a: torch.as_tensor(np.asarray(a), device=cuda)
    mu = np.cos(np.deg2rad([0.0, 20.0, 40.0, 60.0, 80.0]))
    weights = np.full(5, np.pi / 5)
    itop = np.array([0, 0, 2, 0, 5, 0])
    if with_deck:
        deck_itop = np.array([45, 50, 30, 12, 3, 20])
        operands = ek.prep_emission_chains(
            f32(radius), f32(temp), i64(itop), i64(deck_itop + 1),
            i64(deck_itop), f32(np.full(nb, 1600.0)))
    else:
        operands = ek.prep_emission_chains(
            f32(radius), f32(temp), i64(itop), i64(np.full(nb, nlayers)))
    kw = dict(cia_w=f32(cia_w), cia_tab=f32(cia_tab), r1_cols=f32(r1c),
              r1_rows=f32(r1r), maxdepth=10.0)
    ec = [f32(p) for p in parts]
    launches = ek.emission_rt_cuda.launches
    got = ek.emission_rt_cuda(ec, *operands, f32(wn), mu, weights, **kw)
    want = ek.emission_rt_plain(ec, *operands, f32(wn), mu, weights, **kw)
    torch.cuda.synchronize()
    assert ek.emission_rt_cuda.launches == launches + 1
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    assert np.all(np.isfinite(got))
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert np.max(np.abs(got - want) / scale) < EMISSION_TOL


@pytest.mark.cuda
@pytest.mark.parametrize('case', [
    'ls', 'ls_nodeck', 'ls_beside_parts', 'one_chain', 'odd_group',
    'gauss3', 'gauss12', 'many_cia'])
def test_cuda_emission_kernel_line_sample_operands(cuda, case):
    """The emission kernel on ls_w / ls_tab against the plain version:
    alone, beside dense parts, one chain, a chain count that no chain
    group divides, angle counts of the predicated instantiations, and
    more than 16 CIA rows."""
    nb = {'one_chain': 1, 'odd_group': 37}.get(case, 6)
    nlayers, nwave = 51, 1000
    radius, temp, parts, wn, cia_w, cia_tab, r1c, r1r = _emission_operands(
        nb, nlayers, nwave, seed=13)
    if case == 'many_cia':
        rng = np.random.default_rng(5)
        cia_w = rng.lognormal(-28.0, 1.0, (nb, nlayers, 20))
        cia_tab = rng.lognormal(0.0, 1.0, (20, nwave))
    ls_w, ls_tab = _line_sample(nb, nlayers, nwave, 10, seed=14,
                                scale=3e-10)
    f32 = lambda a: torch.as_tensor(
        np.asarray(a), dtype=torch.float32, device=cuda)
    i64 = lambda a: torch.as_tensor(np.asarray(a), device=cuda)
    if case.startswith('gauss'):
        from pyratbay_tpu_torch.spectrum.rt import gauss_quadrature
        mu, weights = gauss_quadrature(int(case[5:]))
    else:
        mu = np.cos(np.deg2rad([0.0, 20.0, 40.0, 60.0, 80.0]))
        weights = np.full(5, np.pi / 5)
    itop = np.arange(nb) % 3
    if case == 'ls_nodeck':
        operands = ek.prep_emission_chains(
            f32(radius), f32(temp), i64(itop), i64(np.full(nb, nlayers)))
    else:
        deck_itop = nlayers - 1 - np.arange(nb) % 7
        operands = ek.prep_emission_chains(
            f32(radius), f32(temp), i64(itop), i64(deck_itop + 1),
            i64(deck_itop), f32(np.full(nb, 1600.0)))
    kw = dict(cia_w=f32(cia_w), cia_tab=f32(cia_tab), r1_cols=f32(r1c),
              r1_rows=f32(r1r), ls_w=f32(ls_w), ls_tab=f32(ls_tab),
              maxdepth=10.0)
    ec = [f32(p) for p in parts] if case == 'ls_beside_parts' else []
    launches = ek.emission_rt_cuda.launches
    got = ek.emission_rt_cuda(ec, *operands, f32(wn), mu, weights, **kw)
    want = ek.emission_rt_plain(ec, *operands, f32(wn), mu, weights, **kw)
    torch.cuda.synchronize()
    assert ek.emission_rt_cuda.launches == launches + 1
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    assert np.all(np.isfinite(got))
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert np.max(np.abs(got - want) / scale) < EMISSION_TOL


@pytest.mark.cuda
def test_cuda_emission_wrapper_routes_to_kernel(cuda):
    """emission_flux_ensemble on CUDA tensors launches the kernel once."""
    radius, temp, parts, wn, _, _, _, _ = _emission_operands(2, 12, 64, 1)
    f32 = lambda a: torch.as_tensor(
        np.asarray(a), dtype=torch.float32, device=cuda)
    launches = ek.emission_rt_cuda.launches
    out = ek.emission_flux_ensemble(
        [f32(parts[0])], f32(radius), f32(temp), f32(wn), [1.0, 0.5],
        [1.5, 1.5], torch.zeros(2, dtype=torch.int64, device=cuda),
        torch.full((2,), 12, device=cuda))
    torch.cuda.synchronize()
    assert out.is_cuda and out.shape == (2, 64)
    assert ek.emission_rt_cuda.launches == launches + 1


def _lbl_lines(nspec, nlines=4000, seed=0):
    """A synthetic H2O-like line list over the flagship grid; nspec = 2
    splits the isotopes into two species."""
    return synthetic_lines(np.arange(5882.0, 9091.0, 1.0), nlines, seed,
                           nspec)


def _lbl_cells(direct, ncell=4):
    temps = np.linspace(300.0, 3000.0, ncell)
    vmr = np.array([0.85, 0.149, 1e-6, 3e-6, 5e-8, 4e-4, 1e-4, 5e-4, 1e-7])
    dens = vmr[None, :] * (np.logspace(-6, 2, ncell)[:, None] * 1e6
                           / (1.380649e-16 * temps[:, None]))
    pf = direct.lbl.iso_pf(temps).T
    return [direct._f32(a) for a in (temps, dens, pf)]


def _masked_rel(got, want):
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    mask = np.abs(want) > 1e-6 * np.abs(want).max()
    return float(np.max(np.abs(got[mask] - want[mask]) / np.abs(want[mask])))


@pytest.mark.cuda
@pytest.mark.parametrize('nspec', [1, 2])
@pytest.mark.parametrize('kernel', ['wing_grouped', 'core', 'wing'])
def test_cuda_lbl_kernels_match_plain(cuda, kernel, nspec):
    direct = DirectLBL(_lbl_lines(nspec), device=cuda)
    tables = direct.tables()
    prefix = {'wing_grouped': 'wf_', 'core': 'c_', 'wing': 'w_'}[kernel]
    fac = direct._cell_factors(tables, *_lbl_cells(direct),
                               'w_' if kernel == 'wing' else 'wf_')
    tiles = {'wf_': 'wn_wf', 'c_': 'wn_core', 'w_': 'wn_tiles'}[prefix]
    factors = ('scale_c', 'y_c', 'inv_ad_c') if kernel == 'core' \
        else ('c1_w', 'y2_w', 'inv_ad_w')
    args = [tables[tiles + '_hi'], tables[tiles + '_lo'],
            tables[prefix + 'lwn_hi'], tables[prefix + 'lwn_lo'],
            *[fac[k] for k in factors],
            tables[prefix + 'spec'] if nspec > 1 else None]
    kw = dict(margin=direct.margin, nspec=nspec)
    if kernel != 'core':
        kw['cutoff'] = direct.cutoff
    cuda_fn = getattr(lk, {'wing_grouped': 'wing_sigma_grouped_cuda',
                           'core': 'core_sigma_cuda',
                           'wing': 'wing_sigma_cuda'}[kernel])
    plain_fn = getattr(lk, cuda_fn.__name__.replace('_cuda', '_plain'))
    launches = cuda_fn.launches
    got = cuda_fn(*args, **kw)
    want = plain_fn(*args, **kw)
    torch.cuda.synchronize()
    assert cuda_fn.launches == launches + 1
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert _masked_rel(got, want) < LBL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize('split', [None, False, True])
@pytest.mark.parametrize('nspec', [1, 2, 8])
def test_cuda_wing_windows_kernel_matches_plain(cuda, nspec, split):
    """K6 on its window layout against the plain version at nspec 1, 2
    and 8 (a species index drawn over eight), with the launch's own
    choice and with each warp's run split over a block's warps or not;
    also on windows whose width is not a multiple of four (4-byte
    copies)."""
    direct = DirectLBL(_lbl_lines(min(nspec, 2)), device=cuda)
    tables = direct.tables()
    fac = direct._cell_factors(tables, *_lbl_cells(direct, 21), 'w_')
    spec = None
    if nspec == 2:
        spec = tables['w_spec']
    elif nspec == 8:
        spec = torch.as_tensor(np.random.default_rng(8).integers(
            0, 8, tuple(tables['w_spec'].shape)), dtype=torch.int32,
            device=cuda)
    args = [tables['wn_tiles_hi'], tables['wn_tiles_lo'],
            tables['w_lwn_hi'], tables['w_lwn_lo'], fac['c1_w'],
            fac['y2_w'], fac['inv_ad_w'], spec]
    kw = dict(margin=direct.margin, cutoff=direct.cutoff, nspec=nspec)
    for cut in (args[2].shape[-1] % 4, args[2].shape[-1] % 4 + 1):
        ops = [a if a is None or i < 2 else a[..., :a.shape[-1] - cut]
               .contiguous() for i, a in enumerate(args)]
        launches = lk.wing_sigma_cuda.launches
        got = lk.wing_sigma_cuda(*ops, split=split, **kw)
        want = lk.wing_sigma_plain(*ops, **kw)
        torch.cuda.synchronize()
        assert lk.wing_sigma_cuda.launches == launches + 1
        assert got.shape == want.shape and bool(torch.isfinite(got).all())
        assert _masked_rel(got, want) < LBL_TOL


def _line_operands(direct, kind, ncell):
    """Per-line operands and keywords of K4 ('wing') or K5 ('core')."""
    tables = direct.tables()
    fac = direct._line_factors(tables, *_lbl_cells(direct, ncell))
    spec = tables['l_spec'] if direct.nspec > 1 else None
    lines = [tables['l_lwn_hi'], tables['l_lwn_lo']]
    if kind == 'wing':
        args = [tables['wn_wf_hi'], tables['wn_wf_lo'], tables['starts_wf'],
                *lines, fac['c1'], fac['y2'], fac['inv_ad'], spec]
        kw = dict(lmax=direct.lmax_wf, margin=direct.margin,
                  cutoff=direct.cutoff, nspec=direct.nspec)
    else:
        args = [tables['wn_core_hi'], tables['wn_core_lo'],
                tables['starts_core'], *lines, fac['scale'], fac['y'],
                fac['inv_ad'], spec]
        kw = dict(lmax=direct.lmax_core, margin=direct.margin,
                  nspec=direct.nspec)
    return args, kw


_LINE_KERNELS = {
    'wing': ('wing_sigma_lines_cuda', 'wing_sigma_lines_plain'),
    'core': ('core_sigma_lines_cuda', 'core_sigma_lines_plain'),
}


@pytest.mark.cuda
@pytest.mark.parametrize('ncell', [4, 21])
@pytest.mark.parametrize('nspec', [1, 2])
@pytest.mark.parametrize('kind', ['wing', 'core'])
def test_cuda_lbl_line_kernels_match_plain(cuda, kind, nspec, ncell):
    """K4 and K5 on per-line factors read by line range, one and two
    species, a cell count that is and one that is not a multiple of the
    kernels' cell tiles."""
    direct = DirectLBL(_lbl_lines(nspec), device=cuda)
    args, kw = _line_operands(direct, kind, ncell)
    cuda_fn, plain_fn = (getattr(lk, name) for name in _LINE_KERNELS[kind])
    launches = cuda_fn.launches
    got = cuda_fn(*args, **kw)
    want = plain_fn(*args, **kw)
    torch.cuda.synchronize()
    assert cuda_fn.launches == launches + 1
    assert got.shape == want.shape and got.shape[0] == ncell
    assert bool(torch.isfinite(got).all())
    assert _masked_rel(got, want) < LBL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['fine_grid', 'tile_wing_8', 'three_lines'])
def test_cuda_lbl_line_kernels_other_tilings(cuda, case):
    """A fine grid (whole warps inside one window, many warps: no split
    of the line range), 8-point sub-tiles (a warp spans two windows) and
    a list of three lines (every window is the whole padded array)."""
    if case == 'fine_grid':
        wn = np.linspace(7000.0, 7040.0, 40_000)
        direct = DirectLBL(synthetic_lines(wn, 1500, 0, 1), wn=wn,
                           device=cuda)
    elif case == 'tile_wing_8':
        direct = DirectLBL(_lbl_lines(1), device=cuda, tile_wing=8)
    else:
        import copy
        lines = copy.copy(_lbl_lines(1))
        for key in ('lwn', 'gf', 'elow', 'isoid'):
            setattr(lines, key, getattr(lines, key)[2000:2003])
        direct = DirectLBL(lines, device=cuda, margin=0.5)
    for kind in ('wing', 'core'):
        args, kw = _line_operands(direct, kind, 5)
        cuda_fn, plain_fn = (getattr(lk, n) for n in _LINE_KERNELS[kind])
        got = cuda_fn(*args, **kw)
        want = plain_fn(*args, **kw)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        assert _masked_rel(got, want) < LBL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize('fault', ['nlines', 'nspec', 'lmax', 'alignment',
                                   'no_spec'])
def test_cuda_lbl_line_wrappers_refuse_operands_beyond_limits(cuda, fault):
    """Operands that no instantiation takes raise ValueError before any
    launch: line arrays that are no multiple of LINE_ALIGN entries or
    not aligned to 16 bytes, more than MAX_SPEC species, several species
    without a species index, a window longer than the line array."""
    direct = DirectLBL(_lbl_lines(1, nlines=500), device=cuda)
    for kind in ('wing', 'core'):
        args, kw = _line_operands(direct, kind, 3)
        nlines = args[3].shape[0]
        if fault == 'nlines':
            args[3:8] = [t[..., :nlines - 1] for t in args[3:8]]
            kw['lmax'] = min(kw['lmax'], nlines - 1)
        elif fault == 'nspec':
            kw['nspec'] = lk.MAX_SPEC + 1
            args[8] = direct.tables()['l_spec']
        elif fault == 'no_spec':
            kw['nspec'] = 2
        elif fault == 'lmax':
            kw['lmax'] = nlines + 1
        else:
            cut = slice(1, nlines - lk.LINE_ALIGN + 1)
            args[3:8] = [t[..., cut] for t in args[3:8]]
            kw['lmax'] = min(kw['lmax'], nlines - lk.LINE_ALIGN)
        cuda_fn = getattr(lk, _LINE_KERNELS[kind][0])
        launches = cuda_fn.launches
        with pytest.raises(ValueError):
            cuda_fn(*args, **kw)
        assert cuda_fn.launches == launches


@pytest.mark.cuda
def test_cuda_lbl_engine_routes_to_kernels(cuda):
    """_cross_section_batch on CUDA launches K4 and K5 on per-line
    factors once each, and no window-layout kernel."""
    direct = DirectLBL(_lbl_lines(1, nlines=500), device=cuda)
    counters = (lk.wing_sigma_lines_cuda, lk.core_sigma_lines_cuda,
                lk.wing_sigma_grouped_cuda, lk.core_sigma_cuda,
                lk.wing_sigma_cuda)
    before = [c.launches for c in counters]
    out = direct._cross_section_batch(direct.tables(), *_lbl_cells(direct, 2))
    torch.cuda.synchronize()
    assert out.is_cuda and out.shape == (2, 1, direct.nwave)
    assert bool(torch.all(out >= 0))
    assert [c.launches for c in counters] == [
        before[0] + 1, before[1] + 1, *before[2:]]
    # The engine's result against the window-layout route's plain
    # versions (float32 on the card):
    want = direct._cross_section(
        direct.tables(), *(a[0] for a in _lbl_cells(direct, 2)))
    torch.cuda.synchronize()
    assert _masked_rel(out[0], want) < LBL_TOL


def _overflow_operands(case, nb, nlayers, nwave, seed, emission=False,
                       nk=10):
    """Operands beyond one of the kernels' limits (40 CIA rows, 6 rank-1
    terms, 5 dense parts, or 81 layers), as lists the forwards would
    make before the size rule; nk line-sample rows."""
    rng = np.random.default_rng(seed)
    lo = -28.0 if emission else -3.0
    scale = np.exp(np.linspace(0.0, 7.0, nlayers))[None, :, None]
    n_cia = 40 if case == 'cia40' else 15
    n_r1 = 6 if case == 'r1_6' else 2
    n_parts = 5 if case == 'parts5' else 1
    parts = [rng.lognormal(lo - 1.0, 1.5, (nb, nlayers, nwave)) * scale
             for _ in range(n_parts)]
    cia_w = rng.lognormal(lo, 0.5, (nb, nlayers, n_cia))
    cia_tab = rng.lognormal(-1.0, 1.0, (n_cia, nwave))
    r1c = rng.lognormal(lo, 1.0, (nb, n_r1, nlayers))
    r1r = rng.lognormal(-1.0, 1.0, (nb, n_r1, nwave))
    ls_w, ls_tab = _line_sample(nb, nlayers, nwave, nk, seed=seed + 1,
                                scale=3e-10 if emission else 1.0)
    return parts, cia_w, cia_tab, r1c, r1r, ls_w, ls_tab


def _fitted(case, nlayers, rt_path, f32, parts, cia_w, cia_tab, r1c, r1r,
            ls_w, ls_tab):
    """The plain version's operands (all of them, any count) and the
    kernel's (through the forwards' size rule for `rt_path`: above 64
    layers the emission kernel takes the line sample as a dense part)."""
    ls = dict(ls_w=f32(ls_w), ls_tab=f32(ls_tab))
    if not tk.ls_in_kernel(ls_w.shape[1], nlayers, rt_path):
        assert case == 'layers81' and rt_path == 'eclipse'
        parts = parts + [np.einsum('bkl,klw->blw', ls_w, ls_tab)]
        ls = dict(ls_w=None, ls_tab=None)
    full = dict(cia_w=f32(cia_w), cia_tab=f32(cia_tab), r1_cols=f32(r1c),
                r1_rows=f32(r1r), **ls)
    ec = [f32(p) for p in parts]
    fit = tk.fit_operands(ec, **full)
    assert len(fit['ec_parts']) <= tk.MAX_PARTS
    assert fit['r1_cols'].shape[1] <= tk.MAX_R1
    assert fit['cia_w'].shape[2] <= tk.MAX_CIA
    return (ec, full), (fit.pop('ec_parts'), fit)


@pytest.mark.cuda
@pytest.mark.parametrize('case,nlayers', [
    (case, nlayers) for case in ('cia40', 'r1_6', 'parts5')
    for nlayers in K1_LAYERS] + [('layers81', 81)])
def test_cuda_kernel_beyond_operand_limits(cuda, case, nlayers):
    """The transit kernel on operands that the size rule fitted, against
    the plain version on all of them: 40 CIA rows, 6 rank-1 terms and 5
    dense parts at every layer count of the tensor-core chord product up
    to 64 layers, and 81 layers (the tall function, the line sample in
    it).  Each launch counts as the tensor-core chord product's up to 64
    layers, and as the tall function's above."""
    nb, nwave = 37, 1000
    radius, _, _, _, _, _ = _operands(nb, nlayers, nwave, 1, 1, seed=21)
    raw = _overflow_operands(case, nb, nlayers, nwave, seed=22,
                             nk=10 if nlayers > 64 else _k1_ls_rows(nlayers))
    f32 = lambda a: torch.as_tensor(
        np.asarray(a), dtype=torch.float32, device=cuda)
    i64 = lambda a: torch.as_tensor(np.asarray(a), device=cuda)
    itop = np.minimum(np.arange(nb) % 3, nlayers - 2)
    deck_itop = np.maximum(nlayers - 1 - np.arange(nb) % 9, itop + 1)
    rsurf = radius[np.arange(nb), deck_itop] + 0.4 * (
        radius[np.arange(nb), deck_itop - 1]
        - radius[np.arange(nb), deck_itop])
    rr = f32(radius)
    operands = tk.prep_chains(
        transit_path_matrix(rr, i64(itop)), rr, 12.0, i64(itop),
        i64(deck_itop + 1), i64(deck_itop), f32(rsurf))
    (ec, full), (fit_ec, fit) = _fitted(case, nlayers, 'transit', f32,
                                        *raw)
    assert fit['ls_w'] is not None
    before = _k1_launches()
    got = tk.transit_rt_cuda(fit_ec, *operands, **fit, maxdepth=10.0)
    want = tk.transit_rt_plain(ec, *operands, **full, maxdepth=10.0)
    torch.cuda.synchronize()
    assert _k1_launches() == _k1_counted(before, nlayers)
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    assert np.all(np.isfinite(got))
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert np.max(np.abs(got - want) / scale) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['cia40', 'r1_6', 'parts5', 'layers81'])
def test_cuda_emission_kernel_beyond_operand_limits(cuda, case):
    """The emission kernel in the same four cases (it has no layer
    limit of its own: 81 layers only fewer warps a block)."""
    nb, nwave = 37, 1000
    nlayers = 81 if case == 'layers81' else 51
    radius, temp, _, wn, _, _, _, _ = _emission_operands(
        nb, nlayers, nwave, seed=23)
    raw = _overflow_operands(case, nb, nlayers, nwave, seed=24,
                             emission=True)
    f32 = lambda a: torch.as_tensor(
        np.asarray(a), dtype=torch.float32, device=cuda)
    i64 = lambda a: torch.as_tensor(np.asarray(a), device=cuda)
    mu = np.cos(np.deg2rad([0.0, 20.0, 40.0, 60.0, 80.0]))
    weights = np.full(5, np.pi / 5)
    itop = np.arange(nb) % 3
    deck_itop = nlayers - 1 - np.arange(nb) % 9
    operands = ek.prep_emission_chains(
        f32(radius), f32(temp), i64(itop), i64(deck_itop + 1),
        i64(deck_itop), f32(np.full(nb, 1600.0)))
    (ec, full), (fit_ec, fit) = _fitted(case, nlayers, 'eclipse', f32,
                                        *raw)
    launches = ek.emission_rt_cuda.launches
    got = ek.emission_rt_cuda(fit_ec, *operands, f32(wn), mu, weights, **fit,
                              maxdepth=10.0)
    want = ek.emission_rt_plain(ec, *operands, f32(wn), mu, weights, **full,
                                maxdepth=10.0)
    torch.cuda.synchronize()
    assert ek.emission_rt_cuda.launches == launches + 1
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    assert np.all(np.isfinite(got))
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert np.max(np.abs(got - want) / scale) < EMISSION_TOL


def _faulty_case(cuda, nlayers, line_sample, nb=6, nwave=200, seed=31):
    """Operands of the transit kernel and of its plain version: chain 0
    plain, 1 with a NaN and an inf in its dense part, 2 rejected (its top
    beyond the layers), 3 weak (depths below maxdepth, so that every row
    and the deck splice count), 4 without a deck, 5 with its top lowered
    by four layers; CIA, two rank-1 terms and, if `line_sample`, ls_w /
    ls_tab; the dense part not 16-byte aligned.  From 13 layers."""
    radius, parts, cia_tab, cia_w, r1c, r1r = _operands(
        nb, nlayers, nwave, ncia=15, nr1=2, seed=seed)
    parts = [parts[0]]
    ls_w, ls_tab = _line_sample(
        nb, nlayers, nwave, 10 if nlayers > 64 else _k1_ls_rows(nlayers),
        seed=seed + 1)
    for weights in (parts[0], cia_w, r1c, ls_w):
        weights[3] *= 1e-4
    parts[0][1, 5, 17] = np.nan
    parts[0][1, nlayers - 9, 40] = np.inf
    f32 = lambda a: torch.as_tensor(
        np.asarray(a), dtype=torch.float32, device=cuda)
    i64 = lambda a: torch.as_tensor(np.asarray(a), device=cuda)
    itop = np.array([0, 1, 10**6, 0, 2, 4])[:nb]
    deck_itop = np.maximum(nlayers - 1 - 5 * np.arange(nb), 6)
    deck_itop[3] = nlayers // 3
    ibottom = deck_itop + 1
    ibottom[4] = nlayers
    rsurf = radius[np.arange(nb), deck_itop] + 0.4 * (
        radius[np.arange(nb), deck_itop - 1]
        - radius[np.arange(nb), deck_itop])
    rr = f32(radius)
    path = transit_path_matrix(rr, i64(np.clip(itop, 0, nlayers - 1)))
    operands = tk.prep_chains(path, rr, 12.0, i64(itop), i64(ibottom),
                              i64(deck_itop), f32(rsurf))
    kw = dict(cia_w=f32(cia_w), cia_tab=f32(cia_tab), r1_cols=f32(r1c),
              r1_rows=f32(r1r), maxdepth=10.0)
    if line_sample:
        kw.update(ls_w=f32(ls_w), ls_tab=f32(ls_tab))
    # The dense part as a view 4 bytes into its storage (the kernel copies
    # it 4 bytes a lane, at any alignment):
    part = f32(parts[0])
    store = torch.empty(part.numel() + 1, dtype=part.dtype, device=cuda)
    store[1:] = part.reshape(-1)
    part = store[1:].view(part.shape)
    assert part.data_ptr() % 16 != 0
    return [part], operands, kw


def _rows_agree(got, want, tol):
    """Same non-finite entries, and the finite rows within `tol` of
    their maximum."""
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fine = np.where(np.isfinite(want), want, 0.0)
    scale = np.abs(fine).max(axis=1, keepdims=True)
    err = np.abs(np.where(np.isfinite(got), got, 0.0) - fine) / scale
    assert np.max(err) < tol


@pytest.mark.cuda
@pytest.mark.parametrize('line_sample', [True, False])
@pytest.mark.parametrize('nlayers', [65, 81, 100, 'largest'])
def test_cuda_tall_kernel_matches_plain(cuda, nlayers, line_sample):
    """The tall function against the plain version at 65, 81 and 100
    layers and at the most it takes with these operands, with the line
    sample in the kernel or none: a NaN and an inf in one chain's dense
    part stay in its columns, a rejected chain computes without
    faulting, and the deck splice of a weakly absorbing chain holds."""
    nwave = 200
    if nlayers == 'largest':
        nlayers = tk.tall_max_layers(2, 15, 10 if line_sample else 0, 1)
        assert nlayers > 1000
        nwave = 64
    ec, operands, kw = _faulty_case(cuda, nlayers, line_sample, nwave=nwave)
    launches = tk.transit_rt_cuda.tall_launches
    got = tk.transit_rt_cuda(ec, *operands, **kw)
    want = tk.transit_rt_plain(ec, *operands, **kw)
    torch.cuda.synchronize()
    assert tk.transit_rt_cuda.tall_launches == launches + 1
    assert not bool(torch.isfinite(got[1]).all())
    assert bool(torch.isfinite(got[[0, 2, 3, 4, 5]]).all())
    _rows_agree(got, want, TOL)


@pytest.mark.cuda
@pytest.mark.parametrize('line_sample', [True, False])
@pytest.mark.parametrize('nlayers', [13, 32, 51, 64])
def test_cuda_kernel_keeps_a_rejected_chain_apart(cuda, nlayers,
                                                  line_sample):
    """The tensor-core chord product up to 64 layers on the faulty
    chains: the NaN and the inf in one chain's dense part leave that
    chain non-finite and no other, the chain whose top lies beyond the
    layers computes without faulting, and every other chain matches the
    plain version."""
    ec, operands, kw = _faulty_case(cuda, nlayers, line_sample)
    before = _k1_launches()
    got = tk.transit_rt_cuda(ec, *operands, **kw)
    want = tk.transit_rt_plain(ec, *operands, **kw)
    torch.cuda.synchronize()
    assert _k1_launches() == _k1_counted(before, nlayers)
    assert not bool(torch.isfinite(got[1]).all())
    assert bool(torch.isfinite(got[[0, 2, 3, 4, 5]]).all())
    _rows_agree(got, want, TOL)


@pytest.mark.cuda
@pytest.mark.parametrize('nlayers', [51, 64, 81, 100, 'largest'])
def test_cuda_tall_kernel_keeps_float32_on_wide_range_operands(cuda,
                                                               nlayers):
    """The transit kernel's chord product runs on the tensor cores as
    three TF32 products a step, summed into the depths in float32 outside
    them, in both functions (up to 64 layers, and the tall one above).
    On operands whose extinction grows e^7 down the layers, with the line
    sample made a dense part beside two others (3 dense parts, 4 rank-1
    terms, 32 CIA rows), at 51, 64, 81 and 100 layers and at the most
    the tall function takes with these operands, it stays within a tenth
    of the bound: as close to the plain version as float32 sums in
    another order come, not the ~1e-3 of one TF32 product."""
    nb, nwave = 8, 640
    if nlayers == 'largest':
        nlayers = tk.tall_max_layers(4, 32, 0, 3)
        assert nlayers > 1000
        nwave = 64
    radius, parts, cia_tab, cia_w, r1c, r1r = _operands(
        nb, nlayers, nwave, ncia=32, nr1=4, seed=41)
    ls_w, ls_tab = _line_sample(nb, nlayers, nwave, 10, seed=42)
    parts.append(np.einsum('bkl,klw->blw', ls_w, ls_tab))
    f32 = lambda a: torch.as_tensor(
        np.asarray(a), dtype=torch.float32, device=cuda)
    i64 = lambda a: torch.as_tensor(np.asarray(a), device=cuda)
    itop = np.arange(nb) % 3
    deck_itop = nlayers - 1 - 3 * np.arange(nb)
    rsurf = radius[np.arange(nb), deck_itop] + 0.4 * (
        radius[np.arange(nb), deck_itop - 1]
        - radius[np.arange(nb), deck_itop])
    rr = f32(radius)
    operands = tk.prep_chains(
        transit_path_matrix(rr, i64(itop)), rr, 12.0, i64(itop),
        i64(deck_itop + 1), i64(deck_itop), f32(rsurf))
    kw = dict(cia_w=f32(cia_w), cia_tab=f32(cia_tab), r1_cols=f32(r1c),
              r1_rows=f32(r1r), maxdepth=10.0)
    ec = [f32(p) for p in parts]
    before = _k1_launches()
    got = tk.transit_rt_cuda(ec, *operands, **kw)
    want = tk.transit_rt_plain(ec, *operands, **kw)
    torch.cuda.synchronize()
    assert _k1_launches() == _k1_counted(before, nlayers)
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    assert np.all(np.isfinite(got))
    err = np.max(np.abs(got - want) / np.abs(want).max(axis=1, keepdims=True))
    print(f'transit kernel, {nlayers} layers, wide-range operands: '
          f'{err:.3g} of the row maximum')
    assert err < TOL / 10


@pytest.mark.cuda
def test_cuda_tall_kernel_refuses_beyond_shared_memory(cuda):
    """Above the layer count whose weights, layer columns and ring fit a
    block's shared memory the tall function raises, stating the limit,
    before any launch; the limit lies far above the 81 and 100 layers
    reference users run."""
    top = tk.tall_max_layers(1, 15, 0, 1)
    assert top > 1000
    assert tk.tall_max_layers(1, 15, 10, 1) < top
    nb, nlayers, nwave = 2, top + 1, 64
    radius, parts, cia_tab, cia_w, r1c, r1r = _operands(
        nb, nlayers, nwave, 15, 1, seed=25)
    f32 = lambda a: torch.as_tensor(
        np.asarray(a), dtype=torch.float32, device=cuda)
    rr = f32(radius)
    operands = tk.prep_chains(
        transit_path_matrix(rr), rr, 12.0,
        torch.zeros(nb, dtype=torch.int64, device=cuda),
        torch.full((nb,), nlayers, device=cuda))
    launches = tk.transit_rt_cuda.launches
    with pytest.raises(ValueError, match=f'at most {top} layers'):
        tk.transit_rt_cuda([f32(parts[0])], *operands, cia_w=f32(cia_w),
                           cia_tab=f32(cia_tab), r1_cols=f32(r1c),
                           r1_rows=f32(r1r))
    assert tk.transit_rt_cuda.launches == launches


@pytest.mark.cuda
def test_cuda_tall_kernel_chains_in_flight(cuda):
    """The tall function's occupancy at the 81-layer retrieval's operand
    counts (no dense part, one rank-1 term, 15 CIA rows, 10 line-sample
    rows): three blocks of two teams an SM, six chains; and at the
    spectrum path's (3 dense parts, 4 rank-1 terms, 32 CIA rows), whose
    larger ring leaves room for two blocks."""
    assert tk.chains_per_sm(81, 1, 15, 10, 0) >= 6
    assert tk.chains_per_sm(81, 4, 32, 0, 3) >= 4


@pytest.mark.cuda
def test_cuda_kernel_chains_in_flight(cuda):
    """Up to 64 layers, at the flagship's operand counts (no dense part,
    one rank-1 term, 15 CIA rows, 10 line-sample rows, 51 layers): one
    block of eight teams an SM beside the line-sample slab, eight
    chains."""
    assert tk.chains_per_sm(51, 1, 15, 10, 0) >= 8


@pytest.mark.cuda
@pytest.mark.parametrize('rt_path', ['transit', 'eclipse'])
def test_cuda_model_run_matches_plain_route(cuda, tmp_path, rt_path):
    """Model.run on the card (float32, one kernel launch) against the
    same model on the CPU (float64, the plain versions), the flagship at
    test size with Rayleigh, a gray cloud and the deck."""
    from pyratbay_tpu_torch.benchmark import make_flagship
    from pyratbay_tpu_torch.model import Model
    make_flagship(str(tmp_path), nlayers=21, wl_low=1.1, wl_high=1.3,
                  wnstep=4.0, device='cpu', rt_path=rt_path)
    cfg = tmp_path / 'flagship.cfg'
    text = cfg.read_text().replace(
        'clouds =', 'rayleigh = rayleigh_H2 rayleigh_He\nclouds =\n'
        '    ccsgray 0.0 -3.0 1.0')
    cfg.write_text(text)
    counter = (tk.transit_one_cuda if rt_path == 'transit'
               else ek.emission_rt_cuda)
    launches = counter.launches
    gpu = Model(str(cfg), device='cuda').run()
    torch.cuda.synchronize()
    assert counter.launches == launches + 1
    cpu = Model(str(cfg), device='cpu').run()
    got = gpu['spectrum'].double().cpu().numpy()
    want = cpu['spectrum'].numpy()
    assert np.all(np.isfinite(got))
    assert np.max(np.abs(got - want)) / np.abs(want).max() < 1e-4


@pytest.mark.cuda
def test_cuda_model_run_streams_a_deep_atmosphere(cuda, tmp_path):
    """Model.run on 300 layers, more than K2 holds in shared memory:
    one streamed launch on the card, whose spectrum equals the same
    model on the CPU (float64, the plain versions) within 1e-4."""
    from pyratbay_tpu_torch.benchmark import make_flagship
    from pyratbay_tpu_torch.model import Model
    make_flagship(str(tmp_path), nlayers=300, wl_low=1.1, wl_high=1.3,
                  wnstep=4.0, device='cpu', rt_path='transit')
    cfg = str(tmp_path / 'flagship.cfg')
    launches = tk.transit_one_cuda.launches
    streamed = tk.transit_one_cuda.streamed_launches
    gpu = Model(cfg, device='cuda').run()
    torch.cuda.synchronize()
    assert tk.transit_one_cuda.launches == launches + 1
    assert tk.transit_one_cuda.streamed_launches == streamed + 1
    cpu = Model(cfg, device='cpu').run()
    got = gpu['spectrum'].double().cpu().numpy()
    want = cpu['spectrum'].numpy()
    assert np.all(np.isfinite(got))
    assert np.max(np.abs(got - want)) / np.abs(want).max() < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize('rt_path', ['transit', 'eclipse'])
def test_cuda_spectrum_posterior_matches_cpu(cuda, rt_path, tmp_path):
    """The spectrum envelope of the retrieval's post-processing: 128
    draws in one batched forward (one K1 or K3 launch) on the card in
    float32, against the CPU in float64, within 1e-4 of the maximum."""
    from pyratbay_tpu_torch.benchmark import make_flagship
    from pyratbay_tpu_torch.retrieval.batched import build_forward_batched
    from pyratbay_tpu_torch.retrieval.posterior import spectrum_posterior

    envelopes = {}
    for dev in (cuda, 'cpu'):
        model, obs, ret, _, p0 = make_flagship(
            str(tmp_path / str(dev)), nlayers=21, wl_low=1.1, wl_high=1.3,
            wnstep=4.0, device=dev, rt_path=rt_path)
        rng = np.random.default_rng(5)
        draws = np.clip(p0 + 0.5 * ret.pstep * rng.standard_normal(
            (300, len(p0))), ret.pmin, ret.pmax)
        forward_b = build_forward_batched(model, obs, ret)
        counter = tk.transit_rt_cuda if rt_path == 'transit' \
            else ek.emission_rt_cuda
        launches = counter.launches
        envelopes[str(dev)] = np.array(spectrum_posterior(
            draws, lambda p: forward_b(p)['spectrum'], max_draws=128))
        if dev == cuda:
            assert counter.launches == launches + 1
    got, want = envelopes[str(cuda)], envelopes['cpu']
    assert np.all(np.isfinite(got)) and got.shape == want.shape
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert np.max(np.abs(got - want) / scale) < 1e-4


def _hires_file(path, wn, npoints, seed=4):
    """A high-res data file: points uniform in ln(wavelength) across the
    grid `wn` and beyond both its ends."""
    from pyratbay_tpu_torch.io import io as pio
    wl_lo, wl_hi = 1e4 / wn[-1], 1e4 / wn[0]
    wl = np.exp(np.linspace(np.log(wl_lo) - 2e-4, np.log(wl_hi) + 2e-4,
                            npoints))
    rng = np.random.default_rng(seed)
    pio.write_observations(path, 1.0 + 0.01 * rng.standard_normal(npoints),
                           np.full(npoints, 0.01),
                           [f'{w:.8f}' for w in wl])
    return path


@pytest.mark.cuda
def test_cuda_hires_forward_matches_cpu_float64(cuda, tmp_path):
    """The batched forward's high-res stage on the card in float32 (a
    retrieved rv_shift at -100 to 100 km/s) against the CPU in float64,
    within 1e-4 of the row maximum.  cuDNN's TF32, on by default, would
    round the spectra to 10 bits (~5e-4): building the forward turns it
    off."""
    from pyratbay_tpu_torch.benchmark import make_flagship
    from pyratbay_tpu_torch.observation import Observation
    from pyratbay_tpu_torch.retrieval.batched import build_forward_batched
    from pyratbay_tpu_torch.retrieval.params import RetrievalParams

    torch.backends.cudnn.allow_tf32 = True
    fluxes = {}
    for dev in (cuda, 'cpu'):
        workdir = tmp_path / str(dev)
        model, _, _, _, _ = make_flagship(
            str(workdir), nlayers=21, wl_low=1.1, wl_high=1.3, wnstep=0.5,
            device=dev, rt_path='eclipse')

        class Cfg:
            data = uncert = obsfile = dunits = filters = None
            offset_inst = uncert_scaling = None
            obsfile_hires = _hires_file(str(workdir / 'hires.dat'),
                                        model.wn, 3000)
            inst_resolution = 20000.0

        model.cfg.retrieval_params += '\n    rv_shift  0.0 -120.0 120.0 5.0'
        obs = Observation(Cfg, model.wn)
        ret = RetrievalParams(model, obs)
        forward_b = build_forward_batched(model, obs, ret)
        pb = np.tile(np.asarray(ret.params), (5, 1))
        pb[:, ret.irv] = [-100.0, -12.0, 0.0, 12.0, 100.0]
        fluxes[str(dev)] = forward_b(pb)['bandflux_hires'].double().cpu()
        if dev == cuda:
            assert not torch.backends.cudnn.allow_tf32
    got, want = fluxes[str(cuda)].numpy(), fluxes['cpu'].numpy()
    assert np.all(np.isfinite(got)) and got.shape == (5, 3000)
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert np.max(np.abs(got - want) / scale) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize('velocity', [-100.0, -12.0, 0.0, 12.0, 100.0])
def test_cuda_shifted_lerp_at_high_resolution(cuda, velocity):
    """The per-chain lerp on a 0.02 cm-1 grid near 6,300 cm-1: its
    indices on the card equal the CPU's (float64 positions), and the
    float32 result is np.interp's in float64 within 1e-6, points beyond
    the grid's ends included."""
    from pyratbay_tpu_torch.spectrum.hires import HiresStage, rv_shift
    wn = np.arange(5900.0, 6700.0, 0.02)
    wn_hires = np.exp(np.linspace(np.log(5899.0), np.log(6701.0), 16650))
    rng = np.random.default_rng(7)
    spectrum = 1.0 + 0.1 * np.sin(wn / 0.37) \
        + 0.01 * rng.standard_normal(len(wn))
    vel = torch.as_tensor([velocity * 1e5], dtype=torch.float64)
    stages = {dev: HiresStage(wn, wn_hires, np.ones(1), torch.device(dev),
                              dtype)
              for dev, dtype in (('cuda', torch.float32),
                                 ('cpu', torch.float64))}
    ilo_gpu, _ = stages['cuda'].shifted_lerp(vel.to(cuda))
    ilo_cpu, _ = stages['cpu'].shifted_lerp(vel)
    assert torch.equal(ilo_gpu.cpu(), ilo_cpu)
    got = stages['cuda'](
        torch.as_tensor(spectrum[None], dtype=torch.float32, device=cuda),
        vel.to(cuda)).double().cpu().numpy()[0]
    want = np.interp(wn_hires, rv_shift(velocity, wn=wn), spectrum)
    assert np.max(np.abs(got - want)) / np.abs(want).max() < 1e-6


@pytest.mark.cuda
def test_cuda_interp_sed_at_the_grid_ends(cuda):
    """_interp_sed on the card at, between and beyond the SED grid's
    temperatures against float64 on the CPU."""
    from pyratbay_tpu_torch.model import _interp_sed
    rng = np.random.default_rng(8)
    temps = np.linspace(5000.0, 6500.0, 7)
    fluxes = rng.uniform(1e5, 2e5, (7, 2000))
    tstar = np.array([4000.0, 5000.0, 5123.4, 6250.0, 6500.0, 9000.0])
    want = _interp_sed(torch.as_tensor(fluxes), torch.as_tensor(temps),
                       torch.as_tensor(tstar)).numpy()
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    got = _interp_sed(f32(fluxes), f32(temps), f32(tstar)).double().cpu()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_array_equal(want[0], fluxes[0])
    np.testing.assert_array_equal(want[-1], fluxes[-1])


# ----------------------------------------------------------------------
# Equilibrium chemistry (the float64 solve, one launch of
# csrc/chem_gibbs.cu) and two-stream emission (no kernel of its own: the
# two-stream recurrences on the card)

def _network(nlayers=51):
    from pyratbay_tpu_torch.atmosphere import chem
    press = np.logspace(-6, 2, nlayers)
    temp = np.linspace(600.0, 2800.0, nlayers)
    return chem, chem.Network(press, temp,
                              'H2 He H H2O CH4 CO CO2 Na K'.split())


def _chains(net, nb, seed):
    rng = np.random.default_rng(seed)
    nlayers = len(net.pressure)
    temps = net.temperature[None] + rng.uniform(-400.0, 400.0,
                                                (nb, nlayers))
    metal = rng.uniform(-1.0, 2.0, nb)
    ratio = rng.uniform(0.1, 1.5, nb)
    ic = list(net.elements).index('C')
    io = list(net.elements).index('O')
    return temps, metal, ratio, ic, io


@pytest.mark.cuda
@pytest.mark.parametrize('temp_dtype', [torch.float64, torch.float32])
def test_cuda_equilibrium_solve_matches_cpu(cuda, temp_dtype):
    """The float64 solve of 64 chains x 51 layers on the card against
    the same solve on the CPU (rtol 1e-10 on VMRs above 1e-30); the
    temperatures given in the forward's float32 or in float64."""
    chem, net = _network()
    temps, metal, ratio, ic, io = _chains(net, 64, seed=5)
    temps = torch.as_tensor(temps).to(temp_dtype).double()
    out = {}
    for dev in (cuda, torch.device('cpu')):
        fn = chem.equilibrium_fn(net, dev)
        on = lambda a: torch.as_tensor(a, device=dev)
        vmr = fn(temps.to(dev, temp_dtype), on(metal), None,
                 ((ic, io, on(ratio)),))
        assert vmr.dtype == torch.float64
        out[dev.type] = vmr.cpu().numpy()
    live = out['cpu'] > 1e-30
    np.testing.assert_allclose(out['cuda'][live], out['cpu'][live],
                               rtol=1e-10)
    np.testing.assert_allclose(out['cpu'].sum(axis=-1), 1.0, rtol=1e-12)


@pytest.mark.cuda
def test_cuda_equilibrium_solve_syncs_nothing(cuda):
    """The 152 Newton steps read no device value on the host: under
    torch's sync debug mode 'error' a synchronising call would raise (a
    prototype that does not see every synchronisation), and a
    torch.profiler trace of one solve holds no synchronising runtime call
    or scalar read beyond those of an empty trace (its runtime calls are
    recorded: kernel launches are there).  A timing behind a busy kernel
    cannot tell: ~9,500 launches fill the launch queue, which blocks the
    host as a synchronisation would."""
    from torch.profiler import ProfilerActivity, profile
    chem, net = _network()
    temps, metal, ratio, ic, io = _chains(net, 512, seed=6)
    fn = chem.equilibrium_fn(net, cuda)
    on = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    args = (on(temps), on(metal), None, ((ic, io, on(ratio)),))
    fn(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        vmr = fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(vmr).all()
    torch.cuda.synchronize()

    def synchronising_calls(work):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            work()
            torch.cuda.synchronize()
        calls = {evt.key: evt.count for evt in prof.key_averages()}
        return calls, {name: count for name, count in calls.items()
                       if 'Synchronize' in name or name in (
                           'aten::item', 'aten::_local_scalar_dense',
                           'cudaMemcpy', 'aten::nonzero')}

    # The profiler and the trailing synchronize add their own calls: a
    # trace of nothing but those is the baseline.
    _, baseline = synchronising_calls(lambda: None)
    calls, syncs = synchronising_calls(lambda: fn(*args))
    assert any('LaunchKernel' in name for name in calls), sorted(calls)
    assert syncs == baseline, (syncs, baseline)


# tests/test_chem.py's networks (tests/test_torch_chem.py _NETWORKS): the
# largest (20 species, 10 elements), ions with a charge column, and the
# rest.
_CHEM_NETWORKS = {
    'pcl_metals': (
        'H2 He H H2O CH4 CO PH3 PO P P2 HCl Cl NaCl KCl Na K Mg MgH Fe FeH',
        np.full(4, 1.0), np.array([500.0, 500.0, 2500.0, 2500.0]),
        'asplund_2021'),
    'cno': ('H2O CH4 CO CO2 NH3 HCN N2 H2 H He', np.logspace(-8, 3, 16),
            np.linspace(900.0, 2400.0, 16), 'asplund_2009'),
    'saha_ions': ('H2 He H Na Na+ K K+ e-', np.full(3, 1e-3),
                  np.array([2000.0, 2500.0, 3000.0]), 'asplund_2009'),
    'hydrides': ('H2 H He Fe FeH Ca CaH Cr CrH', np.logspace(-4, 1, 12),
                 np.full(12, 2000.0), 'asplund_2021'),
    'flagship_species': ('H2 He H H2O CH4 CO CO2 Na K',
                         np.logspace(-8, 2, 24),
                         np.linspace(400.0, 3500.0, 24), 'asplund_2021'),
}


def _assert_vmr_close(got, want, rtol=1e-10):
    live = want > 1e-30
    np.testing.assert_allclose(got[live], want[live], rtol=rtol)


@pytest.mark.cuda
def test_cuda_equilibrium_kernel_flagship_corners(cuda):
    """The solve kernel (one launch) against the plain float64 solve on
    the CPU, rtol 1e-10 on VMRs above 1e-30: the flagship network at
    B = 512 x 51 layers, temperatures drawn over 300-3000 K with eight
    chains on the ramps 300 -> 3000 K and back, [M/H] and C/O at the four
    corners of their priors ([-1, 2], [0.1, 1.5]) on those and drawn
    inside them on the rest; temperatures in float32 (the forward's) and
    float64."""
    from pyratbay_tpu_torch.atmosphere import chem
    chem_, net = _network()
    rng = np.random.default_rng(11)
    nb, nlayers = 512, len(net.pressure)
    temps = rng.uniform(300.0, 3000.0, (nb, nlayers))
    ramp = np.linspace(300.0, 3000.0, nlayers)
    metal = rng.uniform(-1.0, 2.0, nb)
    ratio = rng.uniform(0.1, 1.5, nb)
    for k, (m, c) in enumerate([(-1.0, 0.1), (-1.0, 1.5), (2.0, 0.1),
                                (2.0, 1.5)]):
        temps[2 * k], temps[2 * k + 1] = ramp, ramp[::-1]
        metal[2 * k:2 * k + 2], ratio[2 * k:2 * k + 2] = m, c
    ic = list(net.elements).index('C')
    io = list(net.elements).index('O')
    for dtype in (torch.float32, torch.float64):
        t = torch.as_tensor(temps).to(dtype)
        out = {}
        for dev in (cuda, torch.device('cpu')):
            on = lambda a: torch.as_tensor(a, device=dev)
            out[dev.type] = chem.equilibrium_fn(net, dev)(
                t.to(dev), on(metal), None,
                ((ic, io, on(ratio)),)).cpu().numpy()
        _assert_vmr_close(out['cuda'], out['cpu'])


@pytest.mark.cuda
@pytest.mark.parametrize('name', list(_CHEM_NETWORKS))
def test_cuda_equilibrium_kernel_networks(cuda, name):
    """The kernel on tests/test_chem.py's networks, ions included, both
    ways in: equilibrium_vmr on CUDA tensors (G/RT, ln p and b given per
    layer, with the overrides of tests/test_torch_chem.py) and
    equilibrium_fn on 8 chains with [M/H] and per-element dex offsets;
    rtol 1e-10 against the CPU."""
    from pyratbay_tpu_torch.atmosphere import chem
    species, press, temp, source = _CHEM_NETWORKS[name]
    net = chem.Network(press, temp, species.split(), e_source=source)
    b = net._element_b(0.7, {'He': 10.9}, {'H': 0.0}, {'C_O': 0.8})
    args = (net.gibbs_at(temp), np.log(press),
            np.broadcast_to(b, (len(press), len(b))).copy(),
            net._stoich_full)
    got, want = (chem.equilibrium_vmr(
        *[torch.as_tensor(a, device=dev) for a in args]).cpu().numpy()
        for dev in (cuda, torch.device('cpu')))
    _assert_vmr_close(got, want)
    rng = np.random.default_rng(3)
    nb = 8
    temps = temp[None] + rng.uniform(-300.0, 300.0, (nb, len(temp)))
    metal = rng.uniform(-1.0, 2.0, nb)
    escale = rng.uniform(-0.5, 0.5, (nb, len(net.elements)))
    out = {}
    for dev in (cuda, torch.device('cpu')):
        on = lambda a: torch.as_tensor(a, device=dev)
        out[dev.type] = chem.equilibrium_fn(net, dev)(
            on(temps), on(metal), on(escale)).cpu().numpy()
    _assert_vmr_close(out['cuda'], out['cpu'])


@pytest.mark.cuda
def test_cuda_equilibrium_solve_is_one_launch(cuda):
    """One solve of 512 chains x 51 layers, as a batched forward calls it
    (float32 temperatures, float64 [M/H] and C/O), is one launch, the
    solve kernel, by torch.profiler: one kernel launch and no copy or set
    among the host's runtime calls, and, where the profile recorded the
    device's work (late in a long process it may record none), that
    launch the solve kernel's; the wrapper counts the call once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from pyratbay_tpu_torch.atmosphere import chem
    chem_, net = _network()
    temps, metal, ratio, ic, io = _chains(net, 512, seed=9)
    fn = chem.equilibrium_fn(net, cuda)
    args = (torch.as_tensor(temps, dtype=torch.float32, device=cuda),
            torch.as_tensor(metal, device=cuda), None,
            ((ic, io, torch.as_tensor(ratio, device=cuda)),))
    fn(*args)
    torch.cuda.synchronize()
    launches = chem.equilibrium_cuda.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    assert chem.equilibrium_cuda.launches == launches + 1
    events = prof.key_averages()
    host = {e.key: e.count for e in events if e.device_type == DeviceType.CPU}
    assert sum(n for k, n in host.items() if 'LaunchKernel' in k) == 1, host
    assert not any('Memcpy' in k or 'Memset' in k for k in host), host
    device = [e for e in events if e.device_type != DeviceType.CPU]
    if device:
        assert sum(e.count for e in device) == 1, [e.key for e in device]
        assert 'chem_gibbs_kernel' in device[0].key


@pytest.mark.cuda
def test_cuda_equilibrium_kernel_size_limit(cuda):
    """A network above the kernel's sizes (every supported species: 72
    species, 21 element columns) raises ValueError naming the limit on
    the card; the CPU path takes it."""
    from pyratbay_tpu_torch.atmosphere import chem
    net = chem.Network(np.ones(2), np.full(2, 1500.0),
                       chem.supported_species())
    with pytest.raises(ValueError, match='CHEM_MAX_SPECIES'):
        chem.equilibrium_fn(net, cuda)
    g0 = torch.as_tensor(net.gibbs_at(net.temperature), device=cuda)
    with pytest.raises(ValueError, match='CHEM_MAX_SPECIES'):
        chem.equilibrium_vmr(g0, torch.zeros(2, device=cuda),
                             torch.as_tensor(net._element_b(0, {}, {}, {}),
                                             device=cuda),
                             torch.as_tensor(net._stoich_full, device=cuda))
    assert chem.equilibrium_fn(net, 'cpu')(
        torch.full((1, 2), 1500.0, dtype=torch.float64)).shape == (1, 2, 72)


@pytest.mark.cuda
def test_cuda_two_stream_float32_against_float64(cuda):
    """spectrum/rt.py two_stream over [64, 51, 3209] on the card in
    float32 against float64 on the CPU (relative to each column's
    largest flux; the emission bound, 1e-4), with layers of zero optical
    depth in one chain.  Both take the same float32-representable depths
    and temperatures: the layer depths are differences of the
    cumulative depth, and a float32 depth of ~20 carries layer depths of
    1e-5 to only a few digits whatever the code does with them."""
    from pyratbay_tpu_torch.ops.planck import blackbody_wn
    from pyratbay_tpu_torch.spectrum import rt
    rng = np.random.default_rng(7)
    nb, nlayers, nwave = 64, 51, 3209
    dtau = rng.lognormal(-3.0, 2.0, (nb, nlayers - 1, nwave))
    dtau[0, 10:14] = 0.0
    depth = np.concatenate([np.zeros((nb, 1, nwave)),
                            np.cumsum(dtau, axis=1)], axis=1)
    wn = np.linspace(5800.0, 9100.0, nwave)
    temp = np.linspace(900.0, 2200.0, nlayers)[None] \
        + rng.uniform(-100.0, 100.0, (nb, nlayers))
    depth, temp = (a.astype(np.float32).astype(float) for a in (depth, temp))
    fdown = rng.uniform(0.0, 1e4, nwave)
    out = {}
    for dev, dt in ((cuda, torch.float32), (torch.device('cpu'),
                                            torch.float64)):
        on = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
        bbody = blackbody_wn(on(wn), on(temp)[..., None])
        f_int = rt.internal_flux(on(wn), 100.0)
        up, down = rt.two_stream(on(depth), bbody, on(wn), on(fdown), f_int)
        out[dev.type] = (up.double().cpu().numpy(),
                         down.double().cpu().numpy())
    for got, want in zip(out['cuda'], out['cpu']):
        assert np.isfinite(got).all()
        scale = np.abs(want).max(axis=1, keepdims=True)
        assert np.max(np.abs(got - want) / scale) < EMISSION_TOL


# ----------------------------------------------------------------------
# The nested sampler and the line-by-line retrieval's engine

def _gauss_log_like(d):
    return lambda theta: (-0.5 * torch.sum(theta**2, dim=1)
                          - 0.5 * d * np.log(2 * np.pi))


@pytest.mark.cuda
def test_cuda_nested_gaussian_evidence(cuda):
    """Nested sampling on CUDA tensors (the state in float64, as the
    driver runs it): a unit Gaussian in a [-5, 5]^3 box has
    logZ = -3 ln 10, within 0.5 (tests/test_nested.py's bound)."""
    from pyratbay_tpu_torch.retrieval.nested import sample_nested
    d = 3
    res = sample_nested(
        _gauss_log_like(d), lambda u: 10.0 * u - 5.0, d, nlive=400,
        max_iter=6000, nsteps_walk=40,
        generator=torch.Generator(device=cuda).manual_seed(1),
        device=cuda, dtype=torch.float64)
    assert abs(res['logz'] + d * np.log(10.0)) < 0.5
    assert np.all(np.abs(res['posterior'].mean(axis=0)) < 0.15)
    assert res['n_iter'] > 1000 and 0.05 < res['efficiency'] < 0.95


@pytest.mark.cuda
def test_cuda_nested_scan_step_syncs_nothing(cuda):
    """One scan step (nlive = 400, 7 dimensions, 25 walkers x 25 walk
    steps, a float32 likelihood as the forward's) reads no device value
    on the host: under torch's sync debug mode 'error' a synchronising
    call would raise, and a torch.profiler trace of the step holds no
    synchronising runtime call or scalar read beyond those of an empty
    trace (tests: test_cuda_equilibrium_solve_syncs_nothing)."""
    from torch.profiler import ProfilerActivity, profile
    from pyratbay_tpu_torch.retrieval.nested import draw_step, scan_step
    nlive, ndim, batch, nsteps = 400, 7, 25, 25
    gen = torch.Generator(device=cuda).manual_seed(3)
    like32 = _gauss_log_like(ndim)

    def log_like(u):
        return like32((4.0 * u - 2.0).float()).double()

    live_u = torch.rand((nlive, ndim), generator=gen, dtype=torch.float64,
                        device=cuda)
    live_logl = log_like(live_u)
    scales = np.tile([1.0, 0.3, 0.1], 9)[:nsteps]
    draws = draw_step(gen, nlive, batch, ndim, nsteps, torch.float64, cuda)

    def step():
        return scan_step(log_like, live_u, live_logl, *draws, batch, scales)

    step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        out = step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(out[1]).all()
    torch.cuda.synchronize()

    def synchronising_calls(work):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            work()
            torch.cuda.synchronize()
        calls = {evt.key: evt.count for evt in prof.key_averages()}
        return calls, {name: count for name, count in calls.items()
                       if 'Synchronize' in name or name in (
                           'aten::item', 'aten::_local_scalar_dense',
                           'cudaMemcpy', 'aten::nonzero')}

    _, baseline = synchronising_calls(lambda: None)
    calls, syncs = synchronising_calls(step)
    assert any('LaunchKernel' in name for name in calls), sorted(calls)
    assert syncs == baseline, (syncs, baseline)


def _retrieval_cells(direct, nb, nlayers=51, seed=8):
    """Temperatures [nb, nlayers] and densities [nb, nlayers, 9] of nb
    chains on the flagship's pressures, as the batched forward gives
    them to extinction_fn."""
    rng = np.random.default_rng(seed)
    temps = rng.uniform(400.0, 2800.0, (nb, 1)) + np.linspace(
        -200.0, 200.0, nlayers)[None]
    vmr = np.array([0.85, 0.149, 1e-6, 3e-6, 5e-8, 4e-4, 1e-4, 5e-4, 1e-7])
    dens = vmr * (np.logspace(-6, 2, nlayers)[None, :, None] * 1e6
                  / (1.380649e-16 * temps[..., None]))
    on = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                   device=direct.device)
    return on(temps), on(dens)


@pytest.mark.cuda
def test_cuda_extinction_fn_budget_block_matches_64(cuda):
    """extinction_fn at the budget block (50,000 lines: ~1,800 cells a
    pass) against 64-cell passes, on 40 chains x 51 layers (2,040 cells:
    two budget passes), within the line-by-line bound: a launch of fewer
    cells splits the wing windows over four warps, another order of the
    float32 sums."""
    direct = DirectLBL(_lbl_lines(1, nlines=50_000), device=cuda)
    temp, dens = _retrieval_cells(direct, 40)
    assert 1_000 < direct.factor_block() < temp.numel()
    launches = lk.wing_sigma_lines_cuda.launches
    got = direct.extinction_fn()(temp, dens)
    torch.cuda.synchronize()
    assert lk.wing_sigma_lines_cuda.launches == launches + 2
    want = direct.extinction_fn(block=64)(temp, dens)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (40, 51, direct.nwave)
    assert bool(torch.isfinite(got).all()) and bool((got >= 0).all())
    assert _masked_rel(got, want) < LBL_TOL


@pytest.mark.parametrize('kind', ['wing', 'core'])
@pytest.mark.cuda
def test_cuda_lbl_line_kernels_at_retrieval_block(cuda, kind):
    """K4 and K5 on per-line factors against their plain versions on a
    block of the size a retrieval's forward takes (the budget block of
    50,000 lines, ~1,800 cells)."""
    direct = DirectLBL(_lbl_lines(1, nlines=50_000), device=cuda)
    block = direct.factor_block()
    args, kw = _line_operands(direct, kind, block)
    cuda_fn, plain_fn = (getattr(lk, name) for name in _LINE_KERNELS[kind])
    got = cuda_fn(*args, **kw)
    want = plain_fn(*args, **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.shape[0] == block
    assert bool(torch.isfinite(got).all())
    assert _masked_rel(got, want) < LBL_TOL


def _row_rel(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    scale = want.abs().amax(dim=1, keepdim=True)
    return float(((got - want).abs() / scale).max())


@pytest.mark.cuda
@pytest.mark.parametrize('rank', [0, 1])
def test_cuda_kernel_on_a_wave_window_matches_plain(cuda, tmp_path, rank):
    """K1 on the operands of a wave-sharded forward (the flagship at test
    size, wnstep 3: 467 columns, rank 1's window ends with the padded
    one) against its plain version on the same float32 operands, moved
    to the CPU.  One process: the ranks' windows come from meshes
    without a group."""
    from pyratbay_tpu_torch import model as model_mod
    from pyratbay_tpu_torch.benchmark import make_flagship
    from pyratbay_tpu_torch.parallel import sharded
    from pyratbay_tpu_torch.retrieval.batched import build_forward_batched
    model, obs, ret, _, p0 = make_flagship(
        str(tmp_path), nlayers=21, wl_low=1.1, wl_high=1.3, wnstep=3.0,
        device='cuda')
    mesh = sharded.Mesh((1, 2))
    mesh.coords['wave'] = rank
    sharded.shard_model_tables(model, obs, mesh)
    calls = []
    real = model_mod.transit_spectrum_ensemble

    def record(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    rng = np.random.default_rng(4)
    params = np.tile(p0, (16, 1)) + 0.01 * rng.standard_normal(
        (16, len(p0)))
    model_mod.transit_spectrum_ensemble = record
    try:
        launches = tk.transit_rt_cuda.launches
        with torch.no_grad():
            spec = build_forward_batched(model, obs, ret)(params)['spectrum']
        torch.cuda.synchronize()
    finally:
        model_mod.transit_spectrum_ensemble = real
    assert tk.transit_rt_cuda.launches == launches + 1
    assert spec.shape == (16, 234)
    args, kw = calls[-1]
    to_cpu = lambda v: v.cpu() if torch.is_tensor(v) else (
        [p.cpu() for p in v] if isinstance(v, list) else v)
    got = real(*args, **kw)
    want = real(*[to_cpu(a) for a in args],
                **{k: to_cpu(v) for k, v in kw.items()})
    assert _row_rel(got, want) < TOL


@pytest.mark.cuda
def test_cuda_two_ranks_share_the_card(cuda):
    """mp_probe's group of two ranks on one card: gloo (NCCL refuses two
    ranks on one device), the wave-sharded flagship's DEMC on the card."""
    import json
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, '-m', 'pyratbay_tpu_torch.parallel.mp_probe',
         '--nprocs', '2', '--iters', '3', '--timeout', '300'],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
        capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line['backend'] == 'gloo' and line['device'].startswith('cuda')
    assert line['mesh'] == [1, 2] and line['sec_per_generation'] > 0


# The Guillot temperature profile in one launch (csrc/guillot_tp.cu),
# float64 arithmetic whatever the dtype: against the plain float64 version
# on the CPU to 1e-12 in float64, and in float32 within one float32 ulp
# (its one rounding).

def _guillot_params(n, seed):
    """n rows inside and at the ends of the flagship's priors and beyond
    (tau = kappa' pb from ~1e-12 to ~1e5, both E_1 branches; alpha 0 and
    1; T_int 0), each row's six values followed by two columns that the
    profile does not read."""
    rng = np.random.default_rng(seed)
    params = np.column_stack([
        rng.uniform(-7.0, 0.0, n), rng.uniform(-3.0, 1.5, n),
        rng.uniform(-3.0, 1.5, n), rng.uniform(0.0, 1.0, n),
        rng.uniform(300.0, 3000.0, n), rng.uniform(0.0, 300.0, n),
        rng.normal(size=(n, 2))])
    params[:4, 3] = [0.0, 1.0, 0.0, 1.0]
    params[4:6, 5] = 0.0
    return params


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float64', 'float32'])
@pytest.mark.parametrize('gravity', ['none', 'layers'])
def test_cuda_guillot_kernel_matches_plain(cuda, dtype, gravity):
    """The profile of 512 chains x 51 layers, the parameters a column
    slice of a wider tensor (as a retrieval's chains hold them), equals
    the plain float64 profile on the CPU; a single row [6] and leading
    dimensions [2, 3] take the same path.  The plain version reads the
    same parameters (float32 ones exactly, in float64)."""
    from pyratbay_tpu_torch.atmosphere import profiles
    press = profiles.pressure(1e-6, 100.0, 51)
    grav = None if gravity == 'none' else np.linspace(700.0, 1400.0, 51)
    fn = profiles.guillot_tp(press, grav)
    dt = getattr(torch, dtype)
    wide = torch.as_tensor(_guillot_params(512, seed=21), dtype=dt)
    want = fn(wide[:, :6].double()).numpy()
    wide = wide.to(cuda)
    launches = profiles.guillot_cuda.launches
    got = fn(wide[:, :6])
    assert profiles.guillot_cuda.launches == launches + 1
    assert got.dtype == dt and got.shape == (512, 51)
    rtol = 1e-12 if dtype == 'float64' else 2.0**-23
    np.testing.assert_allclose(got.cpu().double().numpy(), want, rtol=rtol,
                               atol=0)
    one = fn(wide[7, :6]).cpu().double().numpy()
    np.testing.assert_allclose(one, want[7], rtol=rtol, atol=0)
    lead = fn(wide[:6, :6].reshape(2, 3, 6)).cpu().double().numpy()
    np.testing.assert_allclose(lead, want[:6].reshape(2, 3, 51), rtol=rtol,
                               atol=0)


@pytest.mark.cuda
def test_cuda_guillot_profile_is_one_launch(cuda):
    """A batched forward's profile (512 chains, float32) is one kernel
    launch and no copy or set by torch.profiler, and, where the profile
    recorded the device's work, that launch the profile kernel's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from pyratbay_tpu_torch.atmosphere import profiles
    fn = profiles.guillot_tp(profiles.pressure(1e-6, 100.0, 51))
    params = torch.as_tensor(_guillot_params(512, seed=22)[:, :6],
                             dtype=torch.float32, device=cuda)
    fn(params)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(params)
        torch.cuda.synchronize()
    events = prof.key_averages()
    host = {e.key: e.count for e in events if e.device_type == DeviceType.CPU}
    assert sum(n for k, n in host.items() if 'LaunchKernel' in k) == 1, host
    assert not any('Memcpy' in k or 'Memset' in k for k in host), host
    device = [e for e in events if e.device_type != DeviceType.CPU]
    if device:
        assert sum(e.count for e in device) == 1, [e.key for e in device]
        assert 'guillot_tp_kernel' in device[0].key


@pytest.mark.cuda
def test_cuda_guillot_kernel_refuses_what_it_cannot_read(cuda):
    """float16 parameters raise TypeError, fewer than six a row
    ValueError; a CPU tensor is not the kernel's."""
    from pyratbay_tpu_torch.atmosphere import profiles
    pb = torch.ones(5, device=cuda)
    with pytest.raises(TypeError, match='float32 or float64'):
        profiles.guillot_cuda(torch.ones((2, 6), dtype=torch.float16,
                                         device=cuda), pb)
    with pytest.raises(ValueError, match='6 parameters'):
        profiles.guillot_cuda(torch.ones((2, 5), device=cuda), pb)
    with pytest.raises(TypeError, match='CUDA'):
        profiles.guillot_cuda(torch.ones((2, 6)), pb.cpu())
