"""The per-line route of the direct line-by-line engine, float64 on the
CPU: per-cell line factors once per line ([ncell, nlines_pad]) and the
wing and core passes that read them by line range (window starts),
against the window layout ([ncell, ntiles, lmax]) and the JAX package.

* line_tables: the padded per-line host tables are the window tables
  read back through the starts; `l_kmask` is the union of the fine-wing
  and core windows; the JAX engine's host attributes give the same
  tables (convert.direct_lbl_tables).
* _line_factors against _cell_factors(..., 'wf_') gathered by the
  starts: rtol 1e-12 (the same elementwise arithmetic), kmax exact.
* wing_sigma_lines_plain / core_sigma_lines_plain against the
  window-layout plain versions: rtol 1e-12 on entries above 1e-6 of the
  maximum (the same terms; the sums may run in another order).
* _cross_section_batch, extinction_fn and tabulate of engines whose
  windows are shifted at both ends of the grid, of an engine with fewer
  lines than one window holds, and of two species, against the JAX
  engine at the bound of tests/test_torch_lbl.py (1e-10; the Pallas
  kernels in interpret mode for one case).
* The main path makes no window-layout factor tensor.

Engines: 'mid' has its lines in the middle third of the grid, so the
windows of the tiles at both ends are shifted (clipped starts); 'few'
has 3 lines (every window is the whole padded array); 'none' has no
line at all (nlines < lmax: the array is fake lines only).
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

from pyratbay_tpu.opacity.lbl_tpu import DirectLBL as JDirectLBL  # noqa: E402
from pyratbay_tpu_torch import benchmark, convert  # noqa: E402
from pyratbay_tpu_torch.opacity import lbl_direct  # noqa: E402
from pyratbay_tpu_torch.opacity import lbl_kernel as lk  # noqa: E402
from pyratbay_tpu_torch.opacity.lbl_direct import DirectLBL  # noqa: E402

RTOL_LAYOUT = 1e-12   # the same terms in float64, summed in another order
RTOL = 1e-10          # against the JAX engine (tests/test_torch_lbl.py)
VMR = np.array([0.85, 0.149, 1e-6, 3e-6, 5e-8, 4e-4, 1e-4, 5e-4, 1e-7])
WN = np.arange(7000.0, 7600.0, 1.0)
CASES = ['one_species', 'two_species', 'mid', 'few', 'none']


def masked_rel(got, want, floor=1e-6):
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape
    if not np.any(want):
        return float(np.abs(got).max())
    mask = np.abs(want) > floor * np.abs(want).max()
    return float(np.max(np.abs(got[mask] - want[mask]) / np.abs(want[mask])))


def make_lines(case):
    """(line list, engine keywords) of a case."""
    if case == 'two_species':
        return benchmark.synthetic_lines(WN, 2500, 1, 2), {}
    if case == 'mid':
        # Lines on 7200-7400 cm-1 only, under the whole grid:
        lines = benchmark.synthetic_lines(WN[200:400], 1500, 2, 1)
        lines.wn = WN
        return lines, dict(tile_wing=16)
    lines = benchmark.synthetic_lines(WN, 3000, 0, 1)
    if case in ('few', 'none'):
        lines = copy.copy(lines)
        keep = slice(1000, 1003) if case == 'few' else slice(0, 0)
        for key in ('lwn', 'gf', 'elow', 'isoid'):
            setattr(lines, key, getattr(lines, key)[keep])
        # No line, no Doppler bound: the split distance is given.
        return lines, dict(margin=0.5)
    return lines, {}


@pytest.fixture(scope='module')
def engines():
    cache = {}

    def get(case):
        if case not in cache:
            lines, kw = make_lines(case)
            cache[case] = DirectLBL(lines, device='cpu', **kw)
        return cache[case]
    return get


def cells(direct, ncell=3, seed=3):
    """Float32-rounded cell inputs as float64 tensors."""
    rng = np.random.default_rng(seed)
    temps = np.sort(rng.uniform(400.0, 2900.0, ncell))
    press = np.logspace(-4, 1, ncell)
    dens = VMR[None, :] * (press[:, None] * 1.01e6
                           / (1.380649e-16 * temps[:, None]))
    pf = direct.lbl.iso_pf(temps).T
    return [torch.as_tensor(np.asarray(a, np.float32).astype(np.float64))
            for a in (temps, dens, pf)]


@pytest.mark.parametrize('case', CASES)
def test_line_tables_are_the_windows(engines, case):
    direct = engines(case)
    host = direct._tables
    npad = len(host['l_lwn_hi'])
    assert npad % lk.LINE_ALIGN == 0
    assert npad >= max(direct.nlines, direct.lmax_wf, direct.lmax_core)
    union = np.zeros(npad, bool)
    for pre, starts, lmax in (('wf_', direct.starts_wf, direct.lmax_wf),
                              ('c_', direct.starts_core, direct.lmax_core)):
        idx = starts[:, None].astype(np.int64) + np.arange(lmax)[None, :]
        assert idx.max() < npad
        union[idx] = True
        for key in ('lwn_hi', 'lwn_lo', 'logkb', 'elow', 'iso', 'inv_dop',
                    'spec'):
            np.testing.assert_array_equal(
                host['l_' + key][idx], host[pre + key], pre + key)
    np.testing.assert_array_equal(host['l_kmask'], union)
    np.testing.assert_array_equal(host['starts_wf'], direct.starts_wf)
    np.testing.assert_array_equal(host['starts_core'], direct.starts_core)
    tables = direct.tables()
    assert tables['starts_wf'].dtype == tables['starts_core'].dtype \
        == tables['l_spec'].dtype == torch.int32
    assert tables['l_kmask'].dtype == torch.bool
    if case == 'mid':
        # Shifted windows at both ends of the grid:
        assert direct.starts_wf[0] == direct.starts_wf[1] == 0
        assert direct.starts_wf[-1] == direct.starts_wf[-2] \
            == direct.nlines - direct.lmax_wf
    if case == 'none':
        assert direct.nlines == 0 < direct.lmax_wf


@pytest.mark.parametrize('case', CASES)
def test_line_factors_equal_window_factors(engines, case):
    direct = engines(case)
    tables = direct.tables()
    args = cells(direct)
    line = direct._line_factors(tables, *args)
    window = direct._cell_factors(tables, *args, 'wf_')
    assert torch.equal(line['kmax'], window['kmax'])
    ncell, npad = line['c1'].shape
    assert (ncell, npad) == (3, len(direct._tables['l_lwn_hi']))
    for starts, lmax, keys in (
            (tables['starts_wf'], direct.lmax_wf,
             {'c1': 'c1_w', 'y2': 'y2_w', 'inv_ad': 'inv_ad_w'}),
            (tables['starts_core'], direct.lmax_core,
             {'scale': 'scale_c', 'y': 'y_c', 'inv_ad': 'inv_ad_c'})):
        idx = starts[:, None].long() + torch.arange(lmax)[None, :]
        for lkey, wkey in keys.items():
            got, want = line[lkey][:, idx], window[wkey]
            assert got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=RTOL_LAYOUT, atol=0, err_msg=lkey)


def _pass_operands(direct, kind):
    """(per-line operands, window-layout operands, keywords) of a pass
    over 3 cells."""
    tables = direct.tables()
    args = cells(direct)
    line = direct._line_factors(tables, *args)
    window = direct._cell_factors(tables, *args, 'wf_')
    nspec = direct.nspec
    multi = nspec > 1
    if kind == 'wing':
        tiles, pre, starts, lmax = 'wn_wf', 'wf_', 'starts_wf', direct.lmax_wf
        lkeys, wkeys = ('c1', 'y2', 'inv_ad'), ('c1_w', 'y2_w', 'inv_ad_w')
        kw = dict(margin=direct.margin, cutoff=direct.cutoff, nspec=nspec)
    else:
        tiles, pre, starts, lmax = ('wn_core', 'c_', 'starts_core',
                                    direct.lmax_core)
        lkeys, wkeys = ('scale', 'y', 'inv_ad'), ('scale_c', 'y_c',
                                                  'inv_ad_c')
        kw = dict(margin=direct.margin, nspec=nspec)
    wn = [tables[tiles + '_hi'], tables[tiles + '_lo']]
    by_line = wn + [tables[starts], tables['l_lwn_hi'], tables['l_lwn_lo'],
                    *[line[k] for k in lkeys],
                    tables['l_spec'] if multi else None]
    by_window = wn + [tables[pre + 'lwn_hi'], tables[pre + 'lwn_lo'],
                      *[window[k] for k in wkeys],
                      tables[pre + 'spec'] if multi else None]
    return by_line, by_window, kw, lmax


@pytest.mark.parametrize('case', CASES)
@pytest.mark.parametrize('kind', ['wing', 'core'])
def test_line_passes_equal_window_passes(engines, kind, case):
    direct = engines(case)
    by_line, by_window, kw, lmax = _pass_operands(direct, kind)
    if kind == 'wing':
        plain, wrapper = lk.wing_sigma_lines_plain, lk.wing_sigma_lines
        want = lk.wing_sigma_grouped_plain(*by_window, **kw)
    else:
        plain, wrapper = lk.core_sigma_lines_plain, lk.core_sigma_lines
        want = lk.core_sigma_plain(*by_window, **kw)
    got = plain(*by_line, lmax=lmax, **kw)
    assert got.shape == want.shape
    assert (got.dim() == 4) == (direct.nspec > 1)
    assert masked_rel(got.numpy(), want.numpy()) < RTOL_LAYOUT
    if case in ('one_species', 'two_species', 'mid'):
        assert float(want.abs().max()) > 0
    # The public wrapper takes the plain version for CPU tensors:
    assert torch.equal(wrapper(*by_line, lmax=lmax, **kw), got)


def test_line_plain_versions_chunk_their_tiles(engines, monkeypatch):
    """A small pair budget makes the plain versions gather the windows a
    few tiles at a time: the result does not change."""
    direct = engines('one_species')
    for kind, plain in (('wing', lk.wing_sigma_lines_plain),
                        ('core', lk.core_sigma_lines_plain)):
        by_line, _, kw, lmax = _pass_operands(direct, kind)
        whole = plain(*by_line, lmax=lmax, **kw)
        monkeypatch.setattr(lk, '_PAIR_BUDGET', 1 << 12)
        ntiles, tile = by_line[0].shape
        assert len(lk._tile_chunks(3, ntiles, tile, lmax)) > 1
        assert torch.equal(plain(*by_line, lmax=lmax, **kw), whole)
        monkeypatch.undo()


@pytest.mark.parametrize('case', CASES)
def test_cross_section_batch_matches_jax(engines, case):
    direct = engines(case)
    lines, kw = make_lines(case)
    # The Pallas kernels in interpret mode for the shifted-window case,
    # the XLA path otherwise:
    jdirect = JDirectLBL(
        lines, use_pallas='interpret' if case == 'mid' else False, **kw)
    assert jdirect.lmax_wf == direct.lmax_wf
    np.testing.assert_array_equal(jdirect.starts_wf, direct.starts_wf)
    args = cells(direct)
    got = direct._cross_section_batch(direct.tables(), *args).numpy()
    want = np.asarray(jdirect._cross_section_batch(
        jdirect.tables(), *(jnp.asarray(a.numpy()) for a in args)))
    assert got.shape == want.shape == (3, direct.nspec, direct.nwave)
    assert masked_rel(got, want) < RTOL
    if case == 'none':
        assert not np.any(got)
    else:
        assert np.all(np.isfinite(got)) and got.max() > 0
    # The JAX engine's host tables and attributes give the same result:
    jtables = convert.direct_lbl_tables(jdirect, 'cpu')
    assert torch.equal(
        direct._cross_section_batch(jtables, *args), torch.as_tensor(got))


@pytest.mark.parametrize('case', ['mid', 'two_species'])
def test_tabulate_and_extinction_match_jax(engines, case):
    import jax
    direct = engines(case)
    lines, kw = make_lines(case)
    jdirect = JDirectLBL(lines, use_pallas=False, **kw)
    press = np.logspace(-4, 1, 3)
    temps = np.array([700.0, 2100.0])
    vmr = np.tile(VMR, (3, 1))
    # block = 4 leaves a ragged last block (6 cells):
    got = direct.tabulate(temps, press, vmr, block=4)
    want = jdirect.tabulate(temps, press, vmr, block=4)
    assert got.shape == want.shape
    assert masked_rel(got, want) < 1e-6     # XLA's float32 folding under jit
    t2, d2, _ = (a.numpy() for a in cells(direct))
    t2, d2 = np.stack([t2, t2 + 40.0]), np.stack([d2, 0.9 * d2])
    got = direct.extinction_fn(block=4)(
        torch.as_tensor(t2), torch.as_tensor(d2)).numpy()
    want = np.asarray(jax.vmap(jdirect.extinction_fn())(
        jnp.asarray(t2), jnp.asarray(d2)))
    assert masked_rel(got, want) < RTOL


def test_main_path_makes_no_window_layout_factors(engines, monkeypatch):
    """_cross_section_batch, tabulate and extinction_fn compute the
    factors once per line: the window-layout functions are not called."""
    direct = engines('one_species')

    def refuse(*args, **kwargs):
        raise AssertionError('a window-layout factor tensor was made')

    monkeypatch.setattr(DirectLBL, '_cell_factors', refuse)
    monkeypatch.setattr(DirectLBL, '_window_factors', refuse)
    shapes = []
    real = DirectLBL._line_factors

    def record(self, *args):
        fac = real(self, *args)
        shapes.extend(tuple(v.shape) for k, v in fac.items() if k != 'kmax')
        return fac

    monkeypatch.setattr(DirectLBL, '_line_factors', record)
    args = cells(direct)
    direct._cross_section_batch(direct.tables(), *args)
    direct.tabulate(np.array([500.0, 900.0]), np.logspace(-3, 0, 2),
                    np.tile(VMR, (2, 1)), block=3)
    direct.extinction_fn(block=2)(args[0][None], args[1][None])
    npad = len(direct._tables['l_lwn_hi'])
    assert shapes and all(s[1:] == (npad,) and len(s) == 2 for s in shapes)


def test_line_tables_is_exported():
    assert 'line_tables' in lbl_direct.__all__
    assert {'wing_sigma_lines', 'core_sigma_lines',
            'wing_sigma_lines_cuda', 'core_sigma_lines_cuda'} <= set(
                lk.__all__)
    assert lk.wing_sigma_lines_cuda.launches == 0
    assert lk.core_sigma_lines_cuda.launches == 0
