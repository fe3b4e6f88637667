"""The line-lists-to-opacity-table slice of the port against
pyratbay_tpu, float64 on the CPU.

* TLI: the port's make_tli writes a file byte-identical to the JAX
  package's from the same synthetic HITRAN list; read_tli, tips, the
  isotope tables and LineByLine's host setup are equal.
* DirectLBL host setup: margin, tilings and every host table equal
  (np.array_equal); the species one-hots become species indices.
* The plain versions of K4 (wing_sigma_grouped), K5 (core_sigma) and K6
  (wing_sigma) against the Pallas kernels in interpret mode, one and two
  species, at rtol 1e-10 on entries above 1e-6 of the maximum (the
  masked relative of tests/test_lbl_pallas.py).
* _cross_section_batch, _cross_section, cross_section, extinction_fn,
  tabulate and Model.compute_opacity(engine='direct') against the JAX
  engine, end to end, at the same bound and mask.  The JAX engine rounds
  the cell inputs to float32 and keeps the float32 parts of its
  arithmetic in float32 (the Lorentz prefactor, sqrt(T), log(pf)); the
  port is fed the same rounded inputs and rounds at the same places.
  Under jit, XLA folds the float32 constant chain of the Lorentz
  prefactor differently from its eager evaluation (one float32 ulp,
  up to 2e-7 in a table): the port is held at 1e-10 to the engine's
  eager evaluation of the same cells, and at 1e-6 to its jitted entry
  points (cross_section, tabulate, compute_opacity).
* The two runmode = opacity faults of the port's Model (the table to be
  written was read as an input), and the parts still to be ported.

The CUDA kernels themselves run only on a GPU: tests/test_torch_cuda.py
holds them against these plain versions there.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pyratbay_tpu import data as jdata  # noqa: E402
from pyratbay_tpu.model import Model as JModel  # noqa: E402
from pyratbay_tpu.opacity import lbl_pallas as jpallas  # noqa: E402
from pyratbay_tpu.opacity import partitions as jpartitions  # noqa: E402
from pyratbay_tpu.opacity.lbl_tpu import DirectLBL as JDirectLBL  # noqa: E402
from pyratbay_tpu.opacity.tli import make_tli as jmake_tli  # noqa: E402
from pyratbay_tpu.opacity.tli import read_tli as jread_tli  # noqa: E402
from pyratbay_tpu_torch import benchmark, convert, data  # noqa: E402
from pyratbay_tpu_torch.driver import run  # noqa: E402
from pyratbay_tpu_torch.io import io as pio  # noqa: E402
from pyratbay_tpu_torch.model import Model  # noqa: E402
from pyratbay_tpu_torch.opacity import lbl_kernel as lk  # noqa: E402
from pyratbay_tpu_torch.opacity import partitions  # noqa: E402
from pyratbay_tpu_torch.opacity.lbl_direct import DirectLBL  # noqa: E402
from pyratbay_tpu_torch.opacity.line_sample import LineSample  # noqa: E402
from pyratbay_tpu_torch.opacity.linelists import get_linelist_reader  # noqa: E402
from pyratbay_tpu_torch.opacity.tli import read_tli  # noqa: E402
from pyratbay_tpu_torch.retrieval.batched import (  # noqa: E402
    build_forward_batched,
)

RTOL = 1e-10
RTOL_JIT = 1e-6     # XLA's float32 folding in the JAX jitted entries
VMR = np.array([0.85, 0.149, 1e-6, 3e-6, 5e-8, 4e-4, 1e-4, 5e-4, 1e-7])


def masked_rel(got, want, floor=1e-6):
    """Largest relative difference over the entries of `want` above
    `floor` of its maximum magnitude."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape
    mask = np.abs(want) > floor * np.abs(want).max()
    assert mask.any()
    return float(np.max(np.abs(got[mask] - want[mask]) / np.abs(want[mask])))


def synthetic_lines(nlines=1200, nspec=1, seed=0):
    """The synthetic H2O-like line list of tests/test_lbl_pallas.py on a
    1000-point slice of the flagship grid, at its line density (one
    object, read by both engines); nspec = 2 splits the isotopes into
    two species."""
    return benchmark.synthetic_lines(np.arange(7000.0, 8000.0, 1.0),
                                     nlines, seed, nspec)


def cells(ncell=3, seed=3):
    """Cell inputs (temps [n], densities [n, 9], iso pfs [n, 4]),
    float32-rounded as the JAX engine's sweep rounds them."""
    rng = np.random.default_rng(seed)
    temps = np.sort(rng.uniform(400.0, 2900.0, ncell))
    press = np.logspace(-4, 1, ncell)
    dens = VMR[None, :] * (press[:, None] * 1.01e6
                           / (1.380649e-16 * temps[:, None]))
    pf = synthetic_lines().iso_pf(temps).T
    f32 = lambda a: np.asarray(a, np.float32).astype(np.float64)
    return f32(temps), f32(dens), f32(pf)


@pytest.fixture(scope='module')
def engines():
    """(JAX DirectLBL, port DirectLBL) per number of species."""
    out = {}
    for nspec in (1, 2):
        lines = synthetic_lines(nlines=1200 if nspec == 1 else 800,
                                nspec=nspec)
        out[nspec] = (JDirectLBL(lines, tile=128, use_pallas=False),
                      JDirectLBL(lines, tile=128, use_pallas='interpret'),
                      DirectLBL(lines, tile=128, device='cpu'))
    return out


@pytest.fixture(scope='module')
def workflow(tmp_path_factory):
    """The flagship opacity workflow at test size: 3000 lines, 1.1-1.2 um
    at 1 cm-1 (758 points), 4 layers, 10 temperatures."""
    workdir = str(tmp_path_factory.mktemp('lbl_workflow'))
    par, tli_cfg, opacity_cfg = benchmark.make_lbl_flagship(
        workdir, nlines=3000, seed=0, nlayers=4, wl_low=1.1, wl_high=1.2)
    # A small Voigt-profile grid: the JAX package's LineByLine builds it
    # for its parity engine (the direct engine never reads it), and the
    # default 50 x 100 profiles take ~20 s per Model here.
    with open(opacity_cfg, 'a') as f:
        f.write('ndop = 4\nnlor = 4\n')
    summary = run(tli_cfg)
    return dict(workdir=workdir, par=par, tli_cfg=tli_cfg,
                opacity_cfg=opacity_cfg, summary=summary,
                tli=os.path.join(workdir, 'flagship_h2o.tli'))


# ----------------------------------------------------------------------
# Line lists, TLI files, partition functions

def test_make_tli_byte_identical(workflow, tmp_path):
    jtli = str(tmp_path / 'jax.tli')
    jsummary = jmake_tli([workflow['par']], ['tips'], ['hitran'], jtli,
                         1.05, 1.75, 'um')
    with open(workflow['tli'], 'rb') as f, open(jtli, 'rb') as g:
        assert f.read() == g.read()
    assert len(jsummary) == len(workflow['summary']) == 1
    for key in ('name', 'molecule', 'n_lines', 'ntemp'):
        assert jsummary[0][key] == workflow['summary'][0][key]
    assert list(jsummary[0]['isotopes']) == list(
        workflow['summary'][0]['isotopes'])
    assert workflow['summary'][0]['n_lines'] == 3000


@pytest.mark.parametrize('wn_range', [(-np.inf, np.inf), (8000.0, 8500.0)])
def test_read_tli_matches_jax(workflow, wn_range):
    dbs, *arrays = read_tli(workflow['tli'], *wn_range)
    jdbs, *jarrays = jread_tli(workflow['tli'], *wn_range)
    for got, want in zip(arrays, jarrays):
        np.testing.assert_array_equal(got, want)
    assert len(dbs) == len(jdbs) == 1
    for key in ('name', 'molname', 'temp', 'iso_name', 'iso_mass',
                'iso_ratio', 'iso_pf'):
        np.testing.assert_array_equal(getattr(dbs[0], key),
                                      getattr(jdbs[0], key))


@pytest.mark.parametrize('molecule', ['H2O', 'CO2', 'CH4'])
def test_tips_matches_jax(molecule):
    pf, isos, temp = partitions.tips(molecule)
    jpf, jisos, jtemp = jpartitions.tips(molecule)
    np.testing.assert_array_equal(pf, jpf)
    np.testing.assert_array_equal(temp, jtemp)
    assert isos == jisos
    assert data.get_iso(molecule) == jdata.get_iso(molecule)
    assert partitions.get_tips_molname(1) == jpartitions.get_tips_molname(1)


def test_data_tables_read_by_path():
    table, jtable = data.isotopes_table(), jdata.isotopes_table()
    assert sorted(table) == sorted(jtable)
    for key in table:
        np.testing.assert_array_equal(table[key], jtable[key])
    assert os.path.samefile(
        data.TABLES_DIR, os.path.dirname(jdata.__file__))


@pytest.mark.parametrize('single_isotope', [None, '118'])
def test_line_by_line_setup_matches_jax(workflow, tmp_path, single_isotope):
    """The host setup of LineByLine (TLI merge, isotope bookkeeping,
    single_isotope, temperature range, iso_pf, _layer_widths)."""
    cfg = workflow['opacity_cfg']
    if single_isotope is not None:
        cfg = str(tmp_path / 'single.cfg')
        with open(workflow['opacity_cfg']) as f, open(cfg, 'w') as g:
            g.write(f.read() + f'single_isotope = {single_isotope}\n')
    lbl = Model(cfg, device='cpu').opacity_models[0][1]
    jlbl = JModel(cfg).opacity_models[0][1]
    for attr in ('lwn', 'gf', 'elow', 'isoid', 'iso_name', 'iso_mass',
                 'iso_ratio', 'iso_atm_index', 'iso_spec_index', 'species',
                 'tmin', 'tmax', 'ntransitions', 'cutoff', 'nspec'):
        np.testing.assert_array_equal(getattr(lbl, attr),
                                      getattr(jlbl, attr), attr)
    temps = np.array([150.0, 1234.5, 2999.0])
    np.testing.assert_array_equal(lbl.iso_pf(temps), jlbl.iso_pf(temps))
    dens = VMR[[0, 1, 5]] * 1e15
    for got, want in zip(lbl._layer_widths(1234.5, dens),
                         jlbl._layer_widths(1234.5, dens)):
        np.testing.assert_array_equal(got, want)
    if single_isotope is not None:
        assert np.all(lbl.isoid == 1) and lbl.iso_ratio[1] == 1.0


# ----------------------------------------------------------------------
# DirectLBL host setup

@pytest.mark.parametrize('nspec', [1, 2])
def test_direct_host_tables_equal(engines, nspec):
    jdirect, _, direct = engines[nspec]
    for attr in ('margin', 'cutoff', 'nwave', 'tile', 'tile_core',
                 'tile_wing', 'wing_group', 'ntiles', 'lmax', 'ntiles_core',
                 'lmax_core', 'ntiles_wf', 'lmax_wf', 'nspec', '_pf_t0',
                 '_pf_dt'):
        assert getattr(direct, attr) == getattr(jdirect, attr), attr
    for attr in ('tile_starts', 'starts_core', 'starts_wf'):
        np.testing.assert_array_equal(getattr(direct, attr),
                                      getattr(jdirect, attr))
    for key, want in jdirect._tables.items():
        if key.endswith('_spec_oh'):
            # The one-hot [ntiles, nspec, lmax] becomes a species index:
            got = direct._tables[key[:-3]]
            np.testing.assert_array_equal(np.argmax(want, axis=1), got)
            assert np.all(want.sum(axis=1) == 1)
        else:
            np.testing.assert_array_equal(direct._tables[key], want, key)
    assert all(np.all(direct._tables[pre + 'spec'] == 0)
               for pre in ('w_', 'c_', 'wf_')) == (nspec == 1)


# ----------------------------------------------------------------------
# The plain versions of K4, K5 and K6 against the Pallas kernels

def _pass_operands(direct, nspec, prefix):
    """(operands, JAX one-hot) of one pass over 3 cells of `direct`."""
    tables = direct.tables()
    temps, dens, pf = (torch.as_tensor(a) for a in cells(3))
    fac = direct._cell_factors(tables, temps, dens, pf,
                               'w_' if prefix == 'w_' else 'wf_')
    if prefix == 'c_':
        tiles = ('wn_core_hi', 'wn_core_lo')
        factors = ('scale_c', 'y_c', 'inv_ad_c')
    else:
        tiles = (('wn_tiles_hi', 'wn_tiles_lo') if prefix == 'w_'
                 else ('wn_wf_hi', 'wn_wf_lo'))
        factors = ('c1_w', 'y2_w', 'inv_ad_w')
    operands = [tables[k] for k in tiles] + [
        tables[prefix + 'lwn_hi'], tables[prefix + 'lwn_lo']] + [
        fac[k] for k in factors]
    if nspec == 1:
        return operands, None, None
    # The JAX kernels take the one-hot [ntiles, nspec, lmax]:
    onehot = (direct._tables[prefix + 'spec'][:, None, :]
              == np.arange(nspec)[None, :, None]).astype(float)
    return operands, tables[prefix + 'spec'], onehot


@pytest.mark.parametrize('nspec', [1, 2])
@pytest.mark.parametrize('kernel', ['wing_grouped', 'core', 'wing'])
def test_plain_kernels_match_pallas_interpret(engines, kernel, nspec):
    _, _, direct = engines[nspec]
    prefix = {'wing_grouped': 'wf_', 'core': 'c_', 'wing': 'w_'}[kernel]
    operands, spec, onehot = _pass_operands(direct, nspec, prefix)
    arrays = [jnp.asarray(t.numpy()) for t in operands]
    oh = None if onehot is None else jnp.asarray(onehot)
    if kernel == 'core':
        got = lk.core_sigma_plain(*operands, spec, margin=direct.margin,
                                  nspec=nspec)
        want = jpallas.core_sigma(*arrays, oh, margin=direct.margin,
                                  interpret=True)
    elif kernel == 'wing':
        got = lk.wing_sigma_plain(*operands, spec, margin=direct.margin,
                                  cutoff=direct.cutoff, nspec=nspec)
        want = jpallas.wing_sigma(*arrays, oh, margin=direct.margin,
                                  cutoff=direct.cutoff, interpret=True)
    else:
        got = lk.wing_sigma_grouped_plain(
            *operands, spec, margin=direct.margin, cutoff=direct.cutoff,
            nspec=nspec)
        want = jpallas.wing_sigma_grouped(
            *arrays, oh, margin=direct.margin, cutoff=direct.cutoff,
            group=direct.wing_group, interpret=True)
    # The public wrapper takes the plain version for CPU tensors:
    wrapper = {'wing_grouped': lk.wing_sigma_grouped, 'core': lk.core_sigma,
               'wing': lk.wing_sigma}[kernel]
    kw = dict(margin=direct.margin, nspec=nspec)
    if kernel != 'core':
        kw['cutoff'] = direct.cutoff
    assert torch.equal(wrapper(*operands, spec, **kw), got)
    assert masked_rel(got.numpy(), np.asarray(want)) < RTOL


# ----------------------------------------------------------------------
# The engine end to end against the JAX engine

@pytest.mark.parametrize('nspec', [1, 2])
def test_cross_section_batch_matches_jax(engines, nspec):
    jdirect, jdirect_p, direct = engines[nspec]
    temps, dens, pf = cells(3)
    tables = convert.direct_lbl_tables(jdirect, 'cpu')
    got = direct._cross_section_batch(
        tables, *(torch.as_tensor(a) for a in (temps, dens, pf))).numpy()
    assert got.shape == (3, nspec, direct.nwave)
    args = (jnp.asarray(temps), jnp.asarray(dens), jnp.asarray(pf))
    for jeng in (jdirect, jdirect_p):      # XLA path and Pallas kernels
        want = np.asarray(jeng._cross_section_batch(jeng.tables(), *args))
        assert masked_rel(got, want) < RTOL
    if nspec == 2:
        assert np.abs(got[:, 0] - got[:, 1]).max() > 0.1 * np.abs(got).max()


def test_cross_section_single_cell_matches_jax(engines):
    jdirect, _, direct = engines[1]
    temps, dens, pf = cells(2)
    # The lane-tiled (K6 windows) route of one cell:
    got = direct._cross_section(
        direct.tables(), *(torch.as_tensor(a[0]) for a in (temps, dens, pf)))
    want = jdirect._cross_section(
        jdirect.tables(), *(jnp.asarray(a[0]) for a in (temps, dens, pf)))
    assert masked_rel(got.numpy(), np.asarray(want)) < RTOL
    # The public entry rounds its inputs to float32, as the JAX one:
    temp, dens1 = 1234.5, dens[1] * 1.01
    got = direct.cross_section(temp, dens1).numpy()
    pf1 = direct.lbl.iso_pf(np.atleast_1d(temp))[:, 0]
    want = jdirect._cross_section(
        jdirect.tables(), *(jnp.asarray(a, jnp.float32)
                            for a in (temp, dens1, pf1)))
    assert masked_rel(got, np.asarray(want)) < RTOL
    assert masked_rel(got, np.asarray(
        jdirect.cross_section(temp, dens1))) < RTOL_JIT


def test_extinction_fn_matches_jax(engines):
    """2 chains x 3 layers of live line-by-line extinction."""
    jdirect, _, direct = engines[1]
    temps, dens, _ = cells(3)
    t2 = np.stack([temps, temps + 25.0])
    d2 = np.stack([dens, 1.1 * dens])
    got = direct.extinction_fn(block=4)(torch.as_tensor(t2),
                                        torch.as_tensor(d2)).numpy()
    want = np.asarray(jax.vmap(jdirect.extinction_fn())(
        jnp.asarray(t2), jnp.asarray(d2)))
    assert got.shape == want.shape == (2, 3, direct.nwave)
    assert masked_rel(got, want) < RTOL


def eager_table(jdirect, temps, press, vmr):
    """The JAX engine's table of the same float32-rounded cells as its
    tabulate, evaluated eagerly (no jit), rounded to float32."""
    from pyratbay_tpu import constants as jpc
    cells_t = np.repeat(temps, len(press))
    cells_p = np.tile(press, len(temps))
    dens = np.tile(vmr, (len(temps), 1)) * (
        cells_p[:, None] * jpc.bar / (jpc.k * cells_t[:, None]))
    pf = jdirect.lbl.iso_pf(cells_t).T
    out = jdirect._cross_section_batch(jdirect.tables(), *(
        jnp.asarray(np.asarray(a, np.float32)) for a in (cells_t, dens, pf)))
    return np.asarray(out, np.float32)[:, 0].reshape(
        len(temps), len(press), -1)


def test_tabulate_matches_jax(engines):
    jdirect, _, direct = engines[1]
    press = np.logspace(-4, 1, 4)
    temps = np.array([500.0, 1800.0])
    vmr = np.tile(VMR, (4, 1))
    # block = 3 leaves a padded last block; max_out_bytes forces three
    # superblocks:
    got = direct.tabulate(temps, press, vmr, block=3,
                          max_out_bytes=3 * direct.nwave * 4)
    want = jdirect.tabulate(temps, press, vmr, block=3)
    assert got.shape == want.shape == (2, 4, direct.nwave)
    assert got.dtype == want.dtype == np.float32
    assert masked_rel(got, eager_table(jdirect, temps, press, vmr)) < RTOL
    assert masked_rel(got, want) < RTOL_JIT


def test_compute_opacity_matches_jax(workflow, tmp_path):
    """runmode = opacity through Model.compute_opacity(engine='direct'),
    then the table read back through io and LineSample."""
    model = Model(workflow['opacity_cfg'], device='cpu')
    assert [m[0] for m in model.opacity_models] == ['lbl']
    table = model.compute_opacity(engine='direct')
    jcfg = str(tmp_path / 'jax_opacity.cfg')
    jtable_file = str(tmp_path / 'jax_table.npz')
    with open(workflow['opacity_cfg']) as f:
        text = f.read()
    with open(jcfg, 'w') as f:
        f.write('\n'.join(
            f'sampled_cross_sec = {jtable_file}'
            if ln.startswith('sampled_cross_sec') else ln
            for ln in text.splitlines()) + '\n')
    jmodel = JModel(jcfg)
    want = jmodel.compute_opacity(engine='direct')
    assert table.shape == want.shape == (10, 4, 758)
    assert np.all(np.isfinite(table)) and np.all(table >= 0)
    assert masked_rel(table, want) < RTOL_JIT
    jdirect = JDirectLBL(jmodel.opacity_models[0][1])
    assert masked_rel(table, eager_table(
        jdirect, jmodel.cs_temps, jmodel.press, jmodel.base_vmr)) < RTOL

    out_file = os.path.join(workflow['workdir'], 'flagship_h2o_lbl.npz')
    _, species, temps, press, wn, read = pio.read_opacity(out_file)
    assert species == 'H2O'
    np.testing.assert_array_equal(temps, np.arange(300.0, 3001.0, 300.0))
    np.testing.assert_array_equal(press, model.press)
    np.testing.assert_array_equal(wn, model.wn)
    np.testing.assert_array_equal(read, table)
    ls = LineSample(out_file, pressure=model.press)
    ls.to(torch.device('cpu'), torch.float64)
    np.testing.assert_array_equal(ls.cs_table[0], table)
    ec = ls.extinction(
        torch.full((1, 4), 1450.0, dtype=torch.float64),
        torch.full((1, 4, 1), 1e15, dtype=torch.float64))
    assert ec.shape == (1, 4, 758) and bool(torch.all(ec > 0))


# ----------------------------------------------------------------------
# Faults of the port's Model against the JAX package (runmode = opacity)

def _stale_table(workflow, tmp_path):
    """An opacity config whose output table already exists, written on
    another grid (a table left by an earlier run)."""
    cfg = str(tmp_path / 'opacity.cfg')
    stale = str(tmp_path / 'stale.npz')
    wn = np.linspace(8400.0, 8900.0, 50)
    press = np.logspace(-6, 2, 4)
    pio.write_opacity(stale, 'H2O', np.array([300.0, 3000.0]), press, wn,
                      np.ones((2, 4, 50)))
    with open(workflow['opacity_cfg']) as f:
        text = f.read()
    with open(cfg, 'w') as f:
        f.write('\n'.join(
            f'sampled_cross_sec = {stale}'
            if ln.startswith('sampled_cross_sec') else ln
            for ln in text.splitlines()) + '\n')
    return cfg


def test_opacity_config_keeps_its_own_grid(workflow, tmp_path):
    """The wavenumber grid of runmode = opacity comes from the sampling
    keys, not from the table it is about to write (the port read that
    table, failing when it did not exist yet)."""
    cfg = _stale_table(workflow, tmp_path)
    model = Model(cfg, device='cpu')
    np.testing.assert_array_equal(model.wn, JModel(cfg).wn)
    assert model.nwave == 758
    assert Model(workflow['opacity_cfg'], device='cpu').nwave == 758


def test_opacity_config_reads_no_line_sample(workflow, tmp_path):
    """runmode = opacity builds no line-sample opacity from its output
    table (the port did)."""
    cfg = _stale_table(workflow, tmp_path)
    types = [m[0] for m in Model(cfg, device='cpu').opacity_models]
    assert types == [m[0] for m in JModel(cfg).opacity_models] == ['lbl']


# ----------------------------------------------------------------------
# What is not ported raises, naming its ROADMAP item; the line-list
# readers and partition sources (A13) and the batched forward of a TLI
# model (A12) run

def test_unported_parts_raise():
    """Every line-list reader and partition source of the JAX package is
    ported and raises nothing (A13, tested against the JAX package in
    tests/test_torch_linelists.py); the one refusal left on these paths,
    the Pallas kernels' layer-major operands, raises naming B1."""
    from pyratbay_tpu.opacity import linelists as jlinelists
    from pyratbay_tpu_torch.spectrum import emission_kernel as ek
    for dbtype in sorted(jlinelists._READERS):
        assert get_linelist_reader(dbtype).__name__ == \
            jlinelists.get_linelist_reader(dbtype).__name__
    assert partitions.poly_pf([1.0, 0, 0, 0, 0, 0])[0].shape == (1, 121)
    layers = torch.ones((1, 3), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match='B1'):
        ek.emission_flux_ensemble(
            [], layers, layers, np.ones(2), np.ones(1), np.ones(1),
            torch.zeros(1, dtype=torch.int64),
            torch.full((1,), 3, dtype=torch.int64),
            ec_parts_lbw=[torch.ones((3, 1, 2), dtype=torch.float64)])


def test_batched_forward_of_tli_model_runs_direct_engine(
        workflow, tmp_path, monkeypatch):
    """The batched forward of a TLI model runs the direct engine's
    passes (K4 and K5's wrappers, their plain versions on the CPU) and
    gives the JAX package's direct forward (build_forward, lbl_engine =
    'direct') at the config's state, rtol 1e-10."""
    from pyratbay_tpu.retrieval.forward import build_forward as jforward
    from pyratbay_tpu_torch.opacity import lbl_direct
    cfg = str(tmp_path / 'spectrum.cfg')
    with open(workflow['opacity_cfg']) as f:
        text = f.read().replace(
            'runmode = opacity', 'runmode = retrieval\nrt_path = transit')
    with open(cfg, 'w') as f:
        f.write('\n'.join(ln for ln in text.splitlines()
                          if not ln.startswith('sampled_cross_sec'))
                + '\ntmodel = isothermal\ntpars = 1500.0\n'
                'rstar = 1.27 rsun\nrplanet = 1.0 rjup\n'
                'mplanet = 0.6 mjup\nrefpressure = 0.1 bar\n'
                'radmodel = hydro_m\n')
    model = Model(cfg, device='cpu')
    passes = []
    for name in ('wing_sigma_lines', 'core_sigma_lines'):
        real = getattr(lbl_direct, name)
        monkeypatch.setattr(lbl_direct, name, lambda *a, _n=name, _r=real,
                            **kw: passes.append(_n) or _r(*a, **kw))
    got = build_forward_batched(model)()
    assert passes == ['wing_sigma_lines', 'core_sigma_lines']
    # Eager, as the file's 1e-10 comparisons (jit folds the float32
    # Lorentz constants another way, ~5e-10 here):
    want = jforward(JModel(cfg))()
    assert bool(got['good'][0]) and bool(want['good'])
    np.testing.assert_allclose(got['spectrum'][0].numpy(),
                               np.asarray(want['spectrum']), rtol=RTOL,
                               atol=0)
