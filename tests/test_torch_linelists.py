"""The port's line-list readers, partition sources and TLI files against
pyratbay_tpu on the same files, host float64.

* Each reader (HITRAN, ExoMol, repack, P&S, Schwenke TiO, Plez VO, VALD)
  on benchmark.make_line_lists' synthetic files: its attributes,
  partition functions and dbread arrays equal the JAX package's
  exactly, and runmode = tli writes a byte-identical TLI file, for each
  pflist source (tips, a PF file, poly).
* read_pf / write_pf, kurucz (H2O, TiO), exomol_pf and poly_pf equal the
  JAX package's; the files written are byte-identical.
* The error messages of an unknown dbtype, a missing ExoMol states file,
  an unknown repack isotope and a bad Kurucz file name are the JAX
  package's.
* A HITRAN CO2 file with isotopes A and B and a blank Elow field gives
  the JAX package's TLI file (the native parse reads the blank as 0,
  which the Elow filter drops; the numpy parse raises on it).
* read_tli over a wavenumber range (the native binary search) equals the
  JAX package's and the numpy mask.

At test size: 400 lines (HITRAN, ExoMol over 600 states, repack), 300
(P&S, TiO, VO) and 300 VALD records.
"""
import filecmp
import os

import numpy as np
import pytest

pytest.importorskip('torch')

from pyratbay_tpu import driver as jdriver  # noqa: E402
from pyratbay_tpu.io import io as jio  # noqa: E402
from pyratbay_tpu.opacity import linelists as jlinelists  # noqa: E402
from pyratbay_tpu.opacity import partitions as jpartitions  # noqa: E402
from pyratbay_tpu.opacity.tli import make_tli as jmake_tli  # noqa: E402
from pyratbay_tpu.opacity.tli import read_tli as jread_tli  # noqa: E402
from pyratbay_tpu_torch import benchmark, runtime  # noqa: E402
from pyratbay_tpu_torch.driver import run  # noqa: E402
from pyratbay_tpu_torch.io import io as pio  # noqa: E402
from pyratbay_tpu_torch.opacity import linelists  # noqa: E402
from pyratbay_tpu_torch.opacity import partitions  # noqa: E402
from pyratbay_tpu_torch.opacity.tli import make_tli, read_tli  # noqa: E402

from test_torch_runtime import jax_native_runtime  # noqa: E402

FORMATS = benchmark.LINE_LIST_FORMATS
WN_RANGE = (1e4 / 1.75, 1e4 / 1.05)


@pytest.fixture(scope='module')
def lists(tmp_path_factory):
    jax_native_runtime()
    workdir = str(tmp_path_factory.mktemp('line_lists'))
    return benchmark.make_line_lists(workdir, nlines=400, nlines_small=300,
                                     nlines_vald=300, nstates=600, seed=3)


def readers(entry):
    """(port, JAX) readers of one make_line_lists entry."""
    args = entry['dbfile'], entry['pflist']
    return (linelists.get_linelist_reader(entry['dbtype'])(*args),
            jlinelists.get_linelist_reader(entry['dbtype'])(*args))


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        assert np.asarray(g).dtype.kind == np.asarray(w).dtype.kind


@pytest.mark.parametrize('dbtype', FORMATS)
def test_reader_matches_jax(lists, dbtype):
    """Attributes, partition functions and dbread arrays, exactly."""
    reader, jreader = readers(lists[dbtype])
    for attr in ('name', 'molecule'):
        assert getattr(reader, attr) == getattr(jreader, attr)
    for attr in ('isotopes', 'mass', 'isoratio'):
        np.testing.assert_array_equal(getattr(reader, attr),
                                      getattr(jreader, attr))
    assert_same(reader.getpf(), jreader.getpf())
    got = reader.dbread(*WN_RANGE)
    want = jreader.dbread(*WN_RANGE)
    assert len(got[0]) > 100
    assert_same(got, want)
    # A range the list does not reach:
    assert reader.dbread(100.0, 200.0) is None
    assert jreader.dbread(100.0, 200.0) is None


@pytest.mark.parametrize('dbtype,pflist', [
    *[(fmt, None) for fmt in FORMATS],
    ('hitran', 'pf_file'), ('repack', 'pf_file'), ('exomol', 'tips')])
def test_runmode_tli_byte_identical(lists, tmp_path, dbtype, pflist):
    """runmode = tli through the port's driver and the JAX package's
    writes the same bytes, with the make_line_lists pflist or (second
    group) another source: the -pf tips file, tips."""
    entry = lists[dbtype]
    with open(entry['tli_cfg']) as f:
        text = f.read()
    if pflist == 'pf_file':
        pflist = os.path.join(os.path.dirname(entry['dbfile']),
                              'PF_tips_H2O.dat')
    if pflist is not None:
        text = text.replace(f"pflist = {entry['pflist']}",
                            f'pflist = {pflist}')
    files = {}
    for name, runner in (('port', lambda c: run(c, device='cpu')),
                         ('jax', jdriver.run)):
        cfg = str(tmp_path / f'{name}.cfg')
        files[name] = str(tmp_path / f'{name}.tli')
        with open(cfg, 'w') as f:
            f.write(text.replace(entry['tlifile'], files[name]))
        summary = runner(cfg)
    assert summary[0]['n_lines'] > 100
    assert filecmp.cmp(files['port'], files['jax'], shallow=False)


@pytest.mark.parametrize('source', [
    'read_write_pf', 'kurucz_h2o', 'kurucz_tio', 'exomol_pf', 'poly_pf'])
def test_partition_sources_match_jax(tmp_path, source):
    """The partition-function readers and writers against the JAX
    package's: equal arrays, byte-identical files."""
    if source == 'read_write_pf':
        pf, isotopes, temp = partitions.tips('CO2')
        pio.write_pf(str(tmp_path / 'port.dat'), pf, isotopes, temp,
                     header='# CO2\n\n')
        jio.write_pf(str(tmp_path / 'jax.dat'), pf, isotopes, temp,
                     header='# CO2\n\n')
        assert filecmp.cmp(tmp_path / 'port.dat', tmp_path / 'jax.dat',
                           shallow=False)
        got = pio.read_pf(str(tmp_path / 'jax.dat'))
        want = jio.read_pf(str(tmp_path / 'port.dat'))
        np.testing.assert_allclose(got[0], pf, rtol=1e-4)
    elif source.startswith('kurucz'):
        molecule = {'kurucz_h2o': 'H2O', 'kurucz_tio': 'TiO'}[source]
        table = benchmark.synthetic_kurucz_pf(
            str(tmp_path / f'{molecule.lower()}partfn.dat'), molecule)
        got = partitions.kurucz(table, outfile=str(tmp_path / 'port.dat'))
        want = jpartitions.kurucz(table, outfile=str(tmp_path / 'jax.dat'))
        assert filecmp.cmp(tmp_path / 'port.dat', tmp_path / 'jax.dat',
                           shallow=False)
    elif source == 'exomol_pf':
        pf_file = str(tmp_path / '1H2-16O__Synth.pf')
        temp = np.arange(1.0, 5001.0)
        np.savetxt(pf_file, np.column_stack([temp, 3.0 * temp**1.5]),
                   fmt=['%8.1f', '%15.4f'])
        got = partitions.exomol_pf(pf_file)
        want = jpartitions.exomol_pf(pf_file)
        assert got[1] is None and want[1] is None
        got, want = (got[0], got[2]), (want[0], want[2])
    else:
        coeffs = [6.62090157e+02, -4.03350494e+02, 9.82836218e+01,
                  -1.18526504e+01, 7.08429905e-01, -1.67235124e-02]
        got = (*partitions.poly_pf(coeffs),
               *partitions.poly_pf([coeffs, coeffs], np.array([900.0, 2e3])))
        want = (*jpartitions.poly_pf(coeffs),
                *jpartitions.poly_pf([coeffs, coeffs],
                                     np.array([900.0, 2e3])))
        assert got[0].shape == (1, 121) and got[1][[0, -1]].tolist() == [
            1000.0, 7000.0]
    assert_same(got, want)


def _exomol_without_states(tmp_path, lists):
    trans = str(tmp_path / '1H2-16O__Synth__05800-09200.trans')
    with open(lists['exomol']['dbfile']) as src, open(trans, 'w') as dst:
        dst.write(src.read())
    return lambda reader: reader(trans, 'tips')


def _repack_unknown_isotope(tmp_path, lists):
    path = str(tmp_path / 'H2O_synth_lbl.dat')
    data = np.fromfile(lists['repack']['dbfile'], np.dtype([
        ('wn', 'f8'), ('elow', 'f8'), ('gf', 'f8'), ('iso', 'i4')]))
    data['iso'][::7] = 999
    data.tofile(path)
    return lambda reader: reader(path, 'tips').dbread(*WN_RANGE)


def _bad_kurucz_name(tmp_path, lists):
    path = benchmark.synthetic_kurucz_pf(str(tmp_path / 'partfn.dat'))
    return lambda module: module.kurucz(path)


def _unknown_dbtype(tmp_path, lists):
    return lambda module: module.get_linelist_reader('hitemp')


def _missing_hitran(tmp_path, lists):
    return lambda module: module.Hitran(str(tmp_path / 'missing.par'),
                                        'tips')


ERRORS = {
    'unknown_dbtype': (ValueError, _unknown_dbtype, 'linelists'),
    'missing_states': (FileNotFoundError, _exomol_without_states, 'exomol'),
    'missing_hitran': (FileNotFoundError, _missing_hitran, 'linelists'),
    'unknown_repack_isotope': (ValueError, _repack_unknown_isotope, 'repack'),
    'bad_kurucz_name': (ValueError, _bad_kurucz_name, 'partitions'),
}


@pytest.mark.parametrize('case', list(ERRORS))
def test_error_messages_match_jax(lists, tmp_path, case):
    """The same exception type and message as the JAX package's."""
    kind, make, target = ERRORS[case]
    call = make(tmp_path, lists)
    messages = []
    for mod, pmod in ((linelists, partitions), (jlinelists, jpartitions)):
        arg = {'linelists': mod, 'partitions': pmod,
               'exomol': mod.Exomol, 'repack': mod.Repack}[target]
        with pytest.raises(kind) as err:
            call(arg)
        messages.append(str(err.value).replace(str(tmp_path), '<tmp>'))
    assert messages[0] == messages[1], messages


@pytest.mark.parametrize('name,want', [
    ('1H2-16O__POKAZATEL__00400-00500.trans', ('H2O', '116')),
    ('12C-16O2__UCL-4000.trans', ('CO2', '266')),
    ('16O-12C-16O__UCL.trans', ('CO2', '626')),
    ('48Ti-16O__Toto__00000-00100.trans', ('TiO', '86')),
    ('14N-1H3__CoYuTe.trans', ('NH3', '4111'))])
def test_get_exomol_mol_matches_jax(name, want):
    got = linelists.get_exomol_mol(os.path.join('some', 'dir', name))
    assert got == jlinelists.get_exomol_mol(name) == want


def test_hitran_isotopes_a_b_and_blank_elow(lists, tmp_path):
    """A CO2 .par file (HITRAN molecule 2) whose isotope column holds A
    and B (CO2's 11th and 12th isotopes) and one blank Elow field: the
    port's runmode = tli writes the JAX package's bytes; the native parse
    reads the blank field as 0, which the Elow filter drops, while the
    numpy parse raises on it."""
    with open(lists['hitran']['dbfile'], 'rb') as f:
        records = f.read().splitlines(keepends=True)
    out = []
    for i, rec in enumerate(records):
        rec = bytearray(rec)
        rec[0:2] = b' 2'
        rec[2:3] = b'12AB'[i % 4:i % 4 + 1]
        if i == 5:
            rec[45:55] = b' ' * 10
        out.append(bytes(rec))
    par = str(tmp_path / 'co2.par')
    with open(par, 'wb') as f:
        f.write(b''.join(out))
    raw = b''.join(out)
    wn, a21, g2, elow, iso = runtime.parse_hitran_records(raw, len(out[0]))
    assert elow[5] == 0.0 and sorted(set(iso.tolist())) == [0, 1, 10, 11]
    with pytest.raises(ValueError):
        runtime.parse_hitran_records_plain(raw, len(out[0]))
    tli = {name: str(tmp_path / f'{name}.tli') for name in ('port', 'jax')}
    summary = make_tli([par], ['tips'], ['hitran'], tli['port'], 1.05, 1.75)
    jmake_tli([par], ['tips'], ['hitran'], tli['jax'], 1.05, 1.75)
    assert [str(i) for i in summary[0]['isotopes']] == [
        '266', '366', '738', '377']
    assert summary[0]['n_lines'] == len(records) - 1
    assert filecmp.cmp(tli['port'], tli['jax'], shallow=False)


@pytest.mark.parametrize('wn_range', [
    (6000.0, 7000.0), (5000.0, 20000.0), (100.0, 200.0),
    (-np.inf, np.inf)])
def test_read_tli_range_matches_jax_and_plain(lists, wn_range):
    """read_tli over a range: the native binary search of each isotope
    segment gives the JAX package's arrays and the numpy mask's."""
    path = lists['hitran']['tlifile']
    if not os.path.isfile(path):
        run(lists['hitran']['tli_cfg'], device='cpu')
    got = read_tli(path, *wn_range)[1:]
    want = jread_tli(path, *wn_range)[1:]
    assert_same(got, want)
    _, wn, gf, elow, iso = read_tli(path)
    counts = np.unique(iso, return_counts=True)[1]
    plain = runtime.tli_extract_range_plain(wn, iso, elow, gf, counts,
                                            *wn_range)
    assert_same(got, (plain[0], plain[3], plain[2], plain[1]))


def test_exomol_states_found_under_any_directory(lists, tmp_path):
    """The ExoMol states-file rule reads the file's name only: under a
    directory named with 'trans', '__' and '.' the port reads the pair
    as the JAX package reads it elsewhere, where the JAX package (which
    applies the rule to the whole path) finds no states file."""
    odd = tmp_path / 'transit__v1.0'
    odd.mkdir()
    src = os.path.dirname(lists['exomol']['dbfile'])
    for name in ('1H2-16O__Synth__05800-09200.trans',
                 '1H2-16O__Synth.states.bz2'):
        with open(os.path.join(src, name), 'rb') as f, \
                open(odd / name, 'wb') as g:
            g.write(f.read())
    trans = str(odd / '1H2-16O__Synth__05800-09200.trans')
    got = linelists.Exomol(trans, 'tips').dbread(*WN_RANGE)
    want = jlinelists.Exomol(lists['exomol']['dbfile'], 'tips').dbread(
        *WN_RANGE)
    assert_same(got, want)
    with pytest.raises(FileNotFoundError):
        jlinelists.Exomol(trans, 'tips')
