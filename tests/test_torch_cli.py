"""The port's CLI tools against pyratbay_tpu's: -v, -pf tips and -cs.

* `-pf tips MOLECULE [OUTFILE]` and `-cs hitran FILE [TSTEP [WSTEP]]` /
  `-cs borysow FILE SP1 SP2` write files with the JAX CLI's names and
  bytes (each run in a directory of its own), on CIA files
  benchmark.synthetic_cia_hitran / synthetic_cia_borysow write.
* Usage errors return 1 with the usage line, as the JAX CLI's do.
* `python -m pyratbay_tpu_torch -pf tips H2O` in a process of its own
  writes the JAX CLI's file; `-v` prints the version.
"""
import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip('torch')

from pyratbay_tpu import __main__ as jmain  # noqa: E402
from pyratbay_tpu_torch import __main__ as pmain  # noqa: E402
from pyratbay_tpu_torch import benchmark, tools  # noqa: E402
from pyratbay_tpu_torch.io import io as pio  # noqa: E402
from pyratbay_tpu_torch.version import __version__  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_both(tmp_path, monkeypatch, capsys, args):
    """Run the port's and the JAX package's CLI with `args`, each in a
    directory of its own; returns {name: (exit code, stdout, files)}."""
    out = {}
    for name in ('port', 'jax'):
        workdir = tmp_path / name
        workdir.mkdir()
        monkeypatch.chdir(workdir)
        if name == 'port':
            code = pmain.main(list(args))
        else:
            monkeypatch.setattr(sys, 'argv', ['pbay-tpu', *args])
            code = jmain.main()
        stdout = capsys.readouterr().out
        out[name] = (code, stdout, sorted(os.listdir(workdir)))
    return out


def same_files(tmp_path, files):
    return all(filecmp.cmp(tmp_path / 'port' / name,
                           tmp_path / 'jax' / name, shallow=False)
               for name in files)


@pytest.mark.parametrize('args', [
    ['-pf', 'tips', 'H2O'], ['-pf', 'tips', 'CO2', 'pf_co2.dat']])
def test_pf_tips_matches_jax(tmp_path, monkeypatch, capsys, args):
    got = run_both(tmp_path, monkeypatch, capsys, args)
    assert got['port'][0] == got['jax'][0] == 0
    assert got['port'][2] == got['jax'][2] == [
        args[3] if len(args) > 3 else f'PF_tips_{args[2]}.dat']
    assert same_files(tmp_path, got['port'][2])
    assert got['port'][1] == got['jax'][1]


@pytest.mark.parametrize('steps', [[], ['2'], ['2', '3']])
def test_cs_hitran_matches_jax(tmp_path, monkeypatch, capsys, steps):
    """Two wavenumber grids (two tables), thinned by TSTEP and WSTEP."""
    cia = str(tmp_path / 'H2-H2_synthetic.cia')
    benchmark.synthetic_cia_hitran(cia, temps=np.arange(200.0, 1401.0, 200))
    with open(cia, 'a') as f:
        benchmark.synthetic_cia_hitran(
            str(tmp_path / 'high.cia'), temps=np.array([2000.0, 3000.0]),
            wn=np.arange(20.0, 5001.0, 20.0))
        with open(tmp_path / 'high.cia') as high:
            f.write(high.read())
    got = run_both(tmp_path, monkeypatch, capsys,
                   ['-cs', 'hitran', cia, *steps])
    assert got['port'][0] == got['jax'][0] == 0
    assert got['port'][2] == got['jax'][2]
    assert len(got['port'][2]) == 2
    assert same_files(tmp_path, got['port'][2])
    _, species, temps, _ = pio.read_cs(
        str(tmp_path / 'port' / got['port'][2][0]))
    assert list(species) == ['H2', 'H2']
    assert len(temps) == len(np.arange(200.0, 1401.0, 200)[
        ::int(steps[0]) if steps else 1])


def test_cs_borysow_matches_jax(tmp_path, monkeypatch, capsys):
    cia = benchmark.synthetic_cia_borysow(str(tmp_path / 'final_CIA_LT.dat'))
    got = run_both(tmp_path, monkeypatch, capsys,
                   ['-cs', 'borysow', cia, 'H2', 'H2'])
    assert got['port'][0] == got['jax'][0] == 0
    assert got['port'][2] == got['jax'][2]
    assert len(got['port'][2]) == 1
    assert same_files(tmp_path, got['port'][2])
    assert tools.cia_borysow(cia, 'H2', 'H2', outdir=str(tmp_path)) == \
        str(tmp_path / got['port'][2][0])


@pytest.mark.parametrize('args', [
    ['-pf'], ['-pf', 'exomol', 'x.pf'], ['-cs'], ['-cs', 'hitran'],
    ['-cs', 'borysow', 'file', 'H2'], ['-cs', 'plez', 'file']])
def test_usage_errors_return_1(tmp_path, monkeypatch, capsys, args):
    got = run_both(tmp_path, monkeypatch, capsys, args)
    assert got['port'][0] == got['jax'][0] == 1
    assert got['port'][2] == got['jax'][2] == []
    usage = got['port'][1].replace('python -m pyratbay_tpu_torch', 'pbay-tpu')
    assert usage == got['jax'][1]
    assert usage.startswith('Usage: pbay-tpu -' + args[0][1:])


def test_cli_pf_in_a_process_and_version(tmp_path, monkeypatch, capsys):
    """The console entry point as users run it (a process of its own, no
    --device: the tool needs none) against the JAX CLI in-process."""
    (tmp_path / 'port').mkdir()
    proc = subprocess.run(
        [sys.executable, '-m', 'pyratbay_tpu_torch', '-pf', 'tips', 'H2O'],
        cwd=tmp_path / 'port', env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    (tmp_path / 'jax').mkdir()
    monkeypatch.chdir(tmp_path / 'jax')
    monkeypatch.setattr(sys, 'argv', ['pbay-tpu', '-pf', 'tips', 'H2O'])
    assert jmain.main() == 0
    assert same_files(tmp_path, ['PF_tips_H2O.dat'])
    assert pmain.main(['-v']) == 0
    assert capsys.readouterr().out.endswith(
        f'pyratbay_tpu_torch version {__version__}\n')


@pytest.mark.parametrize('name', [
    'radius_to_depth', 'depth_to_radius', 'divisors', 'ifirst', 'ilast',
    'Formatted_Write', 'Timer'])
def test_tools_match_jax(name):
    """The rest of tools.py, copied whole from the JAX package's, gives
    its results."""
    from pyratbay_tpu import tools as jtools
    got, want = getattr(tools, name), getattr(jtools, name)
    if name in ('radius_to_depth', 'depth_to_radius'):
        args = (np.array([0.1, 0.12]), np.array([1e-3, 2e-3]))
        for g, w in zip(got(*args), want(*args)):
            np.testing.assert_array_equal(g, w)
    elif name == 'divisors':
        np.testing.assert_array_equal(got(360), want(360))
    elif name in ('ifirst', 'ilast'):
        for data in ([0, 0, 1, 1, 0], [0, 0, 0], [1]):
            assert got(data) == want(data)
        assert got([0, 0], default_ret=-7) == -7
    elif name == 'Formatted_Write':
        texts = []
        for cls in (got, want):
            fw = cls(indent=2, fmt={'float': '{:.2f}'.format})
            fw.write('x = {}\ny = {:.3e}', np.array([1.0, 2.5]), 3.0)
            fw.write('edge {}', np.arange(10.0), edge=2)
            texts.append(fw.text)
        assert texts[0] == texts[1]
    else:
        timer = got()
        assert 0.0 <= timer.clock() < 60.0 and 0.0 <= timer.clock()
