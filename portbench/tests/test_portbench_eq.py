"""The equilibrium flagship's parts on the CPU, at a small size (11 layers,
321 columns), against the plain torch reference (portbench/
torch_reference/): its inputs, its frozen thermochemical data, the
program's VMRs and log-posteriors, the TF32 control, the readers of its
per-layer metrics and the comparison that decides `correct`.

The chains: 16 drawn uniformly inside the priors from a seed, and the
four corners of the ([M/H], C/O) prior at the other true parameters."""
import ast
import hashlib
import os
import time

import numpy as np
import pytest
import torch

from portbench import (chem_trace, compare, counts, counts_chem, harness,
                       readers_chem, write_gibbs_table)
from portbench.models import flagship_eq as fm
from portbench.reference import eq_inputs
from portbench.tests import small
from portbench.torch_reference import flagship_eq as ref_eq
from portbench.torch_reference import gibbs

CELL = 'flagship_eq.demc512'
# The species the forward reads: the absorber (H2O), the CIA pair (H2)
# and, with it, the bulk of the mean molecular weight (He):
READ = ['H2', 'He', 'H2O']


@pytest.fixture(scope='module')
def built(tmp_path_factory):
    config = small.config('flagship_eq', nlayers=11, wnstep=10.0)
    paths = eq_inputs.write_inputs(config, str(tmp_path_factory.mktemp('in')))
    observed = fm.Observed(config, paths, 7)
    model, obs, ret = fm.build(config, paths, observed, 'cpu')
    return config, paths, observed, model, obs, ret


def _chains(ret, seed):
    rng = np.random.default_rng(seed)
    free = ret.pstep > 0
    drawn = np.tile(ret.params, (16, 1))
    drawn[:, free] = rng.uniform(ret.pmin[free], ret.pmax[free],
                                 (16, int(free.sum())))
    corners = np.tile(ret.params, (4, 1))
    for k, (im, ic) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
        corners[k, 2] = (ret.pmin[2], ret.pmax[2])[im]
        corners[k, 3] = (ret.pmin[3], ret.pmax[3])[ic]
    return np.concatenate([drawn, corners])


def test_equilibrium_cfg_and_species(built):
    config, paths, observed, model, obs, ret = built
    with open(paths['cfg']) as f:
        text = f.read()
    assert 'chemistry = equilibrium' in text and 'bulk' not in text
    assert 'log_H2O' not in text
    assert model.species == config['species'] == observed.reference.species
    assert [r[0] for r in config['retrieval_params']][2:4] == ['[M/H]', 'C/O']
    assert int(np.sum(ret.pstep > 0)) == 7


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_program_vmrs_match_the_reference(built, seed):
    """The program's equilibrium (atmosphere/chem.py, float64 on the CPU)
    against the reference's converged solve at the program's temperatures,
    on the chains whose every layer lies inside [tlow, thigh] (the others
    the likelihood rejects before it reads a VMR).  Bounds: 1e-4 on the
    species the forward reads and 2e-2 on every species above 1e-30
    (largest over seeds 0-5: 2.7e-5 and 5.2e-3, Na and K at [M/H] = -1).
    The gap is the program's: its fixed 152 steps stop short of
    convergence where a species sits at its clip (ln n - 70), whose wanted
    drop sets the step limit lam = 2 / step of every step; colder layers,
    which the likelihood rejects, are further off (K by a factor ~580 at
    250 K, [M/H] = -1, C/O = 0.1).  ROADMAP C7 holds it open."""
    config, paths, observed, model, obs, ret = built
    from pyratbay_tpu_torch.retrieval.batched import build_forward_batched
    params = _chains(ret, seed)
    temp = build_forward_batched(model, obs, ret)(
        torch.as_tensor(params))['temperature']
    got = model._equilibrium_vmr([torch.as_tensor(params[:, 2:3]),
                                  torch.as_tensor(params[:, 3:4])],
                                 temp).numpy()
    temp = temp.numpy()
    ref = observed.reference
    want = ref.network.vmr(temp, ref.press, params[:, 2], params[:, 3])
    inside = np.all((temp >= config['tlow']) & (temp <= config['thigh']),
                    axis=1)
    assert inside.sum() >= 4
    got, want = got[inside], want[inside]
    read = [model.species.index(s) for s in READ]
    np.testing.assert_allclose(got[..., read], want[..., read], rtol=1e-4)
    live = want > 1e-30
    np.testing.assert_allclose(got[live], want[live], rtol=2e-2)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_log_posterior_matches_and_the_control_does_not(built, seed):
    """log_post of the batched forward against the reference: the same
    chains rejected, logp_gap at most 1e-5 (largest 7.7e-7 over seeds
    0-5: the solve's shortfall above through H2O and the mean molecular
    weight, and the E_2 series of the Guillot profile); the TF32 control
    (RT in TF32, solve in float32) reads above the cell's limit and above
    the program."""
    config, paths, observed, model, obs, ret = built
    from pyratbay_tpu_torch.retrieval.batched import (
        build_log_posterior_batched)
    params = _chains(ret, seed)
    got = build_log_posterior_batched(model, obs, ret)(
        torch.as_tensor(params)).numpy()
    ref = observed.reference
    want = ref.log_post(params, observed.data, observed.uncert)
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    assert np.isfinite(want).sum() >= 4
    gap = compare.logp_gap(got, want)
    assert gap <= 1e-5
    control = fm.Reference(config, paths, precision='tf32').log_post(
        params, observed.data, observed.uncert)
    control_gap = compare.logp_gap(control, want)
    assert control_gap > compare.limits(CELL)['logp_gap']
    assert control_gap > 100 * gap


def test_reference_solve_meets_the_equilibrium_conditions():
    """The reference's answer is the equilibrium: every element balanced
    to 1e-12 of its budget, and each species' chemical potential g + ln p
    + ln x in the span of the stoichiometry (the mass action of every
    reaction) to 1e-8, down to 300 K at the corners of the priors."""
    config = harness.load_json(harness.HERE, 'configs', 'flagship_eq.json')
    net = gibbs.Network(ref_eq.gibbs_path(config))
    press = np.logspace(-6, 2, 9)
    temp = np.repeat(np.array([300.0, 700.0, 1500.0, 3000.0])[:, None], 9,
                     axis=1)
    for mh, co in [(-1.0, 0.1), (-1.0, 1.5), (2.0, 0.1), (2.0, 1.5)]:
        nb = len(temp)
        x = net.vmr(temp, press, np.full(nb, mh), np.full(nb, co))
        b0 = net.budget(np.full(nb, mh), np.full(nb, co))
        atoms = x @ net.stoich
        share = atoms / atoms[..., :1]
        np.testing.assert_allclose(
            share, np.broadcast_to((b0 / b0[:, :1])[:, None], share.shape),
            rtol=1e-12)
        mu = net.gibbs_at(temp) + np.log(press)[None, :, None] + np.log(x)
        a = net.stoich
        pi = np.linalg.lstsq(a, mu.reshape(-1, len(a)).T, rcond=None)[0]
        resid = mu.reshape(-1, len(a)).T - a @ pi
        assert np.max(np.abs(resid)) < 1e-8


def test_gibbs_file_is_the_plain_writers():
    """The frozen data file holds its digest, and the plain writer
    (portbench/write_gibbs_table.py) makes its arrays again from the
    published data it enters and the configuration's offsets."""
    config = harness.load_json(harness.HERE, 'configs', 'flagship_eq.json')
    path = os.path.join(harness.ROOT, config['chemistry']['gibbs_file'])
    with open(path, 'rb') as f:
        assert hashlib.sha256(f.read()).hexdigest() == ref_eq.GIBBS_SHA256
    with np.load(ref_eq.gibbs_path(config)) as f:
        frozen = dict(f)
    again = write_gibbs_table.table(config)
    assert sorted(frozen) == sorted(again)
    for key, value in again.items():
        np.testing.assert_array_equal(frozen[key], value, err_msg=key)


# Standard entropies [J/mol/K] at 1 bar and enthalpies of formation
# [kJ/mol] at 298.15 K: the CODATA key values (Cox, Wagman & Medvedev
# 1989), and JANAF's (Chase 1998, 4th ed.) for CH4, which has none.
KEY_VALUES = {'H2': (130.680, 0.0), 'H2O': (188.835, -241.826),
              'CO': (197.660, -110.53), 'CO2': (213.785, -393.51),
              'H': (114.717, 217.998), 'He': (126.153, 0.0),
              'Na': (153.718, 107.5), 'K': (160.341, 89.0),
              'CH4': (186.251, -74.873)}


@pytest.mark.parametrize('name', sorted(KEY_VALUES))
def test_published_data_meet_the_key_values(name):
    """The writer's entered data against independent key values at
    298.15 K: S to 0.02 J/mol/K (a fifth of R ln 1.01325 = 0.109, the
    step between the 1 atm and 1 bar standard states) and the enthalpy
    of formation to 0.01 kJ/mol.  GRI-Mech 3.0's CH4 differs from JANAF's
    by 0.12 J/mol/K and 0.27 kJ/mol, and is held to 0.15 and 0.3."""
    w = write_gibbs_table
    t = np.array([w.T_REF])
    h, s = w.nasa7(name, t) if name in w.GRI30 else w.atom(name, t)
    s_key, h_key = KEY_VALUES[name]
    s_tol, h_tol = (0.15, 0.3) if name == 'CH4' else (0.02, 0.01)
    assert abs(s[0] * w.R_GAS - s_key) <= s_tol
    assert abs(h[0] * w.R_GAS * w.T_REF * 1e-3 - h_key) <= h_tol


def test_program_gibbs_against_the_published_table():
    """The program's G/RT (atmosphere/chem.py, its chemcat offsets
    included) against the table on its grid: to 1e-6 up to thigh
    (3,000 K) and 3e-5 above it, where the program's grouping of the Na
    and K fine-structure levels shows; the polynomials' species to
    1e-12.  Elements, solar abundances and stoichiometry are the
    same."""
    from pyratbay_tpu_torch.atmosphere import chem
    config = harness.load_json(harness.HERE, 'configs', 'flagship_eq.json')
    net = gibbs.Network(ref_eq.gibbs_path(config))
    assert net.species == config['species']
    np.testing.assert_array_equal(net.temps, chem._T_GRID)
    cool = net.temps <= config['thigh']
    for j, name in enumerate(net.species):
        gap = np.abs(chem.gibbs_over_rt(name, net.temps) - net.gibbs[:, j])
        assert np.max(gap[cool]) <= 1e-6, name
        assert np.max(gap) <= (1e-12 if name in write_gibbs_table.GRI30
                               else 3e-5), name
    program = chem.Network(np.ones(1), np.full(1, 1000.0), net.species)
    order = [list(program.elements).index(e) for e in net.elements]
    assert sorted(net.elements) == sorted(program.elements)
    np.testing.assert_array_equal(net.solar_dex, program._solar_dex[order])
    np.testing.assert_array_equal(net.stoich,
                                  program._stoich_full[:, order])


def test_the_fits_reading_of_gri_mech_is_one_atmosphere():
    """The table reads GRI-Mech's polynomials as at 1 atm, as the
    chemcat-parity fit did (the configuration's g0_fit_gri_pressure_pa):
    read at their own 1 bar, each species' G/RT is ln 1.01325 higher, and
    the atoms', which the fit read right, are the same."""
    config = harness.load_json(harness.HERE, 'configs', 'flagship_eq.json')
    chemistry = config['chemistry']
    as_published = dict(chemistry)
    del as_published['g0_fit_gri_pressure_pa']
    temps = write_gibbs_table.TEMPERATURE
    for name in config['species']:
        step = (write_gibbs_table.gibbs_over_rt(name, temps, as_published)
                - write_gibbs_table.gibbs_over_rt(name, temps, chemistry))
        want = np.log(1.01325) if name in write_gibbs_table.GRI30 else 0.0
        np.testing.assert_allclose(step, want, rtol=0, atol=1e-12)


def test_a_changed_table_is_refused(tmp_path, monkeypatch):
    config = harness.load_json(harness.HERE, 'configs', 'flagship_eq.json')
    with np.load(ref_eq.gibbs_path(config)) as f:
        arrays = dict(f)
    arrays['gibbs_over_rt'] = arrays['gibbs_over_rt'] * (1 + 1e-12)
    np.savez(tmp_path / 'g.npz', **arrays)
    monkeypatch.setattr(ref_eq, '_ROOT', str(tmp_path))
    with pytest.raises(ValueError, match='sha256'):
        ref_eq.gibbs_path(dict(config, chemistry=dict(
            config['chemistry'], gibbs_file='g.npz')))


def test_a_program_without_the_solve_kernel_stops_at_prepare(
        tmp_path, monkeypatch, capsys):
    """The configuration's solve is the program's one-launch kernel: a
    program without it exits 2 before any input is written."""
    from pyratbay_tpu_torch.atmosphere import chem
    config = small.config('flagship_eq', nlayers=11)
    monkeypatch.delattr(chem, 'equilibrium_cuda')
    with pytest.raises(SystemExit) as stop:
        fm.prepare(config, str(tmp_path))
    assert stop.value.code == 2
    assert 'chem_gibbs_kernel' in capsys.readouterr().err
    assert not (tmp_path / 'portbench').exists()


def _imports(path):
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ('.' * node.level) + (node.module or '')


def test_torch_reference_imports_nothing_of_either_package():
    """torch_reference/ imports numpy, torch, the standard library and the
    frozen numpy reference (..reference) only, and the writer of its data
    numpy and the standard library: nothing of pyratbay_tpu_torch or
    pyratbay_tpu, and no JAX."""
    here = os.path.join(harness.HERE, 'torch_reference')
    allowed = {'numpy', 'torch', 'hashlib', 'os', 're', '.', '..reference',
               '..reference.flagship'}
    for name in sorted(os.listdir(here)):
        if name.endswith('.py'):
            tops = set(_imports(os.path.join(here, name)))
            assert tops <= allowed, (name, tops - allowed)
    tops = set(_imports(write_gibbs_table.__file__))
    assert tops <= {'numpy', 'hashlib', 'json', 'os', 're', 'sys'}, tops


def test_chem_trace_counts_the_launches_inside_the_span():
    """chem_trace.inside on a chrome trace: the device work whose launch
    lies inside a pbt.state.chem annotation, and none for a trace
    without the span (a program before the span: the readers give
    None)."""
    def x(name, cat, ts, dur, **args):
        return {'ph': 'X', 'name': name, 'cat': cat, 'ts': ts, 'dur': dur,
                'args': args}
    events = [x('pbt.state.chem', 'user_annotation', 10, 5),
              x('cudaLaunchKernel', 'cuda_runtime', 11, 1, correlation=1),
              x('chem_gibbs_kernel', 'kernel', 20, 30, correlation=1),
              x('cudaLaunchKernel', 'cuda_runtime', 16, 1, correlation=2),
              x('transit_rt_kernel', 'kernel', 50, 9, correlation=2)]
    assert chem_trace.inside(events, chem_trace.SPAN) == {
        'spans': 1, 'launches': 1, 'device_us': 30.0}
    none = chem_trace.inside(events[1:], chem_trace.SPAN)
    assert none['spans'] == 0
    ctx = {'profile': {'annotations': 21, chem_trace.SPAN: none}}
    assert readers_chem.chem_launches_per_forward(ctx) is None
    assert readers_chem.chem_device_ms(ctx, spans=[]) is None


def test_counts_of_the_solve():
    """A step of the flagship's network (9 species, 6 element columns,
    a 7-square system) and the whole solve at 512 chains x 51 layers."""
    # m = 2: the first pivot's division, row 1's multiplier, its one
    # update and its right-hand side's; the second pivot's division; the
    # back substitution's two divisions and one FMA.
    assert counts_chem._elimination(2) == (1 + 1 + 2 + 2) + 1 + (2 + 2)
    config = harness.load_json(harness.HERE, 'configs', 'flagship_eq.json')
    work = config['work']
    step = counts_chem.step_flops(work['chem_species'], work['chem_cols'])
    assert 1000 < step < 1400
    flops, nbytes = counts_chem.solve_work(work, 512, 51)
    assert flops == 512 * 51 * counts_chem.system_flops(9, 6, 152)
    ms, by = counts_chem.bound_ms(flops, nbytes, work['chem_peak'],
                                  counts.peaks()['bytes_per_s'])
    assert by == 'operations' and 0.1 < ms < 0.2


def test_sound_run_is_correct_and_a_solve_without_c_to_o_is_not(
        monkeypatch):
    """The cell's comparison through the driver on the CPU: a sound run
    is correct; a program whose solve drops C/O (the chains' element
    ratio) is not."""
    config = small.config('flagship_eq', nlayers=11)
    mix = small.mix('demc512', nchains=24, chunk_gens=10)

    def run():
        return harness.driver('demc').run(
            work=small.work(CELL), config=config, mix=mix, seed=2**31 + 5,
            seconds=1.0, trace=False, t0=time.perf_counter(), device='cpu')

    out = run()
    assert out['correct'], out['checks']
    from pyratbay_tpu_torch.atmosphere import chem
    real = chem.equilibrium_fn

    def without_ratio(network, device):
        fn = real(network, device)
        return lambda temp, metallicity=None, escale=None, ratios=(): fn(
            temp, metallicity, escale, ())
    monkeypatch.setattr(chem, 'equilibrium_fn', without_ratio)
    out = run()
    assert not out['correct'], out['checks']
