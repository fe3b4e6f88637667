"""The port's several processes against the JAX package's mesh, float64
on the CPU: torch.distributed groups of 2 or 4 ranks (gloo), each rank a
new interpreter running tests/torch_dist_worker.py (no JAX), against
pyratbay_tpu's (chains, wave) mesh on the conftest's virtual devices.

* (2, 2), 4 ranks: the test-size flagship's wave-sharded transit
  forward (wnstep 2, 8 chains; tests/test_parallel.py's case) equals
  JAX's sharded forward at rtol 1e-8 (spectra on the unpadded width,
  band fluxes); two DEMC generations of build_flagship_sharded (16
  chains, wnstep 4) with the JAX keys' draws injected equal JAX's
  sharded_retrieval_step on the same float64 ensemble (rtol 1e-8,
  atol 1e-12, the bounds of tests/test_distributed.py), and the port's
  single-rank run at rtol 1e-12.
* (1, 2): the eclipse flagship's wave-sharded forward (wnstep 3: an odd
  width, so the last window holds a padded column) equals JAX's at rtol
  1e-8; a TLI model's wave-sharded forward (the direct engine on each
  window with the whole line list) equals the unsharded one at 2e-4,
  the line-by-line bound (it agrees to ~1e-13 here), and each window's
  line ranges reach the cutoff beyond its edges.
* (2, 1): the DEMC run equals the single-rank run at rtol 1e-12;
  sample_nested with `mesh` equals JAX's run with its mesh and injected
  draws (tests/test_torch_nested.py's contract) and the port's
  single-rank run at rtol 1e-12, and so does a flagship run with draws
  of its own.
* driver.run of a runmode = spectrum config on 2 ranks through the
  dist_* keys: only rank 0 writes the log, both write equal spectra.
* `python -m pyratbay_tpu_torch.parallel.mp_probe --device cpu` prints
  the JAX probe's keys.

Every group runs under its own timeout, which kills its ranks; a rank
that fails kills the others.  Ports come from binding port 0.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import random  # noqa: E402

from pyratbay_tpu.benchmark import make_flagship as jmake_flagship  # noqa: E402
from pyratbay_tpu.parallel import sharded as jsharded  # noqa: E402
from pyratbay_tpu.retrieval import nested as jnested  # noqa: E402
from pyratbay_tpu.retrieval.forward import build_forward as jbuild_forward  # noqa: E402
from pyratbay_tpu_torch import benchmark  # noqa: E402
from pyratbay_tpu_torch.driver import run  # noqa: E402
from pyratbay_tpu_torch.model import Model  # noqa: E402
from pyratbay_tpu_torch.observation import Observation  # noqa: E402
from pyratbay_tpu_torch.parallel import sharded  # noqa: E402
from pyratbay_tpu_torch.parallel.mp_probe import free_port, run_group  # noqa: E402
from pyratbay_tpu_torch.retrieval.batched import build_forward_batched  # noqa: E402
from pyratbay_tpu_torch.retrieval.nested import sample_nested  # noqa: E402
from pyratbay_tpu_torch.retrieval.params import RetrievalParams  # noqa: E402

from test_torch_nested import assert_results_equal, jax_draws  # noqa: E402
from test_torch_sampler import _jax_draws  # noqa: E402
from torch_dist_worker import (  # noqa: E402
    FLAGSHIP, MU, NESTED, demc_run, gaussian)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, 'tests', 'torch_dist_worker.py')
GROUP_TIMEOUT = 300.0
RTOL = 1e-8
SAME_RTOL = 1e-12
LBL_TOL = 2e-4
NCHAINS = 16


def run_ranks(commands_on):
    """run_group of the commands that commands_on(port) gives for a port
    from free_port(); once more on another port when a rank found its
    port taken (under several test workers another process may bind it
    between free_port's release and the group's rendezvous)."""
    for _ in range(2):
        ranks = run_group(commands_on(free_port()), GROUP_TIMEOUT, cwd=REPO)
        if not any('address already in use' in (out + err).lower()
                   for _, out, err in ranks):
            break
    return ranks


def launch(tmp, nprocs, tasks, chains_axis=None, inputs=None, env=None,
           driver_cfgs=None):
    """Run a group of `nprocs` ranks of the worker; each rank's outputs
    by task.  driver_cfgs(port) writes the driver task's configs and
    returns their paths (the driver joins the group from their keys)."""
    tmp = str(tmp)
    base = dict(
        os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get(
            'PYTHONPATH', ''),
        PBT_TASKS=','.join(tasks), PBT_OUT=tmp, PBT_WORK=tmp,
        OMP_NUM_THREADS='1', **(env or {}))
    if chains_axis is not None:
        base['PBT_CHAINS_AXIS'] = str(chains_axis)
    if inputs is not None:
        base['PBT_IN'] = os.path.join(tmp, 'inputs.npz')
        np.savez(base['PBT_IN'], **inputs)

    def commands_on(port):
        if driver_cfgs is not None:
            return [([sys.executable, WORKER],
                     dict(base, PBT_RANK=str(rank), PBT_DRIVER_CFG=cfg))
                    for rank, cfg in enumerate(driver_cfgs(port))]
        return [([sys.executable, WORKER],
                 dict(base, PBT_COORDINATOR=f'localhost:{port}',
                      PBT_NPROCS=str(nprocs), PBT_PROCID=str(rank)))
                for rank in range(nprocs)]

    ranks = run_ranks(commands_on)
    for rank, (code, out, err) in enumerate(ranks):
        assert code == 0, f'rank {rank} exit {code}:\n{out}\n{err[-4000:]}'
    if driver_cfgs is not None:
        return ranks
    return [{task: dict(np.load(os.path.join(tmp, f'{task}_{rank}.npz')))
             for task in tasks} for rank in range(nprocs)]


def _params(p0, seed, n=8):
    rng = np.random.default_rng(seed)
    return np.tile(p0, (n, 1)) + 0.01 * rng.standard_normal((n, len(p0)))


def _jax_sharded_forward(tmp, devices, params, **kw):
    """JAX's wave-sharded forward of the test-size flagship."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    model, obs, ret, forward, p0 = jmake_flagship(str(tmp), **FLAGSHIP,
                                                  **kw)
    mesh = jsharded.make_mesh(devices)
    jsharded.shard_model_tables(model, obs, mesh)
    forward_sh = jbuild_forward(model, obs, ret)
    out = jax.jit(jax.vmap(forward_sh))(jax.device_put(
        params, NamedSharding(mesh, P('chains', None))))
    nwave = getattr(model, 'nwave_unpadded', model.nwave)
    return (np.asarray(out['spectrum'])[:, :nwave],
            np.asarray(out['bandflux']))


def _flagship_p0(tmp, **kw):
    _, _, _, _, p0 = benchmark.make_flagship(
        str(tmp), device='cpu', **FLAGSHIP, **kw)
    return p0


# ----------------------------------------------------------------------
# The JAX runs (the test process's virtual devices)

@pytest.fixture(scope='module')
def jax_demc(tmp_path_factory):
    """JAX's build_flagship_sharded on a (2, 2) mesh and two generations
    of its step from the float64 ensemble, with the draws of the keys."""
    mesh = jsharded.make_mesh(jax.devices()[:4])
    tmp = tmp_path_factory.mktemp('jax_demc')
    (model, obs, ret, log_post, step, chains,
     _) = jsharded.build_flagship_sharded(
        mesh, str(tmp), wnstep=4.0, **FLAGSHIP)
    # The ensemble as JAX draws it, in float64 (JAX stores float32):
    pstep = np.asarray(ret.pstep, float)
    rng = np.random.default_rng(0)
    chains0 = np.clip(np.asarray(ret.params, float) + np.where(
        pstep > 0, pstep, 0.0) * rng.standard_normal(
        (NCHAINS, len(pstep))), ret.pmin, ret.pmax)
    logp0 = jax.jit(jax.vmap(log_post))(jnp.asarray(chains0))
    chains, logp = jnp.asarray(chains0), logp0
    inputs = {'nchains': NCHAINS, 'data': obs.data, 'uncert': obs.uncert}
    for i in range(2):
        key = random.PRNGKey(i)
        chains, logp = step(chains, logp, key)
        for name, val in _jax_draws(key, NCHAINS, len(pstep)).items():
            inputs[f'draw{i}_{name}'] = val.numpy()
    return dict(chains0=chains0, logp0=np.asarray(logp0),
                chains=np.asarray(chains), logp=np.asarray(logp),
                inputs=inputs)


@pytest.fixture(scope='module')
def single_demc(tmp_path_factory, jax_demc):
    """The port's single-rank run on the same draws (no process group:
    a (1, 1) mesh without collectives)."""
    mesh = sharded.make_mesh(device='cpu')
    got = demc_run(mesh, jax_demc['inputs'],
                   str(tmp_path_factory.mktemp('single_demc')))
    assert got.pop('collectives') == 0
    return got


# ----------------------------------------------------------------------
# (2, 2): four ranks

@pytest.fixture(scope='module')
def group_22(tmp_path_factory, jax_demc):
    tmp = tmp_path_factory.mktemp('group_22')
    params = _params(_flagship_p0(tmp / 'p0', wnstep=2.0), 3)
    ranks = launch(tmp, 4, ['transit', 'demc'],
                   inputs={'params': params, **jax_demc['inputs']})
    return params, ranks


def test_group_22_layout(group_22):
    _, ranks = group_22
    for rank, out in enumerate(ranks):
        res = out['transit']
        assert list(res['mesh']) == [2, 2]
        assert list(res['coords']) == [rank // 2, rank % 2]
        assert str(res['backend']) == 'gloo'
        assert int(res['nprocs']) == 4
        # The rank holds half of the padded width:
        assert int(res['nwave_local']) == -(-int(res['nwave']) // 2)
        # Every rank gathered the same whole results:
        for task in ('transit', 'demc'):
            for key in ('chains', 'logp', 'spectrum', 'bandflux'):
                if key in out[task]:
                    np.testing.assert_array_equal(
                        out[task][key], ranks[0][task][key])


def test_transit_forward_22_matches_jax(group_22, tmp_path):
    params, ranks = group_22
    spec, band = _jax_sharded_forward(
        tmp_path, jax.devices()[:4], params, wnstep=2.0)
    got = ranks[0]['transit']
    np.testing.assert_allclose(got['spectrum'], spec, rtol=RTOL)
    np.testing.assert_allclose(got['bandflux'], band, rtol=RTOL)


def test_demc_22_matches_jax(group_22, jax_demc):
    got = group_22[1][0]['demc']
    np.testing.assert_array_equal(got['chains0'], jax_demc['chains0'])
    np.testing.assert_allclose(got['logp0'], jax_demc['logp0'], rtol=RTOL)
    np.testing.assert_allclose(got['chains'], jax_demc['chains'],
                               rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(got['logp'], jax_demc['logp'], rtol=RTOL)
    assert np.any(got['chains'] != got['chains0'])


def test_demc_22_matches_single_rank(group_22, single_demc):
    got = group_22[1][0]['demc']
    for key in ('logp0', 'chains', 'logp'):
        np.testing.assert_allclose(got[key], single_demc[key],
                                   rtol=SAME_RTOL, err_msg=key)
    # A generation: the wave all-reduce of the band fluxes and the chain
    # gather of the log-posterior; two more for the initial one.
    assert int(got['collectives']) == 2 * 3


# ----------------------------------------------------------------------
# (1, 2): two ranks on the wave axis

@pytest.fixture(scope='module')
def tli_case(tmp_path_factory):
    """A TLI model (tests/test_torch_lbl_retrieval.py's fixture, 1.1-1.141
    um: an odd width) and four chains of its parameters."""
    from test_torch_lbl_retrieval import RETRIEVAL_KEYS, _ObsCfg
    workdir = str(tmp_path_factory.mktemp('tli_case'))
    _, tli_cfg, opacity_cfg = benchmark.make_lbl_flagship(
        workdir, nlines=3000, seed=0, nlayers=6, wl_low=1.1, wl_high=1.141)
    run(tli_cfg, device='cpu')
    with open(opacity_cfg) as f:
        body = f.read().replace('runmode = opacity', 'runmode = retrieval')
    body = '\n'.join(ln for ln in body.splitlines() if not ln.startswith(
        ('sampled_cross_sec', 'tmin', 'tmax', 'tstep')))
    cfg = os.path.join(workdir, 'lbl.cfg')
    with open(cfg, 'w') as f:
        f.write(body + '\n' + RETRIEVAL_KEYS)
    model = Model(cfg, device='cpu')
    obs = Observation(_ObsCfg, model.wn)
    ret = RetrievalParams(model, obs)
    rng = np.random.default_rng(2)
    params = np.tile(ret.params, (4, 1)) + [50.0, 0.3, 0.02] \
        * rng.standard_normal((4, 3))
    with torch.no_grad():
        want = build_forward_batched(model, obs, ret)(params)
    return dict(cfg=cfg, params=params, filters=_ObsCfg.filters,
                nwave=model.nwave, spectrum=want['spectrum'].numpy(),
                bandflux=want['bandflux'].numpy())


@pytest.fixture(scope='module')
def group_12(tmp_path_factory, tli_case):
    tmp = tmp_path_factory.mktemp('group_12')
    params = _params(_flagship_p0(tmp / 'p0', wnstep=3.0,
                                  rt_path='eclipse'), 4)
    ranks = launch(tmp, 2, ['eclipse', 'tli'], chains_axis=1, inputs={
        'params': params, 'tli_params': tli_case['params'],
        'tli_filters': np.array(tli_case['filters'])},
        env={'PBT_TLI_CFG': tli_case['cfg']})
    return params, ranks


def test_eclipse_forward_12_matches_jax(group_12, tmp_path):
    params, ranks = group_12
    got = ranks[0]['eclipse']
    assert list(got['mesh']) == [1, 2]
    assert int(got['nwave']) % 2 == 1      # the last window is padded
    spec, band = _jax_sharded_forward(
        tmp_path, jax.devices()[:2], params, wnstep=3.0, rt_path='eclipse')
    np.testing.assert_allclose(got['spectrum'], spec, rtol=RTOL)
    np.testing.assert_allclose(got['bandflux'], band, rtol=RTOL)


def test_tli_forward_12_matches_unsharded(group_12, tli_case):
    got = group_12[1][0]['tli']
    assert int(got['nwave']) == tli_case['nwave']
    assert tli_case['nwave'] % 2 == 1
    for key in ('spectrum', 'bandflux'):
        np.testing.assert_allclose(got[key], tli_case[key], rtol=LBL_TOL,
                                   err_msg=key)


def test_tli_windows_reach_the_cutoff(group_12, tli_case):
    for rank, out in enumerate(group_12[1]):
        got = out['tli']
        lo, hi, need_lo, need_hi = got['window_lines']
        assert lo <= need_lo and hi >= need_hi
        # The engine was built on the rank's window of the grid:
        assert len(got['wn_local']) == -(-tli_case['nwave'] // 2)


# ----------------------------------------------------------------------
# (2, 1): two ranks on the chains axis

@pytest.fixture(scope='module')
def nested_jax():
    """JAX's nested run on a Gaussian with a (2, 1) mesh: its batch is
    set to a multiple of the chain shards, and its draws."""
    mesh = jsharded.make_mesh(jax.devices()[:2], chains_axis=2)
    key = random.PRNGKey(5)
    want = jnested.sample_nested(
        lambda t: -0.5 * jnp.sum(((t - MU) / 0.4)**2), lambda u: u, 3,
        key=key, mesh=mesh, **NESTED)
    batch = 2       # max(nlive // 16, 2) rounded down to 2 shards
    draws = jax_draws(key, NESTED['nlive'], 3, NESTED['nsteps_walk'],
                      batch, -(-NESTED['max_iter'] // batch))
    return want, draws


@pytest.fixture(scope='module')
def group_21(tmp_path_factory, jax_demc, nested_jax):
    tmp = tmp_path_factory.mktemp('group_21')
    _, draws = nested_jax
    return launch(tmp, 2, ['demc', 'nested'], chains_axis=2, inputs={
        **jax_demc['inputs'],
        **{f'nested_{k}': v for k, v in draws.items()}})


def test_demc_21_matches_single_rank(group_21, single_demc, jax_demc):
    got = group_21[0]['demc']
    assert list(got['mesh']) == [2, 1]
    for key in ('logp0', 'chains', 'logp'):
        np.testing.assert_allclose(got[key], single_demc[key],
                                   rtol=SAME_RTOL, err_msg=key)
    np.testing.assert_allclose(got['chains'], jax_demc['chains'],
                               rtol=RTOL, atol=1e-12)
    # The wave axis has one rank: the chain gathers alone.
    assert int(got['collectives']) == 3


def test_nested_mesh_matches_jax(group_21, nested_jax):
    want, _ = nested_jax
    got = {key[len('gauss_'):]: val for key, val in group_21[0][
        'nested'].items() if key.startswith('gauss_')}
    assert_results_equal(got, want)


def test_nested_mesh_matches_single_rank(group_21, nested_jax,
                                         tmp_path):
    _, draws = nested_jax
    got = group_21[0]['nested']
    single = sample_nested(gaussian, lambda u: u, 3, draws=draws, batch=2,
                           **NESTED)
    for key, val in single.items():
        np.testing.assert_allclose(got[f'gauss_{key}'], val,
                                   rtol=SAME_RTOL, err_msg=key)
    # The flagship's log-posterior, the sampler's own draws:
    (model, obs, ret, log_post, _, _) = sharded.build_flagship_sharded(
        sharded.make_mesh(device='cpu'), str(tmp_path), device='cpu',
        wnstep=4.0, **FLAGSHIP)
    free = np.flatnonzero(np.asarray(ret.pstep) > 0)
    lo = torch.as_tensor(np.asarray(ret.pmin, float))
    span = torch.as_tensor(np.asarray(ret.pmax, float)) - lo

    def transform(u):
        theta = torch.as_tensor(np.asarray(ret.params, float)).expand(
            u.shape[0], -1).clone()
        theta[:, free] = lo[free] + span[free] * u
        return theta

    with torch.no_grad():
        flag = sample_nested(log_post, transform, len(free), batch=2,
                             generator=torch.Generator().manual_seed(3),
                             **NESTED)
    for key, val in flag.items():
        np.testing.assert_allclose(got[f'flagship_{key}'], val,
                                   rtol=SAME_RTOL, err_msg=key)
    assert np.isfinite(flag['logz'])


# ----------------------------------------------------------------------
# The driver and the probe

def test_driver_two_ranks_only_rank0_logs(tmp_path):
    _, _, _, _, _ = benchmark.make_flagship(
        str(tmp_path), device='cpu', wnstep=8.0, **FLAGSHIP)
    with open(tmp_path / 'flagship.cfg') as f:
        text = f.read()

    def driver_cfgs(port):
        cfgs = []
        for rank in range(2):
            body = '\n'.join(
                f'logfile = {tmp_path}/run{rank}.log'
                if ln.startswith('logfile')
                else 'verb = 2' if ln.startswith('verb') else ln
                for ln in text.splitlines())
            cfg = tmp_path / f'spectrum{rank}.cfg'
            cfg.write_text(
                body + f'\nspecfile = {tmp_path}/spec{rank}.dat\n'
                f'dist_coordinator = localhost:{port}\ndist_nprocs = 2\n'
                f'dist_procid = {rank}\n')
            cfgs.append(str(cfg))
        return cfgs

    ranks = launch(tmp_path, 2, ['driver'], driver_cfgs=driver_cfgs)
    assert (tmp_path / 'run0.log').is_file()
    assert not (tmp_path / 'run1.log').exists()
    assert 'Run mode: spectrum' in (tmp_path / 'run0.log').read_text()
    assert 'Run mode: spectrum' in ranks[0][1]
    assert ranks[1][1] == ''
    spec = [np.loadtxt(tmp_path / f'spec{r}.dat', comments='#')
            for r in range(2)]
    np.testing.assert_array_equal(spec[0], spec[1])


def test_mp_probe_cpu_prints_jax_keys():
    import json
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    # The probe takes its own port (the one given here goes unused):
    (code, out, err), = run_ranks(lambda port: [(
        [sys.executable, '-m', 'pyratbay_tpu_torch.parallel.mp_probe',
         '--device', 'cpu', '--iters', '2', '--timeout', '200'], env)])
    assert code == 0, err[-4000:]
    line = json.loads(out.strip().splitlines()[-1])
    for key in ('nprocs', 'local_devices', 'nchains', 'sec_per_generation',
                'chain_evals_per_s'):
        assert key in line, line
    assert line['nprocs'] == 2 and line['nchains'] == 16
    assert line['backend'] == 'gloo' and line['device'] == 'cpu'
    assert line['mesh'] == [1, 2]
    assert line['sec_per_generation'] > 0
