"""The port's several-process pieces that one process can hold, float64
on the CPU (tests/test_torch_distributed.py runs process groups):

* make_mesh's split of 1-8 ranks equals the JAX package's make_mesh on
  as many of the conftest's virtual devices; without a process group the
  mesh is (1, 1) and its collectives are the identity.
* initialize_distributed's precedence (pyratbay_tpu/parallel/
  distributed.py): nothing configured creates no group; config keys
  before PBT_COORDINATOR / PBT_NPROCS / PBT_PROCID; the variables alone;
  PBT_NPROCS=auto through torch's env:// (a group of one rank in this
  process, destroyed after each test); the backend rule.
* Log mutes every rank but 0 (tests/test_logger.py's counterparts, by
  argument, by PBT_PROCID and by an initialized group's rank).
* shard_model_tables on the eclipse flagship at an odd width: each
  rank's window of the spectrum is the unsharded spectrum's columns (the
  padded column repeats the last), the windows' band products sum to the
  unsharded band fluxes, the tensors hold W / n columns, and a model is
  sharded once.  The ranks are emulated by two meshes without a group,
  whose collectives are the identity.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402

from pyratbay_tpu.parallel import sharded as jsharded  # noqa: E402
from pyratbay_tpu_torch.benchmark import make_flagship  # noqa: E402
from pyratbay_tpu_torch.logger import Log  # noqa: E402
from pyratbay_tpu_torch.parallel import distributed  # noqa: E402
from pyratbay_tpu_torch.parallel import sharded  # noqa: E402
from pyratbay_tpu_torch.parallel.mp_probe import free_port  # noqa: E402
from pyratbay_tpu_torch.retrieval.batched import build_forward_batched  # noqa: E402

RTOL = 1e-12
DIST_VARS = ('PBT_COORDINATOR', 'PBT_NPROCS', 'PBT_PROCID', 'RANK',
             'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT', 'LOCAL_RANK',
             'LOCAL_WORLD_SIZE')


@pytest.mark.parametrize('nranks', range(1, 9))
def test_mesh_shape_matches_jax(nranks):
    want = jsharded.make_mesh(jax.devices()[:nranks]).devices.shape
    assert sharded.mesh_shape(nranks) == want


def test_mesh_without_group_is_the_identity():
    mesh = sharded.make_mesh(device='cpu')
    assert mesh.shape == {'chains': 1, 'wave': 1}
    assert mesh.coords == {'chains': 0, 'wave': 0}
    x = torch.arange(6.0).reshape(2, 3)
    assert mesh.gather(x, 'wave', -1) is x
    assert mesh.all_sum(x, 'chains') is x
    assert sharded.split_chains(lambda p: 2 * p, mesh)(x).equal(2 * x)
    assert mesh.calls == mesh.host_syncs == 0
    with pytest.raises(ValueError, match='3 chain shards'):
        sharded.mesh_shape(4, chains_axis=3)


@pytest.mark.parametrize('nrows', [8, 7, 5])
def test_split_chains_slices_and_pads(nrows):
    """Each of 3 chain shards evaluates its slice of the rows (the
    last row repeated up to a multiple of 3); their slices in coordinate
    order are the whole evaluation, cut back to the rows given.  The
    gather is emulated."""
    x = torch.arange(nrows * 2, dtype=torch.float64).reshape(nrows, 2)
    seen = []

    def fn(rows):
        seen.append(rows.clone())
        return rows.sum(dim=1)

    total = 0
    for coord in range(3):
        mesh = sharded.Mesh((3, 1))
        mesh.coords['chains'] = coord
        # Each rank's block at its offset (the others' rows zero), as
        # the all-reduce of the zero-filled buffer adds them up:
        mesh.gather = lambda y, axis, dim: torch.cat(
            [torch.zeros(coord * len(y)), y,
             torch.zeros((2 - coord) * len(y))]).to(y.dtype)
        total = total + sharded.split_chains(fn, mesh)(x)
    assert total.equal(x.sum(dim=1))
    per = -(-nrows // 3)
    assert [len(rows) for rows in seen] == [per] * 3
    padded = torch.cat(seen)
    assert padded[:nrows].equal(x)
    assert all(row.equal(x[-1]) for row in padded[nrows:])


# ----------------------------------------------------------------------
# The bootstrap

@pytest.fixture
def clean_env(monkeypatch):
    for var in DIST_VARS:
        monkeypatch.delenv(var, raising=False)
    yield monkeypatch
    if dist.is_initialized():
        dist.destroy_process_group()


class _Cfg:
    def __init__(self, coordinator=None, nprocs=None, procid=None):
        self.dist_coordinator = coordinator
        self.dist_nprocs = nprocs
        self.dist_procid = procid


def test_nothing_configured_stays_single_process(clean_env):
    assert distributed.initialize_distributed(_Cfg(), device='cpu') is False
    assert distributed.initialize_distributed(None, device='cpu') is False
    assert not distributed.is_initialized()
    assert distributed.process_index() == 0
    assert distributed.process_count() == 1


def test_config_keys_before_environment(clean_env):
    # The variables name a group of 7 that does not exist: the config's
    # group of one is the one joined.
    clean_env.setenv('PBT_COORDINATOR', 'localhost:1')
    clean_env.setenv('PBT_NPROCS', '7')
    clean_env.setenv('PBT_PROCID', '3')
    cfg = _Cfg(f'localhost:{free_port()}', 1, 0)
    assert distributed.initialize_distributed(cfg, device='cpu') is False
    assert distributed.is_initialized()
    assert (distributed.process_index(), distributed.process_count()) \
        == (0, 1)
    assert dist.get_backend() == 'gloo'
    # A second call keeps the group:
    assert distributed.initialize_distributed(cfg, device='cpu') is False


def test_environment_alone(clean_env):
    clean_env.setenv('PBT_COORDINATOR', f'tcp://localhost:{free_port()}')
    clean_env.setenv('PBT_NPROCS', '1')
    clean_env.setenv('PBT_PROCID', '0')
    distributed.initialize_distributed(device='cpu')
    assert distributed.is_initialized()
    assert distributed.process_count() == 1
    # The mesh of a group of one rank: a device mesh whose axes have one
    # rank each, so that no collective is made.
    mesh = sharded.make_mesh(device='cpu')
    assert mesh.shape == {'chains': 1, 'wave': 1}
    assert mesh.backend == 'gloo' and mesh.device_mesh is not None
    x = torch.ones(3, dtype=torch.float64)
    assert mesh.gather(x, 'chains', 0) is x
    assert mesh.calls == mesh.host_syncs == 0


def test_auto_uses_torch_environment(clean_env):
    clean_env.setenv('PBT_NPROCS', 'auto')
    for var, val in (('RANK', '0'), ('WORLD_SIZE', '1'),
                     ('MASTER_ADDR', 'localhost'),
                     ('MASTER_PORT', str(free_port()))):
        clean_env.setenv(var, val)
    assert distributed.initialize_distributed(device='cpu') is False
    assert distributed.is_initialized()
    assert distributed.process_count() == 1


def test_incomplete_configuration_raises(clean_env):
    with pytest.raises(ValueError, match='rank'):
        distributed.initialize_distributed(
            _Cfg('localhost:1', 2, None), device='cpu')
    assert not distributed.is_initialized()


def test_backend_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
    assert distributed.backend_for('cpu', 4) == 'gloo'
    assert distributed.backend_for('cuda', 2) == 'nccl'
    assert distributed.backend_for('cuda', 1) == 'nccl'
    # Ranks sharing a card:
    assert distributed.backend_for('cuda', 3) == 'gloo'


# ----------------------------------------------------------------------
# Rank muting

def test_error_muted_on_nonzero_rank(capsys):
    log = Log(verb=2, rank=3)
    assert log.verb == -1
    with pytest.raises(ValueError):
        log.error('worker error')
    captured = capsys.readouterr()
    assert captured.out == ''
    assert captured.err == ''


@pytest.mark.parametrize('procid', ['0', '1'])
def test_procid_variable_mutes_other_ranks(tmp_path, capsys, monkeypatch,
                                           procid):
    monkeypatch.setenv('PBT_PROCID', procid)
    logname = tmp_path / 'run.log'
    with Log(logname=str(logname), verb=2) as log:
        log.head('a head line')
        log.warning('a warning')
    captured = capsys.readouterr()
    if procid == '0':
        assert log.rank == 0 and log.verb == 2
        assert 'a head line' in captured.out
        assert 'a head line' in logname.read_text()
    else:
        assert log.rank == 1 and log.verb == -1 and log.file is None
        assert captured.out == captured.err == ''
        assert not logname.exists()
    assert log.warnings == ['a warning']


def test_group_rank_is_the_log_rank(clean_env):
    distributed.initialize_distributed(
        _Cfg(f'localhost:{free_port()}', 1, 0), device='cpu')
    assert Log(verb=2).rank == 0
    clean_env.setattr(distributed, 'process_index', lambda: 2)
    assert Log(verb=2).verb == -1


# ----------------------------------------------------------------------
# Wave windows, one process

def test_wave_windows_sum_to_the_unsharded_forward(tmp_path):
    kw = dict(nlayers=21, wl_low=1.1, wl_high=1.3, wnstep=3.0,
              rt_path='eclipse', device='cpu')
    model, obs, ret, _, p0 = make_flagship(str(tmp_path / 'whole'), **kw)
    nwave = model.nwave
    assert nwave % 2 == 1
    rng = np.random.default_rng(1)
    params = np.tile(p0, (4, 1)) + 0.01 * rng.standard_normal((4, len(p0)))
    with torch.no_grad():
        want = build_forward_batched(model, obs, ret)(params)
    width = (nwave + 1) // 2
    band = 0.0
    for rank in range(2):
        mesh = sharded.Mesh((1, 2))
        mesh.coords['wave'] = rank
        m, o, r, _, _ = make_flagship(str(tmp_path / f'r{rank}'), **kw)
        sharded.shard_model_tables(m, o, mesh)
        assert (m.nwave, m.nwave_unpadded) == (width, nwave)
        assert m.mesh is mesh and o.mesh is mesh
        for t in (m._wn, m._starflux, o._bands_t,
                  *[op._table for mtype, op, _ in m.opacity_models
                    if mtype == 'line_sample']):
            assert t.shape[-1 if t is not o._bands_t else 0] == width
            assert t.is_contiguous()
        with torch.no_grad():
            got = build_forward_batched(m, o, r)(params)
        cols = np.minimum(np.arange(width) + rank * width, nwave - 1)
        np.testing.assert_allclose(got['spectrum'].numpy(),
                                   want['spectrum'].numpy()[:, cols],
                                   rtol=RTOL)
        band = band + got['bandflux'].numpy()
        with pytest.raises(ValueError, match='sharded already'):
            sharded.shard_model_tables(m, o, mesh)
    np.testing.assert_allclose(band, want['bandflux'].numpy(), rtol=RTOL)
