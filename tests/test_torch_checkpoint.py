"""What a long retrieval needs: history_thin, checkpoints and resume in
the port's sample_demc, against pyratbay_tpu's sampler semantics, and
the retrieval driver's checkpoint file and file log.

The port draws from a torch.Generator where pyratbay_tpu splits JAX keys,
so the two samplers' histories differ; what is compared with pyratbay_tpu
is which generations are recorded (their count for each (ngen,
history_thin, chunk_gens)) and the state a pyratbay_tpu checkpoint
carries.  Against the port itself the comparisons are exact: a thinned
history equals the unthinned one at the recorded generations, and an
interrupted and resumed run equals an uninterrupted one.
"""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402
from jax import random  # noqa: E402

from pyratbay_tpu.retrieval import samplers as jsamplers  # noqa: E402
from pyratbay_tpu_torch.benchmark import make_flagship  # noqa: E402
from pyratbay_tpu_torch.logger import Log  # noqa: E402
from pyratbay_tpu_torch.retrieval import samplers  # noqa: E402

NCHAINS, NPARS = 10, 4
MU = np.array([0.3, -1.0, 2.0, 0.0])
SIG = np.array([0.5, 1.0, 0.2, 1.0])
PSTEP = np.array([0.1, 0.2, 0.05, 0.0])      # last parameter fixed


def _log_post(p):
    return -0.5 * torch.sum(((p - torch.as_tensor(MU)) / torch.as_tensor(
        SIG))**2, dim=1)


def _jlog_post(p):
    return -0.5 * jnp.sum(((p - MU) / SIG)**2)


def _run(ngen, seed=4, **kw):
    return samplers.sample_demc(
        _log_post, MU, nsamples=NCHAINS * ngen, nchains=NCHAINS,
        generator=torch.Generator().manual_seed(seed), pstep=PSTEP,
        dtype=torch.float64, **kw)


def _recorded(ngen, thin, chunk, start=0):
    """Generations pyratbay_tpu records: the last of each whole stride
    of a chunk, and a chunk's last for a partial stride."""
    gens = []
    for lo in range(start, ngen, chunk):
        hi = min(lo + chunk, ngen)
        gens += list(range(lo + thin - 1, hi, thin))
        if (hi - lo) % thin:
            gens.append(hi - 1)
    return gens


@pytest.mark.parametrize('ngen, thin, chunk', [
    (12, 3, None),
    (13, 5, None),
    (14, 3, 4),      # a partial stride at the end of every chunk
])
def test_history_thin_records_jax_generations(ngen, thin, chunk):
    full = _run(ngen)
    thinned = _run(ngen, history_thin=thin, chunk_gens=chunk)
    gens = _recorded(ngen, thin, chunk or ngen)
    np.testing.assert_array_equal(thinned['chain_history'],
                                  full['chain_history'][gens])
    np.testing.assert_array_equal(thinned['log_post'],
                                  full['log_post'].reshape(ngen, -1)[gens]
                                  .reshape(-1))
    torch.testing.assert_close(thinned['chains'], full['chains'],
                               rtol=0, atol=0)
    # burnin and thin count recorded samples:
    kept = _run(ngen, history_thin=thin, chunk_gens=chunk, burnin=1,
                thin=2)
    np.testing.assert_array_equal(
        kept['posterior'],
        full['chain_history'][gens][1::2].reshape(-1, NPARS))

    ref = jsamplers.sample_demc(
        _jlog_post, MU, nsamples=NCHAINS * ngen, nchains=NCHAINS,
        key=random.PRNGKey(1), pstep=PSTEP, history_thin=thin,
        chunk_gens=chunk)
    assert np.asarray(ref['chain_history']).shape == \
        thinned['chain_history'].shape == (len(gens), NCHAINS, NPARS)


class _Interrupt(RuntimeError):
    pass


def _raising_at(k):
    """A log-posterior that raises at its call for generation k (the
    first call evaluates the initial ensemble)."""
    calls = [0]

    def log_post(p):
        calls[0] += 1
        if calls[0] == k + 2:
            raise _Interrupt(f'generation {k}')
        return _log_post(p)
    return log_post


@pytest.mark.parametrize('thin, adapt', [(1, False), (2, True)])
def test_interrupted_and_resumed_equals_uninterrupted(tmp_path, thin,
                                                      adapt):
    ngen, chunk = 17, 4
    ckpt = str(tmp_path / 'run_checkpoint.npz')
    kw = dict(history_thin=thin, chunk_gens=chunk, adapt_gamma=adapt,
              burnin=2)
    whole = _run(ngen, **kw)
    generator = torch.Generator().manual_seed(4)
    with pytest.raises(_Interrupt):
        samplers.sample_demc(
            _raising_at(10), MU, nsamples=NCHAINS * ngen, nchains=NCHAINS,
            generator=generator, pstep=PSTEP, dtype=torch.float64,
            checkpoint_file=ckpt, checkpoint_dt=0.0, **kw)
    with np.load(ckpt) as saved:
        assert int(saved['igen']) == 8          # the last whole chunk
        assert {'chains', 'igen', 'gamma', 'eps_scale', 'hist_chains',
                'hist_logp', 'hist_accept', 'rng_state'} <= set(saved.files)
    resumed = _run(ngen, seed=99, checkpoint_file=ckpt, resume=True,
                   checkpoint_dt=0.0, **kw)
    for key in ('chain_history', 'posterior', 'log_post', 'bestp'):
        np.testing.assert_array_equal(resumed[key], whole[key], err_msg=key)
    assert resumed['gamma_final'] == whole['gamma_final']
    assert resumed['acceptance_rate'] == whole['acceptance_rate']
    with np.load(ckpt) as saved:
        assert int(saved['igen']) == ngen
        np.testing.assert_array_equal(saved['hist_chains'],
                                      whole['chain_history'])


def test_resumes_a_jax_checkpoint(tmp_path):
    """A checkpoint that pyratbay_tpu wrote: chains, igen, the history
    rows, the adapted gamma and eps_scale carry over; the generator is
    seeded from the run's seed and igen, and the log says so."""
    ckpt = str(tmp_path / 'jax_checkpoint.npz')
    ref = jsamplers.sample_demc(
        _jlog_post, MU, nsamples=NCHAINS * 6, nchains=NCHAINS,
        key=random.PRNGKey(2), pstep=PSTEP, checkpoint_file=ckpt,
        checkpoint_dt=0.0, chunk_gens=3, adapt_gamma=True)
    with np.load(ckpt) as saved:
        jax_ckpt = {key: saved[key] for key in saved.files}
    assert 'rng_state' not in jax_ckpt and int(jax_ckpt['igen']) == 6
    gamma0 = 2.38 / np.sqrt(2.0 * 3)
    assert float(jax_ckpt['gamma']) != gamma0

    log = Log(logname=str(tmp_path / 'resume.log'), verb=-1)
    same = _run(6, checkpoint_file=ckpt, resume=True, log=log)
    np.testing.assert_array_equal(same['chains'].numpy(), jax_ckpt['chains'])
    np.testing.assert_array_equal(same['chain_history'],
                                  np.asarray(ref['chain_history']))
    assert same['gamma_final'] == float(jax_ckpt['gamma'])

    # Two resumed runs, each from its own copy of the JAX checkpoint:
    copies = [str(tmp_path / f'copy{i}_checkpoint.npz') for i in range(2)]
    runs = []
    for copy in copies:
        shutil.copyfile(ckpt, copy)
        runs.append(_run(10, checkpoint_file=copy, resume=True, log=log))
    log.close()
    for res in runs:
        assert res['chain_history'].shape == (10, NCHAINS, NPARS)
        np.testing.assert_array_equal(res['chain_history'][:6],
                                      jax_ckpt['hist_chains'])
        assert not np.array_equal(res['chain_history'][6],
                                  res['chain_history'][5])
    # The same seed and igen give the same continuation:
    np.testing.assert_array_equal(runs[0]['chain_history'],
                                  runs[1]['chain_history'])
    with np.load(copies[0]) as saved:
        assert int(saved['igen']) == 10
        assert float(saved['gamma']) == float(jax_ckpt['gamma'])
        np.testing.assert_array_equal(saved['eps_scale'],
                                      jax_ckpt['eps_scale'])
        assert 'rng_state' in saved.files
    with open(tmp_path / 'resume.log') as f:
        text = f.read()
    assert 'Resuming retrieval from' in text
    assert 'seeded from the run\'s seed and generation 6' in text


def test_driver_checkpoints_resumes_and_opens_its_log(tmp_path):
    from pyratbay_tpu_torch.retrieval.driver import run_retrieval
    workdir = str(tmp_path)
    model, obs, _, forward, p0 = make_flagship(
        workdir, nlayers=11, wl_low=1.1, wl_high=1.2, wnstep=10.0,
        device='cpu')
    cfg = model.cfg
    cfg.data = forward(p0)['bandflux'].numpy()
    cfg.uncert = np.full(len(cfg.data), 3e-5)
    cfg.filters = [f'tophat {b.wl0:.4f} {b.half_width}'
                   for b in obs.filters]
    cfg.nchains, cfg.nsamples, cfg.burnin = 8, 8 * 5, 1
    cfg.dt_retrieval_snapshot = 0.0
    assert model.log.logname is None
    first = run_retrieval(model, seed=3)
    ckpt = os.path.join(workdir, 'flagship_checkpoint.npz')
    with np.load(ckpt) as saved:
        assert int(saved['igen']) == 5
    assert model.log.logname == cfg.logfile
    model.log.close()
    with open(cfg.logfile) as f:
        assert 'Checkpoint at generation 5/5' in f.read()

    cfg.resume, cfg.nsamples = True, 8 * 9
    model.log = Log(verb=-1)     # as a new Model's
    second = run_retrieval(model, seed=3)
    model.log.close()
    with np.load(ckpt) as saved:
        assert int(saved['igen']) == 9
    np.testing.assert_array_equal(second['chain_history'][:5],
                                  first['chain_history'])
    assert second['posterior'].shape == (8 * 8, len(p0))
    with open(cfg.logfile) as f:
        text = f.read()
    # The resumed run appends to the log:
    assert 'Checkpoint at generation 5/5' in text
    assert 'Resuming retrieval from' in text
