"""The comparison that decides `correct`, driven through the rest of a
run with the look for a card skipped (on the CPU, at a small size): a
sound run is correct, and a run whose timed path is broken underneath
is not, once for each fault the cell can have: a step that returns its
state unchanged, half of the batch left out with the mean of the rest
in its place, and an answer altered where it is produced.  No cell runs
on several cards, so the exchange between cards has no fault here."""
import time

import torch

from portbench import harness
from portbench.tests import small


def _run(driver, cell, config, mix, seed=2**31 + 11):
    return harness.driver(driver).run(
        work=small.work(cell), config=config, mix=mix, seed=seed,
        seconds=1.0, trace=False, t0=time.perf_counter(), device='cpu')


def _demc(cell='flagship_r115k.demc512'):
    return _run('demc', cell, small.config(),
                small.mix('demc512', nchains=24, chunk_gens=10))


def _wrap_log_post(monkeypatch, wrap):
    from pyratbay_tpu_torch.retrieval import batched
    real = batched.build_log_posterior_batched
    monkeypatch.setattr(batched, 'build_log_posterior_batched',
                        lambda *a, **k: wrap(real(*a, **k)))


def test_sound_demc_run_is_correct():
    out = _demc()
    assert out['correct'], out['checks']


def test_demc_step_returning_its_state_is_not_correct(monkeypatch):
    from pyratbay_tpu_torch.retrieval import samplers
    monkeypatch.setattr(
        samplers, 'generation',
        lambda chains, logp, *a, **k: (
            chains, logp, torch.zeros(len(chains), dtype=torch.bool)))
    assert not _demc()['correct']


def test_demc_half_batch_left_out_is_not_correct(monkeypatch):
    def wrap(log_post):
        def half(x):
            n = x.shape[0] // 2
            lp = log_post(x[:n])
            return torch.cat([lp, lp.mean().expand(x.shape[0] - n)])
        return half
    _wrap_log_post(monkeypatch, wrap)
    assert not _demc()['correct']


def test_demc_altered_answer_is_not_correct(monkeypatch):
    def wrap(log_post):
        def altered(x):
            lp = log_post(x).clone()
            lp[0] += 1.0
            return lp
        return altered
    _wrap_log_post(monkeypatch, wrap)
    assert not _demc()['correct']
