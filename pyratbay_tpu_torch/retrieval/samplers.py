"""Ensemble MCMC: differential-evolution (DEMC) with snooker updates,
every generation evaluating all chains in one batched log-posterior.

Port of pyratbay_tpu/retrieval/samplers.py: the lax.scan over
generations becomes a Python loop, and the random draws of each
generation come from a torch.Generator as tensors (`draw_generation`),
so that a test can inject the JAX sampler's draws into
`_propose_de`, `_propose_snooker` and `generation`.  Checkpoints carry
the generator's state, so that a resumed run continues the random
stream of the interrupted one.

Moves (ter Braak 2006; ter Braak & Vrugt 2008):
  * DE move: x' = x + gamma (x_r1 - x_r2) + e,  gamma = 2.38/sqrt(2 d)
    (gamma = 1 every 10th generation for mode jumps);
  * snooker move (10% of proposals): stretch along (x - z) with the
    difference of two other chains projected onto that line.
"""
import os
import time

import numpy as np
import torch

from .. import tracing
from ..tracing import to_host

__all__ = ['sample_demc', 'gelman_rubin', 'draw_generation', 'generation']


def _skip_self(idx):
    """Shift draws in [0, n-1) past each chain's own index."""
    own = torch.arange(idx.shape[0], device=idx.device)
    return torch.where(idx >= own, idx + 1, idx)


def _propose_de(chains, gamma, eps_scale, free_mask, r1, r2, normal):
    """Differential-evolution proposals for all chains.

    r1, r2: [nchains] partner draws in [0, nchains-1); normal:
    [nchains, npars] standard normal draws.  Returns (proposals,
    log MH factor = 0).
    """
    r1 = _skip_self(r1)
    r2 = _skip_self(r2)
    diff = chains[r1] - chains[r2]
    noise = eps_scale * normal
    prop = chains + (gamma * diff + noise) * free_mask
    return prop, torch.zeros(chains.shape[0], dtype=chains.dtype,
                             device=chains.device)


def _propose_snooker(chains, free_mask, z_idx, r1, r2, gamma_s):
    """Snooker proposals: stretch along the line to a random chain z.

    z_idx: [nchains] draws in [0, nchains-1); r1, r2: [nchains] draws
    in [0, nchains); gamma_s: [nchains, 1] uniform in [1.2, 2.2).
    Returns (proposals, log MH factor |x'-z|^(d-1)/|x-z|^(d-1)).
    """
    z = chains[_skip_self(z_idx)]
    dz = chains - z
    norm2 = torch.sum(dz * dz, dim=1, keepdim=True)
    safe = torch.where(norm2 > 0, norm2, torch.ones_like(norm2))
    proj = torch.sum((chains[r1] - chains[r2]) * dz, dim=1, keepdim=True)
    prop = chains + gamma_s * proj * dz / safe * free_mask
    d_free = torch.sum(free_mask)
    new_norm2 = torch.sum((prop - z)**2, dim=1)
    one = torch.ones_like(new_norm2)
    log_mh = 0.5 * (d_free - 1.0) * (
        torch.log(torch.where(new_norm2 > 0, new_norm2, one))
        - torch.log(torch.where(norm2[:, 0] > 0, norm2[:, 0], one))
    )
    return prop, log_mh


def draw_generation(generator, nchains, npars, dtype, device):
    """All random draws of one generation, as a dict of tensors."""
    kw = dict(generator=generator, device=device)
    return {
        'choice': torch.rand((nchains, 1), dtype=dtype, **kw),
        'de_r1': torch.randint(0, nchains - 1, (nchains,), **kw),
        'de_r2': torch.randint(0, nchains - 1, (nchains,), **kw),
        'de_normal': torch.randn((nchains, npars), dtype=dtype, **kw),
        'sn_z': torch.randint(0, nchains - 1, (nchains,), **kw),
        'sn_r1': torch.randint(0, nchains, (nchains,), **kw),
        'sn_r2': torch.randint(0, nchains, (nchains,), **kw),
        'sn_gamma': 1.2 + torch.rand((nchains, 1), dtype=dtype, **kw),
        'accept': torch.rand((nchains,), dtype=dtype, **kw),
    }


def generation(chains, logp, gamma, eps_scale, free_mask, draws,
               log_post_batched, snooker_fraction=0.1):
    """One DEMC generation over the ensemble.

    Returns (new_chains, new_logp, accept [nchains] bool).
    """
    with tracing.span('pbt.demc.propose'):
        prop_de, mh_de = _propose_de(
            chains, gamma, eps_scale, free_mask,
            draws['de_r1'], draws['de_r2'], draws['de_normal'],
        )
        prop_sn, mh_sn = _propose_snooker(
            chains, free_mask, draws['sn_z'], draws['sn_r1'],
            draws['sn_r2'], draws['sn_gamma'],
        )
        use_snooker = draws['choice'] < snooker_fraction
        prop = torch.where(use_snooker, prop_sn, prop_de)
        log_mh = torch.where(use_snooker[:, 0], mh_sn, mh_de)
    logp_prop = log_post_batched(prop)
    with tracing.span('pbt.demc.accept'):
        log_alpha = logp_prop - logp + log_mh
        accept = torch.log(draws['accept']) < log_alpha
        new_chains = torch.where(accept[:, None], prop, chains)
        new_logp = torch.where(accept, logp_prop, logp)
    return new_chains, new_logp, accept


def _gen_seed(seed, igen):
    """The generator seed of a run resumed at `igen` from a checkpoint
    that holds no generator state."""
    return int(np.random.SeedSequence([int(seed), int(igen)])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


def _load_checkpoint(checkpoint_file, generator, ngen, log):
    """The state of a checkpoint (pyratbay_tpu's keys, plus the
    generator state this package writes); sets `generator` to continue
    the checkpointed run's random stream."""
    with np.load(checkpoint_file) as ckpt:
        state = {key: ckpt[key] for key in ckpt.files}
    igen = int(state['igen'])
    rng_state = state.get('rng_state')
    same_device = (rng_state is not None and str(state['rng_device'])
                   == generator.device.type)
    if same_device:
        generator.set_state(torch.as_tensor(rng_state))
    else:
        # A checkpoint written by pyratbay_tpu (or on another device):
        # its JAX key stream cannot be continued here.
        generator.manual_seed(_gen_seed(generator.initial_seed(), igen))
    if log is not None:
        log.msg(f'Resuming retrieval from {checkpoint_file} at '
                f'generation {igen}/{ngen}')
        if not same_device:
            log.msg('The checkpoint holds no generator state of this '
                    f'device: the generator is seeded from the run\'s seed '
                    f'and generation {igen}')
    return state, igen


def _write_checkpoint(checkpoint_file, chains, igen, gamma, eps_scale,
                      hist_parts, generator):
    """pyratbay_tpu's checkpoint keys, plus the generator state."""
    hist = [np.concatenate([part[i] for part in hist_parts])
            for i in range(3)]
    np.savez(
        checkpoint_file, chains=to_host(chains).numpy(), igen=igen,
        gamma=np.asarray(gamma), eps_scale=to_host(eps_scale).numpy(),
        hist_chains=hist[0], hist_logp=hist[1], hist_accept=hist[2],
        rng_state=generator.get_state().numpy(),
        rng_device=generator.device.type)


def sample_demc(
        log_post_batched, init_params, nsamples, generator=None,
        nchains=None, pstep=None, pmin=None, pmax=None,
        snooker_fraction=0.1, thin=1, burnin=0,
        checkpoint_file=None, checkpoint_dt=None, resume=False,
        chunk_gens=None, log=None,
        adapt_gamma=False, target_acceptance=0.234, gamma_init=None,
        history_thin=1, dtype=None, device=None,
    ):
    """Run snooker-DEMC over a batched log-posterior.

    log_post_batched: params [B, npars] -> [B].
    init_params: [npars] center (jittered by pstep) or [nchains,
    npars] explicit ensemble.  nsamples: total draws (nchains * ngen).

    The generations run in chunks of `chunk_gens` (default: the whole
    run, or at most 200 with a checkpoint file); the history of a chunk
    stays on the device and is copied to the host once at its end.
    adapt_gamma scales the DE step toward `target_acceptance` after every
    chunk, from the acceptance of the chunk's last recorded part.
    history_thin records the last state of every whole stride of
    `history_thin` generations of a chunk, and one record for a partial
    stride at its end; burnin and thin then count recorded samples.
    checkpoint_file: npz of the chain state and history, written when
    `checkpoint_dt` seconds (default 600) have passed since the last one
    and at the end, with the generator's state; resume continues from it
    (pyratbay_tpu's checkpoints too, whose generator is then seeded from
    the generator's initial seed and the generation).

    Returns dict with 'posterior' [nkept, npars], 'log_post' [nkept],
    'chains', 'chain_history' [nrecords, nchains, npars],
    'acceptance_rate', 'bestp', 'best_log_post', 'gamma_final'
    (posterior arrays as numpy).
    """
    with tracing.span('pbt.demc.run', gen=-1):
        init = torch.as_tensor(init_params, dtype=dtype, device=device)
        dtype, device = init.dtype, init.device
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        init = torch.atleast_2d(init)

        def tensor(a):
            # A copy of host data to the device waits for the stream:
            tracing.count(tracing.HOST_WAITS)
            return torch.as_tensor(
                np.asarray(a, float), dtype=dtype, device=device)

        if init.shape[0] == 1:
            if nchains is None:
                raise ValueError('nchains needed with a single init vector')
            npars = init.shape[1]
            step = (
                torch.clamp(tensor(pstep), min=0.0) if pstep is not None
                else 0.01 * torch.abs(init[0]) + 1e-4
            )
            chains = init + step * torch.randn(
                (nchains, npars), generator=generator, dtype=dtype,
                device=device)
        else:
            chains = init
            nchains, npars = chains.shape
        if pmin is not None:
            chains = torch.minimum(torch.maximum(chains, tensor(pmin)),
                                   tensor(pmax))

        free_mask = (
            (tensor(pstep) > 0).to(dtype) if pstep is not None
            else torch.ones(npars, dtype=dtype, device=device)
        )
        d_free = float(to_host(torch.sum(free_mask)))
        gamma0 = (
            float(gamma_init) if gamma_init is not None
            else 2.38 / np.sqrt(2.0 * max(d_free, 1.0))
        )
        eps_scale = (
            1e-4 * torch.clamp(tensor(pstep), min=0.0) if pstep is not None
            else torch.full((npars,), 1e-6, dtype=dtype, device=device)
        )

        ngen = int(np.ceil(nsamples / nchains))
        igen = 0
        hist_parts = []
        if resume and checkpoint_file is not None \
                and os.path.isfile(checkpoint_file):
            ckpt, igen = _load_checkpoint(checkpoint_file, generator, ngen,
                                          log)
            chains = tensor(ckpt['chains'])
            hist_parts.append((ckpt['hist_chains'], ckpt['hist_logp'],
                               ckpt['hist_accept']))
            if 'gamma' in ckpt:
                gamma0 = float(ckpt['gamma'])
            if 'eps_scale' in ckpt:
                eps_scale = tensor(ckpt['eps_scale']) * torch.ones(
                    npars, dtype=dtype, device=device)
        if chunk_gens is None:
            chunk_gens = ngen if checkpoint_file is None \
                else max(1, min(200, ngen))
        logp = log_post_batched(chains)
        t_last = time.time()
        dt_ckpt = checkpoint_dt if checkpoint_dt is not None else 600.0
        while igen < ngen:
            hi = min(igen + chunk_gens, ngen)
            with tracing.span('pbt.demc.chunk', gen=igen):
                tracing.count('pbt.demc.generations', hi - igen)
                # Record the last state of each whole stride of the chunk,
                # and the chunk's final state for a partial stride:
                rec_chains, rec_logp, rec_accept = [], [], []
                for jgen in range(igen, hi):
                    gamma = 1.0 if jgen % 10 == 9 else gamma0
                    with tracing.span('pbt.demc.draws', gen=jgen):
                        draws = draw_generation(generator, nchains, npars,
                                                dtype, device)
                    chains, logp, accept = generation(
                        chains, logp, gamma, eps_scale, free_mask, draws,
                        log_post_batched, snooker_fraction,
                    )
                    if (jgen - igen + 1) % history_thin == 0 \
                            or jgen == hi - 1:
                        rec_chains.append(chains)
                        rec_logp.append(logp)
                        rec_accept.append(accept)
                with tracing.span('pbt.demc.history'):
                    part = tuple(to_host(torch.stack(rec)).numpy()
                                 for rec in (rec_chains, rec_logp,
                                             rec_accept))
                hist_parts.append(part)
                partial = (hi - igen) % history_thin \
                    if history_thin > 1 else 0
                igen = hi
                if adapt_gamma:
                    # pyratbay_tpu adapts on its last history part: the
                    # partial stride's one record when there is one.
                    acc = float(part[2][-1:].mean() if partial
                                else part[2].mean())
                    gamma0 *= float(np.exp(
                        np.clip(acc - target_acceptance, -0.25, 0.25)))
                if checkpoint_file is not None and (
                        time.time() - t_last > dt_ckpt or igen == ngen):
                    with tracing.span('pbt.demc.checkpoint'):
                        _write_checkpoint(checkpoint_file, chains, igen,
                                          gamma0, eps_scale, hist_parts,
                                          generator)
                    t_last = time.time()
                    if log is not None:
                        log.msg(f'Checkpoint at generation {igen}/{ngen} '
                                f'-> {checkpoint_file}')

        history, history_logp, accepts = (
            np.concatenate([part[i] for part in hist_parts])
            for i in range(3))
        kept = history[burnin::thin]
        kept_logp = history_logp[burnin::thin]
        posterior = kept.reshape(-1, npars)
        flat_logp = kept_logp.reshape(-1)
        ibest = int(np.argmax(flat_logp))
        return {
            'gamma_final': gamma0,
            'posterior': posterior,
            'log_post': flat_logp,
            'chains': chains,
            'chain_history': history,
            'acceptance_rate': float(np.mean(accepts)),
            'bestp': posterior[ibest],
            'best_log_post': flat_logp[ibest],
        }


def gelman_rubin(chain_history):
    """Gelman-Rubin potential scale reduction factor per parameter.

    chain_history: [ngen, nchains, npars] post-burn-in samples (numpy).
    """
    chain_history = np.asarray(chain_history, float)
    ngen, nchains, npars = chain_history.shape
    chain_means = np.mean(chain_history, axis=0)
    grand_mean = np.mean(chain_means, axis=0)
    between = ngen / (nchains - 1) * np.sum(
        (chain_means - grand_mean)**2, axis=0)
    within = np.mean(np.var(chain_history, axis=0, ddof=1), axis=0)
    var_est = (ngen - 1) / ngen * within + between / ngen
    return np.sqrt(var_est / np.where(within > 0, within, 1.0))
