"""Nested sampling with batched MCMC replacement (the sampler of
`sampler = multinest`).

Port of pyratbay_tpu/retrieval/nested.py.  Skilling nested sampling
whose live points stay on the device: every scan step removes the
`batch` worst live points at once and replaces them with MCMC walks
cloned from random survivors, each walk step one batched likelihood
call over the `batch` walkers (on the card, one batched forward: K1 or
K3 at B = batch).  The lax.scan over steps becomes a Python loop that
reads nothing back from the device: the sort, the live set's covariance
and its Cholesky factor (cholesky_ex, which leaves its status on the
device), the proposals, the hard constraint and the replacement
(index_copy) are device operations, the dead points go into
preallocated device buffers, and one copy brings them to the host at
the end.  Every scan step runs, as in the JAX package: the truncation
at `stop_dlogz` and the live points that are added both read the
final live set, so an early stop would change the result.

The random draws of a run come from a torch.Generator as tensors, or
are injected (`draws`), so that a test can feed the JAX sampler's own
draws:  live_u [nlive, ndim] uniform; per scan step, src [batch]
(randint over [0, nlive - batch): which survivor each walk clones) and
normal [nsteps_walk, batch, ndim] (one standard normal per walk step).

The evidence sums, the truncation, the bootstrap and information
errors, the mode separation and the equal-weight posterior are host
numpy, copies of the JAX package's.  With `mesh` (several ranks,
parallel/sharded.py) every batched likelihood call is split over the
chains group and gathered (sharded.split_chains), the counterpart of
MultiNest's MPI likelihood farm: the results equal the single-rank
run's.  A gloo group on CUDA tensors stages each gather through the
host, a synchronisation a walk step (Mesh.host_syncs counts them); the
single-rank run still reads nothing back in a scan step.
"""
import numpy as np
import torch

from ..parallel.sharded import split_chains
from ..tracing import to_host
from .posterior import weighted_to_equal

__all__ = ['sample_nested', 'scan_step', 'identify_modes', 'draw_step']

_STEP_SCALES = (1.0, 0.3, 0.1)


def _bootstrap_logz_err(dead_logl, live_logl, nlive, batch, n_use,
                        n_boot=200, seed=0):
    """Monte-Carlo logZ uncertainty from the stochastic prior-volume
    shrinkage: each removal of the k-th point of a batch compresses the
    volume by t ~ Beta(m, 1) with m = nlive - k active points, so
    -ln t ~ Exp(m).  Redrawing every compression factor and
    re-accumulating Z samples the logZ distribution of the run."""
    rng = np.random.default_rng(seed)
    niter = n_use
    m = np.tile(
        [nlive - k for k in range(batch)], -(-niter // batch),
    )[:niter].astype(float)
    logz_samples = np.empty(n_boot)
    for b in range(n_boot):
        dlog_x = rng.exponential(1.0 / m)
        log_x = -np.cumsum(dlog_x)
        log_w = np.log(-np.diff(
            np.exp(np.concatenate([[0.0], log_x])),
        ))
        x_rem = np.exp(log_x[-1]) if niter else 1.0
        live_logw = np.full(len(live_logl), np.log(x_rem / len(live_logl)))
        log_zw = np.concatenate([
            log_w + dead_logl[:niter], live_logw + live_logl,
        ])
        logz_samples[b] = np.logaddexp.reduce(log_zw)
    return float(np.std(logz_samples))


def identify_modes(samples, weights, link_scale=0.3):
    """Friends-of-friends mode separation of a weighted posterior:
    points within `link_scale` weighted-std units of each other join the
    same mode.  Only the points that carry 99.9% of the mass are
    clustered (early dead points would otherwise bridge separated
    modes); the rest join the mode of their nearest clustered point.

    Returns labels [n] int, mode 0 carrying the most posterior mass.
    """
    samples = np.asarray(samples, float)
    weights = np.asarray(weights, float)
    n, ndim = samples.shape
    wsum = weights.sum()
    mean = (weights[:, None] * samples).sum(0) / wsum
    std = np.sqrt(
        (weights[:, None] * (samples - mean)**2).sum(0) / wsum,
    )
    std = np.where(std > 0, std, 1.0)
    x = samples / std
    eps2 = (link_scale * ndim**0.5)**2

    order_w = np.argsort(-weights)
    cum = np.cumsum(weights[order_w]) / wsum
    n_core = int(np.searchsorted(cum, 0.999)) + 1
    core = order_w[:n_core]
    in_core = np.zeros(n, bool)
    in_core[core] = True

    labels = np.full(n, -1, int)
    mode = 0
    for seed_i in core:
        if labels[seed_i] >= 0:
            continue
        stack = [seed_i]
        labels[seed_i] = mode
        while stack:
            i = stack.pop()
            d2 = np.sum((x - x[i])**2, axis=1)
            hit = np.where((d2 < eps2) & (labels < 0) & in_core)[0]
            labels[hit] = mode
            stack.extend(hit.tolist())
        mode += 1
    tail = np.where(~in_core)[0]
    if len(tail) and len(core):
        for i in tail:
            d2 = np.sum((x[core] - x[i])**2, axis=1)
            labels[i] = labels[core[np.argmin(d2)]]
    masses = np.array([
        weights[labels == k].sum() for k in range(mode)
    ])
    order = np.argsort(-masses)
    remap = np.empty(mode, int)
    remap[order] = np.arange(mode)
    return remap[labels]


def draw_step(generator, nlive, batch, ndim, nsteps_walk, dtype, device):
    """The random draws of one scan step: src [batch] (the survivor each
    walk clones, by rank above the batch) and normal [nsteps_walk,
    batch, ndim]."""
    kw = dict(generator=generator, device=device)
    return (torch.randint(0, nlive - batch, (batch,), **kw),
            torch.randn((nsteps_walk, batch, ndim), dtype=dtype, **kw))


def scan_step(log_like, live_u, live_logl, pick, normal, batch, scales):
    """One scan step on the device, reading nothing back: remove the
    `batch` worst live points, walk clones of random survivors under the
    hardest removed likelihood, put the walkers in the dead points'
    places.

    log_like: u [n, ndim] -> [n]; live_u [nlive, ndim], live_logl
    [nlive]; pick [batch] ranks above the batch (draw_step's src);
    normal [nsteps_walk, batch, ndim]; scales [nsteps_walk] the step
    ladder.  Returns (live_u, live_logl, dead_u [batch, ndim], dead_logl
    [batch], accepted [nsteps_walk] walkers moved at each walk step).
    """
    nlive, ndim = live_u.shape
    gamma = 2.38 / np.sqrt(ndim)
    # Worst first (a stable sort, as jnp.argsort):
    order = torch.sort(live_logl, stable=True).indices
    idead = order[:batch]
    dead_u = torch.index_select(live_u, 0, idead)
    dead_logl = torch.index_select(live_logl, 0, idead)
    logl_star = dead_logl[-1]                 # the hardest constraint
    # Walks start from random survivors (ranks >= batch):
    src = torch.index_select(order, 0, batch + pick.long())
    u = torch.index_select(live_u, 0, src)
    logl = torch.index_select(live_logl, 0, src)
    # The live set's full covariance (as jnp.cov, ddof = 1):
    centred = live_u - live_u.mean(dim=0)
    cov = (centred.T @ centred) * (1.0 / (nlive - 1)) + 1e-10 * torch.eye(
        ndim, dtype=live_u.dtype, device=live_u.device)
    chol = torch.linalg.cholesky_ex(cov).L
    accepts = []
    for scale, draw in zip(scales, normal):
        step = (scale * gamma * draw) @ chol.T
        prop = torch.clamp(u + step, 1e-10, 1.0 - 1e-10)
        logl_prop = log_like(prop)
        accept = logl_prop > logl_star
        u = torch.where(accept[:, None], prop, u)
        logl = torch.where(accept, logl_prop, logl)
        accepts.append(accept)
    return (live_u.index_copy(0, idead, u),
            live_logl.index_copy(0, idead, logl), dead_u, dead_logl,
            torch.stack(accepts).sum(dim=1))


def sample_nested(
        log_like_batched, prior_transform, ndim, nlive=400, generator=None,
        max_iter=None, stop_dlogz=0.1, nsteps_walk=25, batch=None,
        draws=None, device=None, dtype=None, mesh=None,
    ):
    """Nested sampling with batched MCMC replacement.

    Parameters
    ----------
    log_like_batched: theta [n, npars] tensor -> log-likelihood [n].
    prior_transform: u [n, ndim] tensor in (0, 1) -> theta [n, npars]
        tensor (the unit-cube mapping).
    ndim: number of sampled dimensions.
    nlive: number of live points.
    generator: torch.Generator on `device` (default: seeded with 0).
    max_iter: dead-point cap (default 50 * nlive); the run takes
        ceil(max_iter / batch) scan steps.
    stop_dlogz: the run is truncated after the first dead point where
        the final live set's largest likelihood times the remaining
        volume falls below this fraction of the evidence so far.
    nsteps_walk: MCMC steps per replacement walk (scales laddered
        1, 0.3, 0.1 times 2.38 / sqrt(ndim) along the live set's
        covariance).
    batch: points removed and replaced per scan step (default nlive //
        16, at most nlive // 2).
    draws: injected draws instead of the generator's: dict of 'live_u'
        [nlive, ndim], 'src' [n_scan, batch] and 'normal' [n_scan,
        nsteps_walk, batch, ndim].
    device, dtype: of the sampler's state (the unit-cube points and
        their log-likelihoods).
    mesh: a (chains, wave) Mesh (parallel/sharded.py) whose chain
        shards split every batched likelihood call (the live set's
        start and each walk step) and gather the results; `batch` is
        set to a multiple of the chain shards, as the JAX package sets
        it (max(batch, shards) rounded down to a multiple).  Every rank
        runs the sampler with the same draws.

    Returns
    -------
    dict with 'samples' [n, npars] (physical), 'log_weights',
    'log_like', 'weights', 'logz', 'logz_err' (bootstrap),
    'logz_err_info', 'posterior' (equally weighted), 'modes',
    'mode_logz', 'n_iter' and 'efficiency', as numpy.
    """
    device = torch.device('cpu') if device is None else torch.device(device)
    dtype = torch.float64 if dtype is None else dtype
    if generator is None and draws is None:
        generator = torch.Generator(device=device).manual_seed(0)
    if max_iter is None:
        max_iter = 50 * nlive
    if batch is None:
        batch = max(1, nlive // 16)
    batch = int(min(batch, nlive // 2))
    if mesh is not None:
        nsh = mesh.shape['chains']
        batch = max(batch, nsh) - max(batch, nsh) % nsh
        log_like_batched = split_chains(log_like_batched, mesh)
    n_scan = max(1, -(-max_iter // batch))
    tensor = lambda a: torch.as_tensor(np.array(a), dtype=dtype,
                                       device=device)

    def log_like(u):
        return log_like_batched(prior_transform(u)).to(dtype)

    if draws is None:
        live_u = torch.rand((nlive, ndim), generator=generator, dtype=dtype,
                            device=device)
    else:
        live_u = tensor(draws['live_u'])
    live_logl = log_like(live_u)
    scales = np.tile(_STEP_SCALES, -(-nsteps_walk // 3))[:nsteps_walk]

    dead_u = torch.empty((n_scan, batch, ndim), dtype=dtype, device=device)
    dead_logl = torch.empty((n_scan, batch), dtype=dtype, device=device)
    accepted = torch.empty((n_scan, nsteps_walk), dtype=torch.int64,
                           device=device)
    for i in range(n_scan):
        if draws is None:
            pick, normal = draw_step(generator, nlive, batch, ndim,
                                     nsteps_walk, dtype, device)
        else:
            pick = torch.as_tensor(draws['src'][i], device=device)
            normal = tensor(draws['normal'][i])
        live_u, live_logl, dead_u[i], dead_logl[i], accepted[i] = scan_step(
            log_like, live_u, live_logl, pick, normal, batch, scales)

    # One copy to the host:
    dead_u = to_host(dead_u).numpy().reshape(-1, ndim)
    dead_logl = to_host(dead_logl).numpy().reshape(-1)
    live_u_np = to_host(live_u).numpy()
    live_logl_np = to_host(live_logl).numpy()
    # The walks' acceptance shares in float32, as the JAX package's
    # jnp.mean of booleans gives them under XLA (a sum times the
    # reciprocal of the count): a share a walk step, their mean a scan
    # step.
    f32 = np.float32
    shares = to_host(accepted).numpy().astype(f32) * f32(1.0 / batch)
    acc = shares.sum(axis=1, dtype=f32) * f32(1.0 / nsteps_walk)

    # Evidence (host): ordered worst-first, the k-th point of a batch is
    # drawn from (nlive - k) active points.
    niter = len(dead_logl)
    dlog_x = np.tile(
        [1.0 / (nlive - k) for k in range(batch)], n_scan,
    )[:niter]
    log_x = -np.cumsum(dlog_x)
    log_w = np.log(-np.diff(np.exp(np.concatenate([[0.0], log_x]))))
    log_zw = log_w + dead_logl

    # Truncate where the remaining live contribution is negligible:
    logz_run = np.logaddexp.accumulate(log_zw)
    n_use = niter
    for i in range(niter):
        rem = np.max(live_logl_np) + log_x[i]
        if rem - logz_run[i] < np.log(stop_dlogz):
            n_use = i + 1
            break

    dead_u = dead_u[:n_use]
    dead_logl = dead_logl[:n_use]
    log_w = log_w[:n_use]

    # The remaining live points, with equal shares of the volume left:
    x_rem = np.exp(log_x[n_use - 1]) if n_use else 1.0
    live_logw = np.full(nlive, np.log(x_rem / nlive))
    all_u = np.vstack([dead_u, live_u_np])
    all_logl = np.concatenate([dead_logl, live_logl_np])
    all_logw = np.concatenate([log_w, live_logw])

    log_zw_all = all_logw + all_logl
    logz = float(np.logaddexp.reduce(log_zw_all))
    weights = np.exp(log_zw_all - logz)
    logz_err = _bootstrap_logz_err(
        dead_logl, live_logl_np, nlive, batch, n_use,
    )
    ok = weights > 0
    info = float(np.sum(weights[ok] * (all_logl[ok] - logz)))
    logz_err_info = float(np.sqrt(max(info, 0.0) / nlive))

    with torch.no_grad():
        samples = to_host(prior_transform(tensor(all_u))).double().numpy()
    posterior = weighted_to_equal(samples, weights)

    modes = identify_modes(samples, weights)
    nmodes = int(modes.max()) + 1
    mode_logz = np.array([
        float(np.logaddexp.reduce(log_zw_all[modes == k]))
        for k in range(nmodes)
    ])

    return {
        'samples': samples,
        'log_weights': all_logw,
        'log_like': all_logl,
        'weights': weights,
        'logz': logz,
        'logz_err': logz_err,
        'logz_err_info': logz_err_info,
        'posterior': posterior,
        'modes': modes,
        'mode_logz': mode_logz,
        'n_iter': n_use,
        'efficiency': float(np.mean(acc)),
    }
