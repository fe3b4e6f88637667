"""Several ranks on a (chains, wave) mesh: the wave-sharded retrieval.

Port of pyratbay_tpu/parallel/sharded.py.  The JAX package annotates
shardings and lets GSPMD insert the collectives; here each rank is a
process with its own device, and the collectives are explicit:

* `chains` axis: data parallel over retrieval chains.  Every rank holds
  the whole [nchains, npars] state and draws the same moves; it
  evaluates its slice of the chains (split_chains) and the log-posterior
  is gathered over the chains group.
* `wave` axis: the wavenumber grid.  shard_model_tables keeps on each
  rank only its contiguous window of every table the batched forward
  reads (line-sample, CIA, Rayleigh, haze and gray-cloud rows, H- and
  alkali wavenumbers, the model's wn, stellar flux and SED), so the
  forward runs K1 or K3 on W / n columns.  The physics is independent
  per wavenumber up to the band integration, which becomes the local
  product followed by one all-reduce over the wave group
  (Observation.band_integrate), and the high-res channel's convolution,
  whose spectrum is gathered over the wave group first.
* The direct line-by-line engine is built on the rank's window with the
  whole (read-only) line list, so every cell gathers the lines within
  the cutoff of its points, across the window's edges too: no halo
  exchange.

A gather is an all-reduce (SUM) of a zero buffer into which each rank
writes its own block: exact (x + 0 = x, and +-inf survive), and
gloo offers only broadcast and all-reduce on CUDA tensors (two ranks
sharing one card run gloo, parallel/distributed.py).  gloo stages a
CUDA all-reduce through host memory, which waits for the stream: the
Mesh counts those host synchronisations.  Each collective is the span
pbt.mesh.all_sum (tracing.py), whose device marks time it on the card.
"""
import numpy as np
import torch
import torch.distributed as dist

from .. import tracing
from ..device import resolve
from .distributed import is_initialized

__all__ = [
    'make_mesh', 'shard_model_tables', 'sharded_retrieval_step',
    'build_flagship_sharded', 'Mesh', 'mesh_shape', 'split_chains',
    'gather_wave',
]

AXES = ('chains', 'wave')

# The device tensors of the opacity models that the batched forward
# reads, with their wavenumber axis (H-'s free-free factors are
# [W, 6]).  Their host set-up arrays stay whole.
_WAVE_TENSORS = (('_table', -1), ('_tab', -1), ('_cs', -1), ('_wn', -1),
                 ('_ones', -1), ('_sigma_bf', -1), ('_ff', 0))
_MODEL_WAVE_TENSORS = ('_wn', '_starflux', '_sed_fluxes', '_f_int',
                       '_fdown_top')


def mesh_shape(nranks, chains_axis=None):
    """(chains, wave) split of `nranks` ranks: by default the largest
    factor <= sqrt(nranks) goes to chains, the rest to wave (JAX's
    make_mesh rule)."""
    if chains_axis is None:
        chains_axis = 1
        for f in range(int(np.sqrt(nranks)), 0, -1):
            if nranks % f == 0:
                chains_axis = f
                break
    if nranks % chains_axis:
        raise ValueError(
            f'{nranks} ranks do not split into {chains_axis} chain shards')
    return chains_axis, nranks // chains_axis


class Mesh:
    """A (chains, wave) grid of the process group's ranks: rank r sits
    at (r // wave, r % wave), JAX's reshape of its device list.

    shape and coords map each axis name to its size and to this rank's
    coordinate; groups to the process group of the ranks that share this
    rank's other coordinate, or None where the axis has one rank or there
    is no process group: its collectives are the identity.  Counters:
    `calls` (collectives made) and `host_syncs` (those of a gloo group on
    CUDA tensors), also counted into the recorder (tracing.py) as
    pbt.mesh.calls and pbt.mesh.host_syncs, in the span pbt.mesh.all_sum.
    """

    def __init__(self, shape, device_mesh=None):
        self.shape = dict(zip(AXES, shape))
        self.device_mesh = device_mesh
        if device_mesh is None:
            self.coords = dict.fromkeys(AXES, 0)
            self.groups = dict.fromkeys(AXES)
            self.backend = None
        else:
            self.coords = dict(zip(AXES, device_mesh.get_coordinate()))
            # A collective over one rank is the identity: none is made
            # (on gloo and CUDA it would still wait for the stream).
            self.groups = {axis: device_mesh.get_group(axis)
                           if self.shape[axis] > 1 else None
                           for axis in AXES}
            self.backend = dist.get_backend()
        self.calls = 0
        self.host_syncs = 0

    def __repr__(self):
        return (f'Mesh(chains={self.shape["chains"]}, '
                f'wave={self.shape["wave"]}, backend={self.backend})')

    def all_sum(self, x, axis):
        """x summed over the ranks of `axis`, in place."""
        group = self.groups[axis]
        if group is None:
            return x
        with tracing.span('pbt.mesh.all_sum'):
            dist.all_reduce(x, group=group)
            self.calls += 1
            tracing.count('pbt.mesh.calls')
            if x.is_cuda and self.backend == 'gloo':
                self.host_syncs += 1
                tracing.count('pbt.mesh.host_syncs')
                tracing.count(tracing.HOST_WAITS)
        return x

    def gather(self, x, axis, dim):
        """The blocks that the ranks of `axis` hold along `dim` (equal
        sizes, in coordinate order), joined: [..., n * size, ...]."""
        if self.groups[axis] is None:
            return x
        size = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = size * self.shape[axis]
        out = x.new_zeros(shape)
        out.narrow(dim, self.coords[axis] * size, size).copy_(x)
        return self.all_sum(out, axis)


def make_mesh(chains_axis=None, device=None):
    """The (chains, wave) mesh over the process group's ranks
    (torch.distributed.device_mesh), split by mesh_shape; a (1, 1) mesh
    without collectives when no group is initialized.  device: the
    ranks' device type (default: the card)."""
    if not is_initialized():
        return Mesh((1, 1))
    from torch.distributed.device_mesh import init_device_mesh
    shape = mesh_shape(dist.get_world_size(), chains_axis)
    dev, _ = resolve(device)
    return Mesh(shape, init_device_mesh(dev.type, shape,
                                        mesh_dim_names=AXES))


def split_chains(fn, mesh):
    """fn(x [n, ...]) -> [n, ...] evaluated by each rank on its slice of
    the n rows (padded with the last row to a multiple of the chain
    shards) and gathered over the chains group.  The ranks of a wave
    group take the same slice, as a wave-sharded fn needs."""
    nsh = mesh.shape['chains']

    def split(x):
        n = x.shape[0]
        per = -(-n // nsh)
        if per * nsh > n:
            x = torch.cat([x, x[-1:].expand(per * nsh - n, *x.shape[1:])])
        lo = mesh.coords['chains'] * per
        return mesh.gather(fn(x[lo:lo + per]), 'chains', 0)[:n]

    return split


def gather_wave(spectrum, mesh):
    """The whole [B, W_padded] spectrum from each rank's window
    [B, W / n] (a wave-sharded forward's output)."""
    return mesh.gather(spectrum, 'wave', -1)


def shard_model_tables(model, obs=None, mesh=None):
    """Keep on this rank only its window of the wavenumber axis of every
    table the batched forward reads.

    The axis is first padded to a multiple of the wave shards: the
    physics tables repeat their last column (padded points compute real
    values that no output uses), the band matrix takes zeros, so band
    fluxes stay exact.  Then each device tensor becomes its window, a
    contiguous copy of W_padded / n columns: the opacity models' tables
    and wavenumber rows, the model's _wn, _starflux, _sed_fluxes and the
    two-stream boundaries, and the observation's band matrix (host,
    [nbands, W]; Observation.to makes its [W, nbands] tensor).  The
    model's wn becomes the window too (so the direct line-by-line engine,
    whose cache is cleared, is built on the rank's cells with the whole
    line list), nwave its width; nwave_unpadded and wn_unsharded keep
    the whole grid, mesh the mesh.

    What stays whole: the host set-up arrays of the opacity models
    (cs_table, tab_cross_section, the line lists of the parity engine)
    and of the Model (starflux, sed_fluxes).  A sharded model serves
    build_forward_batched and build_log_posterior_batched, built after
    this call (line_sample_table joins the tables when the forward is
    built); Model.run and the cross-section methods read the whole set-up.
    """
    if getattr(model, 'mesh', None) is not None:
        raise ValueError('The model is sharded already')
    if mesh is None:
        mesh = make_mesh(device=model.device)
    nwave = model.nwave
    width = -(-nwave // mesh.shape['wave'])
    points = np.arange(width) + mesh.coords['wave'] * width
    cols = np.minimum(points, nwave - 1)
    index = torch.as_tensor(cols, device=model.device)

    def window(obj, name, axis=-1):
        val = getattr(obj, name, None)
        if torch.is_tensor(val):
            setattr(obj, name, val.index_select(axis, index))

    for mtype, opac, _ in model.opacity_models:
        if mtype != 'lbl':
            for name, axis in _WAVE_TENSORS:
                window(opac, name, axis)
    for name in _MODEL_WAVE_TENSORS:
        window(model, name)
    model.mesh = mesh
    model.nwave_unpadded = nwave
    model.wn_unsharded = model.wn
    model.wn = np.asarray(model.wn)[cols]
    model.nwave = width
    # Direct engines are grid-specific: rebuilt on the window.
    model.__dict__.pop('_direct_lbl', None)
    if obs is not None:
        obs.mesh = mesh
        if obs._band_matrix is not None:
            obs._band_matrix = np.where(
                points < nwave, np.asarray(obs._band_matrix)[:, cols], 0.0)
            obs.to(model.device, model.dtype)
    return model, obs


def sharded_retrieval_step(log_post, ret, mesh, nchains=None, seed=0,
                           device=None, dtype=None):
    """One DEMC generation of the retrieval over the mesh.

    Parameters
    ----------
    log_post: params [B, npars] -> [B], the batched log-posterior of a
        wave-sharded model (build_log_posterior_batched after
        shard_model_tables).
    ret: RetrievalParams: initial values, steps and bounds.
    mesh: the (chains, wave) Mesh.
    nchains: ensemble size (default 4x the chain shards, >= 16), cut to
        a multiple of the chain shards.
    seed: of the initial ensemble (numpy) and of the move generator.
    device, dtype: of the chains (default: the card, its dtype).

    Returns (step, chains0): step(chains, logp, draws=None) -> (chains,
    logp) with the JAX package's move set: gamma0 = 2.38 / sqrt(2
    d_free) in every generation, eps_scale = 1e-4 pstep, snooker moves
    where uniform(n, 1) < 0.1.  Every rank draws the same whole-ensemble
    moves from one seeded generator (samplers.draw_generation), or takes
    injected `draws`; it evaluates its slice of the proposals and
    gathers the log-posterior over the chains group, so the [nchains,
    npars] state stays the same on every rank.  step.log_post is that
    chain-split log-posterior (for the initial logp).  chains0 is
    params + pstep * N(0, 1) from np.random.default_rng(seed), clipped
    to the bounds, on `device`.
    """
    from ..retrieval.samplers import draw_generation, generation

    device, default_dtype = resolve(device)
    dtype = default_dtype if dtype is None else dtype
    chain_shards = mesh.shape['chains']
    if nchains is None:
        nchains = max(16, 4 * chain_shards)
    nchains -= nchains % chain_shards

    params0 = np.asarray(ret.params, float)
    pstep = np.asarray(ret.pstep, float)
    free_mask = (pstep > 0).astype(float)
    d_free = max(free_mask.sum(), 1.0)
    gamma0 = 2.38 / np.sqrt(2.0 * d_free)
    eps_scale = 1e-4 * np.where(pstep > 0, pstep, 0.0)

    rng = np.random.default_rng(seed)
    chains0 = params0 + np.where(pstep > 0, pstep, 0.0) \
        * rng.standard_normal((nchains, len(params0)))
    chains0 = np.clip(chains0, np.asarray(ret.pmin), np.asarray(ret.pmax))

    tensor = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    free_t, eps_t = tensor(free_mask), tensor(eps_scale)
    generator = torch.Generator(device=device).manual_seed(seed)
    log_post_split = split_chains(log_post, mesh)

    def step(chains, logp, draws=None):
        if draws is None:
            draws = draw_generation(generator, nchains, len(params0),
                                    dtype, device)
        chains, logp, _ = generation(
            chains, logp, gamma0, eps_t, free_t, draws, log_post_split)
        return chains, logp

    step.log_post = log_post_split
    return step, tensor(chains0)


def build_flagship_sharded(mesh, workdir=None, device=None, nchains=None,
                           **flagship_kw):
    """The flagship retrieval (benchmark.make_flagship) with wave-sharded
    tables: returns (model, obs, ret, log_post, step, chains0).  Without
    data, the observations are synthesized from the model's own forward
    at the example parameters (uncertainties 3% of each band), before
    the tables are sharded.  log_post is the batched log-posterior on
    this rank's window; step and chains0 are sharded_retrieval_step's."""
    from ..benchmark import make_flagship
    from ..retrieval.batched import build_log_posterior_batched

    model, obs, ret, forward, p0 = make_flagship(
        workdir, device=device, **flagship_kw)
    if obs.data is None:
        with torch.no_grad():
            bandflux = tracing.to_host(
                forward(p0)['bandflux'].double()).numpy()
        obs.data = bandflux
        obs.uncert = np.maximum(0.03 * bandflux, 1e-12)
    shard_model_tables(model, obs, mesh)
    log_post = build_log_posterior_batched(model, obs, ret)
    step, chains0 = sharded_retrieval_step(
        log_post, ret, mesh, nchains, device=model.device, dtype=model.dtype)
    return model, obs, ret, log_post, step, chains0
