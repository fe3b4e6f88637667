"""Batched ensemble forward and log-posterior: the retrieval hot path.

Port of the transit and plane-parallel emission branches of
pyratbay_tpu/retrieval/batched.py with one layout for the card: dense
extinction parts are [B, l, W].

* state (T, VMR, densities, radius, patchy fraction) for the whole
  ensemble at once (retrieval/forward.py build_state);
* line-sampled opacity: per-chain layer weights [B, K2, l] contracted
  in the kernel against the table [K2, l, W] when the RT path's kernel
  takes the table (transit_kernel.ls_in_kernel, a static size rule per
  RT path: at any layer count for transit, up to 64 layers for
  emission), else one einsum that makes a dense part;
* CIA: per-layer table weights [B, l, K], contracted in the kernel;
* Rayleigh (H, H2, He, e-), the Lecavelier haze and the gray cloud:
  rank-1 (layer column, wave row) pairs per chain; in a patchy model
  the clouds are dense parts kept apart from the gas;
* H- and active alkali lines: one elementwise dense part; alkali lines
  with no on-grid support are pruned statically;
* line-by-line opacity from TLI files: one dense part [B, l, W].  The
  batched forward computes it on the device through the direct engine
  (opacity/lbl_direct.py DirectLBL.extinction_fn: the line factors,
  then K4 and K5, a budget of cells a pass), as the JAX package's
  forward does (lbl_engine='direct'); Model.run through the parity
  engine, host float64 (lbl_extinction), that package's default;
* deck: the surface triple that bounds the integration;
* the size rule transit_kernel.fit_operands keeps the operands within
  what the kernels take (rank-1 terms, CIA rows, dense parts);
* transit RT: one launch of the ensemble kernel
  (spectrum/transit_kernel.py) on CUDA, its plain version on the CPU;
* emission/eclipse RT: one launch of the emission kernel
  (spectrum/emission_kernel.py), then the post-scalings: f_dilution,
  the eclipse's / starflux * (Rp/Rs)^2 (with a retrieved T_eff, the
  star's blackbody or its temperature-gridded SED interpolated for each
  chain) and the f_lambda flux at Earth;
* patchy clouds: a second launch for the clear spectrum (no cloud
  parts, no deck, bottom at nlayers), mixed as
  f_patchy * cloudy + (1 - f_patchy) * clear;
* two-stream emission/eclipse (two_stream_rt): no kernel, as in the JAX
  package; the summed extinction's depth, the Planck grid and the
  two-stream recurrences of spectrum/rt.py over [B, l, W], the top
  layer's upward flux as the spectrum, then the emission post-scalings;
* band integration: one [B, W] x [W, nbands] product;
* the high-res channel (spectrum/hires.py HiresStage): one grouped
  convolution with the instrumental kernel, then a fixed lerp at the
  data's wavenumbers or, with a retrieved rv_shift, a per-chain lerp
  on the Doppler-shifted grid;
* on a wave-sharded model (parallel/sharded.py shard_model_tables)
  everything above runs on the rank's window of W / n columns: the
  spectrum it returns is that window, the band product is summed over
  the wave group (Observation.band_integrate), and the high-res stage
  takes the whole spectrum, gathered over the wave group;
* on request, the RT diagnostics (depth, ideep, the Planck grid of an
  emission, a patchy transit's clear depth) from the summed dense
  extinction (rt_diagnostics): the kernels return no depth.

Model.run takes the same assembly (assemble_opacity, spectra,
rt_diagnostics) at B = 1.

Float32 CUDA matmuls and convolutions run in full float32: the TF32
switches (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32) are set to False when a CUDA forward is
built.
"""
import numpy as np
import torch

from .forward import build_state
from .. import constants as pc
from .. import tracing
from ..device import index_tensor
from ..atmosphere import geometry
from ..atmosphere import vmr as vmr_models
from ..ops.planck import blackbody_wn
from ..spectrum import rt
from ..spectrum.hires import HiresStage, instrumental_kernel
from ..spectrum.transit_kernel import (
    extinction_plain, fit_operands, ls_in_kernel,
)

__all__ = ['build_forward_batched', 'build_log_posterior_batched',
           'line_sample_table', 'assemble_opacity', 'lbl_extinction',
           'direct_lbl_engine',
           'summed_extinction', 'spectra', 'rt_diagnostics',
           'two_stream_rt']


def line_sample_table(model):
    """The RT kernel's ls_tab operand [K2, l, W] when the line-sample
    tables go into the kernel of the model's RT path (ls_in_kernel, a
    static size rule on the model's shapes), else None: all line-sample
    tables go in, or none.  A two-stream path has no kernel."""
    ls_models = [m for mtype, m, _ in model.opacity_models
                 if mtype == 'line_sample']
    if ls_models and not model.two_stream and ls_in_kernel(
            sum(m.nspec * m.ntemp for m in ls_models), model.nlayers,
            model.rt_path):
        return torch.cat([m.kernel_table for m in ls_models])
    return None


def assemble_opacity(model, temp, dens, radius, pars_list, ls_tab,
                     skip=(), lbl_engine=None):
    """The extinction sources of B chains as RT-kernel operands.

    temp, radius [B, l]; dens [B, l, nspecies]; pars_list: per opacity
    model [B, npars] or None; ls_tab from line_sample_table; skip: names
    or types of the models to leave out, or species of a line-sample
    table (pyratbay_tpu Model.extinction's skip); lbl_engine: fn(lbl
    model, temp, dens, skip) -> [B, l, W], the extinction of a
    line-by-line model (default lbl_extinction, the parity engine;
    the batched forward passes direct_lbl_engine).  Returns a dict of
    operand lists: parts (dense gas parts: line-sample einsums, then the
    elementwise sum of alkali and H-), r1_cols / r1_rows, cia_ws /
    cia_tabs, ls_ws, cloud (a patchy model's clouds, summed into one
    dense part) and deck (the surface triple, or None).
    """
    parts, cloud = [], []
    r1_cols, r1_rows = [], []
    cia_ws, cia_tabs = [], []
    ls_ws = []
    elem = None
    deck = None
    for (mtype, m, imol), pars in zip(model.opacity_models, pars_list):
        if m.name in skip or mtype in skip:
            continue
        if m.name == 'deck':
            deck = m.surface(radius, temp, pars)
            continue
        if mtype == 'line_sample':
            density = dens[:, :, index_tensor(imol, dens.device)]
            if skip:
                keep = [mol not in skip for mol in m.species]
                density = density * torch.as_tensor(
                    keep, dtype=dens.dtype, device=dens.device)
            if ls_tab is not None:
                ls_ws.append(m.kernel_weights(temp, density, pars))
            else:
                parts.append(m.extinction(temp, density, pars=pars))
            continue
        if mtype == 'lbl':
            engine = lbl_extinction if lbl_engine is None else lbl_engine
            parts.append(engine(m, temp, dens, skip))
            continue
        if mtype == 'cia':
            cia_ws.append(m.kernel_weights(
                temp, dens[:, :, index_tensor(imol, dens.device)]))
            cia_tabs.append(m._tab)
            continue
        if mtype == 'rayleigh':
            col, row = m.ec_rank1(dens[:, :, imol])
        elif mtype == 'cloud' and not model.is_patchy:
            col, row = m.ec_rank1(temp, pars)
        elif mtype == 'cloud':
            cloud.append(m.extinction(temp, pars))
            continue
        elif mtype == 'alkali':
            if not m.active_lines:
                # Every line's cutoff window is off this grid: the
                # contribution is exactly zero.
                continue
            contrib = m.extinction(temp, dens[:, :, imol])
            elem = contrib if elem is None else elem + contrib
            continue
        elif mtype == 'h_ion':
            contrib = m.extinction(
                temp, dens[:, :, imol[0]], dens[:, :, imol[1]])
            elem = contrib if elem is None else elem + contrib
            continue
        else:
            raise ValueError(f'Unsupported opacity type {mtype}')
        r1_cols.append(col)
        r1_rows.append(row)
    if elem is not None:
        parts.append(elem)
    if len(cloud) > 1:
        total = cloud[0]
        for extra in cloud[1:]:
            total = total + extra
        cloud = [total]
    return dict(parts=parts, r1_cols=r1_cols, r1_rows=r1_rows,
                cia_ws=cia_ws, cia_tabs=cia_tabs, ls_ws=ls_ws, cloud=cloud,
                deck=deck)


def lbl_extinction(lbl, temp, dens, skip=()):
    """The parity engine's extinction of B chains as one dense part
    [B, l, W]: computed on the host in float64 (opacity/lbl.py, chain by
    chain), then one copy to the tensors' device and dtype.  skip: the
    species to leave out."""
    temp_h = temp.detach().to('cpu', torch.float64).numpy()
    dens_h = dens.detach().to('cpu', torch.float64).numpy()
    ec = np.stack([lbl.extinction(t, d, skip=skip)
                   for t, d in zip(temp_h, dens_h)])
    return torch.as_tensor(ec, dtype=temp.dtype).to(temp.device)


def direct_lbl_engine(model):
    """The direct engine's extinction of the model's line-by-line
    models, in assemble_opacity's lbl_engine form.  Each DirectLBL and
    its device tables are built here, once, when the forward is built.
    Like the JAX package's direct route (pyratbay_tpu/model.py:921-925),
    it computes every species of the TLI files: `skip` is not read."""
    fns = {id(m): model.direct_lbl(m).extinction_fn()
           for mtype, m, _ in model.opacity_models if mtype == 'lbl'}

    def engine(lbl, temp, dens, skip=()):
        return fns[id(lbl)](temp, dens)

    return engine


def _shared_operands(ops, ls_tab):
    """The operands other than the dense parts, joined across sources."""
    return dict(
        cia_w=torch.cat(ops['cia_ws'], dim=2) if ops['cia_ws'] else None,
        cia_tab=torch.cat(ops['cia_tabs'], dim=0) if ops['cia_tabs'] else None,
        r1_cols=torch.stack(ops['r1_cols'], dim=1) if ops['r1_cols'] else None,
        r1_rows=torch.stack(ops['r1_rows'], dim=1) if ops['r1_rows'] else None,
        ls_w=torch.cat(ops['ls_ws'], dim=1) if ops['ls_ws'] else None,
        ls_tab=ls_tab if ops['ls_ws'] else None,
    )


def summed_extinction(model, ops, ls_tab, like):
    """The assembled operands summed into dense extinctions [B, l, W]
    (transit_kernel.extinction_plain): the gas's, and the clouds' of a
    patchy model (zero otherwise).  like [B, l] gives the batch, dtype
    and device."""
    zero = torch.zeros((*like.shape, model.nwave), dtype=like.dtype,
                       device=like.device)
    ec = extinction_plain(ops['parts'] or [zero], **_shared_operands(
        ops, ls_tab), like=like)
    return ec, ops['cloud'][0] if ops['cloud'] else zero


def spectra(model, ops, temp, radius, rtop, ls_tab, fpatchy=None):
    """The RT of B chains on assembled operands: one kernel launch, or
    two for a patchy model (the clear spectrum has no cloud parts, no
    deck and its bottom at nlayers).  Returns (spectrum, cloudy, clear)
    [B, W], the last two None unless the model is patchy; emission
    fluxes before their post-scalings.  A two-stream path launches no
    kernel (two_stream_rt) and has no clear / cloudy split."""
    if model.two_stream:
        fluxes = two_stream_rt(model, ops, ls_tab, temp, radius, rtop)
        return fluxes['flux_up'][:, 0], None, None
    shared = _shared_operands(ops, ls_tab)

    def launch(parts, deck):
        if not parts and all(v is None for v in shared.values()):
            parts = [torch.zeros((*temp.shape, model.nwave),
                                 dtype=temp.dtype, device=temp.device)]
        with tracing.span('pbt.forward.opacity'):
            operands = fit_operands(parts, **shared)
        with tracing.span('pbt.forward.rt'):
            if model.rt_path in pc.TRANSMISSION_RT:
                return model._run_transit(
                    radius=radius, rtop=rtop, deck_surface=deck, **operands)
            return model._run_emission(
                temp=temp, radius=radius, rtop=rtop, deck_surface=deck,
                **operands)

    spectrum = launch(ops['parts'] + ops['cloud'], ops['deck'])
    if not model.is_patchy:
        return spectrum, None, None
    cloudy = spectrum
    clear = launch(ops['parts'], None)
    fp = torch.as_tensor(0.0 if fpatchy is None else fpatchy,
                         dtype=temp.dtype, device=temp.device).reshape(-1, 1)
    return fp * cloudy + (1.0 - fp) * clear, cloudy, clear


def rt_diagnostics(model, ops, ls_tab, temp, radius, rtop):
    """The RT diagnostics of B chains from their operands summed into
    dense extinction (pyratbay_tpu Model._run_transit / _run_emission):
    depth [B, l, W] and ideep [B, W]; an emission's Planck grid bbody
    [B, l, W] (the deck's layer emitting at its surface temperature,
    ideep clipped to the deck; a two-stream path's are two_stream_rt's);
    a patchy transit's depth_clear and ideep_clear (no clouds, no
    deck).  temp, radius [B, l]; rtop [B]."""
    if model.two_stream:
        fluxes = two_stream_rt(model, ops, ls_tab, temp, radius, rtop)
        return {key: fluxes[key] for key in ('depth', 'ideep', 'bbody')}
    ec, ec_cloud = summed_extinction(model, ops, ls_tab, temp)
    deck = ops['deck']
    nb, nlayers = temp.shape
    ec_total = ec + ec_cloud if model.is_patchy else ec
    out = {}
    if model.rt_path in pc.TRANSMISSION_RT:
        rscale = model._radius_scale
        path = geometry.transit_path_matrix(radius / rscale, rtop) * rscale
        ibottom = [nlayers] * nb if deck is None \
            else tracing.to_host(deck[0] + 1).tolist()

        def depths(e, bottoms):
            pairs = [rt.transit_depth(e[b], path[b], model.maxdepth,
                                      rtop[b], bottoms[b])
                     for b in range(nb)]
            return (torch.stack([d for d, _ in pairs]),
                    torch.stack([i for _, i in pairs]))

        out['depth'], out['ideep'] = depths(ec_total, ibottom)
        if model.is_patchy:
            out['depth_clear'], out['ideep_clear'] = depths(
                ec, [nlayers] * nb)
        return out
    ibottom = nlayers if deck is None else deck[0] + 1
    depth, ideep = rt.plane_parallel_depth(
        ec_total, radius, model.maxdepth, rtop, ibottom)
    bbody = blackbody_wn(model._wn, temp[..., None])
    if deck is not None:
        itop, _, tsurf = deck
        rows = torch.arange(nlayers, device=temp.device)[None, :, None]
        bb_surf = blackbody_wn(model._wn, tsurf[:, None])
        bbody = torch.where(rows == itop[:, None, None], bb_surf[:, None],
                            bbody)
        ideep = torch.minimum(ideep, itop[:, None])
    out.update(depth=depth, ideep=ideep, bbody=bbody)
    return out


def two_stream_rt(model, ops, ls_tab, temp, radius, rtop):
    """The two-stream branch of pyratbay_tpu Model._run_emission for B
    chains (model.py:1027-1064 there): the operands summed into dense
    extinction (clouds included in a patchy model), the plane-parallel
    depth without an early stop, the Planck grid at the layer
    temperatures (the deck only bounds ideep), and the two-stream fluxes
    with the model's internal flux and top irradiation.  temp, radius
    [B, l]; rtop [B].  Returns depth, bbody, flux_up, flux_down
    [B, l, W] and ideep [B, W]."""
    ec, ec_cloud = summed_extinction(model, ops, ls_tab, temp)
    ec_total = ec + ec_cloud if model.is_patchy else ec
    deck = ops['deck']
    ibottom = temp.shape[1] if deck is None else deck[0] + 1
    depth, ideep = rt.plane_parallel_depth(
        ec_total, radius, np.inf, rtop, ibottom)
    bbody = blackbody_wn(model._wn, temp[..., None])
    flux_up, flux_down = rt.two_stream(
        depth, bbody, model._wn, model._fdown_top, model._f_int)
    return dict(depth=depth, ideep=ideep, bbody=bbody, flux_up=flux_up,
                flux_down=flux_down)


def build_forward_batched(model, obs=None, ret=None):
    """Build forward_b(params [B, npars], diagnostics=False) -> dict of
    batched outputs (spectrum [B, W], bandflux [B, nbands], good [B],
    temperature [B, l]); same semantics as pyratbay_tpu's
    build_forward_batched.  With diagnostics=True it also returns the
    outputs of pyratbay_tpu's per-chain forward that contribution
    functions read (forward.py:288-306 there): depth, ideep, fpatchy
    [B], and bbody, depth_clear, ideep_clear, clear, cloudy where the
    RT path makes them (rt_diagnostics; clear and cloudy before the
    emission's post-scalings).  The log-posterior does not ask."""
    dev, dt = model.device, model.dtype
    if dev.type == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    state = build_state(model, ret)
    tmin_bound = max([model.tmin[k] for k in model.tmin], default=-np.inf)
    tmax_bound = min([model.tmax[k] for k in model.tmax], default=np.inf)
    if ret is not None:
        tmin_bound = max(tmin_bound, ret.tlow)
        tmax_bound = min(tmax_bound, ret.thigh)
    qcap = ret.qcap if ret is not None else None
    is_transit = model.rt_path in pc.TRANSMISSION_RT
    is_eclipse = model.rt_path in pc.ECLIPSE_RT
    retrieve_tstar = ret is not None and ret.itstar is not None
    if is_eclipse and not retrieve_tstar and model.starflux is None:
        raise ValueError(
            'Undefined stellar flux (tstar), required for eclipse spectra')
    if model.rt_path == 'f_lambda' and model.distance is None:
        raise ValueError(
            'Undefined distance to the system, required for f_lambda flux')
    has_bands = obs is not None and obs.nbands > 0
    if has_bands:
        obs.to(dev, dt)
    hires = None
    if obs is not None and obs.wn_hires is not None:
        hires = hires_stage(model, obs)
    mesh = getattr(model, 'mesh', None)
    retrieve_rv = ret is not None and ret.irv is not None
    ls_tab = line_sample_table(model)
    lbl_engine = direct_lbl_engine(model)

    def forward_b(params_b=None, diagnostics=False):
        with tracing.span('pbt.forward'):
            tracing.count('pbt.forward.calls')
            return forward(params_b, diagnostics)

    def forward(params_b, diagnostics):
        if params_b is not None:
            params_b = torch.as_tensor(params_b, dtype=dt, device=dev)
        with tracing.span('pbt.forward.state'):
            st = state(params_b)
        temp = st['temp']
        with tracing.span('pbt.forward.opacity'):
            ops = assemble_opacity(
                model, temp, st['dens'], st['radius'], st['pars_list'],
                ls_tab, lbl_engine=lbl_engine)
        spectrum, cloudy, clear = spectra(
            model, ops, temp, st['radius'], st['rtop'], ls_tab,
            st['fpatchy'])
        if not is_transit:
            spectrum = _emission_scalings(
                model, spectrum, st, retrieve_tstar)

        tmin = torch.min(temp, dim=1).values
        tmax = torch.max(temp, dim=1).values
        good = (tmin >= tmin_bound) & (tmax <= tmax_bound) & (tmin > 0)
        if qcap is not None and model.ibulk is not None:
            good = good & ~vmr_models.qcapcheck(st['vmr'], qcap, model.ibulk)
        spectrum = torch.where(
            good[:, None], spectrum, torch.zeros_like(spectrum))
        out = {'spectrum': spectrum, 'temperature': temp, 'good': good}
        if diagnostics:
            out.update(rt_diagnostics(
                model, ops, ls_tab, temp, st['radius'], st['rtop']))
            fpatchy = 1.0 if st['fpatchy'] is None else st['fpatchy']
            out['fpatchy'] = torch.as_tensor(
                fpatchy, dtype=dt, device=dev).expand(temp.shape[0])
            if model.is_patchy:
                out['clear'], out['cloudy'] = clear, cloudy
        with tracing.span('pbt.forward.bands'):
            if has_bands:
                bandflux = obs.band_integrate(spectrum)
                out['bandflux'] = torch.where(
                    good[:, None], bandflux,
                    torch.full_like(bandflux, np.inf))
            if hires is not None:
                velocity = st['rv_shift'] * pc.km if retrieve_rv else None
                whole = spectrum if mesh is None else mesh.gather(
                    spectrum, 'wave', -1)[:, :model.nwave_unpadded]
                flux_hires = hires(whole, velocity)
                out['bandflux_hires'] = torch.where(
                    good[:, None], flux_hires,
                    torch.full_like(flux_hires, np.inf))
        return out

    forward_b = tracing.first_call('pbt.setup.first_forward', forward_b)
    forward_b.state = state
    forward_b.hires = hires
    return forward_b


def hires_stage(model, obs):
    """The high-res stage of a model and an Observation with a high-res
    channel (pyratbay_tpu batched.py:117-149): the instrumental kernel
    at inst_resolution on the model's sampling resolution
    (grid.resolution, else the median wn / dwn of the grid), on the
    whole grid of a wave-sharded model."""
    wn = np.asarray(model.wn if getattr(model, 'mesh', None) is None
                    else model.wn_unsharded)
    sampling_res = model.grid.resolution
    if sampling_res is None:
        sampling_res = float(np.median(wn[:-1] / np.ediff1d(wn)))
    kernel = instrumental_kernel(obs.inst_resolution, sampling_res)
    return HiresStage(wn, obs.wn_hires, kernel, model.device, model.dtype)


def _emission_scalings(model, spectrum, st, retrieve_tstar):
    """The post-scalings of an emission flux (pyratbay_tpu
    batched.py:517-555): dilution, then the eclipse depth
    F_p / F_s (Rp/Rs)^2 or the flux at Earth in W m-2 um-1."""
    per_chain = lambda v: v[:, None] if torch.is_tensor(v) else v
    if st['f_dilution'] is not None:
        spectrum = spectrum * per_chain(st['f_dilution'])
    rp = per_chain(st['rplanet'])
    if model.rt_path in pc.ECLIPSE_RT:
        if retrieve_tstar and model.sed_temps is not None:
            from ..model import _interp_sed
            sflux = _interp_sed(
                model._sed_fluxes, model._sed_temps, st['tstar'])
        elif retrieve_tstar:
            sflux = blackbody_wn(model._wn, st['tstar'][:, None]) * np.pi
        else:
            sflux = model._starflux
        spectrum = spectrum / sflux * (rp / model.rstar)**2
    if model.rt_path == 'f_lambda':
        # 10x converts erg s-1 cm-2 cm to W m-2 um-1 after the
        # (wn um)^2 wavelength-unit Jacobian:
        spectrum = 10.0 * spectrum * (
            rp / model.distance * model._wn * pc.um)**2
    return spectrum


def build_log_posterior_batched(model, obs, ret):
    """Batched params [B, n] -> log-posterior [B]: Gaussian likelihood
    of the band-integrated data and of the high-res channel's data
    (either or both), uniform bounds and optional two-sided Gaussian
    priors; -inf for rejected or out-of-bounds chains."""
    has_lowres = obs.data is not None and obs.nbands > 0
    has_hires = obs.data_hires is not None
    if not (has_lowres or has_hires):
        raise ValueError(
            'Undefined observed data (data/obsfile), required to build '
            'the likelihood'
        )
    dev, dt = model.device, model.dtype
    forward_b = build_forward_batched(model, obs, ret)
    tensor = lambda a: torch.as_tensor(
        np.asarray(a, float), dtype=dt, device=dev)
    if has_lowres:
        data = tensor(obs.data)
        uncert = tensor(obs.uncert)
    if has_hires:
        data_hires = tensor(obs.data_hires)
        uncert_hires = tensor(obs.uncert_hires)
    pmin, pmax = tensor(ret.pmin), tensor(ret.pmax)
    prior = tensor(ret.prior)
    priorlow, priorup = tensor(ret.priorlow), tensor(ret.priorup)
    has_prior = torch.as_tensor(ret.priorlow > 0, device=dev)

    def log_post_b(params_b):
        with tracing.span('pbt.log_post'):
            params_b = torch.as_tensor(params_b, dtype=dt, device=dev)
            result = forward_b(params_b)
            with tracing.span('pbt.log_post.likelihood'):
                return likelihood(params_b, result)

    def likelihood(params_b, result):
        log_like = torch.zeros(params_b.shape[0], dtype=dt, device=dev)
        if has_lowres:
            data_adj = data[None, :]
            uncert_adj = uncert[None, :]
            log_norm = 0.0
            if ret.ioffset:
                data_adj = obs.offset_data(params_b[:, ret.ioffset])
            if ret.ierror:
                uncert_adj = obs.scale_uncert(params_b[:, ret.ierror])
                log_norm = -torch.sum(
                    torch.log(uncert_adj / uncert[None, :]), dim=1)
            resid = (result['bandflux'] - data_adj) / uncert_adj
            log_like = -0.5 * torch.sum(resid**2, dim=1) + log_norm
        if has_hires:
            resid_h = (result['bandflux_hires'] - data_hires[None, :]) \
                / uncert_hires[None, :]
            log_like = log_like - 0.5 * torch.sum(resid_h**2, dim=1)
        in_bounds = torch.all(
            (params_b >= pmin[None]) & (params_b <= pmax[None]), dim=1)
        sigma = torch.where(params_b > prior[None], priorup[None],
                            priorlow[None])
        dev_sq = ((params_b - prior[None]) / torch.where(
            sigma > 0, sigma, torch.ones_like(sigma)))**2
        log_prior = -0.5 * torch.sum(torch.where(
            has_prior[None], dev_sq, torch.zeros_like(dev_sq)), dim=1)
        logp = log_like + log_prior
        bad = ~in_bounds | ~result['good'] | ~torch.isfinite(log_like)
        return torch.where(bad, torch.full_like(logp, -np.inf), logp)

    return log_post_b
