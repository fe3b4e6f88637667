"""Direct line-by-line engine: exact Voigt evaluation on the device.

Port of pyratbay_tpu/opacity/lbl_tpu.py::DirectLBL.  The host setup
(sorted lines, the static core/wing split distance, the three static
tilings and their per-tile line windows, the hi/lo float-pair splits
and the dense partition-function grid) is a numpy copy.  The device
part is torch: the per-cell line factors (strengths normalized by the
per-cell maximum, Doppler and Lorentz widths), then the wing pass over
fine sub-tiles (K4) and the core pass over 4-point tiles (K5) of
opacity/lbl_kernel.py, which launch the CUDA kernels on CUDA tensors.

A tile's window is a contiguous range [start, start + lmax) of the
sorted line array, so the main path (_cross_section_batch) computes the
per-cell factors once per line, as [ncell, nlines_pad] arrays
(_line_factors), and hands the passes the window starts: no factor
tensor in the window layout [ncell, ntiles, lmax] is made.  The
window-layout factors (_cell_factors) stay for the lane-tiled route of
_cross_section (K6's windows) and for the tests that hold the two
layouts against each other.

* Gather, not scatter: every output tile evaluates its static window of
  candidate lines (centers within the cutoff, or the margin for the
  core pass, of the tile).
* Static core/wing split: the full Faddeeva function only within
  `margin` of a line center (~8.4 Doppler widths at the temperature
  bound), the 5-term asymptotic series beyond; the distance masks make
  the partition exact pointwise.
* Float32-safe: strengths are computed in log space and normalized by
  the per-cell maximum; dnu = nu - nu0 comes from (hi, lo) float-pair
  splits, which keep ~1e-7 cm-1 in float32.

The per-isotope factors index a [ncell, niso] table with the static
isotope id of each window entry (the JAX package's where-chain over
isotopes exists for the TPU), and the species of a window entry is an
integer index rather than a one-hot.
"""
import numpy as np
import torch

from .. import constants as pc
from ..device import index_tensor, resolve
from ..tracing import to_host
from .lbl_kernel import (
    LINE_ALIGN, core_sigma_lines, core_sigma_plain, wing_sigma_lines,
    wing_sigma_plain,
)

__all__ = ['DirectLBL', 'device_tables', 'line_tables']

_SQRTLN2 = 0.83255461115769775635
_SQRT_PI = 1.7724538509055159
# Large-|z| boundary where the 5-term asymptotic series of w(z) is
# accurate to ~1.3e-6 relative (~2e-7 past the 1.2x margin factor):
_ASYMPTOTIC_Z = 7.0
# Table keys that hold integers: isotope ids index, species ids go to
# the kernels as int32.
_ISO_KEYS = ('w_iso', 'c_iso', 'wf_iso', 'iso_spec', 'l_iso')
_SPEC_KEYS = ('w_spec', 'c_spec', 'wf_spec', 'l_spec', 'starts_wf',
              'starts_core')
_BOOL_KEYS = ('l_kmask',)
# extinction_fn's passes: the per-line factors a cell holds at once
# (_line_factors: kmax aside, c1, y2, scale, y, inv_ad and log_k), the
# device memory they may take, and the cells one kernel launch takes.
_LINE_FACTORS = 6
_FACTOR_BUDGET = 2 << 30
_MAX_CELLS = 65535


def _split_hi_lo(values):
    """Split float64 values into (hi, lo) with hi = f32-rounded value;
    both stored as float64 (the sum is exact; in float32 the difference
    of splits keeps full precision of differences)."""
    values = np.asarray(values, np.float64)
    hi = values.astype(np.float32).astype(np.float64)
    return hi, values - hi


def _tile_ranges(wn_tiles, lwn, window):
    """Per-tile [start, start+lmax) candidate-line windows (static).

    Returns (starts [ntiles] int32, lmax int) such that every line
    within `window` cm-1 of any point of a tile is inside the tile's
    range.  Ranges near the array ends are shifted (not truncated) so
    they stay in bounds; distance masks reject the extra lines.
    """
    tile_lo = wn_tiles.min(axis=1) - window
    tile_hi = wn_tiles.max(axis=1) + window
    starts = np.searchsorted(lwn, tile_lo)
    ends = np.searchsorted(lwn, tile_hi, side='right')
    lmax = max(int((ends - starts).max()), 1)
    nlines = len(lwn)
    starts = np.clip(starts, 0, max(nlines - lmax, 0))
    return starts.astype(np.int32), lmax


def _doppler_coeff(iso_mass):
    """Static per-isotope Doppler coefficient: the Doppler width of a
    line is k_iso * lwn * sqrt(T)."""
    return (np.sqrt(2.0 * pc.KB_KERNEL / pc.AMU_KERNEL)
            / pc.LS_KERNEL / np.sqrt(iso_mass))


def line_tables(engine):
    """Static per-line host tables over the sorted line array of a
    DirectLBL engine (this package's or the JAX package's: only its host
    attributes are read), for the passes that read line factors by line
    range.

    The array is padded to `nlines_pad` entries with the fake far lines
    of the window layout (strength exp(-700), 1e9 cm-1 past the grid):
    up to the longest window where the engine has fewer lines than one
    window holds, then to a multiple of LINE_ALIGN, so that the kernels
    copy 16 bytes at a time.  Index i of a window that starts at s is
    entry s + i here.  `l_kmask` marks the entries inside any fine-wing
    or core window: the set over which a cell's strongest line is taken.
    """
    lmax = max(engine.lmax_wf, engine.lmax_core)
    nlines = engine.nlines
    npad = -(-max(nlines, lmax) // LINE_ALIGN) * LINE_ALIGN
    nfake = npad - nlines
    iso_ratio = np.asarray(engine.iso_ratio, np.float64)
    isoid = np.asarray(engine.isoid, np.int32)
    log_kbase = np.log(
        pc.SIGCTE * iso_ratio[isoid] * np.asarray(engine.gf, np.float64))
    lwn = np.concatenate([engine.lwn, np.full(nfake, engine.wn[-1] + 1e9)])
    isoid = np.concatenate([isoid, np.zeros(nfake, np.int32)])
    lwn_hi, lwn_lo = _split_hi_lo(lwn)
    k_iso = _doppler_coeff(np.asarray(engine.iso_mass, np.float64))
    kmask = np.zeros(npad, bool)
    for starts, width in ((engine.starts_wf, engine.lmax_wf),
                          (engine.starts_core, engine.lmax_core)):
        edges = np.zeros(npad + 1, np.int64)
        np.add.at(edges, np.asarray(starts, np.int64), 1)
        np.add.at(edges, np.asarray(starts, np.int64) + width, -1)
        kmask |= np.cumsum(edges)[:-1] > 0
    return {
        'l_lwn_hi': lwn_hi,
        'l_lwn_lo': lwn_lo,
        'l_logkb': np.concatenate([log_kbase, np.full(nfake, -700.0)]),
        'l_elow': np.concatenate([engine.elow, np.zeros(nfake)]),
        'l_iso': isoid,
        'l_inv_dop': 1.0 / (k_iso[isoid] * lwn),
        'l_spec': np.asarray(engine.iso_spec, np.int32)[isoid],
        'l_kmask': kmask,
        'starts_wf': np.asarray(engine.starts_wf, np.int32),
        'starts_core': np.asarray(engine.starts_core, np.int32),
    }


def device_tables(host_tables, device=None):
    """The engine's device tables from a host table dict (numpy):
    floats in the device's dtype, isotope ids as int64, species ids and
    window starts as int32.  A JAX DirectLBL._tables dict works too: its
    species one-hots ('*_spec_oh') become species ids."""
    device, dtype = resolve(device)
    tables = {}
    for key, value in host_tables.items():
        if key.endswith('_spec_oh'):
            continue
        if key in _ISO_KEYS:
            tables[key] = torch.as_tensor(
                np.asarray(value), dtype=torch.int64, device=device)
        elif key in _SPEC_KEYS:
            tables[key] = torch.as_tensor(
                np.asarray(value), dtype=torch.int32, device=device)
        elif key in _BOOL_KEYS:
            tables[key] = torch.as_tensor(
                np.asarray(value), dtype=torch.bool, device=device)
        else:
            tables[key] = torch.as_tensor(
                np.asarray(value, np.float64), dtype=dtype, device=device)
    if 'wf_spec' not in tables:
        iso_spec = np.asarray(host_tables['iso_spec'])
        for pre in ('w_', 'c_', 'wf_'):
            tables[pre + 'spec'] = torch.as_tensor(
                iso_spec[np.asarray(host_tables[pre + 'iso'])],
                dtype=torch.int32, device=device)
    return tables


class DirectLBL:
    """Direct-evaluation LBL sampler over a static wavenumber grid."""

    def __init__(self, lbl, wn=None, tile=128, cutoff=None, tile_core=4,
                 margin=None, tmax_bound=None, tile_wing=None, device=None):
        """
        Parameters
        ----------
        lbl: LineByLine -- line data, isotope properties and partition
            functions (opacity/lbl.py).
        wn: output wavenumber grid (default: the lbl grid).
        tile: tile width of the lane-tiled wing windows (K6's tiling,
            used by _cross_section).
        cutoff: line-wing cutoff in cm-1 (default: the lbl cutoff).
        tile_core: core-pass tile width.
        margin: core/wing split distance in cm-1 (default: computed so
            |z| >= 7 * 1.2 holds in the wings up to tmax_bound).
        tmax_bound: temperature bound of the margin (default: 1.5x the
            lbl tmax, or 6000 K).
        tile_wing: fine wing sub-tile width (default: _pick_wing_subtile).
        device: where the tables live and the passes run (float64 on the
            CPU, float32 on CUDA).
        """
        self.lbl = lbl
        self.device, self.dtype = resolve(device)
        self.wn = np.asarray(wn if wn is not None else lbl.wn, np.float64)
        self.nwave = len(self.wn)
        self.tile = int(tile)
        self.tile_core = int(tile_core)
        self.cutoff = float(cutoff if cutoff is not None else lbl.cutoff)

        # Sort lines by wavenumber (static):
        order = np.argsort(np.asarray(lbl.lwn), kind='stable')
        self.lwn = np.asarray(lbl.lwn, np.float64)[order]
        self.gf = np.asarray(lbl.gf, np.float64)[order]
        self.elow = np.asarray(lbl.elow, np.float64)[order]
        self.isoid = np.asarray(lbl.isoid, np.int32)[order]
        self.nlines = len(self.lwn)

        # Per-line isotope properties:
        self.iso_mass = np.asarray(lbl.iso_mass, np.float64)
        self.iso_ratio = np.asarray(lbl.iso_ratio, np.float64)
        self.iso_spec = np.asarray(lbl.iso_spec_index, np.int32)
        self.iso_imol = np.asarray(lbl.iso_atm_index, np.int32)
        self.nspec = int(lbl.nspec)
        self.mol_radius = np.asarray(lbl.mol_radius, np.float64)
        self.mol_mass = np.asarray(lbl.mol_mass, np.float64)

        # Static core/wing split distance for the largest possible
        # Doppler HWHM:
        if margin is None:
            if tmax_bound is None:
                tmax = getattr(lbl, 'tmax', None)
                tmax_bound = 1.5 * tmax if tmax and np.isfinite(tmax) \
                    else 6000.0
            fdop_max = np.sqrt(
                2.0 * pc.KB_KERNEL * tmax_bound
                / (pc.AMU_KERNEL * self.iso_mass.min())
            ) / pc.LS_KERNEL
            ad_max = fdop_max * self.lwn.max() * _SQRTLN2
            margin = 1.2 * _ASYMPTOTIC_Z * ad_max / _SQRTLN2
        self.margin = float(min(margin, self.cutoff))

        # Lane-tiled wing tiling (K6's, for _cross_section):
        self.ntiles = -(-self.nwave // self.tile)
        self.wn_tiles = self._pad_tiles(self.tile, self.ntiles)
        self.tile_starts, self.lmax = _tile_ranges(
            self.wn_tiles, self.lwn, self.cutoff,
        )
        # Core tiling (fine) over the margin window:
        self.ntiles_core = -(-self.nwave // self.tile_core)
        self.wn_tiles_core = self._pad_tiles(
            self.tile_core, self.ntiles_core,
        )
        self.starts_core, self.lmax_core = _tile_ranges(
            self.wn_tiles_core, self.lwn, self.margin,
        )
        # Fine wing tiling (K4): sub-tiles of tile_wing points, each
        # with its own window (sub-tile span + 2 cutoff):
        if tile_wing is None:
            tile_wing = self._pick_wing_subtile()
        self.tile_wing = int(tile_wing)
        self.wing_group = max(1, 128 // self.tile_wing)
        self.ntiles_wf = -(-self.nwave // self.tile_wing)
        self.wn_tiles_wf = self._pad_tiles(
            self.tile_wing, self.ntiles_wf,
        )
        self.starts_wf, self.lmax_wf = _tile_ranges(
            self.wn_tiles_wf, self.lwn, self.cutoff,
        )

        wn_hi, wn_lo = _split_hi_lo(self.wn_tiles)
        wnc_hi, wnc_lo = _split_hi_lo(self.wn_tiles_core)
        wnwf_hi, wnwf_lo = _split_hi_lo(self.wn_tiles_wf)

        # Dense partition-function grid (a uniform resample of the
        # per-isotope tables makes the device lookup one lerp):
        tlo = getattr(lbl, 'tmin', None) or 70.0
        thi = getattr(lbl, 'tmax', None) or 6000.0
        self._pf_t0 = float(tlo)
        n_pf = 512
        self._pf_dt = (float(thi) - float(tlo)) / (n_pf - 1)
        pf_grid_t = np.linspace(float(tlo), float(thi), n_pf)
        pf_dense = np.asarray(lbl.iso_pf(pf_grid_t), np.float64)

        # Static line data pre-padded into the per-tile window layout
        # [ntiles, lmax]: the device computes per-cell factors directly
        # in this layout and gathers nothing but isotope scalars.
        log_kbase = np.log(
            pc.SIGCTE * self.iso_ratio[self.isoid] * self.gf,
        )
        wing_pad = self._pad_line_windows(
            self.tile_starts, self.lmax, log_kbase,
        )
        core_pad = self._pad_line_windows(
            self.starts_core, self.lmax_core, log_kbase,
        )
        wf_pad = self._pad_line_windows(
            self.starts_wf, self.lmax_wf, log_kbase,
        )

        self._tables = {
            'wn_tiles_hi': wn_hi,
            'wn_tiles_lo': wn_lo,
            'wn_core_hi': wnc_hi,
            'wn_core_lo': wnc_lo,
            'wn_wf_hi': wnwf_hi,
            'wn_wf_lo': wnwf_lo,
            'iso_mass': self.iso_mass,
            'iso_ratio': self.iso_ratio,
            'iso_spec': self.iso_spec,
            'mol_radius': self.mol_radius,
            'mol_mass': self.mol_mass,
            'iso_pf_grid': pf_dense,
        }
        for pre, pad in (('w_', wing_pad), ('c_', core_pad),
                         ('wf_', wf_pad)):
            for key, val in pad.items():
                self._tables[pre + key] = val
            # Species of each window entry (padded fake lines carry
            # strength 0, so their species contributes nothing):
            self._tables[pre + 'spec'] = self.iso_spec[pad['iso']]
        # The same line data once per line, with the window starts (the
        # main path's operands):
        self._tables.update(line_tables(self))
        self._device_tables = None
        self._imol = {}

    def _pick_wing_subtile(self):
        """Fine wing sub-tile width minimizing the estimated pass cost:
        kernel pairs ~ lmax_wf(pts) plus duplicated per-cell factor
        entries ~ lmax_wf(pts)/pts, one entry weighted as 13 pairs (the
        JAX package's fit; kept so both engines pick the same tiling)."""
        best_pts, best_cost = 128, np.inf
        for pts in (8, 16, 32, 64, 128):
            ntiles = -(-self.nwave // pts)
            tiles = self._pad_tiles(pts, ntiles)
            _, lmax = _tile_ranges(tiles, self.lwn, self.cutoff)
            cost = lmax * (1.0 + 13.0 / pts)
            if cost < best_cost:
                best_pts, best_cost = pts, cost
        return best_pts

    def _pad_line_windows(self, starts, lmax, log_kbase):
        """Static per-tile line windows [ntiles, lmax] (host)."""
        nlines = self.nlines
        lwn = self.lwn
        elow = self.elow
        isoid = self.isoid
        if nlines < lmax:
            npad = lmax - nlines
            # Fake far-away lines: distance masks always reject them.
            lwn = np.concatenate([lwn, np.full(npad, self.wn[-1] + 1e9)])
            elow = np.concatenate([elow, np.zeros(npad)])
            isoid = np.concatenate([isoid, np.zeros(npad, np.int32)])
            log_kbase = np.concatenate([log_kbase, np.full(npad, -700.0)])
        idx = starts[:, None].astype(np.int64) + np.arange(lmax)[None, :]
        lwn_hi, lwn_lo = _split_hi_lo(lwn[idx])
        # Static per-entry Doppler coefficient: inv_ad = inv_dop /
        # sqrt(T) at run time:
        k_iso = _doppler_coeff(self.iso_mass)
        inv_dop = 1.0 / (k_iso[isoid] * lwn)
        return {
            'lwn_hi': lwn_hi,
            'lwn_lo': lwn_lo,
            'logkb': log_kbase[idx],
            'elow': elow[idx],
            'iso': isoid[idx],
            'inv_dop': inv_dop[idx],
        }

    def _pad_tiles(self, tile, ntiles):
        # Pad with the last grid value: padded outputs are sliced off,
        # and a repeated real value keeps the candidate windows tight.
        npad = ntiles * tile
        wn_pad = np.concatenate([
            self.wn, np.full(npad - self.nwave, self.wn[-1]),
        ])
        return wn_pad.reshape(ntiles, tile)

    def tables(self):
        """The line data on the engine's device (built once)."""
        if self._device_tables is None:
            self._device_tables = device_tables(self._tables, self.device)
        return self._device_tables

    def _f32(self, values):
        """Float32 cell inputs on the device.  On the CPU they meet the
        float64 tables under torch's promotion rules, which round where
        the JAX engine's do (a float32 temperature keeps the Lorentz
        prefactor, sqrt(T) and log(pf) in float32)."""
        return torch.as_tensor(
            np.asarray(values, np.float32), device=self.device)

    # ------------------------------------------------------------------
    # Device part

    def _layer_widths_t(self, tables, temp, densities):
        """Per-isotope Lorentz HWHM [ncell, niso] at temp [ncell],
        densities [ncell, nmol]."""
        iso_mass = tables['iso_mass']
        mol_radius = tables['mol_radius']
        mol_mass = tables['mol_mass']
        flor = torch.sqrt(
            2.0 * pc.KB_KERNEL * temp / np.pi / pc.AMU_KERNEL
        ) / pc.LS_KERNEL
        imol = self._imol.get(mol_radius.device)
        if imol is None:
            # Made once: a host-to-device copy per block stalls the sweep.
            imol = self._imol[mol_radius.device] = torch.as_tensor(
                self.iso_imol, dtype=torch.int64, device=mol_radius.device)
        coll = mol_radius[imol][:, None] + mol_radius[None, :]
        return flor[:, None] * torch.sum(
            densities[:, None, :] * coll**2
            * torch.sqrt(1.0 / iso_mass[:, None] + 1.0 / mol_mass[None, :]),
            dim=2,
        )

    def _window_factors(self, tables, prefix, temp, alphal_iso, log_pf):
        """Per-cell line factors in the window layout [ncell, ntiles,
        lmax]: (log_k, inv_ad, y)."""
        iso = tables[prefix + 'iso']
        lwn = tables[prefix + 'lwn_hi']   # f32 precision: fine for
        elow = tables[prefix + 'elow']    # strengths and widths
        temp = temp[:, None, None]
        log_k = (
            tables[prefix + 'logkb']
            - pc.EXPCTE * elow / temp
            + torch.log(-torch.expm1(-pc.EXPCTE * lwn / temp))
            - log_pf[:, iso]
        )
        inv_ad = tables[prefix + 'inv_dop'] / torch.sqrt(temp)
        y = alphal_iso[:, iso] * inv_ad
        return log_k, inv_ad, y

    def _cell_factors(self, tables, temp, densities, iso_pf,
                      wing_prefix='wf_'):
        """Per-cell line factors of both passes, normalized by each
        cell's strongest window entry over both window tables.

        wing_prefix picks the wing windows: 'wf_' (fine sub-tiles, K4)
        or 'w_' (lane tiles, K6)."""
        alphal_iso = self._layer_widths_t(tables, temp, densities)
        log_pf = torch.log(iso_pf)
        logk_w, inv_ad_w, y_w = self._window_factors(
            tables, wing_prefix, temp, alphal_iso, log_pf,
        )
        logk_c, inv_ad_c, y_c = self._window_factors(
            tables, 'c_', temp, alphal_iso, log_pf,
        )
        log_kmax = torch.maximum(
            torch.amax(logk_w, dim=(1, 2)), torch.amax(logk_c, dim=(1, 2)),
        )
        norm = log_kmax[:, None, None]
        scale_w = torch.exp(logk_w - norm) * inv_ad_w / _SQRT_PI
        scale_c = torch.exp(logk_c - norm) * inv_ad_c / _SQRT_PI
        # Wing fold: contrib = Re[w]*scale with Re[w] = y u S / sqrt(pi)
        # => c1 = y * scale / sqrt(pi):
        return {
            'kmax': torch.exp(log_kmax),
            'c1_w': y_w * scale_w * (1.0 / _SQRT_PI), 'y2_w': y_w * y_w,
            'inv_ad_w': inv_ad_w,
            'scale_c': scale_c, 'y_c': y_c, 'inv_ad_c': inv_ad_c,
        }

    def _line_factors(self, tables, temp, densities, iso_pf):
        """Per-cell line factors of both passes once per line,
        [ncell, nlines_pad] over the sorted and padded line array:
        the quantities of _cell_factors(..., 'wf_'), whose window entry
        [cell, tile, i] is entry [cell, start[tile] + i] here.  The
        strengths are normalized by each cell's strongest line inside
        any fine-wing or core window (`l_kmask`): the same set of entries
        as the window layout's maximum."""
        alphal_iso = self._layer_widths_t(tables, temp, densities)
        log_pf = torch.log(iso_pf)
        iso = tables['l_iso']
        temp = temp[:, None]
        log_k = (
            tables['l_logkb']
            - pc.EXPCTE * tables['l_elow'] / temp
            + torch.log(-torch.expm1(-pc.EXPCTE * tables['l_lwn_hi'] / temp))
            - log_pf[:, iso]
        )
        inv_ad = tables['l_inv_dop'] / torch.sqrt(temp)
        y = alphal_iso[:, iso] * inv_ad
        log_kmax = torch.amax(
            log_k.masked_fill(~tables['l_kmask'], -np.inf), dim=1)
        scale = torch.exp(log_k - log_kmax[:, None]) * inv_ad / _SQRT_PI
        return {
            'kmax': torch.exp(log_kmax),
            'c1': y * scale * (1.0 / _SQRT_PI), 'y2': y * y,
            'scale': scale, 'y': y, 'inv_ad': inv_ad,
        }

    def _spec(self, tables, prefix):
        return tables[prefix + 'spec'] if self.nspec > 1 else None

    def _cross_section_batch(self, tables, temps, densities, iso_pfs):
        """sigma [ncell, nspec, nwave] over a batch of cells: temps
        [ncell], densities [ncell, nmol], iso_pfs [ncell, niso].  The
        wing pass over the fine sub-tiles (K4) and the core pass (K5),
        both on per-line factors read by line range: the CUDA kernels
        on CUDA tensors, their plain versions on the CPU."""
        fac = self._line_factors(tables, temps, densities, iso_pfs)
        ncell = temps.shape[0]
        wing = wing_sigma_lines(
            tables['wn_wf_hi'], tables['wn_wf_lo'], tables['starts_wf'],
            tables['l_lwn_hi'], tables['l_lwn_lo'],
            fac['c1'], fac['y2'], fac['inv_ad'], self._spec(tables, 'l_'),
            lmax=self.lmax_wf, margin=self.margin, cutoff=self.cutoff,
            nspec=self.nspec,
        )   # [ncell, (nspec,) ntiles_wf, tile_wing]
        core = core_sigma_lines(
            tables['wn_core_hi'], tables['wn_core_lo'],
            tables['starts_core'], tables['l_lwn_hi'], tables['l_lwn_lo'],
            fac['scale'], fac['y'], fac['inv_ad'], self._spec(tables, 'l_'),
            lmax=self.lmax_core, margin=self.margin, nspec=self.nspec,
        )   # [ncell, (nspec,) ntiles_core, tile_core]
        sigma = (
            wing.reshape(ncell, self.nspec, -1)[:, :, :self.nwave]
            + core.reshape(ncell, self.nspec, -1)[:, :, :self.nwave]
        )
        return sigma * fac['kmax'][:, None, None]

    def _cross_section(self, tables, temp, densities, iso_pf):
        """sigma [nspec, nwave] at one (T, densities) cell through the
        lane-tiled wing windows ('w_') and the plain versions (the JAX
        package's XLA path, kept for the tests)."""
        fac = self._cell_factors(
            tables, temp.reshape(1), densities[None], iso_pf[None], 'w_')
        wing = wing_sigma_plain(
            tables['wn_tiles_hi'], tables['wn_tiles_lo'],
            tables['w_lwn_hi'], tables['w_lwn_lo'],
            fac['c1_w'], fac['y2_w'], fac['inv_ad_w'],
            self._spec(tables, 'w_'), margin=self.margin,
            cutoff=self.cutoff, nspec=self.nspec,
        )
        core = core_sigma_plain(
            tables['wn_core_hi'], tables['wn_core_lo'],
            tables['c_lwn_hi'], tables['c_lwn_lo'],
            fac['scale_c'], fac['y_c'], fac['inv_ad_c'],
            self._spec(tables, 'c_'), margin=self.margin, nspec=self.nspec,
        )
        sigma = (
            wing.reshape(self.nspec, -1)[:, :self.nwave]
            + core.reshape(self.nspec, -1)[:, :self.nwave]
        )
        return sigma * fac['kmax'][0]

    def _iso_pf_t(self, tables, temp):
        """Per-isotope partition functions [ncell, niso] at temp [ncell]
        (a lerp on the dense grid)."""
        grid = tables['iso_pf_grid']
        n_pf = grid.shape[1]
        x = (temp - self._pf_t0) / self._pf_dt
        i0 = torch.clamp(x.to(torch.int64), 0, n_pf - 2)
        w = torch.clamp(x - i0, 0.0, 1.0)
        return (grid[:, i0] * (1.0 - w) + grid[:, i0 + 1] * w).T

    def factor_block(self):
        """Cells a pass of extinction_fn takes: as many as the per-line
        factors of _line_factors ([ncell, nlines_pad], _LINE_FACTORS of
        them) fit in _FACTOR_BUDGET bytes, at least 1 and at most the
        65,535 cells a kernel launch takes."""
        nlines = int(self._tables['l_lwn_hi'].shape[0])
        itemsize = torch.finfo(self.dtype).bits // 8
        per_cell = _LINE_FACTORS * nlines * itemsize
        return int(min(max(1, _FACTOR_BUDGET // per_cell), _MAX_CELLS))

    def extinction_fn(self, block=None):
        """fn(temp [B, nlayers], dens [B, nlayers, nmol]) -> ec [B,
        nlayers, nwave] (cm-1): live line-by-line extinction over a
        batch of atmospheres, `block` cells per pass (default
        factor_block(): the passes of a retrieval's forward hold their
        line factors within a fixed budget).  The result does not depend
        on the block."""
        tables = self.tables()
        imol_of_spec = index_tensor([
            int(self.iso_imol[np.argmax(self.iso_spec == s)])
            for s in range(self.nspec)
        ], self.device)
        block = self.factor_block() if block is None else int(block)

        def ec_fn(temp, dens):
            nb, nlayers = temp.shape
            temp = temp.reshape(-1)
            dens = dens.reshape(nb * nlayers, -1)
            pf = self._iso_pf_t(tables, temp)
            ec = torch.empty((nb * nlayers, self.nwave), dtype=self.dtype,
                             device=self.device)
            for lo in range(0, nb * nlayers, block):
                sl = slice(lo, lo + block)
                cs = self._cross_section_batch(
                    tables, temp[sl], dens[sl], pf[sl])
                ec[sl] = torch.sum(
                    cs * dens[sl][:, imol_of_spec][:, :, None], dim=1)
            return ec.reshape(nb, nlayers, self.nwave)

        return ec_fn

    # ------------------------------------------------------------------

    def cross_section(self, temp, densities, iso_pf=None):
        """sigma [nspec, nwave] at one cell (inputs rounded to float32,
        as the JAX engine does)."""
        if iso_pf is None:
            iso_pf = self.lbl.iso_pf(np.atleast_1d(temp))[:, 0]
        return self._cross_section_batch(
            self.tables(), self._f32(np.atleast_1d(temp)),
            self._f32(densities)[None], self._f32(iso_pf)[None])[0]

    def tabulate(self, temps, press, vmr, block=64, max_out_bytes=2**31):
        """Cross-section table [ntemp, nlayers, nwave] for one species
        ([nspec, ntemp, nlayers, nwave] for several).

        The replacement for the reference's forked process pool over
        (T, layer) cells (pyrat/extinction.py:100-119): the cell inputs
        are precomputed on the host and rounded to float32, the sweep
        runs on the device `block` cells at a time, results stay on the
        device and come back to the host once per superblock of at most
        `max_out_bytes` float32 output.
        """
        temps = np.asarray(temps)
        press = np.asarray(press)
        vmr = np.asarray(vmr)
        ntemp, nlayers = len(temps), len(press)
        ncells = ntemp * nlayers

        cells_t = np.repeat(temps, nlayers)
        cells_p = np.tile(press, ntemp)
        cells_vmr = np.tile(vmr, (ntemp, 1))
        dens = cells_vmr * (
            cells_p[:, None] * pc.bar / (pc.k * cells_t[:, None])
        )
        pf = self.lbl.iso_pf(cells_t).T  # [ncells, niso]

        block = max(1, int(block))
        nblocks = -(-ncells // block)
        npad = nblocks * block - ncells
        if npad:
            cells_t = np.pad(cells_t, (0, npad), mode='edge')
            dens = np.pad(dens, ((0, npad), (0, 0)), mode='edge')
            pf = np.pad(pf, ((0, npad), (0, 0)), mode='edge')
        t_all = self._f32(cells_t)
        d_all = self._f32(dens)
        pf_all = self._f32(pf)

        tables = self.tables()
        out_block_bytes = block * self.nspec * self.nwave * 4
        super_nb = max(1, min(nblocks, int(max_out_bytes // out_block_bytes)))
        chunks = []
        for lo in range(0, nblocks, super_nb):
            hi = min(lo + super_nb, nblocks)
            res = torch.empty(((hi - lo) * block, self.nspec, self.nwave),
                              dtype=self.dtype, device=self.device)
            for b in range(lo, hi):
                cells = slice(b * block, (b + 1) * block)
                res[(b - lo) * block:(b - lo + 1) * block] = \
                    self._cross_section_batch(
                        tables, t_all[cells], d_all[cells], pf_all[cells])
            chunks.append(to_host(res.to(torch.float32)).numpy())
        out = np.concatenate(chunks, axis=0)[:ncells]
        return out[:, 0].reshape(ntemp, nlayers, self.nwave) \
            if self.nspec == 1 else \
            out.reshape(ntemp, nlayers, self.nspec, self.nwave) \
            .transpose(2, 0, 1, 3)
