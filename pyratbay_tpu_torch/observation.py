"""Observed data: band-integrated depths and their passbands.

Port of pyratbay_tpu/observation.py for data given in the config
(data/uncert/filters) or an obsfile, with passbands from filter files,
the bundled filter library or tophat entries, plus the instrumental
offset and error-scaling models, and the high-resolution channel
(obsfile_hires: data at wavenumbers, modeled by the instrumental
convolution of the spectrum at inst_resolution, spectrum/hires.py).
"""
import os

import numpy as np
import torch

from . import constants as pc
from .io import io as pio
from .spectrum.passbands import PassBand, Tophat, band_matrix

__all__ = ['Observation']


class Observation:
    """Data points, uncertainties, and filter passbands."""

    def __init__(self, cfg, wn, root=None):
        self.data = None
        self.uncert = None
        self.filters = []
        self.nbands = 0
        self.band_wl = None
        self._band_matrix = None
        # The (chains, wave) mesh of a wave-sharded forward
        # (parallel/sharded.py shard_model_tables), None otherwise:
        self.mesh = None
        self.offset_inst = []
        self.uncert_scaling = []

        data = cfg.data
        uncert = cfg.uncert
        filters = cfg.filters
        if cfg.obsfile is not None:
            obs = pio.read_observations(cfg.obsfile)
            data = obs['data']
            uncert = obs['uncert']
            filters = obs['filters']
        if cfg.dunits is not None and cfg.data is not None:
            scale = pc.u(cfg.dunits)
            data = np.asarray(data, float) * scale
            uncert = np.asarray(uncert, float) * scale
        if data is not None:
            self.data = np.asarray(data, float)
        if uncert is not None:
            self.uncert = np.asarray(uncert, float)
        if self.data is not None and self.uncert is not None \
                and len(self.data) != len(self.uncert):
            raise ValueError(
                f'Number of data uncertainty values ({len(self.uncert)}) '
                'does not match the number of data points '
                f'({len(self.data)})'
            )

        if filters is not None:
            from .data import filter_response, list_filters
            for entry in filters:
                if isinstance(entry, str) and os.path.isfile(
                        _expand(entry, root)):
                    band = PassBand(_expand(entry, root), wn=wn)
                elif isinstance(entry, str) \
                        and entry.lower() in list_filters():
                    wl_f, resp = filter_response(entry)
                    band = PassBand.from_arrays(
                        wl_f, resp, entry.lower(), wn=wn)
                else:
                    # 'tophat wl0 half_width' style entries:
                    fields = str(entry).split()
                    if not (len(fields) >= 2 and _is_float(fields[-2])):
                        raise FileNotFoundError(
                            f"Filter file '{entry}' does not exist")
                    band = Tophat(float(fields[-2]), float(fields[-1]), wn=wn)
                self.filters.append(band)
            self.nbands = len(self.filters)
            self.band_wl = np.array([band.wl0 for band in self.filters])
            self._band_matrix = band_matrix(self.filters, len(wn))

        # High-resolution channel (pyratbay_tpu/observation.py:89-116):
        # per-point wavenumbers (a filter file's wl0, or a bare
        # wavelength in um) with data and uncertainties, modeled by
        # convolving the spectrum to inst_resolution (and an optional
        # radial-velocity shift) and interpolating at wn_hires.
        self.wn_hires = None
        self.data_hires = None
        self.uncert_hires = None
        self.inst_resolution = getattr(cfg, 'inst_resolution', None)
        obsfile_hires = getattr(cfg, 'obsfile_hires', None)
        if obsfile_hires is not None:
            if self.inst_resolution is None:
                raise ValueError(
                    'Undefined inst_resolution, required when modeling '
                    'high-resolution data (obsfile_hires)'
                )
            obs_h = pio.read_observations(_expand(obsfile_hires, root))
            wl_hires = []
            for entry in obs_h['filters']:
                fields = str(entry).split()
                path = _expand(fields[0], root)
                if os.path.isfile(path):
                    wl_hires.append(PassBand(path, wn=wn).wl0)
                else:
                    wl_hires.append(float(fields[0]))
            self.wn_hires = 1.0 / (np.asarray(wl_hires) * pc.um)
            if obs_h['data'] is not None and len(obs_h['data']):
                self.data_hires = np.asarray(obs_h['data'], float)
                self.uncert_hires = np.asarray(obs_h['uncert'], float)

        self.offset_pars = []
        self.uncert_pars = []
        if cfg.offset_inst is not None:
            for entry in _param_lines(cfg.offset_inst):
                fields = entry.split()
                self.offset_inst.append(fields[0])
                self.offset_pars.append(
                    float(fields[1]) if len(fields) > 1 else 0.0
                )
        if cfg.uncert_scaling is not None:
            for entry in _param_lines(cfg.uncert_scaling):
                fields = entry.split()
                self.uncert_scaling.append(fields[0])
                self.uncert_pars.append(
                    float(fields[1]) if len(fields) > 1 else 0.0
                )

        if self.data is not None and self.nbands:
            if len(self.data) != self.nbands:
                raise ValueError(
                    f'Number of filter bands ({self.nbands}) does not '
                    f'match the number of data points ({len(self.data)})'
                )

        self._offset_masks = []
        for inst in self.offset_inst:
            name = inst.replace('offset_', '').replace('_', ' ')
            mask = np.array([
                name in band.name.replace('_', ' ')
                for band in self.filters
            ])
            if not mask.any():
                raise ValueError(
                    f"Invalid instrumental offset parameter '{inst}'. "
                    f"There is no instrument matching the name '{name}'"
                )
            self._offset_masks.append(mask)

        self._err_masks = []
        self._err_modes = []
        for var in self.uncert_scaling:
            if var.startswith('err_scale_'):
                mode = 'scale'
                name = var[len('err_scale_'):]
            elif var.startswith('err_quad_'):
                mode = 'quadrature'
                name = var[len('err_quad_'):]
            else:
                raise ValueError(
                    f"Invalid error scaling parameter '{var}'. Valid "
                    "options begin with: ['err_scale_', 'err_quad_']"
                )
            name = name.replace('_', ' ')
            mask = np.array([
                name in band.name.replace('_', ' ')
                for band in self.filters
            ])
            if not mask.any():
                raise ValueError(
                    f"Invalid retrieval parameter '{var}'. There is "
                    f"no instrument matching the name '{name}'"
                )
            self._err_masks.append(mask)
            self._err_modes.append(mode)

        self.units_scale = pc.u(cfg.dunits) if cfg.dunits else 1.0

    def __str__(self):
        from .tools import Formatted_Write
        fw = Formatted_Write()
        fw.write('Observed data:')
        ndata = 0 if self.data is None else len(self.data)
        fw.write('Number of data points (ndata): {}', ndata)
        if self.data is not None:
            fw.write('Data (data):\n  {}', self.data, fmt={
                'float': '{:.6e}'.format}, edge=4)
        if self.uncert is not None:
            fw.write('Uncertainties (uncert):\n  {}', self.uncert, fmt={
                'float': '{:.6e}'.format}, edge=4)
        fw.write('Number of filter bands (nbands): {}', self.nbands)
        for band in self.filters:
            fw.write(
                '  {:24s} wl0 = {:.4f} um', band.name, band.wl0,
            )
        if self.offset_inst:
            fw.write('Instrumental offsets (offset_inst): {}',
                     self.offset_inst)
        if self.uncert_scaling:
            fw.write('Uncertainty scaling (uncert_scaling): {}',
                     self.uncert_scaling)
        if self.wn_hires is not None:
            fw.write(
                'High-resolution channel: {} points, '
                'inst_resolution = {:.1f}',
                len(self.wn_hires), self.inst_resolution,
            )
        return fw.text

    def to(self, device, dtype):
        """Materialize the band matrix, data and masks as tensors."""
        tensor = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        self._bands_t = (
            None if self._band_matrix is None
            else tensor(self._band_matrix.T))
        self._data = None if self.data is None else tensor(self.data)
        self._uncert = None if self.uncert is None else tensor(self.uncert)
        self._offset_masks_t = [
            torch.as_tensor(m, device=device) for m in self._offset_masks]
        self._err_masks_t = [
            torch.as_tensor(m, device=device) for m in self._err_masks]
        return self

    def band_integrate(self, spectrum):
        """Band-integrated values: spectrum [B, nwave] -> [B, nbands].
        On a wave-sharded forward the spectrum and the band matrix are
        this rank's window: the local product is summed over the wave
        group."""
        bands = spectrum @ self._bands_t
        return bands if self.mesh is None else self.mesh.all_sum(
            bands, 'wave')

    def offset_data(self, offset_pars):
        """Data with per-instrument offsets: pars [B, noff] -> [B, nbands]."""
        data = self._data[None, :]
        for mask, par in zip(self._offset_masks_t, offset_pars.unbind(1)):
            data = data + torch.where(
                mask, par[:, None] * self.units_scale,
                torch.zeros_like(data))
        return data

    def scale_uncert(self, err_pars):
        """Inflated uncertainties: pars [B, nerr] -> [B, nbands]
        ('err_scale_X': sigma*10**par; 'err_quad_X': quadrature sum)."""
        uncert = self._uncert[None, :].expand(err_pars.shape[0], -1)
        for mask, mode, par in zip(
                self._err_masks_t, self._err_modes, err_pars.unbind(1)):
            par = par[:, None]
            if mode == 'scale':
                uncert = torch.where(mask, uncert * 10.0**par, uncert)
            else:
                inflated = torch.sqrt(
                    uncert**2 + (10.0**par * self.units_scale)**2)
                uncert = torch.where(mask, inflated, uncert)
        return uncert


def _param_lines(value):
    """Non-empty lines of a "name [value]" config block; a single-line
    value with multiple bare names (legacy form) splits on whitespace."""
    lines = [line.strip() for line in str(value).splitlines()]
    lines = [line for line in lines if line]
    if len(lines) == 1 and len(lines[0].split()) > 1:
        fields = lines[0].split()
        try:
            float(fields[1])
            return [lines[0]]
        except ValueError:
            return fields
    return lines


def _expand(path, root):
    if root is not None:
        path = path.replace('{ROOT}', root)
    return path


def _is_float(val):
    try:
        float(val)
        return True
    except ValueError:
        return False
