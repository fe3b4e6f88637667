"""Line-sampled (tabulated) cross-section opacity.

Setup (table loading, pressure/temperature re-gridding, isotope
ratios) is a numpy copy of pyratbay_tpu/opacity/line_sample.py.  The
runtime temperature interpolation is a contraction of per-chain layer
weights [B, nspec*ntemp, l] (two-hot along temperature, times density
and isotope ratio) with the table [nspec*ntemp, l, W], as in
pyratbay_tpu/retrieval/batched.py:202-247: either inside the RT kernels
(`kernel_weights` and `kernel_table` are their ls_w / ls_tab operands)
or as one einsum that makes a dense [B, l, W] part (`extinction`).
"""
import numpy as np
import scipy.interpolate as sip
import torch

from ..io import io as pio

__all__ = ['LineSample', 'interpolate_opacity', 'wn_mask_tol', 'two_hot']


def wn_mask_tol(wn, wn_min, wn_max, tol=1.0e-8):
    """Range mask with edge tolerance (reference spec_tools.py:778-814)."""
    mask = (wn >= wn_min) & (wn <= wn_max)
    if np.sum(mask) < 2:
        min_dwn = max_dwn = 0.0
    else:
        min_dwn = np.abs(np.ediff1d(wn[mask][0:2]))
        max_dwn = np.abs(np.ediff1d(wn[mask][-2:]))
    return (wn >= wn_min - min_dwn * tol) & (wn <= wn_max + max_dwn * tol)


def interpolate_opacity(
        cs_file, temperature=None, pressure=None, wn_mask=None, wl_thinning=1,
    ):
    """Load a cross-section table, re-gridded in log-opacity space
    (linear in log cs, edge-value extrapolation; no-op when the grids
    already match to 1%)."""
    _, temp, press, wn = pio.read_opacity(cs_file, extract='arrays')
    logp_table = np.log(press)
    if wn_mask is None:
        wn_mask = np.ones(len(wn), bool)

    resample_p = (
        pressure is not None
        and (
            len(press) != len(pressure)
            or np.any(np.abs(1.0 - press / pressure) > 0.01)
        )
    )
    resample_t = (
        temperature is not None
        and (
            len(temp) != len(temperature)
            or np.any(np.abs(1.0 - temp / temperature) > 0.01)
        )
    )

    cross_section = pio.read_opacity(cs_file, extract='opacity')[:, :, wn_mask]
    cross_section = cross_section[:, :, ::wl_thinning]
    if not resample_p and not resample_t:
        return cross_section

    log_cs = np.log(cross_section)
    log_cs[~np.isfinite(log_cs)] = -230.0
    if resample_p:
        logp = np.log(pressure)
        interp = sip.interp1d(
            logp_table, log_cs, axis=1, kind='slinear',
            bounds_error=False, fill_value=(log_cs[:, 0], log_cs[:, -1]),
        )
        log_cs = interp(logp)
    if resample_t:
        interp = sip.interp1d(
            temp, log_cs, axis=0, kind='slinear',
            bounds_error=False, fill_value=(log_cs[0], log_cs[-1]),
        )
        log_cs = interp(temperature)
    return np.exp(log_cs)


def two_hot(tlo, w_hi, ntemp):
    """[B, l] lerp indices/weights -> [B, ntemp, l] two-hot weights."""
    t_idx = torch.arange(ntemp, device=tlo.device)[None, :, None]
    return (
        (t_idx == tlo[:, None, :]) * (1.0 - w_hi)[:, None, :]
        + (t_idx == tlo[:, None, :] + 1) * w_hi[:, None, :]
    )


class LineSample:
    """Tabulated cross sections with runtime temperature interpolation."""

    name = 'line sampling'

    def __init__(
            self, cs_files, pressure=None, temperature=None,
            min_wn=0.0, max_wn=np.inf, wl_thinning=1,
            isotope_ratios=None,
        ):
        if isinstance(cs_files, str):
            cs_files = [cs_files]
        self.cs_files = list(cs_files)

        iso_keys, iso_labels, iso_vals = [], [], []
        if isotope_ratios:
            for line in str(isotope_ratios).splitlines():
                if not line.strip():
                    continue
                fields = line.split()
                if len(fields) != 3:
                    raise ValueError(
                        'Invalid isotope_ratios entry (expected '
                        f"'<file_label> <label> <value>'): {line!r}"
                    )
                iso_keys.append(fields[0])
                iso_labels.append('iso_' + fields[1])
                iso_vals.append(fields[2])

        species0, temp, press, wn = pio.read_opacity(
            self.cs_files[0], extract='arrays',
        )
        self.temp = np.asarray(temp if temperature is None else temperature)
        self.ntemp = len(self.temp)
        self.press = np.asarray(press if pressure is None else pressure)
        self.nlayers = len(self.press)

        mask = wn_mask_tol(wn, min_wn, max_wn)
        self.wn = wn[mask][::wl_thinning]
        self.nwave = len(self.wn)

        species = []
        isotopes = []
        tags = []
        tables = []
        for cs_file in self.cs_files:
            spec, _, file_press, file_wn = pio.read_opacity(
                cs_file, extract='arrays',
            )
            iso = ''
            for key, label in zip(iso_keys, iso_labels):
                if key in cs_file:
                    if iso:
                        raise ValueError(
                            f'Multiple isotope labels match {cs_file!r}'
                        )
                    iso = label
            fmask = wn_mask_tol(file_wn, min_wn, max_wn)
            fwn = file_wn[fmask][::wl_thinning]
            if len(fwn) != self.nwave or np.any(
                    np.abs(1.0 - fwn / self.wn) > 0.01):
                raise ValueError(
                    f"Wavenumber array of '{cs_file}' does not match"
                )
            pmax, pmax_tab = np.amax(self.press), np.amax(file_press)
            if pmax / pmax_tab - 1 > 1e-3:
                raise ValueError(
                    'Pressure profile extends beyond the maximum tabulated '
                    'pressure'
                )
            table = interpolate_opacity(
                cs_file, self.temp, self.press, fmask, wl_thinning,
            )
            tag = spec + iso
            if tag in tags:
                tables[tags.index(tag)] += table
            else:
                tags.append(tag)
                species.append(spec)
                isotopes.append(iso)
                tables.append(table)
        self.species = np.array(species)
        self.isotopes = list(isotopes)
        self.nspec = len(self.species)
        # [nspec, ntemp, nlayers, nwave]:
        self.cs_table = np.stack(tables, axis=0)

        self.tmin = float(np.amin(self.temp))
        self.tmax = float(np.amax(self.temp))

        self.iso_ratios = np.ones(self.nspec)
        self.iso_fill = [None] * self.nspec
        self._iso_free = []
        self.pnames = []
        pars = []
        for i, iso in enumerate(self.isotopes):
            if iso == '':
                continue
            idx = iso_labels.index(iso)
            val = iso_vals[idx]
            if val.startswith('fill_'):
                fillers = ['iso_' + f for f in val[5:].split('_')]
                for filler in fillers:
                    if filler not in self.isotopes:
                        raise ValueError(
                            f'Invalid isotope_ratios filler {filler!r}: '
                            'no matching isotope table'
                        )
                self.iso_fill[i] = [
                    self.isotopes.index(f) for f in fillers
                ]
            else:
                self.iso_ratios[i] = 10.0 ** float(val)
                self.pnames.append(iso)
                self._iso_free.append(i)
                pars.append(float(val))
        for i, fillers in enumerate(self.iso_fill):
            if fillers is not None:
                self.iso_ratios[i] = 1.0 - np.sum(self.iso_ratios[fillers])
        self.pars = list(pars)
        self.npars = len(pars)
        self.mol = list(self.species)

    def to(self, device, dtype):
        """Materialize the static tables as tensors."""
        self._table = torch.as_tensor(
            self.cs_table, dtype=dtype, device=device)
        self._temp = torch.as_tensor(self.temp, dtype=dtype, device=device)
        self._ratios = torch.as_tensor(
            self.iso_ratios, dtype=dtype, device=device)
        return self

    def _jit_ratios(self, pars=None):
        """Isotope ratios [B, nspec] from free log10 ratios [B, npars]
        (or the setup ratios [1, nspec] without parameters)."""
        ratios = self._ratios[None, :]
        if pars is not None and self._iso_free:
            ratios = ratios.expand(pars.shape[0], -1).clone()
            ratios[:, self._iso_free] = 10.0 ** pars
        for i, fillers in enumerate(self.iso_fill):
            if fillers is not None:
                ratios = ratios.clone()
                ratios[:, i] = 1.0 - torch.sum(ratios[:, fillers], dim=1)
        return ratios

    def _t_weights(self, temperature):
        """Lower index + lerp weight along the temperature axis:
        temperature [..., l] -> (tlo, w_hi) of the same shape."""
        tlo = torch.clamp(
            torch.searchsorted(
                self._temp, temperature.contiguous(), right=True) - 1,
            0, self.ntemp - 2,
        )
        dt = self._temp[tlo + 1] - self._temp[tlo]
        return tlo, (temperature - self._temp[tlo]) / dt

    @property
    def kernel_table(self):
        """The table as the RT kernels' ls_tab operand
        [nspec*ntemp, l, nwave] (a view of the device table, whose
        wavenumber axis is a rank's window on a wave-sharded model)."""
        return self._table.reshape(
            self.nspec * self.ntemp, self.nlayers, -1)

    def kernel_weights(self, temperature, density, pars=None):
        """The RT kernels' ls_w operand: temperature [B, l], density
        [B, l, nspec] -> [B, nspec*ntemp, l] layer weights (two-hot
        temperature lerp x density x isotope ratio), whose contraction
        with `kernel_table` over the middle axis is the extinction."""
        tlo, w_hi = self._t_weights(temperature)
        w_t = two_hot(tlo, w_hi, self.ntemp)             # [B, t, l]
        ratios = self._jit_ratios(pars)                  # [B|1, s]
        d_w = density.transpose(1, 2) * ratios[:, :, None]  # [B, s, l]
        w_stl = w_t[:, None] * d_w[:, :, None]           # [B, s, t, l]
        return w_stl.reshape(
            w_stl.shape[0], self.nspec * self.ntemp, self.nlayers)

    def cross_section(self, temperature, per_mol=False):
        """CS (cm2 molec-1): temperature [B, l] -> [B, nspec, l, nwave]
        with per_mol, else summed over the species [B, l, nwave]; the
        temperature lerp of the device table."""
        w_t = two_hot(*self._t_weights(temperature), self.ntemp)
        cs = torch.einsum('btl,stlw->bslw', w_t, self._table)
        return cs if per_mol else torch.sum(cs, dim=1)

    def extinction(self, temperature, density, per_mol=False, pars=None):
        """EC (cm-1) over the ensemble: temperature [B, l], density
        [B, l, nspec] -> a dense [B, l, nwave] part, or with per_mol each
        species' part [B, nspec, l, nwave] (they sum to the former).
        The TF32 switch of CUDA matmuls stays off (float32 products in
        full precision)."""
        weights = self.kernel_weights(temperature, density, pars)
        if per_mol:
            return torch.einsum(
                'bstl,stlw->bslw',
                weights.reshape(-1, self.nspec, self.ntemp, self.nlayers),
                self._table)
        return torch.einsum('bkl,klw->blw', weights, self.kernel_table)

    def __str__(self):
        from ..tools import Formatted_Write
        fw = Formatted_Write()
        fw.write('Line-sampled cross-section opacity:')
        fw.write('Number of species (nspec): {:d}', self.nspec)
        for spec, iso in zip(self.species, self.isotopes):
            fw.write('  {}{}', spec, f' ({iso})' if iso else '')
        fw.write(
            'Temperature range: {:.1f} -- {:.1f} K ({:d} samples)',
            self.tmin, self.tmax, self.ntemp,
        )
        fw.write(
            'Wavenumber range: {:.3f} -- {:.3f} cm-1 ({:d} samples)',
            float(self.wn[0]), float(self.wn[-1]), self.nwave,
        )
        fw.write('Pressure layers (nlayers): {:d}', self.nlayers)
        if self.npars:
            fw.write('Isotope-ratio parameters: {}', self.pnames)
        return fw.text
