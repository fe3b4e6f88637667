"""Line-by-line opacity sampling from TLI line data.

This is the parity engine: it reproduces the reference's C sampling
semantics exactly (src_c/_extcoeff.c:87-345) so spectra match the
published golden files --

* per-(layer) isotope Doppler/Lorentz HWHMs (1986-CODATA kernel
  constants) snapped to the nearest log-grid Voigt profile;
* dynamic downsampling of the fine wavenumber grid so the narrowest
  Voigt FWHM keeps >= 2 samples (largest divisor of wnosamp below
  half the minimum width);
* line strengths in the same SIGCTE/EXPCTE convention, with co-adding
  of same-isotope lines sharing a fine-grid bin and the
  ethresh * kmax pruning;
* binned-profile gather-add over each line's window, clipped by the
  profile extent and the fixed cutoff;
* interpolation (constant-R) or stride-resampling (constant-dnu) back
  to the coarse output grid.

Host-side numpy copy of pyratbay_tpu/opacity/lbl.py.  The same-bin
co-adding and the windowed adds run in the native runtime
(runtime.lbl_group, runtime.lbl_scatter), as the JAX package's do; the
co-adding groups depend on the line list and the fine grid only, so
they are formed once a model and reused by every layer.  The line data
also feed the direct engine (opacity/lbl_direct.py::DirectLBL), which
computes exact-Voigt cross sections on the device through the CUDA
kernels.
"""
import numpy as np

from .. import constants as pc
from .. import runtime
from .tli import read_tli
from .voigt_grid import cached_grid

__all__ = ['LineByLine']

_SQRTLN2 = 0.83255461115769775635


def _nearest_idx(grid, values):
    """Index of nearest grid value (binsearchapprox semantics)."""
    idx = np.searchsorted(grid, values)
    idx = np.clip(idx, 1, len(grid) - 1)
    lo_closer = (
        np.abs(grid[idx - 1] - values) <= np.abs(grid[idx] - values)
    )
    return idx - lo_closer


def _trunc_div(a, b):
    """C-style integer division (truncation toward zero)."""
    q = np.abs(a) // b
    return np.where(a < 0, -q, q)


class LineByLine:
    """Line-by-line opacity model (TLI-driven)."""

    name = 'line by line'

    def __init__(
            self, tlifiles, wn, species, mol_mass, mol_radius,
            voigt_extent=300.0, voigt_cutoff=25.0, ethresh=1e-30,
            wnosamp=None, ownstep=None, own=None, odivisors=None,
            pressure=None, tmin=None, tmax=None,
            ndop=50, nlor=100, dmin=None, dmax=None, lmin=None, lmax=None,
            dlratio=0.1, resolution_mode=None, single_isotope=None,
        ):
        if isinstance(tlifiles, str):
            tlifiles = [tlifiles]
        self.tlifiles = tlifiles
        self.wn = np.asarray(wn)
        self.nwave = len(self.wn)
        self.own = np.asarray(own)
        self.onwave = len(self.own)
        # Array-derived step, exactly as the C kernel recomputes it
        # (_extcoeff.c:186): the last-ulp difference from the analytic
        # grid value flips integer window boundaries otherwise.
        self.ownstep = (
            float(self.own[1] - self.own[0])
            if self.onwave > 1 else ownstep
        )
        self.odivisors = np.asarray(odivisors)
        self.ethresh = ethresh
        self.cutoff = voigt_cutoff

        self.atm_species = list(species)
        self.mol_mass = np.asarray(mol_mass)
        self.mol_radius = np.asarray(mol_radius)

        wn_low = self.own[0]
        wn_high = self.own[-1]

        # Read and merge TLI databases:
        self.db = []
        lwn, gf, elow, isoid = [], [], [], []
        for tli_file in tlifiles:
            dbs, twn, tgf, telow, tiso = read_tli(
                tli_file, wn_low, wn_high,
            )
            offset = sum(db.niso for db in self.db)
            self.db += dbs
            lwn.append(twn)
            gf.append(tgf)
            elow.append(telow)
            isoid.append(np.asarray(tiso, int) + offset)
        self.lwn = np.concatenate(lwn)
        self.gf = np.concatenate(gf)
        self.elow = np.concatenate(elow)
        self.isoid = np.concatenate(isoid)
        self.ntransitions = len(self.lwn)

        self.tmin = np.amax([np.amin(db.temp) for db in self.db])
        self.tmax = np.amin([np.amax(db.temp) for db in self.db])

        # Isotope bookkeeping:
        self.niso = sum(db.niso for db in self.db)
        self.iso_name = np.concatenate([db.iso_name for db in self.db])
        self.iso_mass = np.concatenate([db.iso_mass for db in self.db])
        self.iso_ratio = np.concatenate([db.iso_ratio for db in self.db])
        iso_mol = []
        self._pf_temp = []
        self._pf_val = []
        for db in self.db:
            if db.molname not in self.atm_species:
                raise ValueError(
                    f"The species '{db.molname}' is not present in the "
                    'atmosphere, required for LBL calculation'
                )
            iso_mol += [self.atm_species.index(db.molname)] * db.niso
            for j in range(db.niso):
                self._pf_temp.append(db.temp)
                self._pf_val.append(db.iso_pf[j])
        self.iso_atm_index = np.asarray(iso_mol, int)

        if single_isotope is not None:
            if single_isotope not in self.iso_name:
                raise ValueError(
                    f'Single-isotope {single_isotope!r} not found in '
                    'TLI file'
                )
            idx = list(self.iso_name).index(single_isotope)
            mask = self.isoid == idx
            self.lwn = self.lwn[mask]
            self.gf = self.gf[mask]
            self.elow = self.elow[mask]
            self.isoid = self.isoid[mask]
            self.iso_ratio = np.zeros(self.niso)
            self.iso_ratio[idx] = 1.0
            self.ntransitions = len(self.lwn)

        self.species = np.unique([db.molname for db in self.db])
        self.nspec = len(self.species)
        # Index of each isotope's species within self.species:
        self.iso_spec_index = np.array([
            list(self.species).index(self.atm_species[i])
            for i in self.iso_atm_index
        ])

        # Voigt-profile grid (bounds from the atmosphere extremes), built
        # at the parity engine's first use (the `voigt` property): the
        # direct engine never reads it, and on a fine grid it is large.
        mol_idx = np.unique(self.iso_atm_index)
        press = np.asarray(pressure)
        self._voigt_args = dict(
            ownstep=self.ownstep, onwave=self.onwave,
            min_wn=np.amin(self.wn), max_wn=np.amax(self.wn),
            min_press=np.amin(press), max_press=np.amax(press),
            min_mass=np.amin(self.mol_mass[mol_idx]),
            max_mass=np.amax(self.mol_mass[mol_idx]),
            min_rad=np.amin(self.mol_radius[mol_idx]),
            max_rad=np.amax(self.mol_radius[mol_idx]),
            tmin=100.0 if tmin is None else tmin,
            tmax=3000.0 if tmax is None else tmax,
            ndop=ndop, nlor=nlor,
            dmin=dmin, dmax=dmax, lmin=lmin, lmax=lmax,
            extent=voigt_extent, cutoff=voigt_cutoff, dlratio=dlratio,
        )
        # Output-grid mode: constant-R (interpolate) vs constant-dnu
        # (stride-resample):
        if resolution_mode is None:
            dwn = np.diff(self.wn)
            resolution_mode = not np.allclose(dwn, dwn[0], rtol=1e-8)
        self.resolution_mode = resolution_mode
        self._group_cache = {}
        self.mol = list(self.species)

    @property
    def voigt(self):
        """The VoigtGrid of the parity engine (one a process for equal
        arguments, voigt_grid.cached_grid)."""
        return cached_grid(**self._voigt_args)

    def __str__(self):
        """Inspection dump (capability of the reference's
        pyrat/line_by_line.py __str__)."""
        lines = [
            'Line-by-line opacity model:',
            f'Input TLI files (tlifiles): {list(self.tlifiles)}',
            f'Number of databases (ndb): {len(self.db):d}',
        ]
        lines += [f'  {db.name} ({db.niso:d} isotopes)' for db in self.db]
        lines += [
            'Number of line transitions (ntransitions): '
            f'{int(self.ntransitions):,d}',
            f'Wavenumber range: {float(self.wn[0]):.3f} -- '
            f'{float(self.wn[-1]):.3f} cm-1 ({self.nwave:d} samples)',
            f'Temperature range (tmin, tmax): [{float(self.tmin):.1f}, '
            f'{float(self.tmax):.1f}] K',
            f'Wing cutoff (voigt_cutoff): {self.cutoff:.1f} cm-1',
            'Isotopes (iso_name, mass, ratio):',
        ]
        lines += [
            f'  {str(name):8s} {float(mass):8.4f}  {float(ratio):.3e}'
            for name, mass, ratio in zip(
                self.iso_name, self.iso_mass, self.iso_ratio)]
        return ''.join(line + '\n' for line in lines)

    def to(self, device, dtype):
        """Host-only model: the parity engine computes in numpy float64
        (Model.run copies its extinction to the device), and the device
        tables of the direct engine belong to DirectLBL."""
        return self

    def iso_pf(self, temperature):
        """Partition function per isotope at given temperatures."""
        temperature = np.atleast_1d(temperature)
        pf = np.zeros((self.niso, len(temperature)))
        for i in range(self.niso):
            pf[i] = np.interp(
                temperature, self._pf_temp[i], self._pf_val[i],
            )
        return pf

    def _layer_widths(self, temp, densities):
        """Per-isotope Lorentz/Doppler HWHMs at one layer.

        densities: [nmol] (molec cm-3).  Kernel-constant parity:
        _extcoeff.c:137-170.
        """
        fdoppler = np.sqrt(
            2.0 * pc.KB_KERNEL * temp / pc.AMU_KERNEL
        ) * _SQRTLN2 / pc.LS_KERNEL
        florentz = np.sqrt(
            2.0 * pc.KB_KERNEL * temp / np.pi / pc.AMU_KERNEL
        ) / pc.LS_KERNEL
        imol = self.iso_atm_index
        coll_diam = (
            self.mol_radius[imol][:, None] + self.mol_radius[None, :]
        )
        alphal = florentz * np.sum(
            densities[None, :] * coll_diam**2
            * np.sqrt(1.0 / self.iso_mass[:, None]
                      + 1.0 / self.mol_mass[None, :]),
            axis=1,
        )
        alphad = fdoppler / np.sqrt(self.iso_mass)
        return alphal, alphad

    def _groups(self, key, awavn, aiso, anchor_cand):
        """Same-isotope lines sharing a fine bin, as the reference's
        greedy chain over the active lines: (group_id [n], ngroups),
        cached under `key` (the skipped species)."""
        cache = self._group_cache
        if key not in cache:
            cache[key] = runtime.lbl_group(awavn, aiso, anchor_cand,
                                           self.ownstep)
        return cache[key]

    def _sample_layer(self, temp, densities, iso_pf, skip_spec=()):
        """Sample the line spectrum at one layer.

        Returns ktmp [nspec, dnwn] opacity (cm2/molec) on the dynamic
        grid plus (ofactor, dnwn).  Follows _extcoeff.c:185-318.
        """
        vg = self.voigt
        alphal, alphad = self._layer_widths(temp, densities)

        # Nearest grid widths per isotope:
        ilor = _nearest_idx(vg.lorentz, alphal)
        idop0 = _nearest_idx(vg.doppler, alphad * self.own[0])

        # Dynamic sampling factor: >= 2 samples across the min FWHM.
        vwidth = 0.5346 * alphal + np.sqrt(
            0.2166 * alphal**2 + (alphad * self.own[0])**2
        )
        minwidth = min(1e5, np.amin(vwidth))
        divs = self.odivisors
        # First divisor crossing the threshold, else one past the end
        # (the C loop runs off the array and picks the last divisor,
        # _extcoeff.c:189-193):
        over = np.nonzero(divs[1:] * self.ownstep >= 0.5 * minwidth)[0]
        i_div = (over[0] + 1) if len(over) else len(divs)
        ofactor = int(divs[i_div - 1])
        dwnstep = self.ownstep * ofactor
        dnwn = 1 + (self.onwave - 1) // ofactor

        # Line strengths (SIGCTE/EXPCTE parity):
        wavn = self.lwn
        iso = self.isoid
        in_range = (wavn >= self.own[0]) & (wavn <= self.own[-1])
        spec_of_iso = self.iso_spec_index
        skip_iso = np.array([
            self.atm_species[i] in skip_spec for i in self.iso_atm_index
        ])
        active = in_range & ~skip_iso[iso]

        kprop = (
            pc.SIGCTE * self.iso_ratio[iso] * self.gf
            * np.exp(-pc.EXPCTE * self.elow / temp)
            * -np.expm1(-pc.EXPCTE * wavn / temp)
            / iso_pf[iso]
        )
        kmax = np.zeros(self.nspec)
        np.maximum.at(
            kmax, spec_of_iso[iso[active]], kprop[active],
        )

        # Fine-grid line centers:
        iown = np.clip(
            ((wavn - self.own[0]) / self.ownstep).astype(int),
            0, self.onwave - 2,
        )
        shift = (
            np.abs(wavn - self.own[iown + 1])
            < np.abs(wavn - self.own[iown])
        )
        iown = iown + shift

        # Co-add same-isotope lines sharing a fine bin (anchored at the
        # group's first line):  greedy segmentation over the sorted list.
        ktmp = np.zeros((self.nspec, dnwn))
        active_idx = np.nonzero(active)[0]

        n_act = len(active_idx)
        if n_act == 0:
            return ktmp, ofactor, dnwn
        awavn = wavn[active_idx]
        aiso = iso[active_idx]
        aiown = iown[active_idx]
        akprop = kprop[active_idx]

        # Group starts: new group when isotope changes or line falls
        # outside ownstep of the current group's anchor own[iown].  The
        # greedy chain depends on the active lines only, not on the
        # layer: form it once for each set of skipped species.
        group_id, ngroups = self._groups(
            tuple(skip_spec), awavn, aiso, self.own[aiown])
        first_of_group = np.zeros(ngroups, int)
        first_of_group[group_id[::-1]] = np.arange(n_act)[::-1]
        k_group = np.bincount(group_id, weights=akprop, minlength=ngroups)

        g_first = active_idx[first_of_group]
        g_wavn = wavn[g_first]
        g_iso = iso[g_first]
        g_iown = iown[g_first]
        g_spec = spec_of_iso[g_iso]

        # Prune weak groups:
        strong = k_group >= self.ethresh * kmax[g_spec]

        # Doppler index at each line's wavenumber:
        g_idop = _nearest_idx(vg.doppler, alphad[g_iso] * g_wavn)
        g_ilor = ilor[g_iso]
        psize = vg.size[g_ilor, g_idop]
        pindex = vg.index[g_ilor, g_idop]

        idwn = ((g_wavn - self.own[0]) / dwnstep).astype(int)
        subw = g_iown - idwn * ofactor
        offset = ofactor * idwn - psize + subw
        minj = idwn - _trunc_div(psize - subw, ofactor)
        maxj = idwn + _trunc_div(psize + subw, ofactor)
        minj = np.maximum(minj, 0)
        maxj = np.minimum(maxj, dnwn)
        if self.cutoff > 0:
            mincut = np.trunc(idwn - self.cutoff / dwnstep).astype(int)
            maxcut = np.trunc(idwn + self.cutoff / dwnstep).astype(int)
            minj = np.maximum(minj, mincut)
            maxj = np.minimum(maxj, maxcut)

        # Each strong group adds its strided profile window, in group
        # order:
        runtime.lbl_scatter(strong, g_spec, minj, maxj, pindex, offset,
                            ofactor, k_group, vg.profile, ktmp)
        return ktmp, ofactor, dnwn

    def _to_output_grid(self, ktmp, ofactor, dnwn):
        """Dynamic grid -> coarse output grid (linterp or resample)."""
        dwnstep = self.ownstep * ofactor
        if self.resolution_mode:
            # Linear interpolation onto the output wavenumbers
            # (utils.h linterp).  The C reads its calloc'ed ktmp rows
            # past the dnwn populated values at the top edge, which
            # deterministically yields zeros (rows have onwn capacity,
            # _extcoeff.c:151); replicate with an explicit zero tail:
            ilo = ((self.wn - self.wn[0]) / dwnstep).astype(int)
            npad = max(int(ilo.max()) + 2 - dnwn, 0)
            if npad:
                ktmp = np.concatenate(
                    [ktmp, np.zeros((ktmp.shape[0], npad))], axis=1,
                )
            wnlo = self.wn[0] + dwnstep * ilo
            w_hi = (self.wn - wnlo) / dwnstep
            return (
                ktmp[:, ilo] * (1.0 - w_hi) + ktmp[:, ilo + 1] * w_hi
            )
        # Constant-dnu: stride-pick every scale-th dynamic sample:
        wnstep = self.wn[1] - self.wn[0]
        scale = int(round(wnstep / self.ownstep / ofactor))
        m = 1 + (dnwn - 1) // scale
        out = np.zeros((ktmp.shape[0], self.nwave))
        npick = min(m, self.nwave)
        out[:, :npick] = ktmp[:, ::scale][:, :npick]
        return out

    def cross_section(self, temperature, densities, layer=None,
                      per_mol=False, skip=()):
        """Opacity (cm2 molec-1) per species: [nspec, nlayers, nwave].

        densities enter only through the pressure-broadening widths.
        """
        temperature = np.atleast_1d(np.asarray(temperature, float))
        densities = np.atleast_2d(np.asarray(densities, float))
        nlayers = len(temperature)
        pf = self.iso_pf(temperature)
        layers = range(nlayers) if layer is None else [layer]
        cs = np.zeros((self.nspec, nlayers, self.nwave))
        for i in layers:
            ktmp, ofactor, dnwn = self._sample_layer(
                temperature[i], densities[i], pf[:, i], skip,
            )
            cs[:, i] = self._to_output_grid(ktmp, ofactor, dnwn)
        if per_mol:
            return cs
        return np.sum(cs, axis=0)

    def extinction(self, temperature, densities, skip=()):
        """EC (cm-1): sum over species of cs * density [nlayers, nwave].

        Matches the C add=1 path (density folded into the line
        strength before sampling).
        """
        temperature = np.asarray(temperature, float)
        densities = np.asarray(densities, float)
        nlayers = len(temperature)
        pf = self.iso_pf(temperature)
        mol_index = np.array([
            self.atm_species.index(mol) for mol in self.species
        ])
        ec = np.zeros((nlayers, self.nwave))
        for i in range(nlayers):
            ktmp, ofactor, dnwn = self._sample_layer(
                temperature[i], densities[i], pf[:, i], skip,
            )
            dens = densities[i][mol_index][:, None]
            ec[i] = np.sum(
                self._to_output_grid(ktmp * dens, ofactor, dnwn), axis=0,
            )
        return ec
