"""Forward model: configuration -> static tables on a device -> spectra.

Port of pyratbay_tpu/model.py for: transit and plane-parallel emission
geometry (rt_path transit, emission, eclipse, f_lambda) with a
blackbody star, a Kurucz model or a starspec SED (gridded in
temperature or plain) and raygrid or Gauss quadrature; two-stream
emission (emission_two_stream, eclipse_two_stream: the Heng et al.
two-stream fluxes of spectrum/rt.py, with an internal flux at tint and
the irradiation beta_irr (rstar/smaxis)^2 F_star at the top);
isothermal, Guillot or Madhusudhan T(p); free VMR models with bulk
balancing; thermochemical equilibrium (chemistry = equilibrium,
atmosphere/chem.py) with the [M/H], [X/H] and X/Y element models and
hybrid log_X free VMRs on top of it; hydro_m/hydro_g
radii; input atmospheres, interpolated onto a calculated pressure grid;
the opacity types line_sample, cia (files, or the bundled tables by
basename), alkali, rayleigh (H, H2, He, e-), cloud (deck, ccsgray,
lecavelier), h_ion and patchy clouds (fpatchy); line-by-line opacity
from TLI files (tlifile) through the parity engine (opacity/lbl.py,
host numpy float64: compute_opacity's default, Model.run and get_ec,
as in the JAX package) or the direct engine on the device
(compute_opacity(engine='direct') and the batched forward of a
retrieval, retrieval/batched.py);
and the per-chain forward of runmode = spectrum, Model.run, whose
plane-parallel and transit spectra come from the RT kernels at B = 1.
Other options raise NotImplementedError naming their ROADMAP.md item.

Setup is host-side numpy, as in the JAX package (the set-up profile's
equilibrium solve runs in torch on the CPU in float64); `to(device)`
turns the static tables into tensors (float64 on the CPU, float32 on
CUDA) and builds the equilibrium evaluator on the device.
The ensemble evaluation lives in retrieval/forward.py and
retrieval/batched.py, whose opacity assembly Model.run shares.
"""
import os

import numpy as np
import scipy.constants as sc
import torch

from . import constants as pc
from . import tracing
from .config import parser as cfg_parser
from .device import resolve
from .io import io as pio
from .ops.grids import wavenumber_grid, WavenumberGrid
from .atmosphere import chem, geometry, hydro, profiles, vmr as vmr_models
from .opacity.alkali import get_alkali_model
from .opacity.cia import CIA
from .opacity.clouds import CCSgray, Deck, Lecavelier
from .opacity.h_ion import HydrogenIon
from .opacity.lbl import LineByLine
from .opacity.line_sample import LineSample, wn_mask_tol
from .opacity.rayleigh import Rayleigh
from .spectrum import rt
from .spectrum.emission_kernel import emission_flux_ensemble
from .spectrum.starspec import bbflux, read_kurucz
from .spectrum.transit_kernel import transit_spectrum_ensemble
from .tools import Formatted_Write
from .tracing import to_host

__all__ = ['Model']

class Model:
    """Forward spectroscopic model assembled from a configuration."""

    def __init__(self, cfg, device=None, root=None, log=None):
        with tracing.span('pbt.setup.model', always=True):
            self._setup(cfg, device, root, log)
        self._log_setup_summary()

    def _setup(self, cfg, device, root, log):
        if isinstance(cfg, str):
            cfg = cfg_parser.parse(cfg, root=root)
        self.cfg = cfg
        self.rt_path = cfg.rt_path
        self.two_stream = 'two_stream' in (self.rt_path or '')
        self.maxdepth = cfg.maxdepth
        if log is None:
            from .logger import Log
            log = Log(verb=cfg.verb if cfg.verb is not None else 1)
        self.log = log

        with tracing.span('pbt.setup.spectrum', always=True) as spectrum:
            self._setup_spectrum()
        with tracing.span('pbt.setup.atmosphere', always=True) as atmosphere:
            self._setup_atmosphere()
        with tracing.span('pbt.setup.opacity', always=True) as opacity:
            self._setup_star()
            self._setup_opacity()
            self._setup_quadrature()
            # The opacity set-up ends with its tables on the device:
            self.to(device)
        self.timestamps = {
            key: (s.t1 - s.t0) * 1e-9 for key, s in (
                ('setup spectrum', spectrum),
                ('setup atmosphere', atmosphere),
                ('setup opacity', opacity))}

    def _log_setup_summary(self):
        log = self.log
        log.head(f'Run mode: {self.cfg.runmode} ({self.rt_path})')
        if self.wn is not None:
            log.msg(
                f'Wavenumber grid: {float(self.wn[0]):.3f} -- '
                f'{float(self.wn[-1]):.3f} cm-1 ({self.nwave} samples)'
            )
        log.msg(
            f'Pressure grid: {float(self.press[0]):.2e} -- '
            f'{float(self.press[-1]):.2e} bar ({self.nlayers} layers)'
        )
        if self.species is not None:
            log.msg(f'Species: {" ".join(self.species)}')
        for mtype, opac_model, _ in self.opacity_models:
            bounds = ''
            if mtype in self.tmin:
                bounds = (
                    f'  T in [{self.tmin[mtype]:.1f}, '
                    f'{self.tmax[mtype]:.1f}] K'
                )
            log.msg(f'Opacity: {opac_model.name} ({mtype}){bounds}')

    # ------------------------------------------------------------------
    # Setup (host-side numpy, as pyratbay_tpu/model.py)

    def _setup_spectrum(self):
        cfg = self.cfg
        wnlow = cfg.wnlow
        wnhigh = cfg.wnhigh
        if wnlow is None and cfg.wl_high is not None:
            wnlow = 1.0 / cfg.wl_high
        if wnhigh is None and cfg.wl_low is not None:
            wnhigh = 1.0 / cfg.wl_low
        # Atmosphere-only runs need no spectral grid
        # (pyratbay_tpu/model.py:108-113):
        if cfg.runmode == 'atmosphere' and wnlow is None \
                and wnhigh is None and cfg.sampled_cs is None:
            self.grid = None
            self.wn = None
            self.nwave = 0
            return
        # Inherit the sampling of a cross-section table, except in
        # runmode = opacity, where sampled_cross_sec names the table to
        # be written (pyratbay_tpu/model.py:117-120):
        if cfg.sampled_cs is not None and cfg.runmode != 'opacity':
            _, _, _, wn = pio.read_opacity(cfg.sampled_cs[0], 'arrays')
            mask = wn_mask_tol(wn, wnlow, wnhigh)
            wn = wn[mask][::cfg.wl_thinning]
            self.grid = WavenumberGrid(wn=wn, wnlow=wnlow, wnhigh=wnhigh)
        else:
            self.grid = wavenumber_grid(
                wnlow=wnlow, wnhigh=wnhigh,
                wnstep=cfg.wnstep, wlstep=cfg.wlstep,
                resolution=cfg.resolution, wnosamp=cfg.wnosamp,
            )
        self.wn = self.grid.wn
        self.nwave = len(self.wn)

    def _setup_atmosphere(self):
        cfg = self.cfg
        in_press = in_temp = in_vmr = in_radius = None
        in_species = None
        source = None
        if cfg.ptfile is not None and os.path.isfile(cfg.ptfile):
            source = cfg.ptfile
        elif cfg.atmfile is not None:
            source = cfg.atmfile
        if source is not None:
            units, in_species, in_press, in_temp, in_vmr, in_radius = \
                pio.read_atm(source)
            punits, _, _, runits = units
            in_press = in_press * pc.u(punits) / pc.bar
            if in_radius is not None and runits is not None:
                in_radius = in_radius * pc.u(runits)
            if source == cfg.ptfile:
                in_species = in_vmr = in_radius = None

        calc_press = (
            cfg.nlayers is not None and cfg.ptop is not None
            and cfg.pbottom is not None
        )
        if calc_press:
            press = np.asarray(
                profiles.pressure(cfg.ptop, cfg.pbottom, cfg.nlayers))
        elif in_press is not None:
            press = np.asarray(in_press)
        else:
            raise ValueError(
                'Cannot compute pressure profile, either set {ptop, '
                'pbottom, nlayers} parameters, or provide an input PT '
                'profile (ptfile) or atmospheric file (atmfile)'
            )
        nlayers = len(press)
        # Read profiles onto a calculated grid (pyratbay_tpu/model.py:
        # 190-217): T and r slinear in ln p, VMR log-log.
        if calc_press and in_press is not None and (
                len(in_press) != nlayers or not np.allclose(in_press, press)):
            from scipy.interpolate import interp1d
            logp_in = np.log(in_press)
            logp = np.log(press)
            if in_temp is not None:
                in_temp = interp1d(
                    logp_in, in_temp, kind='slinear', bounds_error=False,
                    fill_value=(in_temp[0], in_temp[-1]))(logp)
            if in_vmr is not None:
                log_vmr = np.log(in_vmr)
                in_vmr = np.exp(interp1d(
                    logp_in, log_vmr, axis=0, kind='slinear',
                    bounds_error=False,
                    fill_value=(log_vmr[0], log_vmr[-1]))(logp))
            if in_radius is not None:
                in_radius = interp1d(
                    logp_in, in_radius, kind='slinear')(logp)

        # VMR provenance: a chemistry model beats the read profiles, and
        # config species beat the file's (pyratbay_tpu/model.py:219-247):
        species = in_species
        vmr = in_vmr
        if cfg.chemistry is not None:
            if cfg.species is not None:
                species = list(cfg.species)
            if species is None:
                raise ValueError(
                    'Cannot compute VMRs. Undefined atmospheric species '
                    'list (species)'
                )
            if cfg.chemistry == 'free':
                if cfg.uniform_vmr is None \
                        or len(cfg.uniform_vmr) != len(species):
                    raise ValueError(
                        'Free chemistry needs species and one uniform_vmr '
                        'value per species'
                    )
                vmr = vmr_models.uniform_vmr(
                    np.array(cfg.uniform_vmr, float), nlayers)
            # Calculated composition invalidates any read radius:
            in_radius = None

        self.press = press
        self.nlayers = nlayers
        self.species = None if species is None else list(species)
        self.base_temp = in_temp
        self.base_vmr = None if vmr is None else np.asarray(vmr)
        self.input_radius = in_radius
        # Equilibrium chemistry resolves the species' properties after
        # the network prunes those without thermodynamic data:
        if self.species is not None and cfg.chemistry != 'equilibrium':
            self.mol_mass, self.mol_radius = pio.species_properties(
                self.species, cfg.molfile)
        else:
            self.mol_mass = self.mol_radius = None

        self.temp_model = None
        self.tpars = None if cfg.tpars is None else np.asarray(cfg.tpars)
        if cfg.tmodelname is not None:
            self.temp_model = profiles.get_tmodel(cfg.tmodelname, self.press)
            # runmode = atmosphere may read the profile instead:
            reads_temp = (
                cfg.runmode == 'atmosphere' and self.base_temp is not None)
            if self.tpars is None and cfg.retrieval_params is None \
                    and not reads_temp:
                raise ValueError(
                    'Not all temperature parameters were defined (tpars)'
                )

        # Thermochemical equilibrium (pyratbay_tpu/model.py:287-332):
        # the network on the set-up profile, its species pruned to those
        # with thermodynamic data, base_vmr its solution there.
        self.chemistry = cfg.chemistry
        self.chem_model = None
        if cfg.chemistry == 'equilibrium':
            if cfg.species is not None:
                self.species = list(cfg.species)
                self.base_vmr = None
            temp0 = self.base_temp
            if temp0 is None:
                if self.temp_model is None or self.tpars is None:
                    raise ValueError(
                        'chemistry=equilibrium requires a temperature '
                        'profile (tmodel/tpars or an input atmosphere)'
                    )
                temp0 = self.temp_model(torch.as_tensor(
                    self.tpars, dtype=torch.float64)[None])[0].numpy()
            e_source = cfg.solar or 'asplund_2021'
            if isinstance(e_source, str) and e_source not in \
                    chem.SOLAR_ABUNDANCES:
                e_source = chem.read_solar_file(e_source)
            self.chem_model = chem.Network(
                self.press, temp0, self.species, e_source=e_source)
            self.chem_model.thermochemical_equilibrium()
            self.species = [str(s) for s in self.chem_model.species]
            self.mol_mass, self.mol_radius = pio.species_properties(
                self.species, cfg.molfile)
            self.base_vmr = np.asarray(self.chem_model.vmr)
            self.base_temp = np.asarray(temp0)

        self.rplanet = cfg.rplanet
        mplanet, gplanet = cfg.mplanet, cfg.gplanet
        if self.rplanet is not None:
            if gplanet is not None and mplanet is None:
                mplanet = gplanet * self.rplanet**2 / pc.G
            if mplanet is not None:
                gplanet = pc.G * mplanet / self.rplanet**2
        self.mplanet = mplanet
        self.gplanet = gplanet
        self.refpressure = cfg.refpressure
        self.rmodelname = cfg.rmodelname
        self.smaxis = cfg.smaxis
        self.rstar = cfg.rstar
        self.tstar = cfg.tstar
        self.tint = cfg.tint
        self.beta_irr = cfg.beta_irr
        self.distance = cfg.distance
        self.rhill = hydro.hill_radius(self.smaxis, self.mplanet, cfg.mstar)
        # Static radius scale for float32-safe transit geometry
        # (pyratbay_tpu/model.py:355-363):
        if self.rplanet is not None:
            self._radius_scale = float(self.rplanet)
        elif self.input_radius is not None:
            self._radius_scale = float(np.mean(self.input_radius))
        else:
            self._radius_scale = 1.0
        self._setup_vmr_models()

    def _setup_vmr_models(self):
        cfg = self.cfg
        lines = [ln for ln in (cfg.vmr_vars or '').splitlines() if ln.strip()]
        self.vmr_var_names = []
        self.vmr_pars = []
        has_pars = any(
            _is_number(val) for ln in lines for val in ln.split()[1:])
        may_retrieve = cfg.retrieval_params is not None
        for ln in lines:
            fields = ln.split()
            if has_pars:
                self.vmr_var_names.append(fields[0])
                if len(fields) < 2:
                    if not may_retrieve:
                        raise ValueError(
                            'Not all vmr parameter values were defined '
                            '(vmr_vars)'
                        )
                    self.vmr_pars.append(None)
                    continue
                self.vmr_pars.append(np.array(fields[1:], float))
            else:
                self.vmr_var_names.extend(fields)
        if not has_pars:
            self.vmr_pars = None
            if self.vmr_var_names and not may_retrieve:
                raise ValueError(
                    'Not all vmr parameter values were defined (vmr_vars)'
                )

        # Free models (log_, scale_, slant_) act on one species; the
        # equilibrium models ([M/H], [X/H], X/Y) set the network's
        # element budget, and a log_X beside them is a hybrid: a free
        # VMR on top of equilibrium, capped by element availability
        # (pyratbay_tpu/model.py:405-470).
        self.ifree = []
        self._vmr_kinds = []
        self._equil_info = []
        is_equil = self.chem_model is not None
        elements = list(self.chem_model.elements) if is_equil else []
        species = self.species or []
        for var in self.vmr_var_names:
            info = None
            if var.startswith('log_'):
                mol, kind = var[4:], 'iso'
            elif var.startswith('scale_'):
                mol, kind = var[6:], 'scale'
            elif var.startswith('slant_'):
                mol, kind = var[6:], 'slant'
            elif var == '[M/H]':
                mol, kind = None, 'metal_equil'
            elif var.startswith('[') and var.endswith('/H]'):
                mol, kind = None, 'scale_equil'
                element = var[1:-3]
                if not is_equil or element not in elements:
                    raise ValueError(
                        f"Invalid vmr_vars variable '{var}', element "
                        f"'{element}' is not in the atmosphere"
                    )
                info = elements.index(element)
            elif '/' in var:
                mol, kind = None, 'ratio_equil'
                num, den = var.split('/')
                if not is_equil or num not in elements \
                        or den not in elements:
                    raise ValueError(
                        f"Invalid vmr_vars variable '{var}', elements "
                        'are not in the atmosphere'
                    )
                info = (elements.index(num), elements.index(den))
            else:
                raise ValueError(f"Unrecognized VMR model (vmr_vars): '{var}'")
            if kind.endswith('_equil') and not is_equil:
                raise ValueError(
                    f"vmr_vars variable '{var}' requires "
                    'chemistry=equilibrium'
                )
            if mol is not None:
                if mol not in species:
                    raise ValueError(
                        f"Invalid vmr_vars variable '{var}', species {mol} "
                        'is not in the atmosphere'
                    )
                imol = species.index(mol)
                if is_equil:
                    if kind != 'iso':
                        raise ValueError(
                            f"vmr_vars variable '{var}': only log_X free "
                            'models combine with chemistry=equilibrium'
                        )
                    kind = 'hybrid'
                    stoich = self.chem_model.stoich_vals
                    icols = np.where(stoich[imol] != 0)[0]
                    info = (imol, stoich[:, icols].astype(float),
                            stoich[imol, icols].astype(float))
                else:
                    self.ifree.append(imol)
            self._vmr_kinds.append(kind)
            self._equil_info.append(info)

        self.bulk = cfg.bulk
        self.ibulk = None
        self.bulkratio = self.invsrat = None
        if self.bulk is not None:
            missing = np.setdiff1d(self.bulk, species)
            if len(missing):
                raise ValueError(
                    f'These bulk species are not present in the '
                    f'atmosphere: {missing}'
                )
            self.ibulk = [species.index(mol) for mol in self.bulk]
            bratio = self.base_vmr[:, self.ibulk] \
                / self.base_vmr[:, [self.ibulk[0]]]
            bratio[:, 0] = 1.0
            self.bulkratio = bratio
            self.invsrat = 1.0 / np.sum(bratio, axis=1)

    def _setup_star(self):
        """The stellar flux at the model's wavenumbers
        (pyratbay_tpu/model.py:498-530): a starspec SED file (with
        @TEMPERATURES, a grid of SEDs interpolated in temperature at
        tstar, else its first temperature; sed_temps and sed_fluxes keep
        the grid for a retrieved T_eff), a Kurucz grid's model closest to
        (tstar, log_gstar), or the blackbody pi B(wn, tstar).

        Each SED is sorted by wavenumber before its interpolation: a
        file in ascending wavelength lists its wavenumbers in descending
        order, which np.interp does not take.
        """
        cfg = self.cfg
        self.starflux = None
        self.sed_temps = None
        self.sed_fluxes = None
        self.star_is_blackbody = False
        if cfg.starspec is not None:
            spectra, starwn, sed_temps = pio.read_spectra(cfg.starspec)
            order = np.argsort(starwn, kind='stable')
            fluxes = np.stack([
                np.interp(self.wn, starwn[order], flux[order])
                for flux in spectra
            ])
            if sed_temps is not None:
                self.sed_temps = np.asarray(sed_temps, float)
                self.sed_fluxes = fluxes
                tstar = self.tstar if self.tstar is not None \
                    else sed_temps[0]
                self.starflux = _interp_sed(
                    torch.as_tensor(fluxes), torch.as_tensor(self.sed_temps),
                    torch.as_tensor([float(tstar)], dtype=torch.float64),
                )[0].numpy()
            else:
                self.starflux = fluxes[0]
        elif cfg.kurucz is not None:
            if self.tstar is None or cfg.log_gstar is None:
                raise ValueError(
                    'Undefined stellar temperature or gravity for Kurucz'
                )
            flux, starwn, _, _ = read_kurucz(
                cfg.kurucz, self.tstar, cfg.log_gstar)
            self.starflux = np.interp(self.wn, starwn, flux)
        elif self.tstar is not None:
            self.starflux = np.asarray(bbflux(self.wn, self.tstar))
            self.star_is_blackbody = True

    def _setup_quadrature(self):
        """Emission angles: Gauss quadrature of `quadrature` points, or
        the `raygrid` angles (degrees) with their annulus weights."""
        cfg = self.cfg
        if cfg.quadrature is not None:
            mu, weights = rt.gauss_quadrature(cfg.quadrature)
        else:
            raygrid = np.asarray(cfg.raygrid) * sc.degree
            mu = np.cos(raygrid)
            bounds = np.linspace(0, 0.5 * np.pi, len(raygrid) + 1)
            bounds[1:-1] = 0.5 * (raygrid[:-1] + raygrid[1:])
            weights = np.pi * (
                np.sin(bounds[1:])**2 - np.sin(bounds[:-1])**2
            )
        self.quadrature_mu = mu
        self.quadrature_weights = weights

    def _setup_opacity(self):
        cfg = self.cfg
        self.opacity_models = []   # (type, model, imol)
        self.tmin = {}
        self.tmax = {}
        species = self.species or []
        wn = self.wn

        if cfg.sampled_cs is not None and cfg.runmode != 'opacity':
            temp_array = None
            if (cfg.tmin is not None and cfg.tmax is not None
                    and cfg.tstep is not None):
                ntemp = int((cfg.tmax - cfg.tmin) / cfg.tstep) + 1
                tmax = cfg.tmin + (ntemp - 1) * cfg.tstep
                temp_array = np.linspace(cfg.tmin, tmax, ntemp)
            ls = LineSample(
                cfg.sampled_cs, pressure=self.press, temperature=temp_array,
                min_wn=self.grid.wnlow, max_wn=self.grid.wnhigh,
                wl_thinning=cfg.wl_thinning,
                isotope_ratios=cfg.isotope_ratios,
            )
            imol = [species.index(mol) for mol in ls.species]
            self.opacity_models.append(('line_sample', ls, imol))
            self.tmin['line_sample'] = ls.tmin
            self.tmax['line_sample'] = ls.tmax

        if cfg.tlifile is not None:
            if self.grid.own is None:
                raise ValueError(
                    'Line-by-line opacity (tlifile) requires an explicit '
                    'spectral sampling (resolution, wnstep, or wlstep); '
                    'it cannot inherit the sampling from a cross-section '
                    'table (sampled_cross_sec). Remove tlifile or set a '
                    'sampling rate.'
                )
            lbl = LineByLine(
                cfg.tlifile, wn=wn, species=species,
                mol_mass=self.mol_mass, mol_radius=self.mol_radius,
                voigt_extent=cfg.voigt_extent,
                voigt_cutoff=cfg.voigt_cutoff,
                ethresh=cfg.ethresh,
                wnosamp=self.grid.wnosamp,
                ownstep=self.grid.ownstep,
                own=self.grid.own,
                odivisors=self.grid.odivisors,
                pressure=self.press,
                tmin=cfg.tmin, tmax=cfg.tmax,
                ndop=cfg.voigt_ndop, nlor=cfg.voigt_nlor,
                dmin=cfg.voigt_dmin, dmax=cfg.voigt_dmax,
                lmin=cfg.voigt_lmin, lmax=cfg.voigt_lmax,
                dlratio=cfg.voigt_dlratio,
                resolution_mode=self.grid.resolution is not None,
                single_isotope=cfg.single_isotope,
            )
            imol = [species.index(mol) for mol in lbl.species]
            self.opacity_models.append(('lbl', lbl, imol))
            self.tmin['lbl'] = lbl.tmin
            self.tmax['lbl'] = lbl.tmax
        if cfg.alkali_models is not None:
            for name in cfg.alkali_models:
                model = get_alkali_model(
                    name, self.press, wn, cutoff=cfg.alkali_cutoff)
                imol = species.index(model.species)
                self.opacity_models.append(('alkali', model, imol))
        if cfg.continuum_cs is not None:
            tmins, tmaxs = [], []
            for cs_file in cfg.continuum_cs:
                if not os.path.isfile(cs_file):
                    # The bundled CIA library by basename
                    # (pyratbay_tpu/model.py:609-617):
                    from .data import cia_file as bundled_cia
                    try:
                        cs_file = bundled_cia(cs_file)
                    except FileNotFoundError:
                        pass
                cia = CIA(cs_file, wn=wn)
                imol = [species.index(mol) for mol in cia.species]
                self.opacity_models.append(('cia', cia, imol))
                tmins.append(cia.tmin)
                tmaxs.append(cia.tmax)
            self.tmin['cia'] = np.amax(tmins)
            self.tmax['cia'] = np.amin(tmaxs)
        if cfg.rayleigh is not None:
            for name in cfg.rayleigh:
                mol = name.split('_')[1]
                model = Rayleigh(mol, wn)
                self.opacity_models.append(
                    ('rayleigh', model, species.index(mol)))

        cloud_names, cloud_pars = cfg_parser.parse_var_vals(cfg.clouds)
        clouds = {'ccsgray': CCSgray, 'deck': Deck, 'lecavelier': Lecavelier}
        for name, pars in zip(cloud_names, cloud_pars):
            model = clouds[name](self.press, wn)
            if pars is None:
                model.pars = [np.nan] * model.npars
            else:
                if len(pars) != model.npars:
                    raise ValueError(
                        f'Number of input parameters ({len(pars)}) does not '
                        f'match required ({model.npars}) for model {name!r}'
                    )
                model.pars = list(np.asarray(pars, float))
            self.opacity_models.append(('cloud', model, None))
        if cfg.h_ion_model is not None:
            model = HydrogenIon(wn)
            imol = [species.index(mol) for mol in model.species]
            self.opacity_models.append(('h_ion', model, imol))

        self.fpatchy = cfg.fpatchy
        self.is_patchy = self.fpatchy is not None
        self.has_deck = any(
            m.name == 'deck' for _, m, _ in self.opacity_models)

    # ------------------------------------------------------------------
    # Tensors

    def to(self, device=None):
        """Put the static tables on `device` (float64 on the CPU,
        float32 on CUDA); returns self."""
        self.device, self.dtype = resolve(device)
        tensor = lambda a: None if a is None else torch.as_tensor(
            np.asarray(a, float), dtype=self.dtype, device=self.device)
        self._press = tensor(self.press)
        self._mol_mass = tensor(self.mol_mass)
        self._base_vmr = tensor(self.base_vmr)
        self._base_temp = tensor(self.base_temp)
        self._input_radius = tensor(self.input_radius)
        self._log_press = tensor(np.log10(self.press))
        self._wn = tensor(self.wn)
        self._starflux = tensor(self.starflux)
        self._sed_temps = tensor(self.sed_temps)
        self._sed_fluxes = tensor(self.sed_fluxes)
        if self.bulk is not None:
            self._bulkratio = tensor(self.bulkratio)
            self._invsrat = tensor(self.invsrat)
        self._equil_fn = None if self.chem_model is None \
            else chem.equilibrium_fn(self.chem_model, self.device)
        if self.two_stream:
            # The two-stream boundaries (pyratbay_tpu/model.py:1040-1049),
            # made on the host in float64: the internal flux at tint and
            # the stellar irradiation at the top.
            wn = torch.as_tensor(self.wn, dtype=torch.float64)
            self._f_int = tensor(rt.internal_flux(wn, self.tint).numpy())
            fdown_top = np.zeros(self.nwave)
            if self.starflux is not None and self.smaxis is not None \
                    and self.rstar is not None:
                fdown_top = self.beta_irr * (self.rstar / self.smaxis)**2 \
                    * np.asarray(self.starflux)
            self._fdown_top = tensor(fdown_top)
        for _, m, _ in self.opacity_models:
            m.to(self.device, self.dtype)
        return self

    # ------------------------------------------------------------------
    # Opacity tabulation (runmode = opacity)

    def compute_opacity(self, engine='parity'):
        """Tabulate line-by-line cross sections over a (T, layer, wave)
        grid and write them to the sampled_cross_sec npz file.

        engine='parity' (the default) reproduces the reference's
        profile-grid sampling on the host in float64 (opacity/lbl.py,
        with grid-temperature densities); engine='direct' evaluates exact
        Voigt profiles on the model's device (opacity/lbl_direct.py, the
        CUDA kernels on a GPU), free of the profile grid's quantization.
        """
        cfg = self.cfg
        if cfg.sampled_cs is None:
            raise ValueError(
                'Undefined output cross-section file (sampled_cross_sec) '
                'needed to compute opacity table'
            )
        if cfg.tmin is None or cfg.tmax is None or cfg.tstep is None:
            raise ValueError(
                'Undefined temperature sampling (tmin/tmax/tstep) needed '
                'to compute opacity table'
            )
        lbl = None
        for mtype, model, _ in self.opacity_models:
            if mtype == 'lbl':
                lbl = model
        if lbl is None:
            raise ValueError(
                'Undefined input TLI files (tlifile) needed to compute '
                'opacity table'
            )
        if len(lbl.species) > 1:
            raise ValueError(
                'Cross-section files must be for a single species only, '
                'but line-by-line data include transitions for multiple '
                f'ones: {lbl.species}'
            )
        if cfg.tmin < lbl.tmin or cfg.tmax > lbl.tmax:
            raise ValueError(
                'Requested cross-section table temperatures '
                f'[{cfg.tmin:.1f}, {cfg.tmax:.1f}] K lie outside the TLI '
                f'range [{lbl.tmin:.1f}, {lbl.tmax:.1f}] K'
            )
        if engine not in ('parity', 'direct'):
            raise ValueError(
                f"Unknown line-by-line engine '{engine}' (parity, direct)")
        ntemp = int((cfg.tmax - cfg.tmin) / cfg.tstep) + 1
        temps = np.linspace(
            cfg.tmin, cfg.tmin + (ntemp - 1) * cfg.tstep, ntemp,
        )
        vmr = self.base_vmr
        if engine == 'direct':
            direct = self.direct_lbl(lbl)
            table = np.asarray(direct.tabulate(temps, self.press, vmr), float)
        else:
            table = np.zeros((ntemp, self.nlayers, self.nwave))
            for itemp, temp_val in enumerate(temps):
                temp_profile = np.full(self.nlayers, temp_val)
                dens = np.asarray(vmr) * (
                    self.press[:, None] * pc.bar / (pc.k * temp_val))
                table[itemp] = lbl.cross_section(temp_profile, dens)
        pio.write_opacity(
            cfg.sampled_cs[0], str(lbl.species[0]), temps, self.press,
            self.wn, table,
        )
        self.cs_table = table
        self.cs_temps = temps
        return table

    def direct_lbl(self, lbl):
        """Cached DirectLBL engine of an lbl opacity model on the model's
        device (opacity/lbl_direct.py)."""
        if not hasattr(self, '_direct_lbl'):
            self._direct_lbl = {}
        key = (id(lbl), str(self.device))
        if key not in self._direct_lbl:
            from .opacity.lbl_direct import DirectLBL
            self._direct_lbl[key] = DirectLBL(
                lbl, wn=self.wn, device=self.device)
        return self._direct_lbl[key]

    # ------------------------------------------------------------------
    # Evaluation pieces shared by the forward builders

    def eval_vmr_batched(self, vmr_par_list, temp):
        """VMRs of B chains [B, l, nspecies] (pyratbay_tpu
        Model._eval_vmr_pure): each entry of vmr_par_list is a [B, npars]
        tensor or None; temp [B, l].  With equilibrium chemistry the
        network is solved again for every chain at its temperature
        (_equilibrium_vmr), as the JAX package's jitted forward does;
        else the free VMR models with bulk balancing."""
        if self.chem_model is not None:
            return self._equilibrium_vmr(vmr_par_list, temp)
        return self._free_vmr(vmr_par_list, temp.shape[0])

    def _free_vmr(self, vmr_par_list, nchains):
        base = self._base_vmr
        if vmr_par_list is None or not self.ifree:
            return base.expand(nchains, *base.shape)
        profiles_list = []
        for kind, imol, pars in zip(
                self._vmr_kinds, self.ifree, vmr_par_list):
            if kind == 'iso':
                prof = vmr_models.iso_vmr(pars[:, 0], self.nlayers)
            elif kind == 'scale':
                prof = vmr_models.scale_vmr(base[:, imol], pars[:, 0])
            else:
                prof = vmr_models.slant_vmr(self._log_press, pars)
            profiles_list.append(prof)
        return vmr_models.vmr_scale(
            base, profiles_list, self.ifree, self.ibulk,
            self._bulkratio, self._invsrat,
        )

    def _equilibrium_vmr(self, vmr_par_list, temp):
        """The network's equilibrium at temp [B, l] with each chain's
        [M/H], [X/H] and X/Y parameters, then the hybrid log_X values
        capped by their elements' availability; solved in float64
        (atmosphere/chem.py; on the card one kernel launch, the span
        pbt.state.chem) and cast to the model's dtype."""
        nb = temp.shape[0]
        metallicity = escale = None
        ratios, hybrids = [], []
        for kind, info, pars in zip(
                self._vmr_kinds, self._equil_info, vmr_par_list or []):
            if pars is None:
                continue
            val = pars[:, 0].to(torch.float64)
            if kind == 'metal_equil':
                metallicity = val
            elif kind == 'scale_equil':
                if escale is None:
                    escale = torch.zeros(
                        (nb, len(self.chem_model.elements)),
                        dtype=torch.float64, device=temp.device)
                escale[:, info] = val
            elif kind == 'ratio_equil':
                ratios.append((info[0], info[1], val))
            elif kind == 'hybrid':
                hybrids.append((*info, val))
        with tracing.span('pbt.state.chem'):
            tracing.count('pbt.chem.systems', temp.shape[0] * temp.shape[1])
            vmr = self._equil_fn(temp, metallicity, escale, ratios)
        for imol, stoich_cols, mol_stoich, val in hybrids:
            cap = chem.hybrid_max_vmr(vmr, stoich_cols, mol_stoich)
            vmr = vmr.clone()
            vmr[:, :, imol] = torch.minimum(10.0 ** val[:, None], cap)
        return vmr.to(self.dtype)

    # ------------------------------------------------------------------
    # The per-chain forward (runmode = spectrum), pyratbay_tpu/model.py:
    # 758-1187, on tensors of the model's device.

    def _tensor(self, a):
        return torch.as_tensor(
            np.asarray(a, float) if not torch.is_tensor(a) else a,
            dtype=self.dtype, device=self.device)

    def model_pars(self):
        """Current parameters of each opacity model as [npars] tensors
        (None for a model without parameters)."""
        return [
            self._tensor(m.pars) if getattr(m, 'npars', 0) > 0 else None
            for _, m, _ in self.opacity_models
        ]

    def eval_temp(self, tpars=None):
        """Temperature profile [l]: the T(p) model at tpars (or the
        configured tpars), else the input profile."""
        if tpars is None:
            tpars = self.tpars
        if tpars is not None and self.temp_model is not None:
            return self.temp_model(self._tensor(tpars)[None])[0]
        if self._base_temp is None:
            raise ValueError('No temperature profile available')
        return self._base_temp

    def eval_vmr(self, vmr_pars=None, temp=None):
        """Volume mixing ratios [l, nspecies] at vmr_pars (a list of
        per-variable parameters, or the configured ones).  With
        equilibrium chemistry they are solved at temp (default: the
        configured profile); without parameters at the set-up profile
        itself they are base_vmr, as pyratbay_tpu's eval_vmr returns
        outside jit (model.py:796-808 there)."""
        if vmr_pars is None:
            vmr_pars = self.vmr_pars
        par_list = None if vmr_pars is None else [
            None if p is None else self._tensor(p).reshape(1, -1)
            for p in vmr_pars]
        if self.chem_model is None:
            return self._free_vmr(par_list, 1)[0]
        temp = self.eval_temp() if temp is None else self._tensor(temp)
        has_pars = par_list is not None and any(
            p is not None for p in par_list)
        if not has_pars and torch.equal(temp, self._base_temp):
            return self._base_vmr
        return self._equilibrium_vmr(par_list, temp[None])[0]

    def eval_radius(self, temp, mm, radius=None):
        """Radius profile [l] (cm) of the radius model, or the input one
        (None without either)."""
        if radius is not None:
            return self._tensor(radius)
        if self.rmodelname == 'hydro_m':
            return hydro.hydro_m(self._press, temp[None], mm[None],
                                 self.mplanet, self.refpressure,
                                 self.rplanet)[0]
        if self.rmodelname == 'hydro_g':
            return hydro.hydro_g(self._press, temp[None], mm[None],
                                 self.gplanet, self.refpressure,
                                 self.rplanet)[0]
        return self._input_radius

    def _operands(self, temp, radius, dens, pars_list, skip,
                  lbl_engine=None):
        """One chain's extinction sources as the RT kernels' operands at
        B = 1 (retrieval/batched.py assemble_opacity) and the line-sample
        table they take."""
        from .retrieval.batched import assemble_opacity, line_sample_table
        if pars_list is None:
            pars_list = self.model_pars()
        pars = [None if p is None else self._tensor(p).reshape(1, -1)
                for p in pars_list]
        ls_tab = line_sample_table(self)
        return assemble_opacity(self, temp[None], dens[None], radius[None],
                                pars, ls_tab, skip, lbl_engine), ls_tab

    def extinction(self, temp, radius, dens, pars_list=None, skip=(),
                   lbl_engine='parity'):
        """The summed extinction of one chain as dense tensors, the
        reference's diagnostics: (ec [l, W] without the clouds of a
        patchy model, ec_cloud [l, W] with them, the deck surface triple
        (itop, rsurf, tsurf) or None).  temp, radius [l]; dens
        [l, nspecies].  lbl_engine: the line-by-line models' engine,
        'parity' (the host profile-grid sampler) or 'direct' (the exact
        Voigt engine on the device, as in the batched forward)."""
        from .retrieval.batched import direct_lbl_engine
        if lbl_engine not in ('parity', 'direct'):
            raise ValueError(
                f"Invalid lbl_engine {lbl_engine!r}, select from "
                f"'parity' or 'direct'")
        engine = direct_lbl_engine(self) if lbl_engine == 'direct' else None
        ops, ls_tab = self._operands(temp, radius, dens, pars_list, skip,
                                     engine)
        return self._summed(ops, ls_tab, temp)

    def _summed(self, ops, ls_tab, temp):
        from .retrieval.batched import summed_extinction
        ec, ec_cloud = summed_extinction(self, ops, ls_tab, temp[None])
        deck = ops['deck']
        return ec[0], ec_cloud[0], None if deck is None else tuple(
            v[0] for v in deck)

    def check_temp_bounds(self, temp):
        """Names of the opacity models whose temperature tables the
        profile leaves."""
        temp = torch.as_tensor(temp)
        tmin, tmax = float(temp.min()), float(temp.max())
        oob = [name for name, t in self.tmin.items() if tmin < t]
        oob += [name for name, t in self.tmax.items() if tmax > t]
        return sorted(set(oob))

    def _rtop(self, radius):
        """Index of the first layer below the Hill radius (0 without
        one), a 0-d int64 tensor."""
        if not np.isfinite(self.rhill):
            return torch.zeros((), dtype=torch.int64, device=self.device)
        inside = radius < self.rhill
        return torch.where(
            torch.any(inside), torch.argmax(inside.to(torch.int8)),
            torch.zeros((), dtype=torch.int64, device=self.device))

    def run(self, temp=None, vmr=None, radius=None, skip=(), tpars=None,
            vmr_pars=None, pars_list=None, fpatchy=None):
        """Evaluate the forward model of one atmosphere; returns a dict
        of tensors and stores .spectrum, .depth, .ideep, .clear,
        .cloudy, .bbody, .depth_clear, .ideep_clear, .temp, .radius and
        .vmr as pyratbay_tpu's Model.run.

        The spectrum comes from the RT kernels at B = 1 (on the CPU their
        plain versions), on the operands the batched forward assembles
        (retrieval/batched.py assemble_opacity, spectra): one launch of
        the transit kernel (the counterpart of pyratbay_tpu's
        transit_spectrum_fused) or of the emission kernel, two for a
        patchy model.  depth, ideep (and bbody, depth_clear,
        ideep_clear) are diagnostics computed from the summed dense
        extinction (retrieval/batched.py rt_diagnostics), as the
        reference computes them beside its fused kernel.  A two-stream
        path launches no kernel: its spectrum is the top layer's upward
        flux of spectrum/rt.py two_stream (retrieval/batched.py
        two_stream_rt), and flux_up, flux_down [l, W] join the result.
        An out-of-bounds temperature gives a zero spectrum and
        'out_of_bounds'.
        """
        from .retrieval.batched import rt_diagnostics, spectra, two_stream_rt
        with tracing.span('pbt.run.atmosphere', always=True) as atmosphere:
            temp = self.eval_temp(tpars) if temp is None \
                else self._tensor(temp)
            oob = self.check_temp_bounds(temp)
            if oob or bool(to_host(torch.any(temp <= 0))):
                self.spectrum = np.zeros(self.nwave)
                return {
                    'spectrum': torch.zeros(self.nwave, dtype=self.dtype,
                                            device=self.device),
                    'out_of_bounds': oob or ['temperature'],
                }
            vmr = self.eval_vmr(vmr_pars, temp) if vmr is None \
                else self._tensor(vmr)
            dens = hydro.ideal_gas_density(vmr, self._press, temp)
            mm = hydro.mean_weight(vmr, self._mol_mass)
            radius = self.eval_radius(temp, mm, radius)
            rtop = self._rtop(radius)
        if fpatchy is None:
            fpatchy = self.fpatchy
        # The stages end where the JAX package's stamps do: the
        # atmosphere, the extinction (here the operands of the RT
        # launch), the spectrum with its diagnostics.
        with tracing.span('pbt.run.extinction', always=True) as extinction:
            ops, ls_tab = self._operands(temp, radius, dens, pars_list, skip)
        with tracing.span('pbt.run.spectrum', always=True) as stage:
            if self.two_stream:
                # Two-stream fluxes of the summed extinction (no kernel):
                fluxes = two_stream_rt(self, ops, ls_tab, temp[None],
                                       radius[None], rtop[None])
                result = {key: val[0] for key, val in fluxes.items()}
                result['spectrum'] = result['fplanet'] = \
                    result['flux_up'][0]
            else:
                # The spectrum, through the kernels at B = 1:
                spectrum, cloudy, clear = spectra(
                    self, ops, temp[None], radius[None], rtop[None],
                    ls_tab, fpatchy)
                result = {'spectrum': spectrum[0]}
                if self.is_patchy:
                    result['cloudy'], result['clear'] = cloudy[0], clear[0]
                # The diagnostics, from the same operands summed:
                diag = rt_diagnostics(self, ops, ls_tab, temp[None],
                                      radius[None], rtop[None])
                result.update({key: val[0] for key, val in diag.items()})

        # Eclipse: Fp/Fs scaled by (Rp/Rs)^2 (pyratbay_tpu/model.py:
        # 1142-1156):
        if self.rt_path in pc.ECLIPSE_RT:
            if self._starflux is None:
                raise ValueError(
                    'Undefined stellar flux model, required for eclipse')
            fstar_rprs = (self.rplanet / self.rstar)**2 / self._starflux
            result['fplanet'] = result['spectrum']
            for key in ('spectrum', 'clear', 'cloudy'):
                if key in result:
                    result[key] = result[key] * fstar_rprs

        host = lambda key: None if key not in result \
            else to_host(result[key]).numpy()
        self.spectrum = host('spectrum')
        self.clear = host('clear')
        self.cloudy = host('cloudy')
        self.depth = result['depth']
        self.ideep = result['ideep']
        self.bbody = result.get('bbody')
        self.depth_clear = result.get('depth_clear')
        self.ideep_clear = result.get('ideep_clear')
        self._last_fpatchy = fpatchy
        self.temp = to_host(temp).numpy()
        self.radius = None if radius is None else to_host(radius).numpy()
        self.vmr = to_host(vmr).numpy()
        # Each stage ends when the device reached its end mark (the host
        # clock's end on the CPU); the copies above drained the stream.
        tracing.resolve((atmosphere, extinction, stage))
        ends = [atmosphere.t0, atmosphere.end, extinction.end, stage.end]
        for key, t0, t1 in zip(('atmosphere', 'extinction', 'spectrum'),
                               ends, ends[1:]):
            self.timestamps[key] = (t1 - t0) * 1e-9
        self.log.msg(
            'Forward model done: '
            + ', '.join(
                f'{key} {val:.3f}s' for key, val in
                self.timestamps.items()
                if key in ('atmosphere', 'extinction', 'spectrum')
            )
        )
        return result

    def get_ec(self, layer, temp=None, vmr=None):
        """Per-model extinction contributions (cm-1) at one layer, the
        reference's opacity.get_ec diagnostic (pyratbay_tpu/model.py:
        1193-1260): (ec [nrows, W] tensor, labels).  A line-sample or
        line-by-line model gives one row per species (the latter from
        the parity engine's per-species cross sections times the
        layer's densities); the deck a row of 1 below its cloud top and
        0 above; every other model one row.  temp [l] and vmr
        [l, nspecies] default to the configured profiles."""
        temp = self.eval_temp() if temp is None else self._tensor(temp)
        vmr = self.eval_vmr() if vmr is None else self._tensor(vmr)
        dens = hydro.ideal_gas_density(vmr, self._press, temp)
        mm = hydro.mean_weight(vmr, self._mol_mass)
        radius = self.eval_radius(temp, mm)
        t1, d1 = temp[None], dens[None]
        rows, labels = [], []
        for (mtype, model, imol), pars in zip(
                self.opacity_models, self.model_pars()):
            pars = None if pars is None else pars[None]
            if model.name == 'deck':
                itop = int(model.surface(radius[None], t1, pars)[0][0])
                rows.append(torch.full(
                    (1, self.nwave), float(layer > itop),
                    dtype=self.dtype, device=self.device))
                labels.append('deck')
                continue
            if mtype == 'line_sample':
                w_st = model.kernel_weights(t1, d1[:, :, imol]).reshape(
                    model.nspec, model.ntemp, model.nlayers)[:, :, layer]
                rows.append(torch.einsum(
                    'st,stw->sw', w_st, model._table[:, :, layer]))
                labels += list(model.species)
                continue
            if mtype == 'lbl':
                dens_h = to_host(dens).double().numpy()
                contrib = model.cross_section(
                    to_host(temp).double().numpy(), dens_h, layer=layer,
                    per_mol=True)[:, layer]
                mol_idx = [self.species.index(mol) for mol in model.species]
                rows.append(self._tensor(
                    contrib * dens_h[layer, mol_idx][:, None]))
                labels += list(model.species)
                continue
            if mtype == 'alkali':
                contrib = model.extinction(t1, d1[:, :, imol])
                labels.append(model.species)
            elif mtype == 'cia':
                contrib = model.extinction(t1, d1[:, :, imol])
                labels.append(model.name)
            elif mtype == 'rayleigh':
                contrib = model.extinction(d1[:, :, imol])
                labels.append(model.name)
            elif mtype == 'cloud':
                contrib = model.extinction(t1, pars)
                labels.append(model.name)
            else:
                contrib = model.extinction(
                    t1, d1[:, :, imol[0]], d1[:, :, imol[1]])
                labels.append(model.name)
            rows.append(contrib[0, layer][None, :])
        return torch.cat(rows, dim=0), labels

    def band_contribution(self, obs, result=None):
        """Band-averaged contribution functions (emission) or
        transmittances (transmission) at each band of `obs`
        [nlayers, nbands] (numpy), as pyratbay_tpu's
        Model.band_contribution: transit gives the patchy-mixed e^-tau,
        emission the Knutson et al. (2009) B d(e^-tau)/dln p with the
        depth zeroed below ideep; both weighted by each band's raw
        response and max-normalized per band.

        result: a dict from run() or from a forward called with
        diagnostics=True (one chain); defaults to the last run()'s state.
        """
        from .spectrum import contribution as cfuncs
        from .spectrum.passbands import band_cf_matrix
        if result is not None:
            depth, ideep = result['depth'], result['ideep']
            bbody = result.get('bbody')
            depth_clear = result.get('depth_clear')
            ideep_clear = result.get('ideep_clear')
            fpatchy = result.get('fpatchy', self.fpatchy)
        else:
            last = lambda key: getattr(self, key, None)
            depth, ideep, bbody = last('depth'), last('ideep'), last('bbody')
            depth_clear, ideep_clear = last('depth_clear'), last('ideep_clear')
            fpatchy = last('_last_fpatchy')
        if depth is None:
            raise ValueError(
                'Cannot compute band contributions before run()')
        if getattr(obs, '_band_matrix', None) is None:
            raise ValueError(
                'Undefined observation filters, needed for band '
                'contribution functions')
        if self.rt_path in pc.TRANSMISSION_RT:
            contrib = cfuncs.transmittance(depth, ideep)
            if self.is_patchy and depth_clear is not None:
                contrib = fpatchy * contrib + (1.0 - fpatchy) * \
                    cfuncs.transmittance(depth_clear, ideep_clear)
        else:
            lay = torch.arange(self.nlayers, device=depth.device)[:, None]
            depth_cf = torch.where(lay > ideep[None, :],
                                   torch.zeros_like(depth), depth)
            contrib = cfuncs.contribution_function(
                depth_cf, self.press, bbody)
        weights = torch.as_tensor(
            band_cf_matrix(obs.filters, self.nwave), dtype=depth.dtype,
            device=depth.device)
        return to_host(cfuncs.band_cf(contrib, weights)).numpy()

    def _run_emission(self, ec_parts, temp, radius, rtop, deck_surface=None,
                      cia_w=None, cia_tab=None, r1_cols=None, r1_rows=None,
                      ls_w=None, ls_tab=None):
        """Plane-parallel emission flux [B, W] through the ensemble
        emission kernel (the per-chain forward is this at B = 1); a deck
        bounds the integration and emits as a blackbody at tsurf."""
        if deck_surface is not None:
            deck_itop, _, tsurf = deck_surface
            ibottom = deck_itop + 1
        else:
            deck_itop = tsurf = None
            ibottom = self.nlayers
        return emission_flux_ensemble(
            ec_parts, radius, temp, self._wn, self.quadrature_mu,
            self.quadrature_weights, rtop, ibottom, deck_itop=deck_itop,
            deck_tsurf=tsurf, cia_w=cia_w, cia_tab=cia_tab,
            ls_w=ls_w, ls_tab=ls_tab, r1_cols=r1_cols, r1_rows=r1_rows,
            maxdepth=self.maxdepth,
        )

    def _run_transit(self, ec_parts, radius, rtop, deck_surface=None,
                     cia_w=None, cia_tab=None, r1_cols=None, r1_rows=None,
                     ls_w=None, ls_tab=None):
        """Transit spectra [B, W] through the ensemble kernel (the
        per-chain forward is this at B = 1, which replaces
        pyratbay_tpu's per-chain transit_spectrum_fused).

        Radius-normalized geometry: chords are computed on radius /
        rscale (float32-safe) and rescaled; the scale cancels in the
        (Rp/Rs)^2 output.
        """
        nb = radius.shape[0]
        if deck_surface is not None:
            deck_itop, rsurf, _ = deck_surface
            ibottom = deck_itop + 1
        else:
            deck_itop = rsurf = None
            ibottom = torch.full(
                (nb,), self.nlayers, dtype=torch.int64, device=self.device)
        rscale = self._radius_scale
        rr = radius / rscale
        path = geometry.transit_path_matrix(rr, rtop) * rscale
        return transit_spectrum_ensemble(
            ec_parts, path, rr, self.rstar / rscale, rtop, ibottom,
            deck_itop=deck_itop,
            deck_rsurf=None if rsurf is None else rsurf / rscale,
            cia_w=cia_w, cia_tab=cia_tab, r1_cols=r1_cols, r1_rows=r1_rows,
            ls_w=ls_w, ls_tab=ls_tab, maxdepth=self.maxdepth,
        )

    def plot_spectrum(self, spec='model', filename=None, obs=None, **kw):
        """Plot the latest (spec='model') or best-fit (spec='best')
        spectrum, with the observation's bands and data when it has
        them; returns the matplotlib Axes (pyratbay_tpu's
        Model.plot_spectrum)."""
        import matplotlib
        matplotlib.use('Agg')
        from . import plots
        if spec == 'best':
            spectrum = getattr(self, 'spec_best', None)
            if spectrum is None:
                raise ValueError(
                    "plot_spectrum(spec='best') requires a retrieval run"
                )
        else:
            spectrum = getattr(self, 'spectrum', None)
        if spectrum is None:
            raise ValueError('Cannot plot spectrum before run()')
        obs = obs if obs is not None else getattr(self, 'obs', None)
        rt_key = (
            'transit' if self.rt_path in pc.TRANSMISSION_RT else
            'eclipse' if self.rt_path in pc.ECLIPSE_RT else 'emission'
        )
        wl = 1.0 / (np.asarray(self.wn) * pc.um)
        kw.setdefault('rt_path', rt_key)
        if obs is not None and obs.nbands:
            kw.setdefault('band_wl', obs.band_wl)
            kw.setdefault('data', obs.data)
            kw.setdefault('uncert', obs.uncert)
        return plots.spectrum(
            np.asarray(spectrum), wl, filename=filename, **kw,
        )

    def plot_temperature(self, filename=None, **kw):
        """Plot the last run's temperature profile (the configured one
        before a run); returns the matplotlib Axes."""
        import matplotlib
        matplotlib.use('Agg')
        from . import plots
        temp = getattr(self, 'temp', None)
        if temp is None:
            temp = to_host(self.eval_temp()).numpy()
        return plots.temperature(
            np.asarray(self.press), profiles=[np.asarray(temp)],
            filename=filename, **kw,
        )

    def __str__(self):
        fw = Formatted_Write()
        fw.write('Radiative-transfer model (pyratbay_tpu_torch):')
        fw.write('Run mode (runmode): {}', self.cfg.runmode)
        fw.write('RT path (rt_path): {}', self.rt_path)
        fw.write(
            'Wavenumber range: {:.2f} -- {:.2f} cm-1 ({:d} samples)',
            float(self.wn[0]), float(self.wn[-1]), self.nwave,
        )
        fw.write(
            'Pressure range: {:.2e} -- {:.2e} bar ({:d} layers)',
            float(self.press[0]), float(self.press[-1]), self.nlayers,
        )
        fw.write('Species: {}', [str(s) for s in self.species])
        fw.write('Opacity models:')
        for mtype, model, _ in self.opacity_models:
            bounds = ''
            if self.tmin.get(mtype) is not None:
                bounds = (
                    f'  T = [{self.tmin[mtype]:.1f}, '
                    f'{self.tmax[mtype]:.1f}] K'
                )
            fw.write('  {:22s} ({}){}', model.name, mtype, bounds)
        if self.temp_model is not None:
            fw.write('Temperature model: {}', self.cfg.tmodelname)
        if self.rmodelname is not None:
            fw.write('Radius model: {}', self.rmodelname)
        fw.write('System:')
        if self.rplanet is not None:
            fw.write(
                '  Planet radius (rplanet): {:.3f} rjup',
                float(self.rplanet) / pc.rjup,
            )
        if self.mplanet is not None:
            fw.write(
                '  Planet mass (mplanet): {:.3f} mjup',
                float(self.mplanet) / pc.mjup,
            )
        if self.rstar is not None:
            fw.write(
                '  Stellar radius (rstar): {:.3f} rsun',
                float(self.rstar) / pc.rsun,
            )
        if self.tstar is not None:
            fw.write(
                '  Stellar temperature (tstar): {:.1f} K',
                float(self.tstar),
            )
        if self.smaxis is not None:
            fw.write(
                '  Semi-major axis (smaxis): {:.4f} au',
                float(self.smaxis) / pc.au,
            )
        if np.isfinite(self.rhill):
            fw.write(
                '  Hill radius (rhill): {:.3f} rjup',
                float(self.rhill) / pc.rjup,
            )
        # The last run's optical depth (ideep is a device tensor):
        ideep = getattr(self, 'ideep', None)
        if ideep is not None:
            fw.write('Optical depth (last run):')
            fw.write('  Maximum depth to integrate (maxdepth): {:.2f}',
                     float(self.maxdepth))
            fw.write(
                '  ideep range (first layer at maxdepth): '
                '[{:d}, {:d}] of {:d} layers',
                int(to_host(ideep.min())), int(to_host(ideep.max())),
                self.nlayers,
            )
        if self.timestamps:
            fw.write('Last-run timestamps (s):')
            for key, val in self.timestamps.items():
                fw.write('  {:12s} {:.4f}', key, val)
        return fw.text



def _is_number(value):
    try:
        float(value)
        return True
    except ValueError:
        return False


def _interp_sed(fluxes, temps, tstar):
    """Linear-in-T interpolation of a temperature-gridded stellar SED
    (pyratbay_tpu/model.py:1466-1477): fluxes [ntemps, W], temps
    [ntemps], tstar [B] -> [B, W], on the fluxes' device.  The lower
    index is clipped to [0, ntemps - 2] and the weight to [0, 1], so a
    temperature off the grid takes the SED at its nearer end."""
    tstar = tstar.to(fluxes.dtype)
    i = torch.clamp(
        torch.searchsorted(temps, tstar.contiguous(), right=True) - 1,
        0, len(temps) - 2)
    w = torch.clamp(
        (tstar - temps[i]) / (temps[i + 1] - temps[i]), 0.0, 1.0)[:, None]
    return fluxes[i] * (1.0 - w) + fluxes[i + 1] * w
