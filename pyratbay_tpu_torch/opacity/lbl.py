"""Line-by-line opacity from TLI line data: the host setup.

Host-side numpy copy of the setup half of pyratbay_tpu/opacity/lbl.py
(LineByLine): the TLI merge, the isotope bookkeeping, single_isotope,
the temperature range, iso_pf and _layer_widths.  The line data feed
the direct engine (opacity/lbl_direct.py::DirectLBL), which computes
cross sections on the device through the CUDA kernels.

The parity engine (the reference's profile-grid sampler: VoigtGrid,
_sample_layer, cross_section, extinction) is not ported yet
(ROADMAP.md A11).
"""
import numpy as np

from .. import constants as pc
from .tli import read_tli

__all__ = ['LineByLine']

_SQRTLN2 = 0.83255461115769775635


def _parity_not_ported():
    return NotImplementedError(
        'The parity line-by-line engine (profile-grid sampling) is not '
        'ported to pyratbay_tpu_torch yet (ROADMAP.md A11); use the '
        "direct engine, Model.compute_opacity(engine='direct')")


class LineByLine:
    """Line-by-line opacity model (TLI-driven), host setup."""

    name = 'line by line'

    def __init__(self, tlifiles, wn, species, mol_mass, mol_radius, own,
                 voigt_cutoff=25.0, single_isotope=None):
        """tlifiles: TLI file(s); wn: output grid; species, mol_mass,
        mol_radius: the atmosphere's species; own: the fine grid, whose
        range selects the transitions; voigt_cutoff: line-wing cutoff
        (cm-1).  The parity engine's Voigt-grid and sampling options
        (voigt_extent, ndop, nlor, wnosamp, ...) come with it
        (ROADMAP.md A11)."""
        if isinstance(tlifiles, str):
            tlifiles = [tlifiles]
        self.tlifiles = tlifiles
        self.wn = np.asarray(wn)
        self.nwave = len(self.wn)
        self.own = np.asarray(own)
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

        self.mol = list(self.species)

    def to(self, device, dtype):
        """Host-only model: the device tables belong to DirectLBL."""
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

    def cross_section(self, temp, densities):
        """Parity-engine cross sections (not ported)."""
        raise _parity_not_ported()

    def extinction(self, temp, densities):
        """Parity-engine extinction (not ported)."""
        raise _parity_not_ported()
