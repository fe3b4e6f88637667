"""Retrieval parameter space: parse the `retrieval_params` block and map
each free parameter onto its model slot.

Reference behavior: pyratbay/pyrat/retrieval.py:36-324 (pnames, pmin,
pmax, pstep, priors; index maps itemp/imol/iopacity/irad/...).
Host-side numpy copy of pyratbay_tpu/retrieval/params.py.
"""
import numpy as np

from .. import constants as pc
from ..atmosphere.profiles import TMODEL_PNAMES

__all__ = ['RetrievalParams']

SOLO_PARAMS = [
    'log_p_ref', 'R_planet', 'M_planet', 'rv_shift', 'f_patchy',
    'T_eff', 'f_dilution',
]


class RetrievalParams:
    """Free-parameter definitions and model-slot mappings."""

    def __init__(self, model, obs=None):
        cfg = model.cfg
        self.tlow = cfg.tlow if cfg.tlow is not None else -np.inf
        self.thigh = cfg.thigh if cfg.thigh is not None else np.inf
        self.qcap = cfg.qcap
        self.sampler = cfg.sampler
        self.nsamples = cfg.nsamples
        self.nchains = cfg.nchains
        self.burnin = cfg.burnin
        self.thinning = cfg.thinning or 1

        if cfg.retrieval_params is not None:
            self._parse_block(cfg.retrieval_params)
        elif cfg.params is not None:
            self.pnames = []
            self.params = np.asarray(cfg.params, float)
            n = len(self.params)
            self.pmin = (
                np.asarray(cfg.pmin, float) if cfg.pmin is not None
                else np.full(n, -np.inf)
            )
            self.pmax = (
                np.asarray(cfg.pmax, float) if cfg.pmax is not None
                else np.full(n, np.inf)
            )
            self.pstep = (
                np.asarray(cfg.pstep, float) if cfg.pstep is not None
                else np.ones(n)
            )
            self.prior = np.zeros(n)
            self.priorlow = np.zeros(n)
            self.priorup = np.zeros(n)
        else:
            raise ValueError('No retrieval parameters defined')

        self.nparams = len(self.params)
        self._build_maps(model, obs)

    def _parse_block(self, block):
        lines = [ln for ln in block.splitlines() if ln.strip()]
        n = len(lines)
        self.pnames = []
        self.params = np.zeros(n)
        self.pmin = np.full(n, -np.inf)
        self.pmax = np.full(n, np.inf)
        self.pstep = np.zeros(n)
        self.prior = np.zeros(n)
        self.priorlow = np.zeros(n)
        self.priorup = np.zeros(n)
        for i, line in enumerate(lines):
            fields = line.split()
            if len(fields) not in (2, 5, 7, 8):
                raise ValueError(
                    'Invalid number of fields for retrieval_params entry'
                    f"\n'{line}'"
                )
            self.pnames.append(fields[0])
            self.params[i] = fields[1]
            if len(fields) == 2:
                continue
            self.pmin[i] = fields[2]
            self.pmax[i] = fields[3]
            self.pstep[i] = fields[4]
            if len(fields) == 5:
                continue
            self.prior[i] = fields[5]
            self.priorlow[i] = fields[6]
            self.priorup[i] = fields[7] if len(fields) == 8 else fields[6]

    def _build_maps(self, model, obs):
        """Index maps: which params feed which model slots."""
        names, counts = np.unique(self.pnames, return_counts=True)
        if np.any(counts > 1):
            raise ValueError(
                f'Repeated parameter names: {names[counts > 1]}'
            )

        temp_pnames = []
        if model.cfg.tmodelname is not None:
            temp_pnames = TMODEL_PNAMES[model.cfg.tmodelname]

        vmr_pnames = list(model.vmr_var_names)

        opacity_pnames = [
            list(getattr(m, 'pnames', []))
            for _, m, _ in model.opacity_models
        ]
        offset_pnames = list(obs.offset_inst) if obs is not None else []
        error_pnames = list(obs.uncert_scaling) if obs is not None else []

        self.itemp, self.map_temp = [], []
        self.imol, self.map_mol = [], []
        self.iopacity = [[] for _ in model.opacity_models]
        self.map_opacity = [[] for _ in model.opacity_models]
        self.ioffset, self.map_offset = [], []
        self.ierror, self.map_error = [], []
        self.irad = self.imass = self.ipress = None
        self.ipatchy = self.itstar = self.idilut = self.irv = None

        all_available = (
            SOLO_PARAMS + temp_pnames + vmr_pnames
            + [p for ps in opacity_pnames for p in ps]
            + offset_pnames + error_pnames
        )
        for i, pname in enumerate(self.pnames):
            if pname == 'log_p_ref':
                self.ipress = i
            elif pname == 'R_planet':
                self.irad = i
            elif pname == 'M_planet':
                self.imass = i
            elif pname == 'rv_shift':
                self.irv = i
            elif pname == 'f_patchy':
                self.ipatchy = i
            elif pname == 'T_eff':
                self.itstar = i
            elif pname == 'f_dilution':
                self.idilut = i
            elif pname in temp_pnames:
                self.itemp.append(i)
                self.map_temp.append(temp_pnames.index(pname))
            elif pname in vmr_pnames:
                self.imol.append(i)
                self.map_mol.append(vmr_pnames.index(pname))
            elif any(pname in ps for ps in opacity_pnames):
                for j, ps in enumerate(opacity_pnames):
                    if pname in ps:
                        self.iopacity[j].append(i)
                        idx = ps.index(pname)
                        self.map_opacity[j].append(idx)
                        # Patch undefined model values with the
                        # retrieval initial value (reference
                        # retrieval.py:258-259):
                        m = model.opacity_models[j][1]
                        pars = np.asarray(m.pars, float)
                        if not np.isfinite(pars[idx]):
                            pars[idx] = self.params[i]
                            m.pars = list(pars)
                        break
            elif pname in offset_pnames:
                self.ioffset.append(i)
                self.map_offset.append(offset_pnames.index(pname))
            elif pname in error_pnames:
                self.ierror.append(i)
                self.map_error.append(error_pnames.index(pname))
            else:
                raise ValueError(
                    f"Invalid retrieval parameter '{pname}'. Possible "
                    f'values are:\n{all_available}'
                )

        # Patch missing model parameters from the retrieval initial
        # values, then enforce completeness (reference
        # retrieval.py:286-323):
        if model.temp_model is not None and model.tpars is None:
            if self.itemp and len(self.map_temp) == len(temp_pnames):
                tpars = np.zeros(len(temp_pnames))
                tpars[np.asarray(self.map_temp)] = \
                    self.params[np.asarray(self.itemp)]
                model.tpars = tpars
            else:
                raise ValueError(
                    'Not all temperature parameters were defined (tpars)'
                )
        if vmr_pnames:
            vmr_pars = model.vmr_pars
            if vmr_pars is None:
                vmr_pars = [None] * len(vmr_pnames)
            if any(p is None for p in vmr_pars):
                vmr_pars = list(vmr_pars)
                for i_par, slot in zip(self.imol, self.map_mol):
                    if vmr_pars[slot] is None:
                        vmr_pars[slot] = np.array([self.params[i_par]])
                if any(p is None for p in vmr_pars):
                    raise ValueError(
                        'Not all vmr parameter values were defined '
                        '(vmr_vars)'
                    )
                model.vmr_pars = vmr_pars
        bad_models = ''
        for j, (mtype, m, _) in enumerate(model.opacity_models):
            if getattr(m, 'npars', 0) == 0:
                continue
            if not np.all(np.isfinite(np.asarray(m.pars, float))):
                bad_models = f"{mtype} model '{m.name}', "
        if bad_models:
            raise ValueError(
                f'Undefined parameter values for {bad_models[:-2]}'
            )

        self.ifree = np.where(self.pstep > 0)[0]
        self.nfree = len(self.ifree)

    def __str__(self):
        from ..tools import Formatted_Write
        fw = Formatted_Write()
        fw.write('Retrieval parameters:')
        fw.write('Number of parameters (nparams): {}', self.nparams)
        fw.write('Number of free parameters (nfree): {}', self.nfree)
        fw.write(
            '  {:16s} {:>10s} {:>10s} {:>10s} {:>8s}',
            'pname', 'value', 'pmin', 'pmax', 'pstep',
        )
        for i, pname in enumerate(self.pnames):
            fw.write(
                '  {:16s} {:10.4g} {:10.4g} {:10.4g} {:8.4g}',
                pname, self.params[i], self.pmin[i], self.pmax[i],
                self.pstep[i],
            )
        fw.write('Sampler: {}', self.sampler)
        fw.write(
            'Temperature bounds (tlow, thigh): [{:.1f}, {:.1f}] K',
            self.tlow, self.thigh,
        )
        return fw.text
