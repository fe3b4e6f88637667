"""Static state across packages: numpy arrays in, the port's tensors out.

`static_arrays` reads the static setup (grids, opacity tables, the
star's flux, the emission quadrature, band matrix, parameter space and
its slot maps) from a Model / Observation / RetrievalParams triple as
numpy arrays.  It only reads attributes, so it works on the JAX
package's objects as well as the port's without importing either.
`to_tensors` turns such a dict into the port's tensors, and
`load_static` installs it into port objects, so tests can feed both
packages the very same tables.  `direct_lbl_tables` does the same for
the line data of the direct line-by-line engine.
"""
import numpy as np

from .device import resolve

__all__ = ['static_arrays', 'to_tensors', 'load_static',
           'direct_lbl_tables']

_INT_KEYS = ('itemp', 'map_temp', 'imol', 'map_mol')


def static_arrays(model, obs, ret):
    """Dict of numpy arrays describing the static state."""
    arrays = {
        'press': model.press,
        'wn': model.wn,
        'base_vmr': model.base_vmr,
        'mol_mass': model.mol_mass,
        'tpars': model.tpars,
        'bulkratio': model.bulkratio,
        'invsrat': model.invsrat,
        'starflux': model.starflux,
        'quadrature_mu': model.quadrature_mu,
        'quadrature_weights': model.quadrature_weights,
        'band_matrix': obs._band_matrix,
        'data': obs.data,
        'uncert': obs.uncert,
    }
    for j, (mtype, m, _) in enumerate(model.opacity_models):
        if mtype == 'line_sample':
            arrays[f'cs_table_{j}'] = m.cs_table
            arrays[f'cs_temps_{j}'] = m.temp
        elif mtype == 'cia':
            arrays[f'tab_cs_amagat_{j}'] = m.tab_cs_amagat
            arrays[f'cia_temps_{j}'] = m.temps
        if getattr(m, 'npars', 0):
            arrays[f'pars_{j}'] = np.asarray(m.pars, float)
    for key in ('params', 'pmin', 'pmax', 'pstep', 'prior', 'priorlow',
                'priorup') + _INT_KEYS:
        arrays[key] = getattr(ret, key)
    for j, (idx, slots) in enumerate(zip(ret.iopacity, ret.map_opacity)):
        arrays[f'iopacity_{j}'] = idx
        arrays[f'map_opacity_{j}'] = slots
    for key in ('irad', 'imass', 'ipress'):
        value = getattr(ret, key)
        arrays[key] = -1 if value is None else value
    return {
        key: None if value is None else np.asarray(
            value, int if key.startswith(_INT_KEYS + (
                'iopacity', 'map_opacity', 'irad', 'imass', 'ipress'))
            else float)
        for key, value in arrays.items()
    }


def to_tensors(arrays, device=None):
    """The port's tensors for a static_arrays dict (floats in the
    device's dtype, index maps as int64); None entries stay None."""
    import torch
    device, dtype = resolve(device)
    out = {}
    for key, value in arrays.items():
        if value is None:
            out[key] = None
        elif np.issubdtype(value.dtype, np.integer):
            out[key] = torch.as_tensor(value, dtype=torch.int64,
                                       device=device)
        else:
            out[key] = torch.as_tensor(value, dtype=dtype, device=device)
    return out


def load_static(model, obs, ret, arrays):
    """Install a static_arrays dict (e.g. taken from the JAX package's
    objects) into the port's Model/Observation/RetrievalParams and
    rebuild their tensors on the model's device."""
    for key in ('press', 'wn', 'base_vmr', 'mol_mass', 'tpars',
                'bulkratio', 'invsrat', 'starflux', 'quadrature_mu',
                'quadrature_weights'):
        setattr(model, key, arrays[key])
    for j, (mtype, m, _) in enumerate(model.opacity_models):
        if mtype == 'line_sample':
            m.cs_table = arrays[f'cs_table_{j}']
            m.temp = arrays[f'cs_temps_{j}']
        elif mtype == 'cia':
            m.tab_cs_amagat = arrays[f'tab_cs_amagat_{j}']
            m.temps = arrays[f'cia_temps_{j}']
        if f'pars_{j}' in arrays:
            m.pars = list(arrays[f'pars_{j}'])
    obs._band_matrix = arrays['band_matrix']
    obs.data = arrays['data']
    obs.uncert = arrays['uncert']
    for key in ('params', 'pmin', 'pmax', 'pstep', 'prior', 'priorlow',
                'priorup'):
        setattr(ret, key, arrays[key])
    for key in _INT_KEYS:
        setattr(ret, key, [int(i) for i in arrays[key]])
    ret.iopacity = [
        [int(i) for i in arrays[f'iopacity_{j}']]
        for j in range(len(ret.iopacity))]
    ret.map_opacity = [
        [int(i) for i in arrays[f'map_opacity_{j}']]
        for j in range(len(ret.map_opacity))]
    for key in ('irad', 'imass', 'ipress'):
        value = int(arrays[key])
        setattr(ret, key, None if value < 0 else value)
    model.to(model.device)
    obs.to(model.device, model.dtype)
    return model, obs, ret


def direct_lbl_tables(jax_direct, device=None):
    """The port's DirectLBL device tables from a JAX DirectLBL's host
    tables (`_tables`, a dict of numpy arrays): floats in the device's
    dtype, isotope ids as int64, and the species one-hots replaced by
    the int32 species index of each window entry.  The per-line tables
    and window starts that the port's main path reads (the JAX engine
    keeps the window layout only) are made from the engine's host
    attributes."""
    from .opacity.lbl_direct import device_tables, line_tables
    return device_tables(
        {**jax_direct._tables, **line_tables(jax_direct)}, device)
