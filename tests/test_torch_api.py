"""The public names of pyratbay_tpu resolve in pyratbay_tpu_torch, and
the verification recipe's transmission forward model runs through the
port's public API and matches the JAX package's (float64 on the CPU,
rtol 1e-8, the slice bound of tests/test_torch_forward.py).

The JAX package's __init__ files are read with ast, so collecting the
names imports nothing of it."""
import ast
import importlib
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-8
SUBPACKAGES = ['', 'atmosphere', 'opacity', 'spectrum', 'retrieval', 'io',
               'ops', 'parallel']

# Names of the JAX package that the port leaves out on purpose (file,
# name; None for a whole module): JAX- and XLA-specific tools, the
# Pallas layout helpers (ROADMAP B1), the reference's C timing harness,
# and the runtime loader whose quiet numpy fallback the port does not
# have (ROADMAP section C).
NOT_PORTED = [
    ('atmosphere/chem.py', 'jit_equilibrium_fn'),
    ('tuning.py', 'set_tuning'),
    ('scaling_probe.py', None),
    ('spectrum/rt_pallas.py', 'prep_chain'),
    ('spectrum/rt_pallas.py', 'chain_rt_epilogue'),
    ('spectrum/emission_pallas.py', 'prep_emission_chain'),
    ('benchmark.py', 'reference_c_baseline'),
    ('runtime/__init__.py', 'load_runtime'),
]


def public_names(subpackage):
    """The names pyratbay_tpu/<subpackage>/__init__.py imports."""
    path = os.path.join(REPO, 'pyratbay_tpu', subpackage, '__init__.py')
    with open(path) as f:
        tree = ast.parse(f.read())
    return [alias.asname or alias.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for alias in node.names]


def defined_names(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    return {node.name for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.ClassDef))}


@pytest.mark.parametrize('subpackage', SUBPACKAGES)
def test_public_names_resolve(subpackage):
    names = public_names(subpackage)
    assert names
    module = importlib.import_module(
        '.'.join(filter(None, ['pyratbay_tpu_torch', subpackage])))
    not_ported = {name for _, name in NOT_PORTED}
    missing = [name for name in names
               if name not in not_ported and not hasattr(module, name)]
    assert missing == []


def test_package_entry_points():
    import pyratbay_tpu_torch as pb
    assert pb.Model.__module__ == 'pyratbay_tpu_torch.model'
    assert pb.run.__module__ == 'pyratbay_tpu_torch.driver'
    assert callable(pb.io.save_model) and callable(pb.io.load_model)
    assert pb.__all__ == [
        '__version__', 'constants', 'ops', 'atmosphere', 'opacity',
        'spectrum', 'io', 'tools', 'run', 'Model']


@pytest.mark.parametrize('path, name', NOT_PORTED)
def test_names_not_ported_on_purpose(path, name):
    """Each exception is a name of the JAX package that the port does
    not have."""
    jax_path = os.path.join(REPO, 'pyratbay_tpu', path)
    port_path = os.path.join(REPO, 'pyratbay_tpu_torch', path)
    assert os.path.exists(jax_path)
    if name is None:
        assert not os.path.exists(port_path)
        return
    assert name in defined_names(jax_path)
    assert not os.path.exists(port_path) \
        or name not in defined_names(port_path)


def test_drive_recipe_matches_the_jax_package():
    """The verification recipe's transmission forward model (at wnstep
    4), written with each package's public names; the port's profiles
    and opacity sources take a leading chain axis (here of one chain)
    and their tables are put on a device first (`to`)."""
    from pyratbay_tpu import atmosphere as jatm, opacity as jop
    from pyratbay_tpu import constants as jpc, spectrum as jsp
    from pyratbay_tpu.atmosphere.profiles import guillot_tp as jguillot
    from pyratbay_tpu.io.io import species_properties as jspecies
    from pyratbay_tpu.ops import wavenumber_grid as jgrid

    grid = jgrid(wl_low=0.5 * jpc.um, wl_high=1.0 * jpc.um, wnstep=4.0)
    press = jatm.pressure('1e-6 bar', '1e2 bar', 51)
    tpars = [-4.67, -0.8, -0.8, 0.5, 1486.0, 100.0]
    temp = jguillot(press)(tpars)
    vmr = jatm.uniform_vmr([0.85, 0.149, 3e-6, 4e-4], 51)
    masses, _ = jspecies(['H2', 'He', 'Na', 'H2O'])
    radius = jatm.hydro_m(press, temp, jatm.mean_weight(vmr, masses),
                          0.6 * jpc.mjup, 0.1, 1.0 * jpc.rjup)
    dens = jatm.ideal_gas_density(vmr, press, temp)
    ec = (jop.Rayleigh('H2', grid.wn).extinction(dens[:, 0])
          + jop.SodiumVdW(press, grid.wn).extinction(temp, dens[:, 2]))
    depth, ideep = jsp.transit_depth(
        ec, jatm.transit_path_matrix(radius), maxdepth=10.0)
    want = jsp.transmission_spectrum(depth, ideep, radius, 1.27 * jpc.rsun)

    import pyratbay_tpu_torch as pb
    from pyratbay_tpu_torch import atmosphere as atm, opacity as op
    from pyratbay_tpu_torch import constants as pc, spectrum as sp
    from pyratbay_tpu_torch.atmosphere.profiles import guillot_tp
    from pyratbay_tpu_torch.io.io import species_properties
    from pyratbay_tpu_torch.ops import wavenumber_grid

    f64 = dict(dtype=torch.float64)
    grid = wavenumber_grid(wl_low=0.5 * pc.um, wl_high=1.0 * pc.um,
                           wnstep=4.0)
    press = atm.pressure('1e-6 bar', '1e2 bar', 51)
    temp = guillot_tp(press)(torch.tensor([tpars], **f64))
    vmr = torch.as_tensor(atm.uniform_vmr([0.85, 0.149, 3e-6, 4e-4], 51),
                          **f64)[None]
    masses, _ = species_properties(['H2', 'He', 'Na', 'H2O'])
    press_t = torch.as_tensor(press, **f64)
    radius = atm.hydro_m(press_t, temp,
                         atm.mean_weight(vmr, torch.as_tensor(masses)),
                         0.6 * pc.mjup, 0.1, 1.0 * pc.rjup)
    dens = atm.ideal_gas_density(vmr, press_t, temp)
    ec = (op.Rayleigh('H2', grid.wn).to('cpu', torch.float64)
          .extinction(dens[:, :, 0])
          + op.SodiumVdW(press, grid.wn).to('cpu', torch.float64)
          .extinction(temp, dens[:, :, 2]))
    depth, ideep = sp.transit_depth(
        ec[0], atm.transit_path_matrix(radius)[0], maxdepth=10.0)
    spec = sp.transmission_spectrum(depth, ideep, radius[0],
                                    1.27 * pc.rsun)
    assert pb.spectrum.transmission_spectrum is sp.transmission_spectrum
    np.testing.assert_allclose(spec.numpy(), np.asarray(want), rtol=RTOL)
    floor = (radius[0, -1] / (1.27 * pc.rsun))**2
    assert bool(torch.all(spec >= floor))
