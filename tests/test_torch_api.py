"""The public names of pyratbay_tpu resolve in pyratbay_tpu_torch, and
the verification recipe's transmission forward model runs through the
port's public API and matches the JAX package's (float64 on the CPU,
rtol 1e-8, the slice bound of tests/test_torch_forward.py).

The whole public surface is compared module by module: each JAX
module's __all__ against the port module's, and the keyword names of
each public function and public class method, apart from NOT_PORTED
and the deliberate differences of RENAMED.  Both trees are read with
ast, so collecting the names imports nothing of either package."""
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
    ('spectrum/ensemble_pallas.py', None),
    ('spectrum/rt_pallas.py', None),
    ('spectrum/emission_pallas.py', None),
    ('opacity/lbl_pallas.py', None),
]

# Port modules under another name than the JAX package's.
MODULE_MAP = {'opacity/lbl_tpu.py': 'opacity/lbl_direct.py'}

# Keywords of the JAX package the port takes under another form, on
# purpose: (file, function or Class.method, JAX keyword) -> reason.
RENAMED = {
    ('retrieval/samplers.py', 'sample_demc', 'log_post'):
        'log_post_b: the log-posterior of a batch of chains',
    ('retrieval/samplers.py', 'sample_demc', 'key'):
        'generator: a torch.Generator in place of a JAX PRNG key',
    ('retrieval/nested.py', 'sample_nested', 'log_like'):
        'log_like_b: the log-likelihood of a batch of points',
    ('retrieval/nested.py', 'sample_nested', 'key'):
        'generator (and draws): a torch.Generator in place of a PRNG key',
    ('retrieval/posterior.py', 'spectrum_posterior', 'forward'):
        'forward_b: one batched forward over the draws',
    ('retrieval/driver.py', 'post_process', 'forward'):
        'the batched forward is built from (model, obs, ret)',
    ('retrieval/driver.py', 'post_process', 'results'):
        'the results are read from model.posterior and model.bestp',
    ('retrieval/forward.py', 'build_forward', 'dtype'):
        "the forward takes the dtype of the model's device tensors",
    ('opacity/lbl_tpu.py', 'DirectLBL.__init__', 'use_pallas'):
        'the CUDA kernels run on a CUDA tensor, their plain versions '
        'on the CPU: no interpreter switch',
    ('spectrum/radeq.py', 'radiative_equilibrium', 'use_scan'):
        'one device loop: no lax.scan switch',
    ('parallel/sharded.py', 'make_mesh', 'devices'):
        'a torch.distributed mesh over the process group, one card a rank',
    ('parallel/mp_probe.py', 'main', 'nprocs'):
        'argv: the probe parses its command line (torch.multiprocessing)',
    ('parallel/mp_probe.py', 'main', 'local_devices'):
        'argv: the probe parses its command line (torch.multiprocessing)',
}


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


def jax_modules():
    """Every module of the JAX package, as a path under pyratbay_tpu/."""
    top = os.path.join(REPO, 'pyratbay_tpu')
    return sorted(
        os.path.relpath(os.path.join(root, f), top)
        for root, _, files in os.walk(top) for f in files
        if f.endswith('.py'))


def read_tree(package, path):
    with open(os.path.join(REPO, package, path)) as f:
        return ast.parse(f.read())


def module_all(tree):
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == '__all__'
                for t in node.targets):
            return ast.literal_eval(node.value)
    return None


def keywords(tree):
    """{function or Class.method: its argument names} for the public
    functions and the public methods (and __init__) of public classes."""
    def names(fn):
        a = fn.args
        return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
                if x.arg not in ('self', 'cls')]

    out = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) \
                and not node.name.startswith('_'):
            out[node.name] = names(node)
        if isinstance(node, ast.ClassDef) and not node.name.startswith('_'):
            for meth in node.body:
                if isinstance(meth, ast.FunctionDef) and (
                        not meth.name.startswith('_')
                        or meth.name == '__init__'):
                    out[f'{node.name}.{meth.name}'] = names(meth)
    return out


def port_path(path):
    return MODULE_MAP.get(path, path)


def ported(path):
    return (path, None) not in NOT_PORTED


ALL_MODULES = [p for p in jax_modules()
               if module_all(read_tree('pyratbay_tpu', p)) is not None]
PORTED_MODULES = [p for p in jax_modules() if ported(p) and os.path.exists(
    os.path.join(REPO, 'pyratbay_tpu_torch', port_path(p)))]


@pytest.mark.parametrize('path', ALL_MODULES)
def test_module_all_names_ported(path):
    """Each name of a JAX module's __all__ is in the port module's
    __all__, unless NOT_PORTED names it or its module."""
    names = module_all(read_tree('pyratbay_tpu', path))
    if not ported(path):
        assert not os.path.exists(
            os.path.join(REPO, 'pyratbay_tpu_torch', port_path(path)))
        return
    port = module_all(read_tree('pyratbay_tpu_torch', port_path(path)))
    assert port is not None
    skip = {name for p, name in NOT_PORTED if p == path}
    assert [n for n in names if n not in port and n not in skip] == []


@pytest.mark.parametrize('path', PORTED_MODULES)
def test_keywords_ported(path):
    """The JAX package's keyword names of each public function and
    method are among the port's, apart from RENAMED."""
    jax_kw = keywords(read_tree('pyratbay_tpu', path))
    port_kw = keywords(read_tree('pyratbay_tpu_torch', port_path(path)))
    missing = [(name, arg) for name, args in jax_kw.items()
               if name in port_kw for arg in args
               if arg not in port_kw[name]
               and (path, name, arg) not in RENAMED]
    assert missing == []


@pytest.mark.parametrize('path, name, arg', sorted(RENAMED))
def test_renamed_keywords_differ(path, name, arg):
    """Each deliberate difference is a JAX keyword the port lacks."""
    jax_kw = keywords(read_tree('pyratbay_tpu', path))
    port_kw = keywords(read_tree('pyratbay_tpu_torch', port_path(path)))
    assert arg in jax_kw[name] and arg not in port_kw[name]


def test_console_script_resolves():
    """pyproject.toml names the port's command line beside pbay-tpu."""
    import tomllib
    with open(os.path.join(REPO, 'pyproject.toml'), 'rb') as f:
        scripts = tomllib.load(f)['project']['scripts']
    entry = scripts['pbay-tpu-torch']
    assert entry == 'pyratbay_tpu_torch.__main__:main'
    module, attr = entry.split(':')
    assert callable(getattr(importlib.import_module(module), attr))


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
