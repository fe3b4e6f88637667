"""The work counts of portbench/counts.py: the roofline bound of K1 at
B = 512 at the flagship's widths (PERF.md: 0.090 and 1.405 ms by the
operations), and counts that come from the configuration's shapes, not
from the operands of any implementation."""
import ast
import os

import numpy as np
import pytest
import torch

from portbench import counts, harness
from portbench.reference import inputs
from portbench.tests import small


@pytest.mark.parametrize('grid, nwave, k1_ms', [
    ({'wnstep': 1.0, 'resolution': None}, 3209, 0.090),
    ({'resolution': 115000.0}, 50062, 1.405)],
    ids=['wnstep1', 'R115k'])
def test_bounds_at_the_flagship_widths(grid, nwave, k1_ms):
    """The flagship configuration on its 1 cm-1 grid (51 x 3,209) and on
    its own R = 115,000 grid (51 x 50,062)."""
    config = small.config('flagship_r115k', **grid)
    assert len(inputs.wavenumbers(config)) == nwave
    shape = counts.shape_of(config, nwave, 512)
    bound, by = counts.bound_ms(*counts.transit_work(shape), shape['peak'])
    assert by == 'operations'
    assert bound == pytest.approx(k1_ms, rel=0.01)


def test_counts_import_nothing_of_the_program():
    path = os.path.join(harness.HERE, 'counts.py')
    tree = ast.parse(open(path).read())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module or '' for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert not any(n.split('.')[0].startswith('pyratbay') for n in names)


def test_shapes_are_the_operands_before_any_layout(tmp_path):
    """The shapes counts.py takes are the program's operands as the
    forward assembles them, before the kernel wrapper pads or lays them
    out: the same count whatever the layout."""
    from pyratbay_tpu_torch.retrieval.batched import (
        assemble_opacity, line_sample_table)
    from portbench.models import flagship as fm
    config = small.config()
    paths = inputs.write_inputs(config, str(tmp_path))
    model, obs, ret = fm.build(config, paths,
                               fm.Observed(config, paths, 1), 'cpu')
    st = fm_state(model, ret, 4)
    ls_tab = line_sample_table(model)
    ops = assemble_opacity(model, st['temp'], st['dens'], st['radius'],
                           st['pars_list'], ls_tab)
    shape = counts.shape_of(config, model.nwave, 4)
    assert ls_tab.shape == (shape['ls_species'] * shape['ls_temps'],
                            shape['nlayers'], shape['nwave'])
    assert len(ops['ls_ws']) == shape['ls_species']
    assert len(ops['cia_tabs']) == shape['cia_tables']
    assert ops['cia_tabs'][0].shape == (shape['cia_temps'], shape['nwave'])
    assert len(ops['r1_rows']) == shape['rank1']
    assert len(ops['parts']) == shape['dense_parts']
    # Two-hot weights: two a layer of each table.
    nz = sum(int(torch.count_nonzero(w)) for w in ops['ls_ws'] + ops['cia_ws'])
    assert nz <= 4 * 2 * shape['nlayers'] * (shape['ls_species']
                                             + shape['cia_tables'])


def fm_state(model, ret, n):
    from pyratbay_tpu_torch.retrieval.forward import build_state
    rng = np.random.default_rng(0)
    p = ret.params + ret.pstep * rng.standard_normal((n, len(ret.params)))
    return build_state(model, ret)(torch.as_tensor(
        np.clip(p, ret.pmin, ret.pmax)))


@pytest.mark.parametrize('listed, recorded, found', [
    (['transit_rt_kernel'], 'void transit_rt_kernel<16>(Args)', True),
    (['transit_rt_kernel'], 'void transit_rt_tall_kernel<4>(Args)', False),
    (['transit_rt_tall_kernel'], 'void transit_rt_tall_kernel<4>(Args)',
     True)])
def test_roofline_reads_the_kernels_the_configuration_names(
        listed, recorded, found):
    """K1's share is read from the kernels the configuration lists under
    its role, at the peak its work names: a configuration whose K1 is
    another kernel brings that kernel's name and peak as data."""
    from portbench import readers
    config = dict(harness.load_json(harness.HERE, 'configs',
                                    'flagship_r115k.json'))
    config['kernels'] = dict(config['kernels'], ensemble=listed)
    shape = counts.shape_of(config, 50062, 512)
    profile = {'kernels': {recorded: (10, 10 * 12500.0),
                           'elementwise_kernel': (50, 50.0)}}
    share = readers.k1_roofline_share(
        {'config': config, 'shape': shape, 'profile': profile})
    if not found:
        assert share is None
        return
    bound, _ = counts.bound_ms(*counts.transit_work(shape), shape['peak'])
    assert share == pytest.approx(100.0 * bound / 12.5)
    config['work'] = dict(config['work'], peak='tf32_flops_per_s')
    tf32 = readers.k1_roofline_share(
        {'config': config, 'shape': counts.shape_of(config, 50062, 512),
         'profile': profile})
    assert tf32 < share
