"""Small cuts of the benchmark's configurations and mixes, for tests on
the CPU: the same files, on 161 columns (wnstep 20, no resolution) and a
few chains."""
import copy

from portbench import harness


def config(name='flagship_r115k', **over):
    cfg = copy.deepcopy(harness.load_json(harness.HERE, 'configs',
                                          f'{name}.json'))
    cfg.update(name=f'test_{name}', wnstep=20.0, resolution=None)
    cfg.update(over)
    return cfg


def mix(name, **over):
    out = copy.deepcopy(harness.load_json(harness.HERE, 'mixes',
                                          f'{name}.json'))
    out.update(over)
    return out


def work(name, chips=1):
    return {'name': name, 'chips': chips}
