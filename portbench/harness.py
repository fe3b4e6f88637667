"""The parts of a run that every cell shares: finding a cell's files by
name, the checks on the card and on the modules loaded, and the result
line.

A cell of BENCHMARK.json names a configuration (portbench/configs/
<config>.json) and a traffic mix (portbench/mixes/<traffic>.json); the
mix names its driver (portbench/drivers/<driver>.py, whose run() makes
the window), the configuration its family (portbench/models/<family>.py,
the program's side and its plain reference), and each per-layer metric
is read by
portbench/metrics/<metric>.py (read(ctx) -> number or None).
"""
import importlib
import importlib.util
import json
import os
import subprocess
import sys

__all__ = ['ROOT', 'manifest', 'cell', 'load_json', 'driver', 'family',
           'reader',
           'forbidden_loaded', 'missing_cards', 'seed_int', 'metrics_of',
           'result_line', 'checks_text']

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, 'portbench')
# Top-level module names that no process of a run may load:
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'pyratbay_tpu')


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def manifest():
    return load_json(ROOT, 'BENCHMARK.json')


def cell(man, name):
    """(workload entry, configuration, mix) of the cell `name`."""
    entries = [w for w in man['workloads'] if w['name'] == name]
    if not entries:
        raise SystemExit(f'No workload {name!r} in BENCHMARK.json')
    work = entries[0]
    config = load_json(HERE, 'configs', f"{work['config']}.json")
    mix = load_json(HERE, 'mixes', f"{work['traffic']}.json")
    return work, config, mix


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(name):
    return _module(os.path.join(HERE, 'drivers', f'{name}.py'),
                   f'portbench_driver_{name}')


def family(config):
    """The program's side of the configuration's family
    (portbench/models/<family>.py): prepare, build, Observed and
    Reference."""
    return importlib.import_module(f"portbench.models.{config['family']}")


def reader(name):
    return _module(os.path.join(HERE, 'metrics', f'{name}.py'),
                   'portbench_metric_' + name.replace('.', '_'))


def forbidden_loaded():
    """The modules loaded whose top-level name is forbidden."""
    return sorted(name for name in list(sys.modules)
                  if name.split('.')[0] in FORBIDDEN)


def missing_cards(chips):
    """Why the cell cannot run here, or None when it can."""
    import torch
    if not torch.cuda.is_available():
        return 'torch.cuda.is_available() is false: no card to measure'
    if torch.cuda.device_count() < chips:
        return (f'the cell needs {chips} cards and torch sees '
                f'{torch.cuda.device_count()}')
    return None


def seed_int(seed, *keys):
    """A non-negative seed for numpy and torch from the run's seed and
    a stream's keys (any whole number, large ones too)."""
    import numpy as np
    seq = np.random.SeedSequence([int(seed) % 2**64, *keys])
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


def metrics_of(man, name, trace):
    """The metric entries a run of the cell reports: the end-to-end ones
    without a trace, the per-layer ones with it."""
    group = man['per_layer'] if trace else man['end_to_end']
    return [m for m in group if name in m.get('workloads', [name])]


def _power_limit():
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=power.limit',
             '--format=csv,noheader,nounits'],
            capture_output=True, text=True, timeout=20).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def result_line(man, work, out, trace):
    """The run's last line (a dict): correct, attempted, failed,
    metrics, device, with a trace the breakdown, and the numbers compared
    last."""
    import torch
    metrics = {}
    for entry in metrics_of(man, work['name'], trace):
        if trace:
            value = reader(entry['name']).read(out['ctx'])
        else:
            value = out['e2e'].get(entry['name'])
        if value is not None:
            metrics[entry['name']] = {'value': value, 'unit': entry['unit']}
    device = {
        'platform': 'gpu',
        'kind': torch.cuda.get_device_name(0),
        'count': work['chips'],
        'memory_peak_bytes': int(out['memory_peak_bytes']),
        'power_limit_w': _power_limit(),
    }
    line = {'correct': bool(out['correct']),
            'attempted': int(out['attempted']),
            'failed': int(out['failed']),
            'metrics': metrics, 'device': device}
    profile = out['ctx'].get('profile') if trace else None
    if profile is not None:
        device['busy_s'] = out.get('busy_s', profile['busy_s'])
        device['window_s'] = profile['window_s']
        line['breakdown'] = {'device_ops': profile['device_ops'],
                             'idle_gaps': profile['idle_gaps']}
    line['checks'] = {c['name']: {'value': c['value'], 'limit': c['limit'],
                                  'pass': c['pass']}
                      for c in out['checks']}
    return line


def checks_text(checks):
    return '\n'.join(f"{c['name']} {c['value']!r} limit {c['pass']} "
                     f"{c['limit']!r}" for c in checks)
