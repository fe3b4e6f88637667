"""BENCHMARK.json against the contract it is written to, the files the
harness finds by name, and the modules the harness and the reference
import."""
import ast
import os
import re
import subprocess
import sys

import pytest

from portbench import harness

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
MAN = harness.manifest()


def test_manifest_keys_names_and_units():
    assert set(MAN) == {'command', 'paths', 'run_seconds', 'configs',
                        'workloads', 'end_to_end', 'per_layer'}
    assert os.path.getsize(os.path.join(harness.ROOT, 'BENCHMARK.json')) \
        <= 64 * 1024
    assert 1 <= MAN['run_seconds'] <= 51
    names = []
    for entry in MAN['configs'] + MAN['workloads'] + MAN['end_to_end'] \
            + MAN['per_layer']:
        assert NAME.match(entry['name']), entry['name']
        names.append(entry['name'])
    for work in MAN['workloads']:
        assert NAME.match(work['config']) and NAME.match(work['traffic'])
        assert work['chips'] in (1, 4)
        assert 1 <= len(work['why']) <= 200 and '\n' not in work['why']
    for metric in MAN['end_to_end'] + MAN['per_layer']:
        assert UNIT.match(metric['unit']), metric['unit']
        assert metric['better'] in ('lower', 'higher')
    assert len(set(names)) == len(names)
    four = sum(w['chips'] == 4 for w in MAN['workloads'])
    assert four <= max(1, len(MAN['workloads']) // 4)


def test_bounds():
    e2e = {m['name']: m for m in MAN['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s']['bound'] <= 0.25
    for metric in e2e.values():
        assert 0.01 <= metric['bound'] <= 0.25
        assert metric['source'] in ('host_clock', 'device_trace')


def _reports(cell):
    return {m['name'] for m in MAN['end_to_end']
            if cell in m.get('workloads', [cell])}


def test_each_per_layer_metric_moves_what_its_cells_report():
    cells = {w['name'] for w in MAN['workloads']}
    layers = {}
    for metric in MAN['per_layer']:
        assert metric['moves'] in {m['name'] for m in MAN['end_to_end']}
        for cell in metric.get('workloads', cells):
            assert cell in cells
            assert metric['moves'] in _reports(cell), (metric['name'], cell)
        layers.setdefault(metric['layer'], []).append(metric['name'])
    for cell in cells:
        assert 'setup_s' in _reports(cell) and len(_reports(cell)) >= 2
        assert harness.metrics_of(MAN, cell, True)


def test_each_cell_finds_its_files():
    for entry in MAN['configs']:
        assert entry['file'].startswith('portbench/')
        config = harness.load_json(harness.ROOT, entry['file'])
        assert config['name'] == entry['name']
        assert config['reduced'] == entry['reduced']
    for work in MAN['workloads']:
        _, config, mix = harness.cell(MAN, work['name'])
        assert os.path.isfile(os.path.join(
            harness.HERE, 'drivers', f"{mix['driver']}.py"))
        family = harness.family(config)
        assert all(hasattr(family, n) for n in
                   ('prepare', 'build', 'Observed', 'Reference'))
        assert os.path.isfile(os.path.join(
            harness.HERE, 'limits', f"{work['name']}.json"))
    for metric in MAN['per_layer']:
        assert hasattr(harness.reader(metric['name']), 'read')


def test_each_cell_names_its_kernels_and_work_in_data():
    """The kernels a traced run must record, and the terms of the work
    counts.py counts, come from the cell's configuration (under the
    role its mix names), not from the code."""
    peaks = harness.load_json(harness.HERE, 'peaks.json')
    for work in MAN['workloads']:
        _, config, mix = harness.cell(MAN, work['name'])
        names = config['kernels'][mix['kernel']]
        assert names and all(NAME.match(n) for n in names)
        assert config['work']['peak'] in peaks
        assert {'ls_species', 'ls_temps', 'cia_tables', 'cia_temps',
                'rank1', 'dense_parts'} <= set(config['work'])


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(*parts):
    for base, _, files in os.walk(os.path.join(harness.HERE, *parts)):
        for name in files:
            if name.endswith('.py'):
                yield os.path.join(base, name)


@pytest.mark.parametrize('path', sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, harness.HERE))
def test_no_jax_and_no_jax_package(path):
    tops = {name.split('.')[0] for name in _imports(path)}
    assert not tops & set(harness.FORBIDDEN), tops


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources('reference'):
        tops = {name.split('.')[0] for name in _imports(path)}
        assert tops <= {'numpy', 'scipy', 'os', 'hashlib', 'json'}, (
            path, tops)


def test_a_run_without_the_card_fails():
    """Without CUDA (here, or with no visible device) a run exits with
    another code than 0 and prints no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    proc = subprocess.run(
        [sys.executable, os.path.join(harness.HERE, 'run.py'),
         '--workload', MAN['workloads'][0]['name'], '--seed', '3',
         '--seconds', '1', '--trace', '0'],
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode != 0
    assert not any(line.startswith('{')
                   for line in proc.stdout.splitlines())
