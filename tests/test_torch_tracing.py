"""The port's recorder of spans and counters (pyratbay_tpu_torch/
tracing.py), on the CPU:

* off, a span is the one shared no-op context: nothing recorded, no
  record_function entered, no CUDA event made;
* while a CPU torch.profiler records, the spans are user_annotation
  events of the profiler's trace, nested as they were opened;
* with PBT_TRACE set, a process writes at its exit a chrome trace that
  holds the spans with their parents, generations and counts, and a
  rank of a group of several writes its own file;
* a sample_demc call of two chunks on the flagship (11 layers) records
  one pbt.demc.run, two pbt.demc.chunk spans with their generations, and
  one pbt.forward a generation plus the initial one, each with its
  generation;
* pbt.host_waits counts a copy to the host in the span that makes it,
  and a Mesh's collective counts into pbt.mesh.all_sum;
* resolve() puts device marks on the host clock (CUDA events stubbed
  by host-clock ones);
* Model.run keeps Model.timestamps' keys and, off, leaves no span in the
  record.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import torch.autograd.profiler as autograd_profiler  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from pyratbay_tpu_torch import tracing  # noqa: E402
from pyratbay_tpu_torch.benchmark import make_flagship  # noqa: E402
from pyratbay_tpu_torch.parallel import sharded  # noqa: E402
from pyratbay_tpu_torch.parallel.mp_probe import free_port  # noqa: E402
from pyratbay_tpu_torch.retrieval.batched import (  # noqa: E402
    build_log_posterior_batched)
from pyratbay_tpu_torch.retrieval.samplers import sample_demc  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REC = tracing.RECORDER
RUN_KEYS = ('setup spectrum', 'setup atmosphere', 'setup opacity',
            'atmosphere', 'extinction', 'spectrum')
NCHAINS = 8


@pytest.fixture(scope='module')
def flagship(tmp_path_factory):
    """The flagship on 11 layers and 201 columns, on the CPU, with its
    own forward's band fluxes as data, and its batched log-posterior."""
    model, obs, ret, forward, p0 = make_flagship(
        str(tmp_path_factory.mktemp('flagship')), nlayers=11, wnstep=16.0,
        device='cpu')
    bandflux = forward(p0)['bandflux'].numpy()
    obs.data = bandflux
    obs.uncert = 0.03 * np.abs(bandflux) + 1e-12
    return model, obs, ret, build_log_posterior_batched(model, obs, ret)


def _demc(ret, log_post, ngen=4, chunk_gens=2):
    with torch.no_grad():
        return sample_demc(
            log_post, ret.params, nsamples=NCHAINS * ngen, nchains=NCHAINS,
            chunk_gens=chunk_gens, pstep=ret.pstep, pmin=ret.pmin,
            pmax=ret.pmax, device='cpu')


def _since(n0, name=None):
    return [s for s in REC.spans[n0:] if name is None or s.name == name]


def _descends(span, ancestor):
    while span is not None:
        if span is ancestor:
            return True
        span = span.parent
    return False


def test_off_span_is_one_shared_noop(monkeypatch):
    """Off, span() hands back one shared context: no Span is made, no
    record_function entered, no CUDA event made, nothing counted."""
    assert not REC.recording()

    def refuse(*args, **kw):
        raise AssertionError('made while tracing is off')

    monkeypatch.setattr(autograd_profiler, 'record_function', refuse)
    monkeypatch.setattr(torch.cuda, 'Event', refuse)
    monkeypatch.setattr(torch.cuda, 'is_initialized', lambda: True)
    n0, gen = len(REC.spans), REC.gen
    first = tracing.span('pbt.forward')
    assert tracing.span('pbt.demc.draws', gen=3) is first
    with first as opened:
        assert opened is None
        tracing.count('pbt.forward.calls')
        assert REC.stack == []
    assert len(REC.spans) == n0 and REC.gen == gen


def test_demc_off_records_only_setup(flagship):
    _, _, ret, log_post = flagship
    n0 = len(REC.spans)
    _demc(ret, log_post)
    assert all(s.name.startswith('pbt.setup.') for s in _since(n0))


def test_profiler_sees_spans_nested(tmp_path):
    """Under a CPU profiler each span is a user_annotation event of the
    trace, inside its parent's."""
    n0 = len(REC.spans)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert REC.recording()
        with tracing.span('pbt.demc.chunk', gen=4):
            with tracing.span('pbt.demc.draws'):
                torch.ones(3).sum()
            with tracing.span('pbt.log_post'):
                with tracing.span('pbt.forward'):
                    torch.ones(3) * 2
    assert not REC.recording()
    spans = _since(n0)
    assert [s.name for s in spans] == [
        'pbt.demc.chunk', 'pbt.demc.draws', 'pbt.log_post', 'pbt.forward']
    chunk, draws, log_post, forward = spans
    assert draws.parent is chunk and log_post.parent is chunk
    assert forward.parent is log_post
    assert all(s.gen == 4 for s in spans)
    assert all(s.t0 <= s.t1 for s in spans)
    path = str(tmp_path / 'profile.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)['traceEvents']
                  if e.get('cat') == 'user_annotation'
                  and e['name'].startswith('pbt.')]
    by_name = {e['name']: (e['ts'], e['ts'] + e['dur']) for e in events}
    assert set(by_name) == {s.name for s in spans}

    def inside(child, parent):
        return by_name[parent][0] <= by_name[child][0] \
            and by_name[child][1] <= by_name[parent][1]

    assert inside('pbt.demc.draws', 'pbt.demc.chunk')
    assert inside('pbt.log_post', 'pbt.demc.chunk')
    assert inside('pbt.forward', 'pbt.log_post')
    assert not inside('pbt.forward', 'pbt.demc.draws')


def test_pbt_trace_writes_chrome_trace_at_exit(tmp_path):
    """PBT_TRACE: the process's spans, parents, gens and counts, in the
    chrome-trace file written at its exit."""
    path = tmp_path / 'trace.json'
    code = (
        'from pyratbay_tpu_torch import tracing\n'
        'assert tracing.RECORDER.recording()\n'
        'with tracing.span("pbt.demc.chunk", gen=2):\n'
        '    tracing.count("pbt.demc.generations", 2)\n'
        '    for g in (2, 3):\n'
        '        with tracing.span("pbt.demc.draws", gen=g):\n'
        '            pass\n'
        '        with tracing.span("pbt.demc.history"):\n'
        '            tracing.to_host(tracing.torch.ones(2))\n')
    env = dict(os.environ, PBT_TRACE=str(path), PYTHONPATH=ROOT)
    subprocess.run([sys.executable, '-c', code], env=env, check=True,
                   timeout=120)
    with open(path) as f:
        trace = json.load(f)
    spans = [e for e in trace['traceEvents'] if e['ph'] == 'X']
    assert all(e['tid'] == 0 for e in spans)     # no device marks here
    names = [e['name'] for e in spans]
    assert names[0] == 'pbt.setup.import'
    assert names[1:] == ['pbt.demc.chunk', 'pbt.demc.draws',
                         'pbt.demc.history', 'pbt.demc.draws',
                         'pbt.demc.history']
    chunk = spans[1]['args']
    assert chunk['gen'] == 2 and chunk['parent'] is None
    assert chunk['pbt.demc.generations'] == 2
    assert [e['args']['gen'] for e in spans[2:]] == [2, 2, 3, 3]
    assert all(e['args']['parent'] == chunk['id'] for e in spans[2:])
    assert [e['args'].get(tracing.HOST_WAITS) for e in spans[2:]] == [
        None, 1, None, 1]
    waits = [e['args']['total'] for e in trace['traceEvents']
             if e['ph'] == 'C' and e['name'] == tracing.HOST_WAITS]
    assert waits == [1, 2]
    assert all(e['ts'] >= 0 and e['dur'] >= 0 for e in spans)


def test_rank_writes_its_own_file(tmp_path):
    """A rank of a group of several writes <stem>.rank<r>.json, its
    events under pid r."""
    rec = tracing.Recorder(path=str(tmp_path / 'trace.json'))
    rec.rank = 3
    with rec.span('pbt.mesh.all_sum', gen=0):
        rec.count('pbt.mesh.calls')
    rec.export()
    assert not (tmp_path / 'trace.json').exists()
    with open(tmp_path / 'trace.rank3.json') as f:
        events = json.load(f)['traceEvents']
    span, = [e for e in events if e['ph'] == 'X']
    assert span['pid'] == 3 and span['name'] == 'pbt.mesh.all_sum'
    assert span['args']['pbt.mesh.calls'] == 1


def test_demc_two_chunks_spans_and_counters(flagship):
    """One pbt.demc.run, two chunks of two generations, one pbt.forward
    a generation and the initial one, the history copies counted as
    host waits."""
    _, _, ret, log_post = flagship
    n0 = len(REC.spans)
    with profile(activities=[ProfilerActivity.CPU]):
        _demc(ret, log_post, ngen=4, chunk_gens=2)
    run, = _since(n0, 'pbt.demc.run')
    inside = [s for s in _since(n0) if _descends(s.parent, run)]
    chunks = [s for s in inside if s.name == 'pbt.demc.chunk']
    assert [c.gen for c in chunks] == [0, 2]
    assert [c.parent for c in chunks] == [run, run]
    assert [c.counts['pbt.demc.generations'] for c in chunks] == [2, 2]
    forwards = [s for s in inside if s.name == 'pbt.forward']
    assert [f.gen for f in forwards] == [-1, 0, 1, 2, 3]
    assert [f.counts['pbt.forward.calls'] for f in forwards] == [1] * 5
    assert forwards[0].parent.name == 'pbt.log_post'
    assert forwards[0].parent.parent is run
    for chunk in chunks:
        kids = [s.name for s in inside if s.parent is chunk]
        assert kids == ['pbt.demc.draws', 'pbt.demc.propose',
                        'pbt.log_post', 'pbt.demc.accept'] * 2 \
            + ['pbt.demc.history']
    assert {s.name for s in inside if s.parent is not None
            and s.parent.name == 'pbt.forward'} == {
        'pbt.forward.state', 'pbt.forward.opacity', 'pbt.forward.rt',
        'pbt.forward.bands'}
    assert {s.name for s in inside if s.parent is not None
            and s.parent.name == 'pbt.forward.state'} == {
        'pbt.state.tp', 'pbt.state.vmr', 'pbt.state.radius'}
    history = [s for s in inside if s.name == 'pbt.demc.history']
    assert [s.counts[tracing.HOST_WAITS] for s in history] == [3, 3]


def test_host_wait_counted_in_its_span():
    n0 = len(REC.spans)
    x = torch.arange(4.0)
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span('pbt.demc.chunk', gen=0):
            with tracing.span('pbt.demc.history'):
                host = tracing.to_host(x)
                tracing.to_host(x).tolist()
            float(tracing.to_host(x.sum()))
    chunk, history = _since(n0)
    assert host.equal(x)
    assert history.counts == {tracing.HOST_WAITS: 2}
    assert chunk.counts == {tracing.HOST_WAITS: 1}
    # Off, nothing is open to count into:
    tracing.to_host(x)
    assert chunk.counts == {tracing.HOST_WAITS: 1}


def test_mesh_collective_counts_into_its_span():
    """A collective over a group of one gloo rank: Mesh.calls and the
    span pbt.mesh.all_sum with pbt.mesh.calls."""
    dist.init_process_group('gloo', init_method=f'tcp://localhost:'
                            f'{free_port()}', world_size=1, rank=0)
    try:
        mesh = sharded.Mesh((1, 1))
        mesh.groups['wave'] = dist.group.WORLD
        n0 = len(REC.spans)
        x = torch.arange(3.0)
        with profile(activities=[ProfilerActivity.CPU]):
            assert mesh.all_sum(x, 'wave').equal(torch.arange(3.0))
        span, = _since(n0)
    finally:
        dist.destroy_process_group()
    assert span.name == 'pbt.mesh.all_sum'
    assert span.counts == {'pbt.mesh.calls': 1}
    assert mesh.calls == 1 and mesh.host_syncs == 0
    assert not hasattr(mesh, 'timed') and not hasattr(mesh, 'seconds')


class _HostEvent:
    """A CUDA event stand-in whose stream reaches it when it is
    recorded, 5 ms after the host call."""
    LAG_NS = 5_000_000

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter_ns() + self.LAG_NS

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e-6


def test_resolve_puts_device_marks_on_the_host_clock(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_initialized', lambda: True)
    monkeypatch.setattr(torch.cuda, 'Event', _HostEvent)
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda device=None: None)
    monkeypatch.setattr(tracing.Recorder, '_current_stream',
                        lambda self: None)
    rec = tracing.Recorder()
    with profile(activities=[ProfilerActivity.CPU]):
        with rec.span('pbt.forward', gen=0) as outer:
            with rec.span('pbt.forward.rt') as inner:
                time.sleep(0.002)
    assert outer.d0 is None and len(rec.pending) == 2
    rec.resolve()
    assert rec.pending == [] and len(rec._pool) == 5
    for s in (outer, inner):
        # The stand-in's stream reaches each mark 5 ms after the host
        # recorded it: the calibration's own event has the same lag.
        assert abs(s.d0 - s.t0) < 1_000_000
        assert abs(s.d1 - s.t1) < 1_000_000
        assert s.end == s.d1
    assert inner.d1 - inner.d0 >= 2_000_000
    trace = rec.chrome_trace()['traceEvents']
    device = [e for e in trace if e['ph'] == 'X' and e['tid'] == 1]
    assert [e['name'] for e in device] == ['pbt.forward', 'pbt.forward.rt']
    # A second span takes its events from the pool:
    with profile(activities=[ProfilerActivity.CPU]):
        with rec.span('pbt.forward'):
            pass
    assert len(rec._pool) == 3


def test_model_run_timestamps_keep_their_keys(flagship):
    model = flagship[0]
    n0 = len(REC.spans)
    model.run()
    assert tuple(model.timestamps) == RUN_KEYS
    assert all(v >= 0 for v in model.timestamps.values())
    # Off, Model.run reads its own stages and the record keeps none:
    assert len(REC.spans) == n0
    with profile(activities=[ProfilerActivity.CPU]):
        model.run()
    assert [s.name for s in _since(n0) if s.name.startswith('pbt.run.')] \
        == ['pbt.run.atmosphere', 'pbt.run.extinction', 'pbt.run.spectrum']


def test_setup_spans_always_recorded(flagship):
    """The package's import, the Model's set-up and its children, and
    the batched forward's first call, recorded with tracing off."""
    names = [s.name for s in REC.spans]
    assert names[0] == 'pbt.setup.import'
    assert {'pbt.setup.model', 'pbt.setup.spectrum',
            'pbt.setup.atmosphere', 'pbt.setup.opacity',
            'pbt.setup.first_forward'} <= set(names)
    model = [s for s in REC.spans if s.name == 'pbt.setup.model'][-1]
    kids = [s.name for s in REC.spans if s.parent is model]
    assert kids == ['pbt.setup.spectrum', 'pbt.setup.atmosphere',
                    'pbt.setup.opacity']
    _, obs, ret, _ = flagship
    log_post = build_log_posterior_batched(flagship[0], obs, ret)
    n0 = len(REC.spans)
    params = torch.as_tensor(np.tile(ret.params, (2, 1)))
    with torch.no_grad():
        log_post(params)
        log_post(params)
    first, = _since(n0)
    assert first.name == 'pbt.setup.first_forward'
    assert first.counts == {'pbt.forward.calls': 1}
