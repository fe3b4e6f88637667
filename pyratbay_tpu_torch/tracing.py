"""Spans and counters of pyratbay_tpu_torch: one recorder for the package.

A span records its name, its parent (the span open around it), the
generation or call it belongs to (`gen`), and the host clock at its two
ends (time.perf_counter_ns).  While CUDA is initialized it also records
a device mark at each end: a CUDA timing event recorded on the current
stream, taken from a pool and never synchronized while the program runs.
`resolve()` maps the marks onto the host clock with one calibration:
after a synchronize it records an event and reads the host clock, so
each mark gets the host time at which the stream reached it, and host
spans and device progress sit on one clock.  A counter is an integer
kept per innermost open span.

When a span records:

* hot-path spans only while torch.profiler is recording, or when
  PBT_TRACE=<file.json> was set before the process started.  While a
  profiler is active each span also enters record_function under its
  name, so the program's stages sit in the profiler's own trace, on the
  device trace's clock.  Off, a span is one flag check: span() hands
  back one shared no-op context, with no allocation, no CUDA event and
  no record_function;
* set-up spans (`pbt.setup.*`) always, and the record keeps them;
* Model.run's stages always; the record keeps them while it records
  hot-path spans, and Model.run reads them itself.

Spans (all `pbt.*`; each line: the module, the spans):

* __init__.py: pbt.setup.import, the package's own import;
* model.py Model: pbt.setup.model, with children pbt.setup.spectrum,
  pbt.setup.atmosphere and pbt.setup.opacity (the star, the opacity
  models, the quadrature and the tables' copy to the device), whose host
  seconds are Model.timestamps' set-up keys;
* spectrum/transit_kernel.py: pbt.setup.kernel_library, the CUDA kernel
  library's build (nvcc) or load (ctypes);
* retrieval/batched.py: pbt.setup.first_forward, the first call of each
  built batched forward, host entry to its device end mark;
* retrieval/samplers.py: pbt.demc.run, one a sample_demc call (its
  initial log-posterior, gen -1 of a fresh run, and every chunk), with
  children pbt.demc.chunk (gen: the chunk's first generation; counter
  pbt.demc.generations: its generations), whose children are
  pbt.demc.draws, pbt.demc.propose, pbt.demc.accept, pbt.demc.history
  (the record's stacks and their copies to the host) and
  pbt.demc.checkpoint; each generation's spans carry its gen;
* retrieval/batched.py: pbt.log_post, with children pbt.forward and
  pbt.log_post.likelihood; pbt.forward with children pbt.forward.state
  (children pbt.state.tp, pbt.state.vmr, pbt.state.radius),
  pbt.forward.opacity (the assembly, and fit_operands before each RT
  launch), pbt.forward.rt (the K1 or K3 launch and its preparation) and
  pbt.forward.bands (the band integration and the high-res stage);
* model.py Model._equilibrium_vmr: pbt.state.chem (inside
  pbt.state.vmr), the equilibrium solve of a batched forward (on the card
  one launch of csrc/chem_gibbs.cu), read by portbench's
  chem_device_ms.eq (its device marks) and chem_launches_per_forward.eq
  (the device launches inside it, from the profiler's trace);
* parallel/sharded.py: pbt.mesh.all_sum, each collective of a Mesh;
* model.py Model.run: pbt.run.atmosphere, pbt.run.extinction and
  pbt.run.spectrum, from whose device marks (host times on the CPU)
  Model.timestamps' run keys are filled.

Counters:

* pbt.host_waits (HOST_WAITS): each place where the program makes the
  host wait for the device: copies to the host, reads of a device
  tensor's value (to_host), copies of host data to the device, explicit
  synchronizes (synchronize), and a gloo collective of CUDA tensors;
* pbt.demc.generations: the generations of a pbt.demc.chunk;
* pbt.forward.calls: one for each pbt.forward;
* pbt.chem.systems: the [chain, layer] systems a pbt.state.chem solves
  (portbench's chem_launches_per_forward.eq counts its spans by it);
* pbt.mesh.calls and pbt.mesh.host_syncs: Mesh.calls and
  Mesh.host_syncs, counted into the span that makes the collective.

The exporter: with PBT_TRACE set, the process writes at its exit one
chrome-trace JSON file (chrome://tracing, Perfetto): {"traceEvents":
[...], "displayTimeUnit": "ms"}, times in microseconds of the host
clock; pid the rank; host spans on tid 0 as complete events ("ph": "X")
whose args hold id, parent (an id or null), gen and the span's counts;
each span's device marks on tid 1 under the same name and id; and the
counters as counter events ("ph": "C", running totals at each span's
end).  A rank of a process group of several writes <stem>.rank<r>.json.
"""
import atexit
import contextlib
import json
import os
import time

import torch
import torch.autograd.profiler as _profiler

__all__ = ['HOST_WAITS', 'Span', 'Recorder', 'RECORDER', 'span', 'count',
           'to_host', 'synchronize', 'resolve', 'first_call']

HOST_WAITS = 'pbt.host_waits'
_SETUP = 'pbt.setup.'


# The context of every span that records nothing:
_OFF = contextlib.nullcontext()


class Span:
    """One span of the record: name, parent (a Span or None), gen, host
    ends t0 and t1 and device marks d0 and d1 (ns of the host clock; the
    marks None off the card, or until resolve()), and counts
    ({counter: n}).  A context manager: entering opens it."""

    __slots__ = ('name', 'parent', 'gen', 't0', 't1', 'd0', 'd1', 'counts',
                 '_rec', '_keep', '_events', '_stream', '_annotation')

    def __init__(self, rec, name, gen, keep):
        self.name, self.gen = name, gen
        self.parent = self.t1 = self.d0 = self.d1 = None
        self.counts = {}
        self._rec, self._keep = rec, keep
        self._events = self._stream = self._annotation = None

    def __enter__(self):
        rec = self._rec
        self.parent = rec.stack[-1] if rec.stack else None
        if self.gen is None:
            self.gen = rec.gen
        else:
            rec.gen = self.gen
        rec.stack.append(self)
        if self._keep:
            rec.spans.append(self)
        self.t0 = time.perf_counter_ns()
        if _profiler._is_profiler_enabled:
            self._annotation = _profiler.record_function(self.name)
            self._annotation.__enter__()
        if torch.cuda.is_initialized():
            self._stream = rec._current_stream()
            self._events = [rec._event()]
            self._events[0].record(self._stream)
        return self

    def __exit__(self, *exc):
        rec = self._rec
        if self._events is not None:
            self._events.append(rec._event())
            self._events[1].record(self._stream)
            self._stream = None
            if self._keep:
                rec.pending.append(self)
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        self.t1 = time.perf_counter_ns()
        rec.stack.pop()
        return False

    @property
    def end(self):
        """The device end mark, or the host end where there is none."""
        return self.t1 if self.d1 is None else self.d1


class Recorder:
    """The spans and counters of a process (RECORDER).  path: the
    chrome-trace file written at exit (PBT_TRACE), or None; rank: this
    process's rank in a process group of several, or None."""

    def __init__(self, path=None):
        self.path = path
        self.rank = None
        self.spans = []
        self.stack = []
        self.pending = []
        self.gen = None
        self._pool = []
        self._stream = (None, None)

    def recording(self):
        """Whether hot-path spans record now."""
        return self.path is not None or _profiler._is_profiler_enabled

    def span(self, name, gen=None, always=False):
        """The context of span `name`: recorded while recording() (or
        always, for set-up spans and Model.run's stages); gen: its
        generation or call, by default its parent's last given one."""
        if self.path is None and not _profiler._is_profiler_enabled:
            if not always:
                return _OFF
            return Span(self, name, gen, name.startswith(_SETUP))
        return Span(self, name, gen, True)

    def count(self, name, n=1):
        """Add n to counter `name` of the innermost open span."""
        if self.stack:
            counts = self.stack[-1].counts
            counts[name] = counts.get(name, 0) + n

    def _current_stream(self):
        # torch.cuda.current_stream() builds a Stream on each call (~5 us
        # on an H100's host); the current stream's ids are read in ~0.3.
        ids = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
        if ids != self._stream[0]:
            self._stream = (ids, torch.cuda.Stream(
                stream_id=ids[0], device_index=ids[1], device_type=ids[2]))
        return self._stream[1]

    def _event(self):
        return self._pool.pop() if self._pool \
            else torch.cuda.Event(enable_timing=True)

    def resolve(self, spans=None):
        """Give the device marks of `spans` (default: every span kept
        whose marks are not resolved yet) their host times, and return
        their events to the pool.  Synchronizes the device once: call it
        where the program waits for the device anyway, or after it."""
        todo = self.pending if spans is None else spans
        todo = [s for s in todo if s._events is not None
                and len(s._events) == 2]
        if spans is None:
            self.pending = []
        if not todo:
            return
        torch.cuda.synchronize()
        ref = self._event()
        before = time.perf_counter_ns()
        ref.record()
        ref.synchronize()
        t_ref = (before + time.perf_counter_ns()) // 2
        for s in todo:
            start, end = s._events
            s.d0 = t_ref - round(start.elapsed_time(ref) * 1e6)
            s.d1 = t_ref - round(end.elapsed_time(ref) * 1e6)
            self._pool.extend(s._events)
            s._events = None
        self._pool.append(ref)

    def chrome_trace(self):
        """The record as a chrome-trace dict (the module's format)."""
        self.resolve()
        pid = 0 if self.rank is None else self.rank
        ids = {id(s): i for i, s in enumerate(self.spans)}
        events = [
            {'name': 'process_name', 'ph': 'M', 'pid': pid,
             'args': {'name': f'pyratbay_tpu_torch rank {pid}'}},
            {'name': 'thread_name', 'ph': 'M', 'pid': pid, 'tid': 0,
             'args': {'name': 'host'}},
            {'name': 'thread_name', 'ph': 'M', 'pid': pid, 'tid': 1,
             'args': {'name': 'device'}}]
        totals = {}
        for i, s in enumerate(self.spans):
            if s.t1 is None:
                continue
            args = {'id': i, 'parent': ids.get(id(s.parent)), 'gen': s.gen,
                    **s.counts}
            events.append({'name': s.name, 'ph': 'X', 'pid': pid, 'tid': 0,
                           'ts': s.t0 / 1e3, 'dur': (s.t1 - s.t0) / 1e3,
                           'args': args})
            if s.d1 is not None:
                events.append({'name': s.name, 'ph': 'X', 'pid': pid,
                               'tid': 1, 'ts': s.d0 / 1e3,
                               'dur': (s.d1 - s.d0) / 1e3,
                               'args': {'id': i}})
            for name, n in s.counts.items():
                totals[name] = totals.get(name, 0) + n
                events.append({'name': name, 'ph': 'C', 'pid': pid,
                               'ts': s.t1 / 1e3,
                               'args': {'total': totals[name]}})
        return {'traceEvents': events, 'displayTimeUnit': 'ms'}

    def export(self):
        """Write the chrome trace to `path` (the rank's file in a
        process group of several)."""
        if torch.distributed.is_available() \
                and torch.distributed.is_initialized() \
                and torch.distributed.get_world_size() > 1:
            self.rank = torch.distributed.get_rank()
        path = self.path
        if self.rank is not None:
            stem, ext = os.path.splitext(path)
            path = f'{stem}.rank{self.rank}{ext or ".json"}'
        with open(path, 'w') as f:
            json.dump(self.chrome_trace(), f)


RECORDER = Recorder(os.environ.get('PBT_TRACE') or None)
if RECORDER.path is not None:
    atexit.register(RECORDER.export)

span = RECORDER.span
count = RECORDER.count
resolve = RECORDER.resolve


def to_host(x):
    """x copied to the host (x.cpu()): the one road by which the program
    reads a device tensor (.numpy(), .tolist(), float(), bool() of the
    copy), counted as a host wait in the innermost open span."""
    RECORDER.count(HOST_WAITS)
    return x.cpu()


def synchronize(device=None):
    """torch.cuda.synchronize(device), counted as a host wait."""
    RECORDER.count(HOST_WAITS)
    torch.cuda.synchronize(device)


def first_call(name, fn):
    """fn, with its first call recorded as the set-up span `name`."""
    called = False

    def wrapped(*args, **kw):
        nonlocal called
        if called:
            return fn(*args, **kw)
        called = True
        with span(name, always=True):
            return fn(*args, **kw)

    return wrapped
