"""Spans and the device trace of a run, reduced to plain numbers.

`Spans` times the calls the benchmark makes into a layer: the host clock
around each (ending in a synchronize of the card), CUDA events inside.
`profiled` runs a phase under torch.profiler and reduces its trace to
the device's busy time in the phase's window (the union of the device
intervals), each kernel's launches and device time, the device launches
made inside each annotated call, and the idle gaps named by the host
operation that launched the work after them.  A kernel's time is over
the launches the trace recorded of it (pyratbay_tpu_torch's chip_smoke
kernel_device_ms); a trace that recorded fewer launches of a kernel
than the calls made is retried and then refused.
"""
import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

__all__ = ['Spans', 'profiled', 'reduce_trace', 'kernel_ms', 'roofline_share',
           'WINDOW']

WINDOW = 'portbench.window'
_DEVICE = ('kernel', 'gpu_memcpy', 'gpu_memset')


class Spans:
    """Host-clock spans around the calls into one layer: each call's
    seconds (ending in a synchronize) and, on the card, its CUDA-event
    milliseconds."""

    def __init__(self, fn, device):
        import torch
        self.fn = fn
        self.cuda = device.type == 'cuda'
        self.torch = torch
        self.host_s = []
        self._events = []

    def __call__(self, *args, **kw):
        torch = self.torch
        t0 = time.perf_counter()
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        out = self.fn(*args, **kw)
        if self.cuda:
            end.record()
            torch.cuda.synchronize()
            self._events.append((start, end))
        self.host_s.append(time.perf_counter() - t0)
        return out

    def event_ms(self):
        return [s.elapsed_time(e) for s, e in self._events]


def profiled(phase, annotation, kernels, calls, tries=3):
    """Run phase(annotate) under torch.profiler, where annotate(name) is
    a context manager around each call into the measured layer, and
    reduce the trace (reduce_trace).  `kernels` lists the names of the
    kernel launched once a call (the configuration's, for the mix's
    kernel role): a trace in which they were recorded fewer than
    `calls` times is taken again, up to `tries` times, then refused."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    last = None
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                phase(record_function)
                torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix='.json')
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)['traceEvents']
        finally:
            os.remove(path)
        last = reduce_trace(events, annotation)
        timed = kernel_ms(last, kernels)
        recorded = timed[1] if timed else 0
        last['recorded'] = recorded
        last['calls'] = calls
        if recorded >= calls:
            return last
    raise RuntimeError(
        f'torch.profiler recorded {last["recorded"]} launches of {kernels} '
        f'for {calls} calls in {tries} traces')


def _merge(intervals):
    merged = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def reduce_trace(events, annotation):
    """Numbers of a chrome trace of torch.profiler (times in us):
    window_s, busy_s, kernels {name: (launches, device us)},
    annotations (calls annotated `annotation`), annotated_launches
    (device kernels and copies launched inside them), device_ops and
    idle_gaps (the ten largest, [name, seconds])."""
    spans = [e for e in events if e.get('ph') == 'X']
    window = [e for e in spans if e.get('name') == WINDOW
              and e.get('cat') == 'user_annotation']
    w_lo = min(e['ts'] for e in window)
    w_hi = max(e['ts'] + e['dur'] for e in window)
    device = [e for e in spans if e.get('cat') in _DEVICE]
    launches = {e['args']['correlation']: e for e in spans
                if e.get('cat') in ('cuda_runtime', 'cuda_driver')
                and 'correlation' in e.get('args', {})}
    kernels = defaultdict(lambda: [0, 0.0])
    for e in device:
        kernels[e['name']][0] += 1
        kernels[e['name']][1] += e['dur']
    calls = sorted((e['ts'], e['ts'] + e['dur']) for e in spans
                   if e.get('name') == annotation
                   and e.get('cat') == 'user_annotation')
    starts = [lo for lo, _ in calls]
    inside = 0
    for e in device:
        launch = launches.get(e.get('args', {}).get('correlation'))
        if launch is None:
            continue
        i = bisect.bisect_right(starts, launch['ts']) - 1
        if i >= 0 and launch['ts'] <= calls[i][1]:
            inside += 1
    busy = _merge((max(e['ts'], w_lo), min(e['ts'] + e['dur'], w_hi))
                  for e in device if e['ts'] + e['dur'] > w_lo
                  and e['ts'] < w_hi)
    busy_us = sum(hi - lo for lo, hi in busy)
    # The idle gaps, each named by the innermost host operation around
    # the launch of the device work that ends it:
    ops = sorted(((e['ts'], e['ts'] + e['dur'], e['name']) for e in spans
                  if e.get('cat') in ('cpu_op', 'user_annotation')
                  and e['name'] != WINDOW), key=lambda o: (o[0], -o[1]))
    op_starts = [o[0] for o in ops]
    first_launch = {}
    for e in device:
        launch = launches.get(e.get('args', {}).get('correlation'))
        if launch is not None:
            first_launch[e['ts']] = launch['ts']

    def host_name(t):
        name = 'host'
        for i in range(bisect.bisect_right(op_starts, t) - 1, -1, -1):
            lo, hi, op = ops[i]
            if lo <= t <= hi:
                name = op
                break
            if t - lo > 5e6:
                break
        return name

    gaps = defaultdict(float)
    edge = w_lo
    for lo, hi in busy:
        if lo > edge:
            gaps[host_name(first_launch.get(lo, lo))] += (lo - edge) * 1e-6
        edge = max(edge, hi)
    if w_hi > edge:
        gaps['after the last device work'] += (w_hi - edge) * 1e-6
    top = lambda d: sorted(([k, v] for k, v in d.items()),
                           key=lambda kv: -kv[1])[:10]
    return {
        'window_s': (w_hi - w_lo) * 1e-6,
        'busy_s': busy_us * 1e-6,
        'kernels': {k: (n, us) for k, (n, us) in kernels.items()},
        'annotations': len(calls),
        'annotated_launches': inside,
        'device_launches': len(device),
        'device_ops': top({k: us * 1e-6 for k, (_, us) in kernels.items()}),
        'idle_gaps': top(gaps),
    }


def kernel_ms(profile, kernels):
    """(device ms a launch, launches recorded) of the device kernels
    whose names contain one of `kernels`, or None when none was
    recorded."""
    hits = [(c, t) for name, (c, t) in profile['kernels'].items()
            if any(k in name for k in kernels)]
    n = sum(c for c, _ in hits)
    us = sum(t for _, t in hits)
    return (us * 1e-3 / n, n) if n else None


def roofline_share(ctx, role, work):
    """A kernel's share of its roofline (%): counts.py's least time for
    the cell's shapes (`work` names its function) over the device ms a
    launch of the kernels the configuration lists under `role` in its
    `kernels` entry; None where the configuration names none for the
    role or no launch of them was recorded."""
    from . import counts
    prof = ctx.get('profile')
    kernels = ctx['config'].get('kernels', {}).get(role)
    timed = kernel_ms(prof, kernels) if prof and kernels else None
    if timed is None or timed[0] <= 0:
        return None
    shape = ctx['shape']
    bound, _ = counts.bound_ms(*getattr(counts, work)(shape), shape['peak'])
    return 100.0 * bound / timed[0]
