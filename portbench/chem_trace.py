"""The device work inside the program's pbt.state.chem spans (the
equilibrium solve of each batched forward), from a profiled phase's
torch.profiler trace.

trace.py reduces a profiled phase to numbers of the whole phase and of
the benchmark's own annotated calls.  The program opens each of its spans
under record_function while torch.profiler records
(pyratbay_tpu_torch/tracing.py), so pbt.state.chem sits in the trace as a
user annotation around the solve's launches.  install() wraps
trace.reduce_trace, which trace.profiled calls on each trace it takes, so
that its result also holds, under SPAN, {'spans': the pbt.state.chem
spans recorded, 'launches': the device kernels, copies and sets launched
inside them, 'device_us': their device time}.  A program without the
span gives 'spans' 0, and the readers then return None.
"""
import bisect

from . import trace

__all__ = ['SPAN', 'inside', 'install']

SPAN = 'pbt.state.chem'
_DEVICE = ('kernel', 'gpu_memcpy', 'gpu_memset')


def inside(events, name):
    """{'spans', 'launches', 'device_us'} of the user annotations named
    `name` in a chrome trace of torch.profiler (times in us): device work
    counted where its launch's runtime call lies inside one of them."""
    spans = sorted((e['ts'], e['ts'] + e['dur']) for e in events
                   if e.get('ph') == 'X' and e.get('name') == name
                   and e.get('cat') == 'user_annotation')
    starts = [lo for lo, _ in spans]
    launches = {e['args']['correlation']: e for e in events
                if e.get('ph') == 'X'
                and e.get('cat') in ('cuda_runtime', 'cuda_driver')
                and 'correlation' in e.get('args', {})}
    n, us = 0, 0.0
    for e in events:
        if e.get('ph') != 'X' or e.get('cat') not in _DEVICE:
            continue
        launch = launches.get(e.get('args', {}).get('correlation'))
        if launch is None:
            continue
        i = bisect.bisect_right(starts, launch['ts']) - 1
        if i >= 0 and launch['ts'] <= spans[i][1]:
            n += 1
            us += e['dur']
    return {'spans': len(spans), 'launches': n, 'device_us': us}


def install():
    """Make trace.reduce_trace also reduce the pbt.state.chem spans
    (once a process)."""
    if getattr(trace.reduce_trace, 'chem_spans', False):
        return
    reduce_phase = trace.reduce_trace

    def reduce_trace(events, annotation):
        out = reduce_phase(events, annotation)
        out[SPAN] = inside(events, SPAN)
        return out

    reduce_trace.chem_spans = True
    reduce_trace.__doc__ = reduce_phase.__doc__
    trace.reduce_trace = reduce_trace
