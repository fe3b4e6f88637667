"""The per-layer metrics read from the program's own record: the spans
and counters of pyratbay_tpu_torch/tracing.py.

Each reading runs once the cell's window and its traced phases have
ended, in the same process.  It reads the record's last pbt.demc.run
and its descendants (a traced run's profiled chunk: the last
sample_demc call, kept after any retry), or the set-up's first forward.  `spans` defaults to the program's record, resolved
(record()); a reading returns None where the record has nothing for it:
a program without the recorder, or a run that recorded no such span.
Times are ns of the host clock (device marks mapped onto it).
"""
import importlib
import statistics

__all__ = ['record', 'last_run', 'forward_host_ms', 'forward_device_ms',
           'host_lead_ms', 'host_waits_per_gen', 'sampler_host_ms_per_gen',
           'first_forward_s']

HOST_WAITS = 'pbt.host_waits'


def record():
    """The program's spans, their device marks resolved; empty for a
    program without the recorder."""
    try:
        tracing = importlib.import_module('pyratbay_tpu_torch.tracing')
    except ImportError:
        return []
    tracing.resolve()
    return list(tracing.RECORDER.spans)


def _within(span, ancestor):
    while span is not None:
        if span is ancestor:
            return True
        span = span.parent
    return False


def last_run(spans=None):
    """(the last pbt.demc.run, its descendants in the record's order),
    or None."""
    spans = record() if spans is None else spans
    runs = [i for i, s in enumerate(spans) if s.name == 'pbt.demc.run']
    if not runs:
        return None
    run = spans[runs[-1]]
    return run, [s for s in spans[runs[-1] + 1:] if _within(s.parent, run)]


def _forwards(spans):
    found = last_run(spans)
    return [] if found is None else [s for s in found[1]
                                     if s.name == 'pbt.forward']


def _median_ms(values):
    values = list(values)
    return statistics.median(values) * 1e-6 if values else None


def _generations(inside):
    return sum(s.counts.get('pbt.demc.generations', 0) for s in inside)


def forward_host_ms(ctx, spans=None):
    """The median host ms of the last run's pbt.forward spans (entry to
    return, nothing synchronized: with the launch queue full, the host
    blocking on it)."""
    return _median_ms(s.t1 - s.t0 for s in _forwards(spans))


def forward_device_ms(ctx, spans=None):
    """The median ms between the device's arrival at a pbt.forward
    span's start mark and at its end mark."""
    return _median_ms(s.d1 - s.d0 for s in _forwards(spans)
                      if s.d0 is not None)


def host_lead_ms(ctx, spans=None):
    """The median ms by which the host entered a pbt.forward span before
    the device reached its start mark: near 0 the card waits for the
    host; large, the host runs ahead and the card sets the pace."""
    return _median_ms(s.d0 - s.t0 for s in _forwards(spans)
                      if s.d0 is not None)


def host_waits_per_gen(ctx, spans=None):
    """pbt.host_waits in the last run (the run and its descendants) over
    its generations."""
    found = last_run(spans)
    if found is None:
        return None
    run, inside = found
    gens = _generations(inside)
    if not gens:
        return None
    return sum(s.counts.get(HOST_WAITS, 0) for s in [run] + inside) / gens


def sampler_host_ms_per_gen(ctx, spans=None):
    """The sampler's own host ms a generation: the last run's host time
    less its outermost pbt.log_post descendants', over its
    generations."""
    found = last_run(spans)
    if found is None:
        return None
    run, inside = found
    gens = _generations(inside)
    if not gens:
        return None
    posts = [s for s in inside if s.name == 'pbt.log_post']
    outer = [s for s in posts
             if not any(_within(s.parent, p) for p in posts)]
    own = (run.t1 - run.t0) - sum(s.t1 - s.t0 for s in outer)
    return own / gens * 1e-6


def first_forward_s(ctx, spans=None):
    """The seconds of the last pbt.setup.first_forward (the first call of
    the run's batched forward): host entry to the device's arrival at its
    end mark (the host's return where there is no mark)."""
    spans = record() if spans is None else spans
    firsts = [s for s in spans if s.name == 'pbt.setup.first_forward']
    if not firsts:
        return None
    s = firsts[-1]
    return ((s.t1 if s.d1 is None else s.d1) - s.t0) * 1e-9
