"""The readings of the program's own record (program_spans.py) on a
synthetic record: a set-up's first forward, then a run of one chunk of
four generations and five forwards, whose numbers are known; each
reading returns None from an empty record, and from a program without
the recorder."""
import sys
from types import SimpleNamespace

import pytest

from portbench import harness, program_spans

MS = 1_000_000          # ns
READINGS = ('forward_host_ms.demc', 'forward_device_ms.demc',
            'host_lead_ms.demc', 'host_waits_per_gen.demc',
            'sampler_host_ms_per_gen.demc', 'first_forward_s')


def _span(name, parent, t0, t1, d0=None, d1=None, **counts):
    return SimpleNamespace(name=name, parent=parent, gen=None, t0=t0,
                           t1=t1, d0=d0, d1=d1, counts=counts)


def _record():
    """An earlier run (its numbers must not be read), the first forward
    (2 s host, its device end mark 0.5 s later), and the last run: its
    initial forward and four generations, forward i taking 10 + i ms on
    the host and 12 ms on the device, its start mark reached 3 + i ms
    after the host entered it; 3 + 2 host waits; 100 ms of run."""
    first = _span('pbt.setup.first_forward', None, 0, 2000 * MS,
                  0, 2500 * MS)
    old = _span('pbt.demc.run', None, 3000 * MS, 3001 * MS)
    old_fwd = _span('pbt.forward', old, 3000 * MS, 3001 * MS, 3000 * MS,
                    3001 * MS)
    spans = [first, old, old_fwd,
             _span('pbt.demc.chunk', old, 3000 * MS, 3001 * MS,
                   **{'pbt.demc.generations': 99})]
    base = 10_000 * MS
    run = _span('pbt.demc.run', None, base, base + 100 * MS,
                **{'pbt.host_waits': 3})
    chunk = _span('pbt.demc.chunk', run, base + 20 * MS, base + 100 * MS,
                  **{'pbt.demc.generations': 4})
    spans += [run, chunk]
    for i in range(5):
        parent = run if i == 0 else chunk
        t0 = base + 15 * MS * i
        post = _span('pbt.log_post', parent, t0, t0 + 12 * MS)
        fwd = _span('pbt.forward', post, t0, t0 + (10 + i) * MS,
                    t0 + (3 + i) * MS, t0 + (15 + i) * MS,
                    **{'pbt.forward.calls': 1})
        spans += [post, fwd]
    spans.append(_span('pbt.demc.history', chunk, base + 99 * MS,
                       base + 100 * MS, **{'pbt.host_waits': 2}))
    return spans


WANT = {
    'forward_host_ms.demc': 12.0,
    'forward_device_ms.demc': 12.0,
    'host_lead_ms.demc': 5.0,
    'host_waits_per_gen.demc': 5 / 4,
    'sampler_host_ms_per_gen.demc': (100 - 5 * 12) / 4,
    'first_forward_s': 2.5,
}


@pytest.mark.parametrize('name', READINGS)
def test_reading_of_a_synthetic_record(name):
    read = harness.reader(name).read
    assert read({}, _record()) == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize('name', READINGS)
def test_reading_of_an_empty_record_is_none(name):
    assert harness.reader(name).read({}, []) is None


def test_marks_missing_read_host_only():
    spans = _record()
    for s in spans:
        s.d0 = s.d1 = None
    assert program_spans.forward_device_ms({}, spans) is None
    assert program_spans.host_lead_ms({}, spans) is None
    assert program_spans.forward_host_ms({}, spans) == 12.0
    assert program_spans.first_forward_s({}, spans) == 2.0


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    monkeypatch.setitem(sys.modules, 'pyratbay_tpu_torch.tracing', None)
    assert program_spans.record() == []
    for name in READINGS:
        assert harness.reader(name).read({}) is None
