"""The recorder's device marks on a GPU (pyratbay_tpu_torch/tracing.py).

This file imports neither JAX nor pyratbay_tpu (run it as
test_torch_cuda.py is: python -m pytest --noconftest -q
tests/test_torch_tracing_cuda.py).  Without a CUDA device the tests
skip.

* A span's device marks land on the host clock: the start mark at or
  after the host's entry, the device time between the marks that of
  CUDA events around the same work.
* Spans that record (under a profiler: CUDA events and record_function)
  make the batched log-posterior synchronize nothing (torch's sync debug
  mode 'error').
* Model.run stamps its stages with one synchronize, after its copies to
  the host have drained the stream, where it took three.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from pyratbay_tpu_torch import tracing  # noqa: E402
from pyratbay_tpu_torch.benchmark import make_flagship  # noqa: E402
from pyratbay_tpu_torch.retrieval.batched import (  # noqa: E402
    build_log_posterior_batched)

RUN_KEYS = ('setup spectrum', 'setup atmosphere', 'setup opacity',
            'atmosphere', 'extinction', 'spectrum')


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc (run chip_smoke.py)')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.fixture
def flagship(cuda, tmp_path):
    model, obs, ret, forward, p0 = make_flagship(
        str(tmp_path), nlayers=21, wnstep=4.0, device=cuda)
    bandflux = forward(p0)['bandflux']
    obs.data = bandflux.double().cpu().numpy()
    obs.uncert = 0.03 * np.abs(obs.data) + 1e-12
    return model, obs, ret


@pytest.mark.cuda
def test_cuda_marks_on_the_host_clock(cuda):
    rec = tracing.Recorder(path='unused.json')
    a = torch.randn(2048, 2048, device=cuda)
    a @ a
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with rec.span('pbt.forward', gen=0) as span:
        start.record()
        for _ in range(20):
            a = (a @ a) / 2048.0
        end.record()
    rec.resolve()
    device_ms = (span.d1 - span.d0) * 1e-6
    assert device_ms == pytest.approx(start.elapsed_time(end), abs=0.05)
    assert device_ms > 1.0
    assert span.d0 >= span.t0 - 50_000          # 50 us of calibration
    assert span.d1 >= span.d0 and span.end == span.d1


@pytest.mark.cuda
def test_cuda_recording_spans_sync_nothing(cuda, flagship):
    model, obs, ret = flagship
    log_post = build_log_posterior_batched(model, obs, ret)
    params = torch.as_tensor(np.tile(ret.params, (64, 1)),
                             dtype=model.dtype, device=cuda)
    with torch.no_grad():
        log_post(params)
        torch.cuda.synchronize()
        n0 = len(tracing.RECORDER.spans)
        with profile(activities=[ProfilerActivity.CPU]):
            torch.cuda.set_sync_debug_mode('error')
            try:
                logp = log_post(params)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    spans = tracing.RECORDER.spans[n0:]
    assert [s.name for s in spans][:2] == ['pbt.log_post', 'pbt.forward']
    tracing.resolve()
    assert all(s.d0 is not None and s.d1 >= s.d0 for s in spans)
    assert torch.isfinite(logp).all()


@pytest.mark.cuda
def test_cuda_model_run_stamps_with_one_synchronize(cuda, flagship):
    model = flagship[0]
    model.run()

    def syncs(work):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            work()
        return sum(evt.count for evt in prof.key_averages()
                   if evt.key == 'cudaDeviceSynchronize')

    # The profiler's own calls are those of a trace of nothing:
    assert syncs(model.run) == syncs(lambda: None) + 1
    assert tuple(model.timestamps) == RUN_KEYS
    assert all(v > 0 for v in model.timestamps.values())
