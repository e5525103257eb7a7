"""The port's utils/metrics and utils/log, as tests/test_utils.py tests the
JAX package's."""
import json
import logging
import time

import pytest

torch = pytest.importorskip("torch")

from weekend_raytracer_tpu_torch.utils.log import (  # noqa: E402
    JsonFormatter, get_logger, log_event)
from weekend_raytracer_tpu_torch.utils.metrics import (  # noqa: E402
    FpsCounter, StepTimer, profiler_trace)


def test_fps_counter_window():
    """8-frame sliding window (reference main.rs:484-513)."""
    f = FpsCounter(window=8)
    assert f.average_fps() == 0.0
    for _ in range(20):
        f.update(0.02)  # 50 fps
    assert f.average_fps() == pytest.approx(50.0, rel=1e-6)
    f.update(0.1)  # one slow frame enters the window
    assert 30.0 < f.average_fps() < 50.0


def test_step_timer_throughput():
    t = StepTimer(rays_per_step=1000)
    with t.step():
        time.sleep(0.01)
    with t.step():
        time.sleep(0.02)
    assert t.total_seconds >= 0.03
    assert t.best_rays_per_sec >= t.mean_rays_per_sec > 0


def test_profiler_trace_noop():
    with profiler_trace(None) as prof:
        assert prof is None  # a harmless no-op without a log dir


def test_profiler_trace_records_and_writes(tmp_path):
    """With a log dir the block runs under torch.profiler: its operators
    are in key_averages() and the Chrome trace is written there."""
    with profiler_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64).cumsum(0)
    names = {e.key for e in prof.key_averages()}
    assert "aten::cumsum" in names
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_profiler_trace_keeps_every_trace_of_a_process(tmp_path):
    """50 traces in one process, each of its own block: every trace keeps
    its operators' events, and none of an earlier block's."""
    from torch.profiler import record_function

    x = torch.ones(64)
    for i in range(50):
        with profiler_trace(str(tmp_path)) as trace:
            with record_function(f"block_{i}"):
                x.cumsum(0)
        names = [e.name for e in trace.events()]
        assert f"block_{i}" in names and "aten::cumsum" in names, i
        assert not [n for n in names if n.startswith("block_") and n != f"block_{i}"]
        assert trace.primers == 0 and trace.complete  # no card: no primers


class _FakeEvent:
    def __init__(self, name, device_type, correlation=0):
        self.name, self.device_type, self.id = name, device_type, correlation


def test_profiler_trace_primes_each_session_on_a_card(monkeypatch, tmp_path):
    """With a card, the session is opened with CPU and CUDA activity and
    PRIMERS primer kernels (torch.cuda._sleep), synchronized before the
    block and again after it; what it yields leaves the primers and their launch calls out,
    keeps a CPU operator whose id is a primer's, and counts the primers
    lost; a session that lost them all is not complete."""
    from torch.autograd import DeviceType

    from weekend_raytracer_tpu_torch.utils import metrics

    calls = []

    class FakeProfile:
        def __init__(self, **kwargs):
            calls.append(("profile", kwargs))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            calls.append(("exit",))
            return False

        def events(self):  # 40 of 64 primers kept, their launches, the block's
            return ([_FakeEvent("at::cuda::spin_kernel(long)", DeviceType.CUDA, c)
                     for c in range(1, 41)]
                    + [_FakeEvent("cudaLaunchKernel", DeviceType.CPU, c) for c in range(1, 65)]
                    + [_FakeEvent("regroup_k0", DeviceType.CUDA, 70),
                       _FakeEvent("cudaLaunchKernel", DeviceType.CPU, 70),
                       _FakeEvent("aten::add", DeviceType.CPU),
                       # an operator's id comes from another counter than
                       # a kernel's, so it may equal a primer's
                       _FakeEvent("aten::mul", DeviceType.CPU, 3)])

        def export_chrome_trace(self, path):
            calls.append(("export", path))

    monkeypatch.setattr(metrics, "PRIMERS", 64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: calls.append(("sleep", cycles)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: calls.append(("sync",)))
    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    with profiler_trace(str(tmp_path)) as trace:
        calls.append(("block",))
    from torch.profiler import ProfilerActivity

    assert calls[0] == ("profile", {"activities": [ProfilerActivity.CPU,
                                                   ProfilerActivity.CUDA]})
    assert calls[1:66] == [("sleep", 1)] * 64 + [("sync",)]
    assert calls[66:] == [("block",), ("sync",), ("exit",),
                          ("export", str(tmp_path / "trace.json"))]
    # the lost primers' launches stay: nothing links them to a kernel
    assert [e.name for e in trace.events()] == (["cudaLaunchKernel"] * 24 + [
        "regroup_k0", "cudaLaunchKernel", "aten::add", "aten::mul"])
    assert (trace.primers, trace.primers_lost, trace.complete) == (64, 24, True)

    FakeProfile.events = lambda self: [_FakeEvent("aten::add", DeviceType.CPU)]
    with profiler_trace(str(tmp_path)) as trace:
        pass
    assert trace.primers_lost == 64 and not trace.complete
    assert calls.count(("sleep", 1)) == 2 * 64  # the count is the same each session


def test_json_log_fields():
    rec = logging.LogRecord("weekend_raytracer_tpu_torch.x", logging.INFO, "f", 1,
                            "hello %s", ("world",), None)
    rec.fields = {"rays": 42}
    data = json.loads(JsonFormatter().format(rec))
    assert data["msg"] == "hello world"
    assert data["rays"] == 42
    assert data["level"] == "info"


def test_get_logger_singleton_handler():
    """One handler on the port's own logger, which is not the JAX
    package's."""
    a = get_logger("one")
    get_logger("two")
    root = logging.getLogger("weekend_raytracer_tpu_torch")
    assert len(root.handlers) == 1 and a.parent is root
    assert not root.propagate
    log_event(a, "evt", x=1)  # must not raise
