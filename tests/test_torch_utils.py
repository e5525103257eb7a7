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
