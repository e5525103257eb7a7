"""Performance instrumentation: FPS window, rays/sec, step timing, traces.

Counterpart of weekend_raytracer_tpu/utils/metrics.py. ``profiler_trace``
runs ``torch.profiler`` where the JAX package runs ``jax.profiler``: CPU
activity always, CUDA activity (kernel device times through CUPTI) when a
card is present.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import time
from typing import Deque, Iterator, Optional


class FpsCounter:
    """Sliding-window FPS (reference main.rs:484-513; window = 8 frames)."""

    def __init__(self, window: int = 8):
        self._deltas: Deque[float] = collections.deque(maxlen=window)

    def update(self, delta_seconds: float) -> None:
        self._deltas.append(delta_seconds)

    def average_fps(self) -> float:
        if not self._deltas:
            return 0.0
        mean = sum(self._deltas) / len(self._deltas)
        return 1.0 / mean if mean > 0 else 0.0


@dataclasses.dataclass
class StepTimer:
    """Accumulates step wall times and derives throughput. A step on the
    card is timed on the host clock, so it must end in a synchronize."""

    rays_per_step: int
    times: list = dataclasses.field(default_factory=list)

    @contextlib.contextmanager
    def step(self) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)

    @property
    def total_seconds(self) -> float:
        return sum(self.times)

    @property
    def best_rays_per_sec(self) -> float:
        return self.rays_per_step / min(self.times) if self.times else 0.0

    @property
    def mean_rays_per_sec(self) -> float:
        return (
            self.rays_per_step * len(self.times) / self.total_seconds
            if self.times
            else 0.0
        )


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]) -> Iterator[object]:
    """Trace the block with torch.profiler when log_dir is set, and write
    the Chrome trace to ``log_dir/trace.json``; yields the profiler (for
    ``key_averages()``), or None as a no-op without a log dir."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
