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


# A CUDA profiler session in this process loses the first device events
# it should record once another process has made a CUDA context on the
# card after CUPTI started here (a census child, the CLI, torchrun): in
# tools/trace_events.py each such child made every later session lose one
# more of its first events, and now and then a session lost tens or
# hundreds (51, 336; PERF.md). profiler_trace therefore opens each session
# with PRIMERS primer kernels, which take the loss, and keeps them out of
# what it yields; a session that lost them all says so (Trace.complete).
PRIMER_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel
PRIMERS = 1024
# the CPU-side launch calls of a kernel, which share its correlation id
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


class Trace:
    """What profiler_trace yields: ``events()`` and ``key_averages()`` of
    the traced block (its device events without the primer kernels and
    their launch calls), the profiler itself as ``prof``, ``primers``
    (launched) and ``primers_lost``. ``complete`` is False where the
    session lost every primer, so that the block's own device events may
    be missing too."""

    def __init__(self, prof, primers: int):
        self.prof, self.primers = prof, primers
        self._events, self._kept = None, 0

    def events(self):
        if self._events is None:
            from torch.autograd import DeviceType
            from torch.autograd.profiler_util import EventList

            events = self.prof.events()
            primer = [e for e in events
                      if e.device_type == DeviceType.CUDA and PRIMER_KERNEL in e.name]
            drop = {id(e) for e in primer}
            # a CPU event's id and a kernel's come from two counters, so
            # only a launch call is matched to a primer by its id
            launches = {e.id for e in primer}
            self._events = EventList(
                [e for e in events if id(e) not in drop
                 and not (e.device_type == DeviceType.CPU and e.name in LAUNCH_CALLS
                          and e.id in launches)],
                use_device=getattr(events, "_use_device", None))
            self._events._tree_built = True  # the events keep their tree
            self._kept = len(primer)
        return self._events

    def key_averages(self):
        return self.events().key_averages()

    @property
    def primers_lost(self) -> int:
        self.events()
        return self.primers - self._kept

    @property
    def complete(self) -> bool:
        return self.primers == 0 or self.primers_lost < self.primers


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]) -> Iterator[object]:
    """Trace the block with torch.profiler when log_dir is set, and write
    the Chrome trace (primer kernels included) to ``log_dir/trace.json``;
    yields a ``Trace``, or None as a no-op without a log dir. With a card,
    the session first launches primer kernels (``torch.cuda._sleep``) and
    waits for them, so that the events it can lose are theirs, and waits
    for the block's kernels before it stops, so that a kernel still running
    there keeps its event."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    primers = 0
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        primers = PRIMERS
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        for _ in range(primers):
            torch.cuda._sleep(1)
        if primers:
            torch.cuda.synchronize()
        trace = Trace(prof, primers)
        yield trace
        if primers:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
