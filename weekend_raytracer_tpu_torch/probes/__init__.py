"""Probes of the port: the questions of the JAX package's benchmarks/probe_*.py
scripts, asked of the port's own kernels on the card.

    python -m weekend_raytracer_tpu_torch.probes.dma [name ...]
    python -m weekend_raytracer_tpu_torch.probes.binned [cut] [rtiow|random10k] [quick] [dump]
    python -m weekend_raytracer_tpu_torch.probes.mxu_sweep [p1 ... p8c16 fill]
    python -m weekend_raytracer_tpu_torch.probes.gather_cost [gather_cost texture fill]
    python -m weekend_raytracer_tpu_torch.probes.place [p1 p2 p3 p4]
    python -m weekend_raytracer_tpu_torch.probes.mosaic [take_along_sublane ...]
"""
from __future__ import annotations

import subprocess
import time

# NVIDIA H100 SXM peaks at 700 W (NVIDIA's published figures), the bounds'
# rates; a card set below its maximum power is slower, so every number is
# printed with the card's name and power limit
FP32_PEAK = 67e12  # FP32 operations per second, outside the tensor cores
TF32_PEAK = 495e12  # dense TF32 tensor-core flops per second
HBM_RATE = 3.35e12  # bytes per second
# FP32 operations of one sphere test, an FMA as two (bounce.cuh sweep_sphere:
# cd 5, co2 8, bq 1, cq 2, bq^2 - cq 2, sqrt 1, t0 and t1 2); compares and
# selects are not counted
SPHERE_TEST_OPS = 21
# FP32 operations of a pair whose 2c is staged (sweep.cu sweep_fma; the
# stats kernels' staged_pairs, csrc/bounce.cuh), an FMA as two: cd 5, 2c.o
# 5, bq 1, cq 2, bq^2 - cq 2; of the root of a pair with a real root (the
# root, t0, t1); of a slab test of a chunk or super-chunk box (6
# subtractions, 6 products). Compares and selects are not counted.
PAIR_OPS = 15
ROOT_OPS = 3
SLAB_TEST_OPS = 12
# shared memory (and L1) serve 32 banks of 4 B, 128 B a clock an SM
SMEM_BYTES_PER_CLOCK = 128
# an H100 SXM's SMs and maximum SM clock (NVIDIA's published figures), the
# shared-memory rate's factors where no card is present to read them from
H100_SMS = 132
H100_MAX_SM_MHZ = 1980


def stats_bound(segments: float, kept: float, nbytes: float, n_spheres: int, n_tests: int,
                n_super: int, n_priors: int) -> dict:
    """The least time of a stats kernel (the megakernel's or K1's; csrc/
    bounce.cuh's stats section) on ``segments`` live path segments, each a
    full sweep: PAIR_OPS for each of its pairs (every sphere of the table
    and the ``n_priors`` priors', which a scene with chunks sweeps first),
    SLAB_TEST_OPS for each chunk and super-chunk box it tests, and ROOT_OPS
    for each of the ``kept`` pairs with a real root (b^2 - cq > 0); or
    ``nbytes`` over the memory rate, whichever is larger."""
    ops = (segments * ((n_spheres + n_priors) * PAIR_OPS + (n_tests + n_super) * SLAB_TEST_OPS)
           + kept * ROOT_OPS)
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_RATE
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes}


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them (a card
    set below its maximum power runs slower), or its name alone."""
    import torch

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
        return out.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(0)


def check(ok: bool, what) -> None:
    """Raise AssertionError("WRONG: what") unless ``ok``."""
    if not ok:
        raise AssertionError(f"WRONG: {what}")


def sync(device) -> None:
    """Wait for the card, where ``device`` is one."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def same_bits(a, b) -> bool:
    """Equal shapes and equal 32-bit patterns (-0.0 and +0.0 differ)."""
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def time_call(fn, device):
    """(fn(), its milliseconds): CUDA events around the call on the card,
    the host clock on the CPU."""
    import torch

    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def time_mean(fn, reps: int, device) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls in a row, after one
    warm call. Each call's result is dropped before the next call, so an
    allocating ``fn`` reuses the caching allocator's block instead of
    allocating ``reps`` new ones."""
    def calls():
        for _ in range(reps):
            fn()

    fn()
    return time_call(calls, device)[1] / reps


def host_ms(fn, reps: int, device) -> float:
    """Host milliseconds a call of ``fn`` takes: the host clock over
    ``reps`` calls in a row, after one warm call and a synchronize, with no
    synchronize between or after them. On the card that is each call's
    host side (checks, allocation, the launch), whatever the kernel's
    device time; on the CPU, the whole call. Makes reps + 1 calls."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    sync(device)
    return ms


def max_sm_clock_mhz() -> float:
    """The card's maximum SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return float(out.strip().splitlines()[0])


def smem_rate(device) -> dict:
    """Shared-memory bytes per second: SMEM_BYTES_PER_CLOCK x SMs x the
    maximum SM clock, read from the card (``multi_processor_count``,
    nvidia-smi's clocks.max.sm); off the card, the H100 SXM's published
    figures."""
    import torch

    if torch.device(device).type == "cuda":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        mhz = max_sm_clock_mhz()
    else:
        sms, mhz = H100_SMS, H100_MAX_SM_MHZ
    return {"sms": sms, "max_sm_mhz": mhz,
            "bytes_per_s": SMEM_BYTES_PER_CLOCK * sms * mhz * 1e6}


# idle host time at each end of a probe's profiler trace: a device event
# whose converted timestamp falls outside the trace's window is dropped, and
# a trace of a few tiny kernels is not much longer than that offset
TRACE_PAD_S = 0.05


def library_device_ms(us, reps: int, per_call: int):
    """A call's device milliseconds of a function that launches ``per_call``
    kernels (learnt from one traced call), from the device events ``us``
    (microseconds) that a trace of ``reps`` calls recorded; None unless the
    trace holds exactly reps x per_call events, as a dropped event would
    make the sum read low."""
    if per_call < 1 or len(us) != reps * per_call:
        return None
    return sum(us) / reps / 1e3


def device_times(fns: dict, reps: int, device, several=()):
    """{label: {"device_ms": ms, "device_ms_by": by}} for each function of
    ``fns``, each of which launches one kernel (those labelled in
    ``several``, a library call, may launch more): each is called ``reps``
    times under its own utils.metrics.profiler_trace, the calls padded on
    both sides by TRACE_PAD_S of idle host time, with a pair of CUDA events
    around each call. By "profiler", the time is the mean of the device
    events the profiler records there (as chip_smoke's [trace] reads them);
    a trace can miss a few of its events, so the mean is over those it has.
    A label of ``several`` is first traced over one call of its own, which
    counts its kernels a call; its time is then the sum of its events over
    ``reps`` (``library_device_ms``), and only where the trace holds every
    event it should. A trace that records none of them (one did after some
    hundred traces in one process), or a ``several`` trace that lost any,
    gives by "cuda_events" the mean of the event pairs of the same calls
    instead, which also counts each launch's host side: no call is made
    again, so the launches stay ``reps`` a function (one more for a label of
    ``several``). More events than calls is an error where a call launches
    one kernel. None off the card."""
    import tempfile

    import torch
    from torch.autograd import DeviceType

    from ..utils.metrics import profiler_trace

    if torch.device(device).type != "cuda":
        return None

    def trace(fn, calls: int):
        pairs = [tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
                 for _ in range(calls)]
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as log_dir:
            with profiler_trace(log_dir) as prof:
                time.sleep(TRACE_PAD_S)
                for start, end in pairs:
                    start.record()
                    fn()
                    end.record()
                torch.cuda.synchronize()
                time.sleep(TRACE_PAD_S)
            us = [e.self_device_time_total for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        return us, pairs

    out = {}
    for label, fn in fns.items():
        per_call = len(trace(fn, 1)[0]) if label in several else 1
        us, pairs = trace(fn, reps)
        if len(us) > reps and label not in several:
            raise AssertionError(f"{label}: the profiler saw {len(us)} device events of "
                                 f"{reps} calls")
        ms = (library_device_ms(us, reps, per_call) if label in several
              else sum(us) / len(us) / 1e3 if us else None)
        if ms is not None:
            out[label] = {"device_ms": ms, "device_ms_by": "profiler"}
        else:
            out[label] = {"device_ms": sum(s.elapsed_time(e) for s, e in pairs) / reps,
                          "device_ms_by": "cuda_events"}
    return out
