"""Probes of the port: the questions of the JAX package's benchmarks/probe_*.py
scripts, asked of the port's own kernels on the card.

    python -m weekend_raytracer_tpu_torch.probes.dma [name ...]
    python -m weekend_raytracer_tpu_torch.probes.binned [cut] [rtiow|random10k] [quick] [dump]
    python -m weekend_raytracer_tpu_torch.probes.mxu_sweep [p1 ... p8c16 fill]
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
