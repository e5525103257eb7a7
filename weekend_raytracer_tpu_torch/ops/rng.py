"""Counter/hash RNG: Jenkins-seeded PCG on uint32 values held in int64.

Counterpart of weekend_raytracer_tpu/ops/rng.py, bit for bit: the same
integer recurrence (raytracer.wgsl:498-521), the same per-(pixel, frame,
sample) seeding, and floats from the top 24 bits.

PyTorch's CPU backend does not implement ``<<``, ``>>`` or ``+`` on
``torch.uint32``, so a uint32 value lives in an int64 tensor and every step
that can carry past bit 31 is masked with ``& 0xFFFFFFFF``. The largest
intermediate, a 32-bit word times the 29-bit PCG multiplier, stays below
2^61. The CUDA kernel does the same arithmetic natively on ``uint32_t``
(csrc/megakernel.cu).
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9  # 2^32 / golden ratio: odd, full-period sample stride
_INV_2_24 = float(1.0 / (1 << 24))


def as_u32(x, device=None) -> torch.Tensor:
    """A uint32 value (int, numpy array or tensor) as a masked int64 tensor."""
    t = torch.as_tensor(x, device=device)
    return t.to(torch.int64) & MASK32


def jenkins_hash(x: torch.Tensor) -> torch.Tensor:
    """Jenkins one-at-a-time finalizer (raytracer.wgsl:513-521)."""
    x = as_u32(x)
    x = (x + (x << 10)) & MASK32
    x = x ^ (x >> 6)
    x = (x + (x << 3)) & MASK32
    x = x ^ (x >> 11)
    x = (x + (x << 15)) & MASK32
    return x


def init_sample_state(pixel_index, frame, sample) -> torch.Tensor:
    """Seed for one (pixel, frame, sample) draw stream (see the JAX
    package's rng.init_sample_state): each sample seeds independently, so
    a path's draws depend only on its own bounce index."""
    pixel_index = as_u32(pixel_index)
    frame = as_u32(frame, pixel_index.device)
    sample = as_u32(sample, pixel_index.device)
    mix = (GOLDEN * (sample + 1)) & MASK32
    return jenkins_hash(pixel_index ^ jenkins_hash(frame) ^ mix)


def next_state(state: torch.Tensor) -> torch.Tensor:
    """One PCG step (raytracer.wgsl:504-511); returns the new state."""
    old = (state + 747796405 + 2891336453) & MASK32
    shift = (old >> 28) + 4
    word = (((old >> shift) ^ old) * 277803737) & MASK32
    return (word >> 22) ^ word


def next_float(state: torch.Tensor):
    """Advance and return (new_state, uniform f32 in [0, 1))."""
    state = next_state(state)
    value = (state >> 8).to(torch.float32) * _INV_2_24
    return state, value


def next_floats(state: torch.Tensor, n: int):
    """Advance n times; returns (new_state, tuple of n f32 tensors)."""
    outs = []
    for _ in range(n):
        state, v = next_float(state)
        outs.append(v)
    return state, tuple(outs)
