"""Uncharted2 filmic tonemapping of the running sample mean.

Counterpart of weekend_raytracer_tpu/ops/tonemap.py (reference
raytracer.wgsl:83-103): uncharted2 curve with exposure bias 0.246 and white
point 11.2, applied to accumulated-radiance / sample-count.
"""
from __future__ import annotations

import torch

EXPOSURE_BIAS = 0.246  # wgsl:86, "determined experimentally for the scene"
WHITE_POINT = 11.2  # wgsl:89


def _curve(x: torch.Tensor) -> torch.Tensor:
    """uncharted2Tonemap (wgsl:94-103)."""
    a, b, c, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * f)) - e / f


def uncharted2(x: torch.Tensor) -> torch.Tensor:
    """Tonemap linear radiance to display range [0, ~1] (wgsl:83-92)."""
    curr = _curve(EXPOSURE_BIAS * x)
    white_scale = 1.0 / _curve(torch.tensor(WHITE_POINT, dtype=torch.float32,
                                            device=x.device))
    return white_scale * curr


def to_srgb_u8(mean_radiance: torch.Tensor) -> torch.Tensor:
    """Tonemap + quantize to uint8 for display/PNG, through the sRGB
    transfer function of the reference's Bgra8UnormSrgb swapchain
    (main.rs:463-473)."""
    x = torch.clamp(uncharted2(mean_radiance), 0.0, 1.0)
    srgb = torch.where(
        x <= 0.0031308, 12.92 * x, 1.055 * torch.pow(x, 1.0 / 2.4) - 0.055
    )
    return torch.clamp(srgb * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
