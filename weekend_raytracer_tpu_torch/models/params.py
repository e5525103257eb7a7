"""Render parameters and typed validation.

Capability parity with the reference's ``RenderParams`` +
``RenderParamsValidationError`` (src/raytracer/mod.rs:396-485) and
``SamplingParams`` (mod.rs:597-613): validated parameter bundles whose
change triggers an accumulation reset in the renderer.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from .camera import Camera
from .sky import SkyParams


class RenderParamsValidationError(ValueError):
    """Typed validation failure (reference mod.rs:396-448 error enum)."""


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Sampling configuration (reference mod.rs:597-613).

    Defaults match the reference: 128 max spp, 2 spp per frame, 8 bounces.
    """

    max_samples_per_pixel: int = 128
    num_samples_per_pixel: int = 2
    num_bounces: int = 8


@dataclasses.dataclass(frozen=True)
class RenderParams:
    """Full validated parameter bundle (reference mod.rs:449-485)."""

    camera: Camera
    sky: SkyParams = dataclasses.field(default_factory=SkyParams)
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    viewport_size: Tuple[int, int] = (800, 600)

    def validate(self) -> None:
        """Raise RenderParamsValidationError on any out-of-range field.

        Mirrors mod.rs:450-484: max spp divisible by spp-per-frame, nonzero
        viewport, vfov in (0, 90], aperture in [0, 1], focus distance > 0,
        plus the sky-model input ranges the hw_skymodel crate enforces.
        """
        s = self.sampling
        if s.num_samples_per_pixel <= 0:
            raise RenderParamsValidationError(
                f"num_samples_per_pixel must be positive, got {s.num_samples_per_pixel}"
            )
        if s.max_samples_per_pixel % s.num_samples_per_pixel != 0:
            raise RenderParamsValidationError(
                "max_samples_per_pixel "
                f"({s.max_samples_per_pixel}) must be divisible by "
                f"num_samples_per_pixel ({s.num_samples_per_pixel})"
            )
        if s.num_bounces < 1:
            raise RenderParamsValidationError(
                f"num_bounces must be >= 1, got {s.num_bounces}"
            )
        w, h = self.viewport_size
        if w == 0 or h == 0:
            raise RenderParamsValidationError(
                f"viewport size must be nonzero, got {self.viewport_size}"
            )
        vfov = self.camera.vfov.as_degrees()
        if not (0.0 < vfov <= 90.0):
            raise RenderParamsValidationError(
                f"vfov must be in (0, 90] degrees, got {vfov}"
            )
        if not (0.0 <= self.camera.aperture <= 1.0):
            raise RenderParamsValidationError(
                f"aperture must be in [0, 1], got {self.camera.aperture}"
            )
        if self.camera.focus_distance <= 0.0:
            raise RenderParamsValidationError(
                f"focus_distance must be > 0, got {self.camera.focus_distance}"
            )
        sky = self.sky
        if not (0.0 <= sky.azimuth_degrees <= 360.0):
            raise RenderParamsValidationError(
                f"sky azimuth must be in [0, 360] degrees, got {sky.azimuth_degrees}"
            )
        if not (0.0 <= sky.zenith_degrees <= 90.0):
            raise RenderParamsValidationError(
                f"sky zenith must be in [0, 90] degrees, got {sky.zenith_degrees}"
            )
        if not (1.0 <= sky.turbidity <= 10.0):
            raise RenderParamsValidationError(
                f"sky turbidity must be in [1, 10], got {sky.turbidity}"
            )
        if any(not (0.0 <= a <= 1.0) for a in sky.albedo):
            raise RenderParamsValidationError(
                f"sky albedo components must be in [0, 1], got {sky.albedo}"
            )
