"""The scene container the renderer and the fused kernel take.

Counterpart of weekend_raytracer_tpu/ops/tracer.py. Only ``Scene`` is
ported so far; the XLA wavefront tracer (``trace_paths``, ``render_pixels``,
``render_image``) waits for the ``"xla"`` backend (ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.materials import MaterialTable
from ..models.spheres import SphereSoA


@dataclasses.dataclass(frozen=True)
class Scene:
    """Sphere SoA + material table (reference Scene, mod.rs:413-416)."""

    spheres: SphereSoA
    materials: MaterialTable

    @property
    def device(self) -> torch.device:
        return self.spheres.device

    @staticmethod
    def from_numpy(spheres: dict, materials: dict, device) -> "Scene":
        """Scene from the JAX package's leaves as numpy arrays, keyed by
        field name: ``spheres`` holds centers, radii and material_idx;
        ``materials`` holds ids, tex1, tex2, x, pool, albedo1 and albedo2.
        Both packages then render the same scene data."""
        return Scene(
            spheres=SphereSoA.from_numpy(**spheres, device=device),
            materials=MaterialTable.from_numpy(**materials, device=device),
        )
