"""Sphere scene geometry as structure-of-arrays tensors.

Counterpart of weekend_raytracer_tpu/models/spheres.py (reference Sphere,
src/raytracer/mod.rs:418-431): spheres are SoA f32 tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Sphere:
    """Host-side sphere description (reference Sphere::new, mod.rs:423-431)."""

    center: Tuple[float, float, float]
    radius: float
    material_idx: int


@dataclasses.dataclass(frozen=True)
class SphereSoA:
    """Sphere tensors: centers [S,3] f32, radii [S] f32, mats [S] i32."""

    centers: torch.Tensor
    radii: torch.Tensor
    material_idx: torch.Tensor

    @property
    def num_spheres(self) -> int:
        return int(self.centers.shape[0])

    @property
    def device(self) -> torch.device:
        return self.centers.device

    @staticmethod
    def from_numpy(centers, radii, material_idx, *, device) -> "SphereSoA":
        """SoA from numpy arrays (the JAX package's SphereSoA leaves)."""
        return SphereSoA(
            centers=torch.as_tensor(
                np.array(centers, dtype=np.float32).reshape(-1, 3), device=device),
            radii=torch.as_tensor(
                np.array(radii, dtype=np.float32).reshape(-1), device=device),
            material_idx=torch.as_tensor(
                np.array(material_idx, dtype=np.int32).reshape(-1),
                device=device),
        )

    @staticmethod
    def build(spheres: Sequence[Sphere], pad_to: int | None = None, *,
              device) -> "SphereSoA":
        """Lower a sphere list to SoA tensors on ``device``.

        ``pad_to`` optionally pads to a fixed size with impossible-to-hit
        spheres (radius 0 at a far distance).
        """
        centers = np.asarray([s.center for s in spheres], dtype=np.float32)
        radii = np.asarray([s.radius for s in spheres], dtype=np.float32)
        mats = np.asarray([s.material_idx for s in spheres], dtype=np.int32)
        n = len(spheres)
        if pad_to is not None and pad_to > n:
            pad = pad_to - n
            centers = np.concatenate(
                [centers, np.full((pad, 3), 1.0e8, dtype=np.float32)], axis=0
            )
            radii = np.concatenate([radii, np.zeros((pad,), dtype=np.float32)])
            mats = np.concatenate([mats, np.zeros((pad,), dtype=np.int32)])
        return SphereSoA.from_numpy(centers, radii, mats, device=device)
