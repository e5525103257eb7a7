"""Thin-lens camera: logical parameters and the derived basis tensors.

Counterpart of weekend_raytracer_tpu/models/camera.py (reference Camera,
src/raytracer/mod.rs:487-541, and GpuCamera::new, mod.rs:699-741). The basis
is derived in float64 numpy on the host and stored as f32 tensors. The fused
kernels generate their own rays (csrc/bounce.cuh); ``make_rays`` generates
them for the ``"xla"`` backend (ops/tracer.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from .angle import Angle


@dataclasses.dataclass(frozen=True)
class Camera:
    """Logical camera: eye position/direction/up + lens parameters."""

    eye_pos: Tuple[float, float, float]
    eye_dir: Tuple[float, float, float]
    up: Tuple[float, float, float]
    vfov: Angle
    aperture: float
    focus_distance: float

    @staticmethod
    def look_at(
        eye: Tuple[float, float, float],
        target: Tuple[float, float, float],
        up: Tuple[float, float, float] = (0.0, 1.0, 0.0),
        vfov_degrees: float = 30.0,
        aperture: float = 0.0,
        focus_distance: float | None = None,
    ) -> "Camera":
        """Camera aimed at ``target``; the world-up hint is orthogonalized
        against the view direction (fly_camera.rs:236-239), since the basis
        derivation uses the stored up vector as given."""
        e = np.asarray(eye, dtype=np.float64)
        t = np.asarray(target, dtype=np.float64)
        d = t - e
        if focus_distance is None:
            focus_distance = float(np.linalg.norm(d))
        f = d / np.linalg.norm(d)
        right = np.cross(f, np.asarray(up, dtype=np.float64))
        right /= np.linalg.norm(right)
        up_ortho = np.cross(right, f)
        return Camera(
            eye_pos=tuple(float(x) for x in e),
            eye_dir=tuple(float(x) for x in d),
            up=tuple(float(x) for x in up_ortho),
            vfov=Angle.degrees(vfov_degrees),
            aperture=float(aperture),
            focus_distance=float(focus_distance),
        )


_BASIS_FIELDS = ("eye", "horizontal", "vertical", "u", "v", "lens_radius",
                 "lower_left_corner")


@dataclasses.dataclass(frozen=True)
class CameraBasis:
    """Camera basis tensors (reference GpuCamera, mod.rs:681-741).

    All fields are f32 tensors of shape [3] except lens_radius ([]).
    """

    eye: torch.Tensor
    horizontal: torch.Tensor
    vertical: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    lens_radius: torch.Tensor
    lower_left_corner: torch.Tensor

    @staticmethod
    def from_numpy(eye, horizontal, vertical, u, v, lens_radius,
                   lower_left_corner, *, device) -> "CameraBasis":
        """Basis from numpy arrays (the JAX package's CameraBasis leaves,
        in field order), stored as f32 on ``device``."""
        vals = (eye, horizontal, vertical, u, v, lens_radius, lower_left_corner)
        return CameraBasis(**{
            name: torch.as_tensor(np.array(a, dtype=np.float32), device=device)
            for name, a in zip(_BASIS_FIELDS, vals)
        })

    @staticmethod
    def create(camera: Camera, viewport: Tuple[int, int], *,
               device) -> "CameraBasis":
        """Derive the ray-generation basis (reference mod.rs:699-741).

        Computed in float64 on host for precision, stored as f32.
        """
        width, height = viewport
        lens_radius = 0.5 * camera.aperture
        aspect = float(width) / float(height)
        theta = camera.vfov.as_radians()
        half_height = camera.focus_distance * np.tan(0.5 * theta)
        half_width = aspect * half_height

        w = np.asarray(camera.eye_dir, dtype=np.float64)
        w = w / np.linalg.norm(w)
        v = np.asarray(camera.up, dtype=np.float64)
        v = v / np.linalg.norm(v)
        u = np.cross(w, v)

        eye = np.asarray(camera.eye_pos, dtype=np.float64)
        lower_left = eye + camera.focus_distance * w - half_width * u - half_height * v
        horizontal = 2.0 * half_width * u
        vertical = 2.0 * half_height * v
        return CameraBasis.from_numpy(
            eye, horizontal, vertical, u, v, lens_radius, lower_left,
            device=device)


def make_rays(
    basis: CameraBasis,
    su: torch.Tensor,
    sv: torch.Tensor,
    disk_r: torch.Tensor,
    disk_alpha: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Thin-lens camera rays for a batch of screen samples.

    Parity with cameraMakeRay (reference raytracer.wgsl:456-464) plus the
    unit-disk lens sample (wgsl:466-478). ``su``/``sv`` in [0, 1] are screen
    coordinates (sv already flipped by the caller, as wgsl:117 passes
    1 - v); ``disk_r``/``disk_alpha`` are uniform [0, 1) draws.

    Returns (origins [N, 3], directions [N, 3]); directions are normalized
    (the reference divides by dot(d, d) in the quadratic instead).
    """
    r = torch.sqrt(disk_r)
    alpha = (2.0 * math.pi) * disk_alpha
    lens_x = basis.lens_radius * r * torch.cos(alpha)
    lens_y = basis.lens_radius * r * torch.sin(alpha)

    offset = lens_x[:, None] * basis.u[None, :] + lens_y[:, None] * basis.v[None, :]
    origin = basis.eye[None, :] + offset
    direction = (
        basis.lower_left_corner[None, :]
        + su[:, None] * basis.horizontal[None, :]
        + sv[:, None] * basis.vertical[None, :]
        - origin
    )
    direction = direction / torch.linalg.vector_norm(direction, dim=-1, keepdim=True)
    return origin, direction
