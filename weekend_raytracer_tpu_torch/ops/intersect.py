"""Ray-sphere intersection: vectorized closest-hit over sphere chunks.

Counterpart of weekend_raytracer_tpu/ops/intersect.py (reference
raytracer.wgsl:137-145 closest-hit loop, rayIntersectSphere wgsl:407-429,
sphereIntersection wgsl:431-440), in plain PyTorch for the ``"xla"``
backend. Intersection is a [rays x chunk] broadcast with a running
(min t, argmin) carried over sphere chunks, in the ``oc = o - c`` form of
the quadratic (a = 1: directions are unit vectors). The fused kernels keep
their own sweep (csrc/bounce.cuh); this module shares nothing with them.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..models.spheres import SphereSoA

MIN_T = 1.0e-3  # raytracer.wgsl:7
MAX_T = 1.0e3  # raytracer.wgsl:8

_PI = 3.14159265358979
_FRAC_1_PI = 1.0 / _PI


def _chunk_hit_t(
    o: torch.Tensor,  # [N, 3]
    d: torch.Tensor,  # [N, 3]
    centers: torch.Tensor,  # [C, 3]
    radii: torch.Tensor,  # [C]
) -> torch.Tensor:
    """Per-(ray, sphere) hit parameter t in (MIN_T, MAX_T), else MAX_T.

    Prefers the nearer root and falls back to the farther one if the nearer
    is out of range (wgsl:414-426).
    """
    oc = o[:, None, :] - centers[None, :, :]  # [N, C, 3]
    b = (oc * d[:, None, :]).sum(-1)  # [N, C]
    c = (oc * oc).sum(-1) - (radii * radii)[None, :]
    disc = b * b - c
    hit = disc > 0.0
    sq = torch.sqrt(torch.where(hit, disc, 0.0))
    t_near = -b - sq
    t_far = -b + sq
    near_ok = hit & (t_near > MIN_T) & (t_near < MAX_T)
    far_ok = hit & (t_far > MIN_T) & (t_far < MAX_T)
    return torch.where(near_ok, t_near, torch.where(far_ok, t_far, MAX_T))


def _min_argmin(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row minimum and the first index that holds it (``torch.argmin``
    returns the first minimal index, as ``jnp.argmin`` does)."""
    idx = torch.argmin(t, dim=-1)
    return t.gather(-1, idx[:, None])[:, 0], idx.to(torch.int32)


def intersect(
    o: torch.Tensor,
    d: torch.Tensor,
    spheres: SphereSoA,
    chunk_size: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closest hit over the whole scene.

    Returns (t [N] f32, MAX_T on a miss; sphere_idx [N] i32, 0 on a miss;
    hit [N] bool). Scans the spheres in chunks of ``chunk_size`` to bound
    the [N, C] intermediates, keeping the running (min t, argmin) with a
    strict ``<``, so the earlier chunk wins a tie.
    """
    n_spheres = spheres.centers.shape[0]
    if n_spheres <= chunk_size:
        best_t, best_idx = _min_argmin(
            _chunk_hit_t(o, d, spheres.centers, spheres.radii))
        return best_t, best_idx, best_t < MAX_T

    # Pad to a multiple of chunk_size with unhittable spheres.
    pad = (-n_spheres) % chunk_size
    dev = spheres.centers.device
    centers = torch.cat([spheres.centers,
                         torch.full((pad, 3), 1.0e8, dtype=torch.float32, device=dev)])
    radii = torch.cat([spheres.radii, torch.zeros((pad,), dtype=torch.float32, device=dev)])
    best_t = torch.full(o.shape[:1], MAX_T, dtype=torch.float32, device=o.device)
    best_idx = torch.zeros(o.shape[:1], dtype=torch.int32, device=o.device)
    for base in range(0, centers.shape[0], chunk_size):
        ct, ci = _min_argmin(_chunk_hit_t(o, d, centers[base:base + chunk_size],
                                          radii[base:base + chunk_size]))
        better = ct < best_t
        best_t = torch.where(better, ct, best_t)
        best_idx = torch.where(better, ci + base, best_idx)
    return best_t, best_idx, best_t < MAX_T


def hit_record(
    o: torch.Tensor,
    d: torch.Tensor,
    t: torch.Tensor,
    sphere_idx: torch.Tensor,
    spheres: SphereSoA,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Derive (p [N,3], n [N,3], u [N], v [N]) from a closest hit.

    Mirrors sphereIntersection (wgsl:431-440): the normal (p - c) / r (a
    negative radius flips it, the RTiOW hollow-glass trick), and spherical
    UVs u = phi / 2pi, v = theta / pi with theta = acos(-n.y),
    phi = atan2(-n.z, n.x) + pi.
    """
    idx = sphere_idx.long()
    c = spheres.centers[idx]  # [N, 3]
    r = spheres.radii[idx]  # [N]
    p = o + t[:, None] * d
    n = (p - c) / torch.where(r == 0.0, 1.0, r)[:, None]
    theta = torch.arccos(torch.clamp(-n[:, 1], -1.0, 1.0))
    phi = torch.atan2(-n[:, 2], n[:, 0]) + _PI
    u = 0.5 * _FRAC_1_PI * phi
    v = _FRAC_1_PI * theta
    return p, n, u, v
