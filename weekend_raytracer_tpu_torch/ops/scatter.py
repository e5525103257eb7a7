"""Material scatter: branchless evaluation of every material model.

Counterpart of weekend_raytracer_tpu/ops/scatter.py (the reference's
``scatterRay`` switch and its five scatter functions, raytracer.wgsl:174-314),
in plain PyTorch for the ``"xla"`` backend: lambertian (cosine-weighted
hemisphere through a Pixar orthonormal basis), metal (mirror + fuzz),
dielectric (refract or Schlick-reflect), checkerboard (3D-sine parity
between two lambertian albedos) and the aggressive-pink missing material.
Every branch is evaluated on every lane and selected by material id.

The JAX package's four fixes of reference bugs are kept: the dielectric
reflection branch assigns the reflected direction (wgsl:269-271 drops it);
Schlick is r0 + (1 - r0)(1 - cos)^5 (wgsl:294-298 raises the product);
unit-sphere sampling uses cos(theta) = 1 - 2u (wgsl:480-491 is
pole-biased); fuzz perturbs the normalized reflected direction.

Textures are sampled at full resolution from ``MaterialTable.pool``; the
fused kernels' mipped LUT (``budget_texels``) plays no part here.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..models.materials import (
    CHECKERBOARD,
    DIELECTRIC,
    EMISSIVE,
    ERROR_PINK,
    LAMBERTIAN,
    METAL,
    MaterialTable,
)

_EPSILON = 1.0e-3  # raytracer.wgsl:1
_PI = 3.14159265358979
_FRAC_1_PI = 1.0 / _PI


class ScatterResult(NamedTuple):
    direction: torch.Tensor  # [N, 3] unit
    albedo: torch.Tensor  # [N, 3] throughput multiplier
    emission: torch.Tensor  # [N, 3] radiance for terminating (emissive) hits
    terminate: torch.Tensor  # [N] bool: path ends at this hit (area light)


def texture_lookup(
    desc: torch.Tensor,  # i32 [N, 3] (width, height, offset)
    u: torch.Tensor,
    v: torch.Tensor,
    pool: torch.Tensor,  # f32 [P, 3]
) -> torch.Tensor:
    """Nearest-texel pool gather (textureLookup, wgsl:377-387), with the
    texel index clamped to the image (the reference's u32 cast can index
    one past the edge at u == 1). The casts truncate toward zero on
    clamped, non-negative values, as the JAX casts do."""
    w = desc[:, 0]
    h = desc[:, 1]
    off = desc[:, 2]
    uu = torch.clamp(u, 0.0, 1.0)
    vv = 1.0 - torch.clamp(v, 0.0, 1.0)
    j = torch.minimum((uu * w.to(torch.float32)).to(torch.int32), w - 1)
    i = torch.minimum((vv * h.to(torch.float32)).to(torch.int32), h - 1)
    idx = off + i * w + j
    return pool[idx.long()]


def pixar_onb(n: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Branchless orthonormal basis from a unit normal (pixarOnb,
    wgsl:233-242, after Duff et al. 2017). Returns tangents (u, v), [N, 3]."""
    s = torch.where(n[:, 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    u = torch.stack([1.0 + s * n[:, 0] * n[:, 0] * a, s * b, -s * n[:, 0]], dim=-1)
    v = torch.stack([b, s + n[:, 1] * n[:, 1] * a, -n[:, 1]], dim=-1)
    return u, v


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return d - 2.0 * (d * n).sum(-1, keepdim=True) * n


def unit_sphere_sample(u1, u2, u3) -> torch.Tensor:
    """Uniform point in the unit ball: r ~ u^(1/3), cos(theta) = 1 - 2u.
    (PyTorch has no cbrt; u1 >= 0, so u1^(1/3) is its value.)"""
    r = torch.pow(u1, 1.0 / 3.0)
    cos_t = 1.0 - 2.0 * u2
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = (2.0 * _PI) * u3
    return torch.stack(
        [r * sin_t * torch.cos(phi), r * sin_t * torch.sin(phi), r * cos_t], dim=-1)


def cosine_hemisphere_dir(n: torch.Tensor, r1, r2) -> torch.Tensor:
    """Cosine-weighted hemisphere direction about n (sampleLambertian,
    wgsl:214-227): z = sqrt(1 - r2), (x, y) on the sqrt(r2) circle."""
    sqrt_r2 = torch.sqrt(r2)
    z = torch.sqrt(torch.clamp(1.0 - r2, min=0.0))
    phi = (2.0 * _PI) * r1
    x = torch.cos(phi) * sqrt_r2
    y = torch.sin(phi) * sqrt_r2
    tu, tv = pixar_onb(n)
    return x[:, None] * tu + y[:, None] * tv + z[:, None] * n


def _lambertian_throughput(n, wi, albedo):
    """eval/pdf as the reference computes it (wgsl:204-231):
    (albedo/pi * max(eps, n.wi)) / max(eps, n.wi/pi)."""
    ndotwi = (n * wi).sum(-1)
    ev = _FRAC_1_PI * torch.clamp(ndotwi, min=_EPSILON)
    pdf = torch.clamp(ndotwi * _FRAC_1_PI, min=_EPSILON)
    return albedo * (ev / pdf)[:, None]


def _schlick(cosine, ior):
    r0 = (1.0 - ior) / (1.0 + ior)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * torch.pow(1.0 - cosine, 5.0)


def scatter(
    d: torch.Tensor,  # [N, 3] unit incoming direction
    n: torch.Tensor,  # [N, 3] outward hit normal
    p: torch.Tensor,  # [N, 3] hit point (checkerboard parity)
    u: torch.Tensor,  # [N] spherical u
    v: torch.Tensor,  # [N] spherical v
    mat_idx: torch.Tensor,  # [N] i32 per-lane material index
    table: MaterialTable,
    rands: Tuple[torch.Tensor, ...],  # 4 uniform [N] draws (r1, r2, r3, r4)
) -> ScatterResult:
    """Evaluate all material branches and select per lane by material id."""
    r1, r2, r3, r4 = rands
    m = mat_idx.long()
    mid = table.ids[m]  # [N] material model id
    x = table.x[m]  # [N] fuzz / ior
    tex1 = table.tex1[m]  # [N, 3]
    tex2 = table.tex2[m]

    albedo1 = texture_lookup(tex1, u, v, table.pool)
    albedo2 = texture_lookup(tex2, u, v, table.pool)

    # lambertian / checkerboard / missing share the diffuse direction
    diffuse_dir = cosine_hemisphere_dir(n, r1, r2)
    sphere_pt = unit_sphere_sample(r1, r2, r3)

    # checkerboard parity (wgsl:300-307)
    sines = torch.sin(5.0 * p[:, 0]) * torch.sin(5.0 * p[:, 1]) * torch.sin(5.0 * p[:, 2])
    checker_albedo = torch.where((sines < 0.0)[:, None], albedo1, albedo2)

    lam_thr = _lambertian_throughput(n, diffuse_dir, albedo1)
    chk_thr = _lambertian_throughput(n, diffuse_dir, checker_albedo)

    # metal (wgsl:244-248)
    refl = reflect(d, n)
    metal_dir = refl + x[:, None] * sphere_pt
    metal_thr = albedo1

    # dielectric (wgsl:250-298, with the intent fixes)
    ddotn = (d * n).sum(-1)
    front = ddotn < 0.0
    outward_n = torch.where(front[:, None], n, -n)
    eta = torch.where(front, 1.0 / x, x)
    cosine = torch.where(front, -ddotn, x * ddotn)
    dt = (d * outward_n).sum(-1)
    disc = 1.0 - eta * eta * (1.0 - dt * dt)
    can_refract = disc > 0.0
    refr = (eta[:, None] * (d - dt[:, None] * outward_n)
            - torch.sqrt(torch.clamp(disc, min=0.0))[:, None] * outward_n)
    reflect_prob = torch.where(
        can_refract, _schlick(torch.clamp(cosine, 0.0, 1.0), x), 1.0)
    use_reflect = r4 < reflect_prob
    diel_dir = torch.where(use_reflect[:, None], refl, refr)
    diel_thr = torch.ones_like(metal_thr)

    # missing material (wgsl:309-314)
    miss_dir = n + sphere_pt
    # filled on the device: a tensor made from host data would be a
    # synchronizing copy on every bounce
    miss_thr = torch.stack([torch.full_like(x, c) for c in ERROR_PINK], dim=-1)

    def sel(id_, yes_dir, yes_thr, no_dir, no_thr):
        pick = (mid == id_)[:, None]
        return torch.where(pick, yes_dir, no_dir), torch.where(pick, yes_thr, no_thr)

    direction, thr = miss_dir, miss_thr
    direction, thr = sel(CHECKERBOARD, diffuse_dir, chk_thr, direction, thr)
    direction, thr = sel(DIELECTRIC, diel_dir, diel_thr, direction, thr)
    direction, thr = sel(METAL, metal_dir, metal_thr, direction, thr)
    direction, thr = sel(LAMBERTIAN, diffuse_dir, lam_thr, direction, thr)

    # emissive area light: the path ends with x * albedo radiance
    terminate = mid == EMISSIVE
    emission = x[:, None] * albedo1

    norm = torch.linalg.vector_norm(direction, dim=-1, keepdim=True)
    direction = direction / torch.clamp(norm, min=1.0e-12)
    return ScatterResult(direction=direction, albedo=thr, emission=emission,
                         terminate=terminate)
