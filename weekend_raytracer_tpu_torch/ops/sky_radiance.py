"""Sky radiance: the Hosek-Wilkie-form distribution, vectorized.

Counterpart of weekend_raytracer_tpu/ops/sky_radiance.py (the reference
shader's ``radiance()``, raytracer.wgsl:316-343, and its call site on a
miss, wgsl:154-167), in plain PyTorch for the ``"xla"`` backend: the
per-channel 9-parameter extended-Perez distribution at (theta = angle from
the zenith, gamma = angle from the sun), scaled by a per-channel radiance.
"""
from __future__ import annotations

import torch

from ..models.sky import SkyState


def sky_radiance(directions: torch.Tensor, sky: SkyState) -> torch.Tensor:
    """Radiance [N, 3] for unit ray directions [N, 3] that missed the scene.

    cos(gamma) is an elementwise product and sum, not a matmul, so it stays
    exact f32 whatever ``torch.backends.cuda.matmul.allow_tf32`` says.
    """
    v = directions
    s = sky.sun_direction
    theta = torch.arccos(torch.clamp(v[..., 1], -1.0, 1.0))
    gamma = torch.arccos(torch.clamp((v * s).sum(-1), -1.0, 1.0))
    return sky_radiance_angles(theta, gamma, sky)


def sky_radiance_angles(theta: torch.Tensor, gamma: torch.Tensor,
                        sky: SkyState) -> torch.Tensor:
    """Evaluate the 9-parameter distribution for all 3 channels; [..., 3].

    theta and gamma are [...]-shaped and broadcast against params [3, 9].
    """
    p = sky.params  # [3, 9]
    t = theta[..., None]  # [..., 1]
    g = gamma[..., None]

    cos_gamma = torch.cos(g)
    cos_gamma2 = cos_gamma * cos_gamma
    cos_theta = torch.abs(torch.cos(t))

    p0, p1, p2 = p[:, 0], p[:, 1], p[:, 2]
    p3, p4, p5 = p[:, 3], p[:, 4], p[:, 5]
    p6, p7, p8 = p[:, 6], p[:, 7], p[:, 8]

    exp_m = torch.exp(p4 * g)
    ray_m = cos_gamma2
    mie_lhs = 1.0 + cos_gamma2
    mie_rhs = torch.pow(1.0 + p8 * p8 - 2.0 * p8 * cos_gamma, 1.5)
    mie_m = mie_lhs / mie_rhs
    zenith = torch.sqrt(cos_theta)

    lhs = 1.0 + p0 * torch.exp(p1 / (cos_theta + 0.01))
    rhs = p2 + p3 * exp_m + p5 * ray_m + p6 * mie_m + p7 * zenith
    return sky.radiances * lhs * rhs
