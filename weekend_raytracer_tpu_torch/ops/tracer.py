"""The scene container, and the batched path tracer of the ``"xla"`` backend.

Counterpart of weekend_raytracer_tpu/ops/tracer.py. ``Scene`` is what every
backend takes. ``trace_paths``, ``render_pixels`` and ``render_image`` are
the JAX package's jitted-XLA reference path in plain PyTorch: SoA ray state
for a batch of pixels, a Python loop over samples and, inside it, over
bounce depth (dead lanes masked, never compacted), each bounce a
chunk-scanned brute-force closest hit (ops/intersect.py), the branchless
material scatter (ops/scatter.py) and the sky on a miss
(ops/sky_radiance.py). It launches none of the port's CUDA kernels: it is
an independent reference for them, and the full-resolution texture path.
Every tensor stays on the device of the accumulator.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..models.camera import CameraBasis, make_rays
from ..models.materials import MaterialTable
from ..models.sky import SkyState
from ..models.spheres import SphereSoA
from . import rng
from .intersect import hit_record, intersect
from .scatter import scatter
from .sky_radiance import sky_radiance


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


def trace_paths(
    o: torch.Tensor,  # [N, 3]
    d: torch.Tensor,  # [N, 3] unit
    states: torch.Tensor,  # [N] uint32 rng states (in int64, ops/rng.py)
    scene: Scene,
    sky: SkyState,
    num_bounces: int,
    sphere_chunk: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trace one path per lane; returns (radiance [N, 3], rng states).

    Mirrors rayColor (wgsl:124-172): multiply the throughput on a scatter,
    take the sky radiance and stop on a miss. Ended lanes are masked; a
    path that never misses within the bounce budget returns 0, as in the
    reference.
    """
    n_lanes = o.shape[0]
    throughput = torch.ones((n_lanes, 3), dtype=torch.float32, device=o.device)
    color = torch.zeros((n_lanes, 3), dtype=torch.float32, device=o.device)
    alive = torch.ones((n_lanes,), dtype=torch.bool, device=o.device)
    for _ in range(num_bounces):
        t, sidx, hit = intersect(o, d, scene.spheres, chunk_size=sphere_chunk)
        p, n, u, v = hit_record(o, d, t, sidx, scene.spheres)
        mat_idx = scene.spheres.material_idx[sidx.long()]

        states, rands = rng.next_floats(states, 4)
        sc = scatter(d, n, p, u, v, mat_idx, scene.materials, rands)

        sky_rgb = sky_radiance(d, sky)

        active_hit = alive & hit
        miss_now = alive & ~hit
        lit = active_hit & sc.terminate  # an emissive hit ends the path
        scattering = active_hit & ~sc.terminate

        throughput = torch.where(scattering[:, None], throughput * sc.albedo, throughput)
        color = torch.where(miss_now[:, None], sky_rgb, color)
        color = torch.where(lit[:, None], sc.emission, color)
        o = torch.where(scattering[:, None], p, o)
        d = torch.where(scattering[:, None], sc.direction, d)
        alive = scattering
    return throughput * color, states


def render_pixels(
    pixel_idx: torch.Tensor,  # [N] flat pixel indices (y * width + x)
    frame,  # u32 frame number (int)
    scene: Scene,
    sky: SkyState,
    basis: CameraBasis,
    width: int,
    height: int,
    spp: int,
    num_bounces: int,
    sphere_chunk: int = 512,
) -> torch.Tensor:
    """Sum of ``spp`` sample radiances for each pixel lane ([N, 3]).

    Mirrors fsMain + samplePixel (wgsl:50-122): per-pixel, per-frame,
    per-sample RNG seeding (ops/rng.init_sample_state), jittered screen
    positions, thin-lens camera rays, v flipped (wgsl:117 passes 1 - v).
    """
    dev = pixel_idx.device
    pixel_idx = pixel_idx.to(torch.int64)
    x = (pixel_idx % width).to(torch.float32)
    y = (pixel_idx // width).to(torch.float32)
    inv_w = 1.0 / float(width)
    inv_h = 1.0 / float(height)
    # the frame and sample numbers are made on the device: a tensor copied
    # from the host would synchronize the stream every sample
    frame_t = torch.full((), int(frame), dtype=torch.int64, device=dev)
    samples = torch.arange(spp, dtype=torch.int64, device=dev)
    acc = torch.zeros((pixel_idx.shape[0], 3), dtype=torch.float32, device=dev)
    for s in range(spp):
        states = rng.init_sample_state(pixel_idx, frame_t, samples[s])
        states, (ju, jv, dr, da) = rng.next_floats(states, 4)
        su = (x + ju) * inv_w
        sv = 1.0 - (y + jv) * inv_h
        o, d = make_rays(basis, su, sv, dr, da)
        radiance, _ = trace_paths(o, d, states, scene, sky, num_bounces, sphere_chunk)
        acc = acc + radiance
    return acc


def render_image(
    accum: torch.Tensor,  # [H*W, 3] f32, updated in place
    frame,  # u32 frame number (int)
    clear,  # bool: reset the accumulation first
    scene: Scene,
    sky: SkyState,
    basis: CameraBasis,
    width: int,
    height: int,
    spp: int,
    num_bounces: int,
    pixel_batch: Optional[int] = None,
    sphere_chunk: int = 512,
) -> torch.Tensor:
    """One progressive frame over the whole image, added into ``accum`` in
    place (cleared first when ``clear``); returns ``accum``.

    Pixels go in batches of ``pixel_batch`` (all at once for None) to bound
    the [lanes x sphere_chunk] intersection intermediates; the last batch
    is the remainder. No pixel's result depends on the batching.
    """
    n = width * height
    if clear:
        accum.zero_()
    step = n if pixel_batch is None else min(pixel_batch, n)
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        idx = torch.arange(lo, hi, dtype=torch.int64, device=accum.device)
        accum[lo:hi] += render_pixels(idx, frame, scene, sky, basis, width, height,
                                      spp, num_bounces, sphere_chunk)
    return accum
