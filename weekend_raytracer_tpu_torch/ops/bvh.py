"""Morton-ordered sphere chunks and their AABBs.

Counterpart of weekend_raytracer_tpu/ops/bvh.py, bit for bit: spheres are
sorted along a 30-bit Morton curve, grouped into fixed-size chunks, each
chunk (and each super-chunk of chunks) bounded by an AABB. Every step is
elementwise f32 arithmetic, an exact min/max reduction, or a stable sort,
so the arrays do not depend on the device they are built on.

Regroup's K0 and K1 (csrc/regroup.cu) cull their sweep per warp with
these chunk and super-chunk boxes and the priors; the megakernel and the
wavefront sweep every sphere, and the kStats kernels count the TPU's
whole-tile cull decisions on them (csrc/stats.cuh).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits out to every 3rd bit (standard Morton interleave)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_codes(cx, cy, cz, lo, hi) -> torch.Tensor:
    """30-bit Morton codes (int64) for points quantized into [lo, hi]^3."""
    span = torch.clamp(hi - lo, min=1e-6)

    def q(v, i):
        cell = torch.clamp((v - lo[i]) / span[i] * 1024.0, 0.0, 1023.0)
        return cell.to(torch.int64)

    return (
        _part1by2(q(cx, 0))
        | (_part1by2(q(cy, 1)) << 1)
        | (_part1by2(q(cz, 2)) << 2)
    )


def percentile(x: torch.Tensor, p: float) -> torch.Tensor:
    """Linear-interpolation percentile with jnp.percentile's f32
    arithmetic: q = p/100, pos = q (n-1), lo/hi = floor/ceil(pos),
    result = x[lo] (1 - w) + x[hi] w with w = pos - lo."""
    f32 = torch.float32
    n = x.shape[0]
    q = torch.tensor(p, dtype=f32) / 100.0
    pos = q * torch.tensor(n - 1, dtype=f32)
    lo = torch.floor(pos)
    hi = torch.ceil(pos)
    hw = pos - lo
    lw = 1.0 - hw
    xs = torch.sort(x).values
    i_lo = int(torch.clamp(lo, 0, n - 1))
    i_hi = int(torch.clamp(hi, 0, n - 1))
    return xs[i_lo] * lw.to(x.device) + xs[i_hi] * hw.to(x.device)


class ChunkedScene(NamedTuple):
    """Morton-sorted per-sphere attributes + per-chunk AABBs.

    attrs: tuple of (S_pad,) f32 tensors (cx, cy, cz, rad, mid, mx, a1r,
           a1g, a1b, a2r, a2g, a2b [, texture descriptors]), sorted and
           padded by duplicating the last sphere (harmless for closest-hit).
    bounds: 6 (NC,) f32 tensors (lox, loy, loz, hix, hiy, hiz).
    """

    attrs: Tuple[torch.Tensor, ...]
    bounds: Tuple[torch.Tensor, ...]


def order_front_to_back(scene: ChunkedScene, eye: torch.Tensor,
                        chunk_size: int) -> ChunkedScene:
    """Reorder whole chunks by distance from the camera eye (a pure
    permutation: near chunks first tighten best-t early under culling)."""
    lox, loy, loz, hix, hiy, hiz = scene.bounds
    cx = 0.5 * (lox + hix)
    cy = 0.5 * (loy + hiy)
    cz = 0.5 * (loz + hiz)
    ex, ey, ez = cx - eye[0], cy - eye[1], cz - eye[2]
    d2 = ex * ex + ey * ey + ez * ez
    order = torch.argsort(d2, stable=True)
    sphere_order = (order[:, None] * chunk_size
                    + torch.arange(chunk_size, device=order.device)[None, :]
                    ).reshape(-1)
    return ChunkedScene(
        attrs=tuple(a[sphere_order] for a in scene.attrs),
        bounds=tuple(b[order] for b in scene.bounds),
    )


def super_bounds(scene: ChunkedScene, super_factor: int):
    """Level-2 AABBs over groups of ``super_factor`` chunks.

    Returns (chunk_bounds_padded, super_bounds): 6 (NCP,) and 6 (NSC,)
    tensors; the chunk count is padded to a multiple of super_factor with
    zero-extent boxes at a far point (lo == hi == 1e9), which no ray within
    MAX_T can enter (an inverted box would pass a min/max slab test).
    """
    nc = scene.bounds[0].shape[0]
    pad = (-nc) % super_factor
    far = 1.0e9
    padded = tuple(
        torch.cat([b, torch.full((pad,), far, dtype=b.dtype, device=b.device)])
        for b in scene.bounds
    )
    nsc = (nc + pad) // super_factor

    def g(a):
        return a.reshape(nsc, super_factor)

    supers = tuple(
        [g(b).amin(dim=1) for b in padded[:3]]
        + [g(b).amax(dim=1) for b in padded[3:]]
    )
    return padded, supers


def build_chunks(attrs: Tuple[torch.Tensor, ...],
                 chunk_size: int) -> ChunkedScene:
    """Sort spheres along the Morton curve and bound fixed-size chunks.

    Quantization bounds use the 5th/95th percentiles, so a huge ground
    sphere doesn't collapse everyone else's codes; outliers land in edge
    cells and their chunk bound grows to cover them.
    """
    cx, cy, cz = attrs[0], attrs[1], attrs[2]
    lo = torch.stack([percentile(cx, 5), percentile(cy, 5),
                      percentile(cz, 5)])
    hi = torch.stack([percentile(cx, 95), percentile(cy, 95),
                      percentile(cz, 95)])
    codes = morton_codes(cx, cy, cz, lo, hi)
    order = torch.argsort(codes, stable=True)
    attrs = tuple(a[order] for a in attrs)

    s = attrs[0].shape[0]
    pad = (-s) % chunk_size
    if pad:
        attrs = tuple(torch.cat([a, a[-1:].expand(pad)]) for a in attrs)
    cx, cy, cz, rad = attrs[0], attrs[1], attrs[2], attrs[3]
    nc = cx.shape[0] // chunk_size

    def g(a):
        return a.reshape(nc, chunk_size)

    gx, gy, gz = g(cx), g(cy), g(cz)
    # |rad|: negative radii (hollow-glass shells) still bound by magnitude
    gr = torch.abs(g(rad))
    bounds = (
        (gx - gr).amin(dim=1), (gy - gr).amin(dim=1), (gz - gr).amin(dim=1),
        (gx + gr).amax(dim=1), (gy + gr).amax(dim=1), (gz + gr).amax(dim=1),
    )
    return ChunkedScene(attrs=attrs, bounds=bounds)
