"""The fused path-tracing megakernel: host prep, CUDA wrapper, plain twin.

Counterpart of weekend_raytracer_tpu/ops/pallas/megakernel.py. The kernel
itself is CUDA C++ for Hopper (csrc/megakernel.cu, replacing the TPU
kernel ``_make_kernel`` / ``_make_bounce`` launched at megakernel.py:1713);
see that file for what bounds it on the card and how its design answers.

- Host prep (``pack_camera``, ``pack_sky``, ``build_kernel_texture_pool``,
  ``default_chunk_size``, ``prepare_scene_arrays``) builds the same arrays
  as the JAX functions of the same names, bit for bit, except the
  winner-retrieval LUT, which is a TPU lane-gather workaround: a CUDA thread
  reads its winner's attributes directly.
- ``render_image_megakernel`` is the counterpart of ``render_image_pallas``:
  one progressive frame, accumulated in place into ``accum``. On a CUDA
  tensor it launches the kernel or raises; on a CPU tensor it runs
  ``render_image_megakernel_plain``. The kernel culls its sweep per warp
  and refills each lane's samples (csrc/megakernel.cu); neither changes a
  bit of the frame, which the plain version computes with the full sweep,
  one sample after another.
- ``render_image_megakernel_plain`` is the same computation in plain
  PyTorch, vectorized over pixels, for the CPU tests and for holding the
  kernel to it on the card.
- ``stats=True`` (kernel #2, ``_make_kernel(stats=True)``) also returns the
  TPU kernel's per-tile cull counters: the CUDA stats kernel counts them on
  the card (csrc/stats.cuh), sweeping every sphere from a table staged in
  shared memory (in windows, ``stats_plan``) with each lane's samples
  refilled as the culled kernel's are; ``CullStats`` in the twin.
- ``mxu_sweep`` (the JAX package's knob, megakernel.py:1681-1708) runs the
  culled chunk sweep's products on the tensor cores: ``kernel_inputs(...,
  mxu_sweep=True)`` builds the per-chunk A table (``mxu_sweep_amats``), and
  a kernel whose inputs carry it takes its ``kMxu`` instantiation where the
  JAX condition holds (``mxu_route``); its twin is ``_closest_hit_mxu``.
  Statistically equivalent to the FMA sweep, not bit-identical.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ...models import materials as _mat
from ...models.camera import CameraBasis
from ...models.sky import SkyState
from .. import rng
from ..bvh import build_chunks, order_front_to_back, super_bounds
from ..intersect import MAX_T, MIN_T
from ..tracer import Scene
from .build import load_library

N_PRIORS = 4  # largest-|radius| spheres (the TPU kernel seeds best-t with them)
# The per-warp cull of regroup K0 and K1 and the megakernel (csrc/bounce.cuh
# sweep_culled, cull.py) tests each box widened by a margin of the lane's own,
#     m = cull_scale * (|o| + cull_reach)^2, where
#     cull_reach = max(|c| + |r|), cull_scale = CULL_MARGIN_ULPS * u / min |r|
# over the spheres that are not priors (a prior's hit joins after the
# sweep, whatever the cull skips), u = 2^-24. Why that holds, to first
# order in u, for a ray (o, d) and a sphere (c, r), with L = |o| + |c| + |r|:
#  - cq = oo - co2 + kq carries the rounding of two dot products, two sums
#    and kq = |c|^2 - r^2: |dcq| <= 6u L^2. bq = cd - od: |dbq| <= 4u L.
#    d = v / sqrtf(|v|^2) has |d|^2 = 1 within 10u.
#  - The computed root t (t <= L) solves t^2 - 2 bq t + cq = 0 up to a
#    residual of 6u L^2 (the rounding of disc, sqrtf and bq +- sq). So the
#    point p = o + t d of the exact ray has |p - c|^2 - r^2 = E with
#    |E| <= |dcq| + 2t |dbq| + t^2 ||d|^2 - 1| + 6u L^2 <= 30u L^2.
#  - Outside the sphere |p - c| >= r, so p lies within E / 2r <= 15u L^2 / r
#    of it, and so of its chunk's box, whose f32 faces are off by uL at most.
#  - The slab test's rounding ((b -+ m - o) * inv, inv) moves its tnear
#    and tfar by 3u t at most, and the widened face by u (|b| + m).
# So a box widened by 20u L^2 / r (each uL is at most uL^2 / r) holds, with
# room for the slab test, every hit the full sweep can take: there tfar >
# MIN_T and tnear < the lane's bound. 32 leaves 60% for the terms of higher
# order. With the exact boxes (scale 0) the cull parts from the full sweep
# on random_spheres(10000), on rays that leave a small sphere at its box's
# face and hit it again just past MIN_T (tests/test_torch_cull.py).
CULL_MARGIN_ULPS = 32.0
DEFAULT_TEXTURE_BUDGET = 8192  # texels per texture in the kernel's LUT

EPS = 1.0e-3
PI = 3.14159265358979
HALF_PI = 0.5 * PI
FRAC_1_PI = 1.0 / PI
TWO_PI = 2.0 * PI

_F32 = torch.float32
# the plain version's batch sizes: rays per pixel block and spheres per
# sweep block bound its [rays, spheres] temporaries to 16 MiB each
_PIXEL_BLOCK = 1 << 16
_SPHERE_BLOCK = 64
_STATS_RAYS = 4096  # rays per batch of the plain cull tests


# --------------------------------------------------------------------------
# Host prep (megakernel.py:1318-1526)
# --------------------------------------------------------------------------

def pack_camera(basis: CameraBasis) -> torch.Tensor:
    """Camera basis as the 20-float vector the kernel reads."""
    return torch.cat([
        basis.eye, basis.horizontal, basis.vertical, basis.u, basis.v,
        basis.lower_left_corner, basis.lens_radius.reshape(1),
        torch.zeros((1,), dtype=_F32, device=basis.eye.device),
    ]).to(_F32)


def pack_sky(sky: SkyState) -> torch.Tensor:
    """Sky state as the 33-float vector (27 params + 3 radiances + sun
    direction)."""
    return torch.cat([
        sky.params.reshape(27), sky.radiances, sky.sun_direction
    ]).to(_F32)


def _box_mean(tex: torch.Tensor, s: int) -> torch.Tensor:
    """Mean over s x s texel blocks, summed in the order XLA's reduction
    uses (block row outer, block column inner), so the mip is bit-equal
    to the JAX package's ``reshape(...).mean((1, 3))``."""
    h, w = tex.shape[0], tex.shape[1]
    t = tex.reshape(h // s, s, w // s, s, 3)
    acc = t[:, 0, :, 0, :].clone()
    for i in range(s):
        for j in range(s):
            if i or j:
                acc = acc + t[:, i, :, j, :]
    return acc / float(s * s)


def build_kernel_texture_pool(mat, budget_texels: int = DEFAULT_TEXTURE_BUDGET):
    """Pack the image textures into the kernel's LUT pool.

    Each image texture is mipped (box filter, or strided sampling when the
    scale doesn't divide) until w*h <= budget_texels, quantized to packed
    RGB8 int32, and laid out row-major in 128-texel rows aligned to row
    boundaries (megakernel.py:1335-1401).

    Returns (pool [rows,128] i32, desc1 [M,3] f32, desc2 [M,3] f32) where a
    descriptor is (base_row, kernel_w, kernel_h), base_row = -1 for solid
    textures; or None when no material has an image texture.
    """
    meta = mat.tex_meta
    if not meta:
        return None
    dev = mat.pool.device
    kern_descs = {}  # (w, h, off) -> (base_row, wk, hk)
    chunks = []
    next_row = 0
    for d1, d2 in meta:
        for d in (d1, d2):
            w, h, off = d
            if w * h <= 1 or d in kern_descs:
                continue
            k = 0
            while (w >> k) * (h >> k) > budget_texels:
                k += 1
            s = 1 << k
            tex = mat.pool[off:off + w * h].reshape(h, w, 3)
            if k:
                if w % s == 0 and h % s == 0:
                    tex = _box_mean(tex, s)
                else:
                    tex = tex[::s, ::s]
            hk, wk = int(tex.shape[0]), int(tex.shape[1])
            q = (torch.clamp(tex, 0.0, 1.0) * 255.0 + 0.5).to(torch.int32)
            packed = (q[..., 0] << 16) | (q[..., 1] << 8) | q[..., 2]
            flat = packed.reshape(-1)
            pad = (-flat.shape[0]) % 128
            if pad:
                flat = torch.cat([flat, flat.new_zeros(pad)])
            kern_descs[d] = (next_row, wk, hk)
            chunks.append(flat)
            next_row += flat.shape[0] // 128
    if not chunks:
        return None
    pool = torch.cat(chunks).reshape(-1, 128)
    pad_rows = (-pool.shape[0]) % 8
    if pad_rows:
        pool = torch.cat([pool, pool.new_zeros((pad_rows, 128))])

    def desc_arr(slot):
        out = np.full((len(meta), 3), -1.0, np.float32)
        for m, pair in enumerate(meta):
            d = pair[slot]
            if d in kern_descs:
                base, wk, hk = kern_descs[d]
                out[m] = (float(base), float(wk), float(hk))
        return torch.as_tensor(out, device=dev)

    return pool, desc_arr(0), desc_arr(1)


def mxu_sweep_amats(s_attrs, chunk_size: int, n_chunks: int) -> torch.Tensor:
    """Per-chunk A matrices of the MXU chunk sweep (megakernel.py:1529-1545),
    equal to the JAX array in every bit: (n_chunks, 8, 2 * chunk_size) f32
    whose columns [0, cs) hold C^T in rows 0-2 (dotted against the ray
    direction) and columns [cs, 2cs) hold -2 C^T in rows 3-5 and kq = |c|^2 -
    r^2 in row 6 (dotted against [o; 1]); row 7 is zero. One product per ray
    then gives c.d and -2 c.o + kq of every sphere of the chunk."""
    cx, cy, cz, kq = s_attrs[0], s_attrs[1], s_attrs[2], s_attrs[-1]
    cs = chunk_size
    c3 = torch.stack([cx, cy, cz], 0).reshape(3, n_chunks, cs).permute(1, 0, 2)
    a = torch.zeros((n_chunks, 8, 2 * cs), dtype=_F32, device=cx.device)
    a[:, 0:3, :cs] = c3
    a[:, 3:6, cs:] = -2.0 * c3
    a[:, 6, cs:] = kq.reshape(n_chunks, cs)
    return a


# The scene size from which the MXU chunk sweep defaults on (the JAX
# package's constant, megakernel.py:1295-1302): None, never.
MXU_DEFAULT_MIN_SPHERES: Optional[int] = None


def _default_mxu_sweep(n_spheres: Optional[int] = None) -> bool:
    """Default for the MXU chunk sweep (megakernel.py:1305-1315):
    WRT_MXU_SWEEP=0/1 forces either way; otherwise scenes of at least
    MXU_DEFAULT_MIN_SPHERES spheres default on once that constant is set."""
    import os

    env = os.environ.get("WRT_MXU_SWEEP")
    if env is not None:
        return env == "1"
    return (MXU_DEFAULT_MIN_SPHERES is not None and n_spheres is not None
            and n_spheres >= MXU_DEFAULT_MIN_SPHERES)


def resolve_mxu_sweep(mxu_sweep, scene: Scene) -> bool:
    """A render_image_* function's ``mxu_sweep``: an explicit value, or for
    None the default of the scene's size (``_default_mxu_sweep``), as the
    JAX wrappers resolve it."""
    if mxu_sweep is None:
        return _default_mxu_sweep(int(scene.spheres.centers.shape[0]))
    return bool(mxu_sweep)


def default_chunk_size(n_spheres: int) -> int:
    """The JAX package's chunk size: 16 up to 2048 spheres, 32 above
    (chosen for its culled sweep; regroup's K0 and K1, the megakernel and
    the wavefront's K0 and K1 cull per warp on the same chunks)."""
    return 16 if n_spheres <= 2048 else 32


class SceneArrays(NamedTuple):
    """Prepared scene: the first seven results of the JAX package's
    ``prepare_scene_arrays``, in its order. Its eighth, the winner-retrieval
    LUT, is left out (see the module docstring)."""

    s_attrs: tuple  # 13 (or 19 with textures) (n_spheres,) f32, kq last
    chunk_arrays: tuple  # 6 chunk-bound tensors + priors i32 [N_PRIORS]
    super_arrays: tuple  # 6 super-chunk-bound tensors
    n_spheres: int  # padded count
    n_chunks: int
    n_super: int
    tex_pool: Optional[torch.Tensor]  # [rows, 128] i32 packed RGB8


def prepare_scene_arrays(scene: Scene, basis: CameraBasis, chunk_size: int,
                         super_factor: int,
                         budget_texels: int = DEFAULT_TEXTURE_BUDGET
                         ) -> SceneArrays:
    """Per-sphere kernel attributes (prefolded material attributes and
    kq = |c|^2 - r^2), morton-chunk / super-chunk AABBs, prior spheres and
    the texture LUT (megakernel.py:1417-1526), on the scene's device."""
    sph = scene.spheres
    mat = scene.materials
    midx = sph.material_idx.long()
    s_attrs = (
        sph.centers[:, 0], sph.centers[:, 1], sph.centers[:, 2], sph.radii,
        mat.ids[midx].to(_F32), mat.x[midx],
        mat.albedo1[midx, 0], mat.albedo1[midx, 1], mat.albedo1[midx, 2],
        mat.albedo2[midx, 0], mat.albedo2[midx, 1], mat.albedo2[midx, 2],
    )
    tex_pool = None
    if not mat.all_solid:
        built = build_kernel_texture_pool(mat, budget_texels)
        if built is not None:
            tex_pool, desc1, desc2 = built
            s_attrs = s_attrs + (
                desc1[midx, 0], desc1[midx, 1], desc1[midx, 2],
                desc2[midx, 0], desc2[midx, 1], desc2[midx, 2],
            )
    n_spheres = int(sph.centers.shape[0])
    dev = sph.centers.device

    use_culling = chunk_size > 0 and n_spheres >= 2 * chunk_size
    z1 = torch.zeros((1,), dtype=_F32, device=dev)
    super_arrays = (z1,) * 6
    n_super = 0
    if use_culling:
        chunked = build_chunks(s_attrs, chunk_size)
        chunked = order_front_to_back(chunked, basis.eye, chunk_size)
        s_attrs = chunked.attrs
        n_spheres = int(s_attrs[0].shape[0])
        n_chunks = n_spheres // chunk_size
        chunk_arrays = chunked.bounds
        if n_chunks >= 2 * super_factor:
            chunk_arrays, super_arrays = super_bounds(chunked, super_factor)
            n_super = int(chunk_arrays[0].shape[0]) // super_factor
    else:
        chunk_arrays = (z1,) * 6
        n_chunks = 0
        if n_spheres > 64:
            # the TPU kernel's rolled unculled sweep reads 32-sphere spans;
            # duplicates of the last sphere are harmless for closest-hit
            pad_s = (-n_spheres) % 32
            if pad_s:
                s_attrs = tuple(torch.cat([a, a[-1:].expand(pad_s)])
                                for a in s_attrs)
                n_spheres = int(s_attrs[0].shape[0])

    cx_, cy_, cz_, rad_ = s_attrs[0], s_attrs[1], s_attrs[2], s_attrs[3]
    kq = cx_ * cx_ + cy_ * cy_ + cz_ * cz_ - rad_ * rad_
    s_attrs = s_attrs + (kq,)
    if n_chunks > 0:
        # jax.lax.top_k order: largest |radius| first, ties by lower index
        prior_idx = torch.argsort(-torch.abs(rad_), stable=True)[:N_PRIORS]
        chunk_arrays = chunk_arrays + (prior_idx.to(torch.int32),)
    else:
        chunk_arrays = chunk_arrays + (
            torch.zeros((N_PRIORS,), dtype=torch.int32, device=dev),)
    return SceneArrays(s_attrs, chunk_arrays, super_arrays, n_spheres,
                       n_chunks, n_super, tex_pool)


class KernelInputs(NamedTuple):
    """What the kernel reads, laid out for it (shared with the plain twin).

    The chunk hierarchy (the last nine fields) is read by regroup's K0 and
    K1 and the megakernel, which cull their sweep per warp with it, and by
    the stats kernels, which count the TPU kernel's cull decisions
    and sweep every sphere; it is a
    few KiB (RTiOW: 6 x 31 chunk bounds, 744 bytes; random_spheres(10000):
    6 x 320 chunk and 6 x 20 super bounds, 8,160 bytes). Its boxes are the
    exact ones of the JAX package; the culled kernels widen them per lane
    by the margin of CULL_MARGIN_ULPS, from cull_reach and cull_scale."""

    cam: torch.Tensor  # [20] f32
    sky: torch.Tensor  # [33] f32
    sweep: torch.Tensor  # [n, 4] f32: cx, cy, cz, kq
    attrs: torch.Tensor  # [12 or 18, n] f32 SoA (no kq)
    tex_pool: Optional[torch.Tensor]  # [rows * 128] i32, or None
    n_spheres: int
    chunk_bounds: torch.Tensor  # [6, max(n_tests, 1)] f32: lo x, y, z, hi x, y, z
    super_bounds: torch.Tensor  # [6, max(n_super, 1)] f32
    prior_idx: torch.Tensor  # [N_PRIORS] i32
    n_chunks: int  # chunks of chunk_size spheres; 0: no chunk hierarchy
    n_super: int  # super-chunks of super_factor chunks; 0: one level
    chunk_size: int
    super_factor: int
    cull_reach: float  # f32: max |c| + |r| of the non-prior spheres (cull_terms)
    cull_scale: float  # f32: CULL_MARGIN_ULPS * 2^-24 / their least |r|
    # [n_chunks, 8, 2 * chunk_size] f32 (mxu_sweep_amats) where the MXU
    # chunk sweep was asked for and the scene has chunks, else None
    amats: Optional[torch.Tensor] = None

    @property
    def n_tests(self) -> int:
        """Chunk boxes the TPU tests per bounce: n_chunks, padded to a
        multiple of super_factor when there are super-chunks."""
        return int(self.chunk_bounds.shape[1]) if self.n_chunks else 0


def kernel_inputs(scene: Scene, sky: SkyState, basis: CameraBasis, *,
                  chunk_size: Optional[int] = None, super_factor: int = 16,
                  budget_texels: int = DEFAULT_TEXTURE_BUDGET,
                  mxu_sweep: bool = False) -> KernelInputs:
    """Prepare the scene and pack camera, sky and spheres for the kernel
    (one call per frame, on the scene's device). With ``mxu_sweep`` a scene
    with chunks also gets the MXU chunk sweep's A table (``amats``), which
    the kernels then sweep where ``mxu_route`` holds."""
    if chunk_size is None:
        chunk_size = default_chunk_size(scene.spheres.num_spheres)
    prep = prepare_scene_arrays(scene, basis, chunk_size, super_factor,
                                budget_texels)
    a = prep.s_attrs
    sweep = torch.stack([a[0], a[1], a[2], a[-1]], dim=1).contiguous()
    attrs = torch.stack(a[:-1], dim=0).contiguous()
    pool = None if prep.tex_pool is None else prep.tex_pool.reshape(-1).contiguous()
    prior_idx = prep.chunk_arrays[6].contiguous()
    terms = cull_terms(sweep, a[3], prior_idx) if prep.n_chunks else (0.0, 0.0)
    return KernelInputs(pack_camera(basis).contiguous(), pack_sky(sky).contiguous(),
                        sweep, attrs, pool, prep.n_spheres,
                        torch.stack(prep.chunk_arrays[:6]).contiguous(),
                        torch.stack(prep.super_arrays).contiguous(),
                        prior_idx, prep.n_chunks, prep.n_super, chunk_size, super_factor,
                        *terms,
                        mxu_sweep_amats(a, chunk_size, prep.n_chunks).contiguous()
                        if mxu_sweep and prep.n_chunks else None)


def mxu_route(inp: KernelInputs, chunk_size: Optional[int] = None) -> bool:
    """Whether a kernel sweeping ``inp``'s chunks takes the MXU chunk
    sweep: the inputs carry the A table (the knob was on and the scene has
    chunks) and the chunk size the JAX package's condition reads
    (``chunk_size``: K1's k1_chunk_size; else the prepared one) is a power
    of two (megakernel.py:1681-1682, regroup.py:1171-1174,
    wavefront.py:390-391). Where it fails the knob is ignored, as there."""
    cs = inp.chunk_size if chunk_size is None else int(chunk_size)
    return inp.amats is not None and cs > 0 and cs & (cs - 1) == 0


def with_route(inp: KernelInputs, mxu: Optional[bool]) -> KernelInputs:
    """``inp`` for a kernel whose MXU route a frame sets apart from the
    inputs (the (K0, K1) routes of regroup's and the wavefront's frames):
    None keeps ``inp``, whose ``mxu_route`` decides; False drops the A
    table, so the FMA sweep runs; True needs inputs on the MXU route."""
    if mxu is None:
        return inp
    if not mxu:
        return inp if inp.amats is None else inp._replace(amats=None)
    if not mxu_route(inp):
        raise ValueError("the MXU chunk sweep needs kernel_inputs(..., mxu_sweep=True) "
                         "on a scene with chunks of a power-of-two size")
    return inp


def check_amats(inp: KernelInputs, device) -> int:
    """The A table's device pointer, after checking it against the chunk
    hierarchy."""
    t = inp.amats
    shape = (inp.n_chunks, 8, 2 * inp.chunk_size)
    if (t is None or t.device != device or tuple(t.shape) != shape or t.dtype != _F32
            or not t.is_contiguous()):
        raise ValueError(f"the MXU chunk sweep's A table must be {shape} f32 contiguous "
                         f"on {device}")
    return t.data_ptr()


def _f32_up(x: float) -> float:
    """x rounded to an f32 no smaller than it."""
    v = np.float32(x)
    return float(np.nextafter(v, np.float32(np.inf)) if float(v) < x else v)


def cull_terms(sweep: torch.Tensor, radii: torch.Tensor, prior_idx: torch.Tensor) -> tuple:
    """(cull_reach, cull_scale) of a scene with chunks, each rounded up to
    f32: the reach max(|c| + |r|) and CULL_MARGIN_ULPS * 2^-24 / min |r|
    over the spheres that are not priors ((0, 0) if every sphere is one;
    an infinite scale, which enters every box, for a zero radius)."""
    rest = torch.ones((sweep.shape[0],), dtype=torch.bool, device=sweep.device)
    rest[prior_idx.long()] = False
    if not bool(rest.any()):
        return 0.0, 0.0
    r = radii[rest].double().abs()
    reach = float((torch.linalg.vector_norm(sweep[rest, :3].double(), dim=1) + r).max())
    r_min = float(r.min())
    scale = CULL_MARGIN_ULPS * 2.0 ** -24 / r_min if r_min > 0.0 else float("inf")
    return _f32_up(reach), _f32_up(scale)


# --------------------------------------------------------------------------
# The CUDA kernel's wrapper
# --------------------------------------------------------------------------

KERNEL_SOURCE = "weekend_raytracer_tpu_torch/csrc/megakernel.cu"
REPLACES = "weekend_raytracer_tpu/ops/pallas/megakernel.py:1713"
# the stats=True instantiation of the same pallas_call (_make_kernel, 1146)
STATS_REPLACES = "weekend_raytracer_tpu/ops/pallas/megakernel.py:1146"
# (name, compiled sources) for build.load_library
LIBRARY = ("wrt_megakernel", ("megakernel.cu",))
# The TPU kernel's tile, which its counters are per: tsub = 32 rows of 128
# lanes as a block of 64 x 64 pixels (megakernel.py:1634-1640).
TILE_W = TILE_H = 64

# TPU-only knobs of render_image_pallas and the values that leave them off.
# listed and subcull were measured as losses on the TPU; tsub and block_w
# shape its lane tiles.
_TPU_KNOBS = {
    "tsub": (None, 32),
    "block_w": (None, 64),
    "subcull": (0,),
    "listed": (False,),
}
# stats=True with the MXU chunk sweep: the stats kernels count the FMA
# sweep's cull; the JAX kernel takes both, the port not yet
STATS_MXU_REFUSAL = ("stats=True with mxu_sweep=True is not ported yet "
                     "(ROADMAP Queue 2, 'stats=True with mxu_sweep')")


def _library():
    """Build (first use) and load the kernel library; raises on failure."""
    built = load_library(*LIBRARY)
    fn = built.lib.wrt_megakernel_launch
    if fn.argtypes is None:
        vp, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
        frame = [vp, vp, vp, vp, vp, vp, i, i, i, f, f, u, u, i, i, i]
        fn.argtypes = frame + CULL_ARGTYPES + [f, f, vp]
        fn.restype = ctypes.c_int
        mxu = built.lib.wrt_megakernel_mxu_launch
        mxu.argtypes = frame + CULL_ARGTYPES + [f, f, vp, vp]
        mxu.restype = ctypes.c_int
        mattr = built.lib.wrt_megakernel_mxu_attributes
        mattr.argtypes = [i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
        mattr.restype = ctypes.c_int
        mbounds = built.lib.wrt_megakernel_mxu_launch_bounds
        mbounds.argtypes = [ctypes.POINTER(i), ctypes.POINTER(i)]
        mbounds.restype = None
        st = built.lib.wrt_megakernel_stats_launch
        st.argtypes = frame + CULL_ARGTYPES + [vp, ctypes.c_longlong, vp, vp]
        st.restype = ctypes.c_int
        attr = built.lib.wrt_megakernel_attributes
        attr.argtypes = [i, i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
        attr.restype = ctypes.c_int
        bounds = built.lib.wrt_megakernel_launch_bounds
        bounds.argtypes = [ctypes.POINTER(i), ctypes.POINTER(i)]
        bounds.restype = None
        plan = built.lib.wrt_stats_plan
        plan.argtypes = [i] * 5 + [ctypes.POINTER(i)] * 2 + [ctypes.POINTER(ctypes.c_longlong)] * 2
        plan.restype = None
    return built


def kernel_attributes(textured: bool, stats: bool = False, staged: bool = True,
                      windowed: bool = False) -> dict:
    """Registers per thread and local-memory bytes of the built kernel
    (``stats``: the stats kernel, with its table staged whole or, with
    ``windowed``, in windows); ``staged`` picks the instantiation that reads
    the box tables from shared memory, else the one that reads them from
    global memory."""
    built = _library()
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    err = built.lib.wrt_megakernel_attributes(int(textured), (2 if windowed else 1) if stats else 0,
                                              int(staged), ctypes.byref(regs),
                                              ctypes.byref(local))
    if err:
        raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err}")
    return {"registers": regs.value, "local_bytes": local.value}


def launch_bounds(mxu: bool = False) -> tuple:
    """(threads a block, blocks an SM) of the culled kernel's
    ``__launch_bounds__`` (0 blocks: no minimum); ``mxu``: its MXU
    instantiation's."""
    threads, blocks = ctypes.c_int(0), ctypes.c_int(0)
    lib = _library().lib
    fn = lib.wrt_megakernel_mxu_launch_bounds if mxu else lib.wrt_megakernel_launch_bounds
    fn(ctypes.byref(threads), ctypes.byref(blocks))
    return threads.value, blocks.value


def mxu_kernel_attributes(textured: bool, staged: bool = True) -> dict:
    """Registers per thread and local-memory bytes of the built kernel's
    MXU instantiation (``staged``: the box tables in shared memory)."""
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    err = _library().lib.wrt_megakernel_mxu_attributes(int(textured), int(staged),
                                                       ctypes.byref(regs), ctypes.byref(local))
    if err:
        raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err}")
    return {"registers": regs.value, "local_bytes": local.value}


def _stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ctypes types of cull_args(), as the culled and stats entry points take them
CULL_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5


def cull_args(inp: KernelInputs, device) -> tuple:
    """The chunk hierarchy as a culled or stats entry point takes it,
    after checking it: three device pointers, then n_chunks, n_tests,
    n_super, chunk_size, super_factor."""
    for t, shape, dtype in ((inp.chunk_bounds, (6, max(inp.n_tests, 1)), _F32),
                            (inp.super_bounds, (6, max(inp.n_super, 1)), _F32),
                            (inp.prior_idx, (N_PRIORS,), torch.int32)):
        if (t.device != device or tuple(t.shape) != shape or t.dtype != dtype
                or not t.is_contiguous()):
            raise ValueError(
                f"chunk hierarchy {tuple(t.shape)} {t.dtype} on {t.device} does not "
                f"match {shape} {dtype} contiguous on {device}")
    return (inp.chunk_bounds.data_ptr(), inp.super_bounds.data_ptr(),
            inp.prior_idx.data_ptr(), inp.n_chunks, inp.n_tests, inp.n_super,
            inp.chunk_size, inp.super_factor)


def stats_scratch_words(groups: int, n_iters: int, inp: KernelInputs) -> int:
    """u32 words of a stats launch's scratch (csrc/stats.cuh): per group
    of rays its iterations, its live lanes, and one bit per chunk and per
    super-chunk for each loop iteration."""
    words = lambda bits: -(-bits // 32)  # noqa: E731
    return groups * (2 + n_iters * (words(inp.n_tests) + words(inp.n_super)))


# The stats kernels' windows (csrc/bounce.cuh stats_plan): the dynamic
# shared memory a block stages (cull tables, then the sphere table), 32
# bytes a staged sphere, and the most a block of the card may opt in to
# (an H100's 227 KB).
STATS_SMEM_BYTES = 48 * 1024
STATS_SPHERE_BYTES = 32
CARD_SMEM_BYTES = 232_448
STAGE_BYTES = 44 * 1024  # csrc/bounce.cuh kStageBytes: the culled kernels' limit


def cull_smem_bytes(n_chunks: int, n_tests: int, n_super: int) -> int:
    """csrc/bounce.cuh cull_smem_bytes: a block's staged cull tables (the
    priors' rows and indices, and the boxes where they fit STAGE_BYTES); 0
    without chunks."""
    if n_chunks == 0:
        return 0
    priors = N_PRIORS * (16 + 4)
    boxes = 24 * (n_tests + n_super)
    return priors + (boxes if priors + boxes <= STAGE_BYTES else 0)


def stats_plan(n_spheres: int, n_chunks: int, n_tests: int, n_super: int,
               chunk_size: int) -> dict:
    """The stats kernels' windows of the sphere table (csrc/bounce.cuh
    stats_plan, which ``[build]`` holds to this mirror): the fewest windows
    of whole chunks (of spheres, without chunks) that each fit
    STATS_SMEM_BYTES beside the cull tables, then the shortest window that
    covers the table in that many. ``window`` spheres a window (the last one
    shorter), ``windows``, the table's offset in a block's dynamic shared
    memory (16-byte aligned) and the block's dynamic bytes (``smem``)."""
    offset = -(-cull_smem_bytes(n_chunks, n_tests, n_super) // 16) * 16
    unit = chunk_size if n_chunks else 1
    units = n_chunks if n_chunks else n_spheres
    most = max(1, max(STATS_SMEM_BYTES - offset, 0) // STATS_SPHERE_BYTES // unit)
    fewest = -(-units // most)
    window = -(-units // fewest) * unit
    return {"window": window, "windows": -(-n_spheres // window), "table_offset": offset,
            "smem": offset + min(window, n_spheres) * STATS_SPHERE_BYTES}


def stats_plan_of(inp: KernelInputs) -> dict:
    """``stats_plan`` of a prepared scene."""
    return stats_plan(inp.n_spheres, inp.n_chunks, inp.n_tests, inp.n_super, inp.chunk_size)


def stats_plan_built(n_spheres: int, n_chunks: int, n_tests: int, n_super: int,
                     chunk_size: int) -> dict:
    """The plan as the built library derives it (wrt_stats_plan)."""
    i, ll = ctypes.c_int, ctypes.c_longlong
    window, windows, offset, smem = i(0), i(0), ll(0), ll(0)
    _library().lib.wrt_stats_plan(n_spheres, n_chunks, n_tests, n_super, chunk_size,
                                  ctypes.byref(window), ctypes.byref(windows),
                                  ctypes.byref(offset), ctypes.byref(smem))
    return {"window": window.value, "windows": windows.value, "table_offset": offset.value,
            "smem": smem.value}


def stats_tiles(width: int, height: int) -> int:
    """TPU tiles of a width x height image (the rows of its stats table)."""
    return -(-width // TILE_W) * -(-height // TILE_H)


def _device_type(t: torch.Tensor) -> str:
    return t.device.type


def _check_knobs(knobs):
    for name, value in knobs.items():
        if value not in _TPU_KNOBS[name]:
            raise NotImplementedError(
                f"{name}={value!r} is a TPU-only knob of render_image_pallas; "
                "the CUDA megakernel takes only its off value "
                f"{_TPU_KNOBS[name][-1]!r} (ROADMAP Queue 2, still to port)")


def _check_accum(accum, width, height, spp, num_bounces):
    if accum.dtype != _F32 or tuple(accum.shape) != (width * height, 3):
        raise ValueError(
            f"accum must be f32 [{width * height}, 3], got "
            f"{accum.dtype} {tuple(accum.shape)}")
    if not accum.is_contiguous():
        raise ValueError("accum must be contiguous")
    if spp < 1 or num_bounces < 1:
        raise ValueError(f"spp and num_bounces must be >= 1, got {spp}, {num_bounces}")


def render_image_megakernel(
    accum: torch.Tensor,  # [H*W, 3] f32, updated in place
    frame,  # u32 frame number (int)
    clear,  # bool: overwrite instead of accumulate
    scene: Scene,
    sky: SkyState,
    basis: CameraBasis,
    *,
    width: int,
    height: int,
    spp: int,
    num_bounces: int,
    chunk_size: Optional[int] = None,
    super_factor: int = 16,
    row_offset: int = 0,
    full_height: Optional[int] = None,
    budget_texels: int = DEFAULT_TEXTURE_BUDGET,
    tsub=None,
    block_w=None,
    stats=False,
    subcull=0,
    listed=False,
    mxu_sweep=None,
):
    """One progressive frame via the fused megakernel; returns ``accum``.

    The JAX package donates and aliases the accumulator into its kernel
    (megakernel.py:1723); here the kernel accumulates in place into the
    caller's tensor, which is also returned. A CUDA ``accum`` launches the
    CUDA kernel (and counts one launch in ``render_image_megakernel.launches``)
    or raises; a CPU ``accum`` runs ``render_image_megakernel_plain``.

    ``mxu_sweep`` (None: ``_default_mxu_sweep``, off unless WRT_MXU_SWEEP=1)
    runs the culled chunk sweep's products on the tensor cores, where the
    scene has chunks of a power-of-two size (``mxu_route``), in the kernel's
    ``kMxu`` instantiation (counted in
    ``render_image_megakernel.mxu_launches``) or, on the CPU, the twin's
    ``_closest_hit_mxu``; elsewhere the knob changes nothing.

    stats=True returns ``(accum, table)`` as ``render_image_pallas`` does:
    a [n_tiles, 8] f32 table, one row per 64 x 64-pixel TPU tile (col 0
    bounce iterations of the tile's loop summed over samples, 1 live lanes
    summed over those iterations, 2 chunk bodies and 3 super-chunk bodies
    the TPU's whole-tile cull enters, 4-7 zero). On a CUDA ``accum`` it
    launches the stats kernel (counted in
    ``render_image_megakernel.stats_launches``) or raises; the image is the
    one stats=False gives.
    """
    _check_knobs(dict(tsub=tsub, block_w=block_w, subcull=subcull, listed=listed))
    _check_accum(accum, width, height, spp, num_bounces)
    mxu = resolve_mxu_sweep(mxu_sweep, scene)
    if stats and mxu:
        raise NotImplementedError(STATS_MXU_REFUSAL)
    kw = dict(width=width, height=height, spp=spp, num_bounces=num_bounces,
              chunk_size=chunk_size, super_factor=super_factor,
              row_offset=row_offset, full_height=full_height,
              budget_texels=budget_texels, stats=stats, mxu_sweep=mxu)
    kind = _device_type(accum)
    if kind == "cpu":
        return render_image_megakernel_plain(accum, frame, clear, scene, sky,
                                             basis, **kw)
    if kind != "cuda":
        raise ValueError(f"unsupported device {accum.device}")
    if scene.device != accum.device:
        raise ValueError(f"scene on {scene.device}, accum on {accum.device}")
    inp = kernel_inputs(scene, sky, basis, chunk_size=chunk_size,
                        super_factor=super_factor, budget_texels=budget_texels,
                        mxu_sweep=mxu)
    return launch_megakernel(accum, inp, frame, clear, width=width,
                             height=height, spp=spp, num_bounces=num_bounces,
                             row_offset=row_offset, full_height=full_height,
                             stats=stats)


def launch_megakernel(accum: torch.Tensor, inp: KernelInputs, frame, clear, *,
                      width: int, height: int, spp: int, num_bounces: int,
                      row_offset: int = 0, full_height: Optional[int] = None,
                      stats: bool = False):
    """Launch the CUDA kernel on prepared inputs, on the current stream;
    counts the launch in ``render_image_megakernel.launches``. With
    ``stats`` it launches the stats kernel instead, counted in
    ``render_image_megakernel.stats_launches``, and returns
    ``(accum, table)``. Where ``mxu_route(inp)`` it launches the kernel's
    MXU instantiation, counted in ``render_image_megakernel.mxu_launches``."""
    _check_accum(accum, width, height, spp, num_bounces)
    mxu = mxu_route(inp)
    if stats and mxu:
        raise NotImplementedError(STATS_MXU_REFUSAL)
    n = inp.n_spheres
    expect = [(inp.cam, (20,), _F32), (inp.sky, (33,), _F32),
              (inp.sweep, (n, 4), _F32),
              (inp.attrs, (18 if inp.tex_pool is not None else 12, n), _F32)]
    if inp.tex_pool is not None:
        expect.append((inp.tex_pool, tuple(inp.tex_pool.shape), torch.int32))
    for t, shape, dtype in expect:
        if (t.device != accum.device or tuple(t.shape) != shape
                or t.dtype != dtype or not t.is_contiguous()):
            raise ValueError(
                f"kernel input {tuple(t.shape)} {t.dtype} on {t.device} does not "
                f"match {shape} {dtype} contiguous on {accum.device}")
    fh = height if full_height is None else full_height
    lib = _library().lib
    frame_args = (
        inp.cam.data_ptr(), inp.sky.data_ptr(), inp.sweep.data_ptr(),
        inp.attrs.data_ptr(),
        None if inp.tex_pool is None else inp.tex_pool.data_ptr(),
        accum.data_ptr(), inp.n_spheres, width, height,
        float(np.float32(1.0 / width)), float(np.float32(1.0 / fh)),
        int(frame) & rng.MASK32, int(row_offset) & rng.MASK32, int(bool(clear)),
        spp, num_bounces)
    cull = cull_args(inp, accum.device)
    if mxu:
        err = lib.wrt_megakernel_mxu_launch(*frame_args, *cull, _f32(inp.cull_reach),
                                            _f32(inp.cull_scale), check_amats(inp, accum.device),
                                            _stream_handle(accum.device))
        if err != 0:
            raise RuntimeError(f"megakernel MXU launch failed: CUDA error {err}")
        render_image_megakernel.mxu_launches += 1
        return accum
    if not stats:
        err = lib.wrt_megakernel_launch(*frame_args, *cull, _f32(inp.cull_reach),
                                        _f32(inp.cull_scale), _stream_handle(accum.device))
        if err != 0:
            raise RuntimeError(f"megakernel launch failed: CUDA error {err}")
        render_image_megakernel.launches += 1
        return accum
    n_tiles = stats_tiles(width, height)
    words = stats_scratch_words(n_tiles * spp, num_bounces, inp)
    scratch = torch.empty((words,), dtype=torch.int32, device=accum.device)
    table = torch.empty((n_tiles, 8), dtype=_F32, device=accum.device)
    err = lib.wrt_megakernel_stats_launch(
        *frame_args, *cull, scratch.data_ptr(), words, table.data_ptr(),
        _stream_handle(accum.device))
    if err != 0:
        raise RuntimeError(f"megakernel stats launch failed: CUDA error {err}")
    render_image_megakernel.stats_launches += 1
    return accum, table


render_image_megakernel.launches = 0
render_image_megakernel.stats_launches = 0
render_image_megakernel.mxu_launches = 0


# --------------------------------------------------------------------------
# The plain PyTorch version
# --------------------------------------------------------------------------

def atan2_approx(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The kernel's four-quadrant arctangent (megakernel.py:70-87)."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    swap = ay > ax
    num = torch.minimum(ax, ay)
    den = torch.maximum(ax, ay)
    z = num / torch.clamp(den, min=1.0e-30)
    z2 = z * z
    r = z * (0.9998660 + z2 * (-0.3302995 + z2 * (
        0.1801410 + z2 * (-0.0851330 + z2 * 0.0208351))))
    r = torch.where(swap, HALF_PI - r, r)
    r = torch.where(x < 0.0, PI - r, r)
    return torch.where(y < 0.0, -r, r)


def acos_approx(x: torch.Tensor) -> torch.Tensor:
    """The kernel's polynomial arccos (megakernel.py:90-98)."""
    ax = torch.abs(x)
    p = 1.5707288 + ax * (-0.2121144 + ax * (0.0742610 + ax * (-0.0187293)))
    f = torch.sqrt(torch.clamp(1.0 - ax, min=0.0)) * p
    return torch.where(x >= 0.0, f, PI - f)


def _sky_channel(p, cos_theta, gamma, cos_gamma):
    """One channel of the HW-form radiance (raytracer.wgsl:316-343); p is
    a [9] f32 tensor, so products of two parameters round to f32 as in the
    kernel."""
    p0, p1, p2, p3, p4, p5, p6, p7, p8 = p
    exp_m = torch.exp(p4 * gamma)
    ray_m = cos_gamma * cos_gamma
    mie_base = 1.0 + p8 * p8 - 2.0 * p8 * cos_gamma
    mie = (1.0 + ray_m) / (mie_base * torch.sqrt(mie_base))
    zen = torch.sqrt(cos_theta)
    lhs = 1.0 + p0 * torch.exp(p1 / (cos_theta + 0.01))
    rhs = p2 + p3 * exp_m + p5 * ray_m + p6 * mie + p7 * zen
    return lhs * rhs


def _f32(v: float) -> float:
    """A Python float rounded to f32, as the kernel's constants are."""
    return float(np.float32(v))


def _tex_lookup(pool, base, tw, th, u, v, fr, fg, fb):
    """Packed-RGB8 fetch (megakernel.py:393-435); base < 0 keeps the
    prefolded albedo."""
    uu = torch.clamp(u, 0.0, 1.0)
    vv = 1.0 - torch.clamp(v, 0.0, 1.0)
    j = torch.minimum(torch.floor(uu * tw), tw - 1.0)
    i = torch.minimum(torch.floor(vv * th), th - 1.0)
    valid = base >= 0.0
    flat = torch.where(valid, base * 128.0 + i * tw + j, torch.zeros_like(u))
    packed = pool[flat.to(torch.int64)]
    inv255 = _f32(1.0 / 255.0)
    tr_ = ((packed >> 16) & 255).to(_F32) * inv255
    tg_ = ((packed >> 8) & 255).to(_F32) * inv255
    tb_ = (packed & 255).to(_F32) * inv255
    return (torch.where(valid, tr_, fr), torch.where(valid, tg_, fg),
            torch.where(valid, tb_, fb))


def _sphere_ts(o, d, od, oo, c):
    """Hit distance [n, m] of each ray against each sphere of c [m, 4]
    (cx, cy, cz, kq), MAX_T where it misses: the kernel's sphere test."""
    ox, oy, oz = o
    dx, dy, dz = d
    cx, cy, cz, kq = c[:, 0], c[:, 1], c[:, 2], c[:, 3]
    cd = cx * dx[:, None] + cy * dy[:, None] + cz * dz[:, None]
    co2 = ((cx + cx) * ox[:, None] + (cy + cy) * oy[:, None]
           + (cz + cz) * oz[:, None])
    b = cd - od
    cq = oo - co2 + kq
    sq = torch.sqrt(b * b - cq)  # NaN for a negative discriminant
    t0 = b - sq
    t1 = b + sq
    ts = torch.where(t0 > MIN_T, t0, t1)
    return torch.where((sq > 0.0) & (ts > MIN_T), ts, torch.full_like(ts, MAX_T))


def _od_oo(o, d):
    ox, oy, oz = o
    dx, dy, dz = d
    return (ox * dx + oy * dy + oz * dz)[:, None], (ox * ox + oy * oy + oz * oz)[:, None]


def _closest_hit(o, d, sweep):
    """Closest hit over every sphere: the kernel's sweep, with the running
    strict-< min taken per block of spheres (first index wins ties)."""
    od, oo = _od_oo(o, d)
    n = o[0].shape[0]
    bt = torch.full((n,), MAX_T, dtype=_F32, device=o[0].device)
    bi = torch.full((n,), -1, dtype=torch.int64, device=o[0].device)
    for s0 in range(0, sweep.shape[0], _SPHERE_BLOCK):
        ts = _sphere_ts(o, d, od, oo, sweep[s0:s0 + _SPHERE_BLOCK])
        tm, im = torch.min(ts, dim=1)
        better = tm < bt
        bt = torch.where(better, tm, bt)
        bi = torch.where(better, im + s0, bi)
    return bt, bi


def _closest_hit_mxu(o, d, inp: KernelInputs):
    """Closest hit with the MXU chunk sweep, the JAX form of
    megakernel.py:560-610 (the CUDA kernels' sweep_culled_mma): the priors
    first, on the FMA sweep (``_sphere_ts``), their least (t, index) kept
    apart; then for each chunk out = A_c^T . [d; o; 1; 0] in f32 (one
    product per ray against ``inp.amats``), b = out[:cs] - o.d, cq = |o|^2 +
    out[cs:], sq = sqrt(b^2 - cq) and the root choice with MIN_T / MAX_T;
    the least (t, index) over every chunk, then the priors' joined by (t,
    index). Ties go to the least sphere index, the port's rule: the JAX
    kernel's half-tree argmin may keep another index on an exact tie
    (megakernel.py:594-597), within the knob's statistical contract.

    It sweeps every chunk: the kernels' per-warp cull skips a chunk only
    where no lane's widened box test enters it, which holds every hit the
    f32-accurate products can take up to rounding at a box's face (a ray
    where it does not is within the same statistical contract). The
    product's f32 sum order is PyTorch's, not the tensor cores' (3xTF32),
    nor XLA's: the twin and the kernels agree statistically, not in every
    bit. It runs on the CPU and nowhere on the card's path."""
    od, oo = _od_oo(o, d)
    n = o[0].shape[0]
    dev = o[0].device
    pbt = torch.full((n,), MAX_T, dtype=_F32, device=dev)
    pbi = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for p in inp.prior_idx.tolist():
        ts = _sphere_ts(o, d, od, oo, inp.sweep[p:p + 1])[:, 0]
        take = (ts < MAX_T) & ((ts < pbt) | ((ts == pbt) & (p < pbi)))
        pbt = torch.where(take, ts, pbt)
        pbi = torch.where(take, torch.full_like(pbi, p), pbi)
    ones = torch.ones_like(o[0])
    rays = torch.stack([d[0], d[1], d[2], o[0], o[1], o[2], ones, torch.zeros_like(ones)], 1)
    cs = inp.chunk_size
    per_block = max(1, _SPHERE_BLOCK // cs)
    bt = torch.full((n,), MAX_T, dtype=_F32, device=dev)
    bi = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for c0 in range(0, inp.n_chunks, per_block):
        a = inp.amats[c0:c0 + per_block]
        k = a.shape[0]
        out = (rays @ a.permute(1, 0, 2).reshape(8, k * 2 * cs)).reshape(n, k, 2 * cs)
        b = out[:, :, :cs] - od[:, :, None]
        cq = oo[:, :, None] + out[:, :, cs:]
        sq = torch.sqrt(b * b - cq)  # NaN for a negative discriminant
        t0 = b - sq
        t1 = b + sq
        ts = torch.where(t0 > MIN_T, t0, t1)
        ts = torch.where((sq > 0.0) & (ts > MIN_T), ts, torch.full_like(ts, MAX_T))
        tm, im = torch.min(ts.reshape(n, k * cs), dim=1)  # the first index of the least
        better = tm < bt
        bt = torch.where(better, tm, bt)
        bi = torch.where(better, im + c0 * cs, bi)
    prior = (pbi >= 0) & ((pbt < bt) | ((pbt == bt) & (pbi < bi)))
    return torch.where(prior, pbt, bt), torch.where(prior, pbi, bi)


def _slab_enters(bounds, o, inv, bt, margin=None):
    """The TPU's slab test (slab_hit, megakernel.py:529-550) of each ray
    against each box of bounds [6, m]: [n, m] bool, can the ray enter the
    box closer than bt [n, m]? With ``margin`` [n] f32 each ray tests the
    boxes widened by its own margin, as csrc/bounce.cuh sweep_culled does
    ((lo - m - o) * inv, (hi + m - o) * inv)."""
    lo, hi = bounds[:3][:, None, :], bounds[3:][:, None, :]
    if margin is not None:
        lo, hi = lo - margin[:, None], hi + margin[:, None]
    t = [(((lo, hi)[k // 3][a]) - o[a][:, None]) * inv[a][:, None]
         for k in (0, 3) for a in range(3)]
    tnear = torch.maximum(torch.maximum(torch.minimum(t[0], t[3]), torch.minimum(t[1], t[4])),
                          torch.minimum(t[2], t[5]))
    tfar = torch.minimum(torch.minimum(torch.maximum(t[0], t[3]), torch.maximum(t[1], t[4])),
                         torch.maximum(t[2], t[5]))
    return (tfar >= tnear) & (tfar > MIN_T) & (tnear < bt)


def _cull_tests(o, d, inp: KernelInputs, margin=None):
    """Each ray's outcome of the TPU's whole-tile cull tests at one bounce
    (megakernel.py:615-660, 826-848): chunk tests [n, n_tests] and super
    tests [n, n_super] bool. The test before chunk c uses min(best-t of the
    priors, best-t of the spheres before c), which is the culled sweep's
    best-t at c for every live ray, since culling never skips a chunk that
    holds a closer hit (csrc/stats.cuh). ``margin`` [n] f32 widens each
    ray's boxes as regroup K0 and K1 do (cull.lane_margin)."""
    od, oo = _od_oo(o, d)
    n = o[0].shape[0]
    dev = o[0].device
    prior_bt = torch.full((n,), MAX_T, dtype=_F32, device=dev)
    for p in inp.prior_idx.tolist():
        ts = _sphere_ts(o, d, od, oo, inp.sweep[p:p + 1])[:, 0]
        prior_bt = torch.where(ts < prior_bt, ts, prior_bt)
    cs = inp.chunk_size
    per_block = max(1, _SPHERE_BLOCK // cs)
    chunk_min = torch.cat([
        _sphere_ts(o, d, od, oo, inp.sweep[c0 * cs:(c0 + per_block) * cs])
        .reshape(n, -1, cs).amin(dim=2)
        for c0 in range(0, inp.n_chunks, per_block)], dim=1)
    # best-t before each chunk box: the spheres of the chunks before it
    run = torch.cummin(chunk_min, dim=1).values
    before = torch.cat([torch.full((n, 1), MAX_T, dtype=_F32, device=dev), run[:, :-1],
                        run[:, -1:].expand(n, inp.n_tests - inp.n_chunks)], dim=1)
    bt = torch.minimum(torch.clamp(before, max=MAX_T), prior_bt[:, None])
    inv = [1.0 / (torch.where(v >= 0.0, 1.0, -1.0).to(_F32) * torch.clamp(torch.abs(v),
                                                                           min=1.0e-12))
           for v in d]
    chunk_hit = _slab_enters(inp.chunk_bounds, o, inv, bt, margin)
    super_hit = (_slab_enters(inp.super_bounds, o, inv, bt[:, ::inp.super_factor], margin)
                 if inp.n_super else None)
    return chunk_hit, super_hit


class CullStats:
    """The TPU kernels' stats=True counters, gathered by the plain twins
    (the CUDA stats kernels count the same, csrc/stats.cuh).

    Rays belong to groups (a TPU tile and sample of the megakernel, a dense
    tile of K1); ``record`` takes the rays alive at the start of loop
    iteration k with their groups and weights (a padded TPU lane traces
    its clamped pixel's path again, so that pixel's rays weigh more), and
    ``table`` sums groups into the [n_tiles, 8] f32 table: col 0 the
    iterations the group's loop ran, col 1 live lanes summed over them,
    col 2 chunk bodies entered inside entered super-chunks, col 3
    super-chunk bodies entered, cols 4-7 zero."""

    def __init__(self, inp: KernelInputs, n_groups: int, n_iters: int, device):
        self.inp = inp
        self.ran = torch.zeros((n_iters, n_groups), dtype=torch.bool, device=device)
        self.live = torch.zeros((n_groups,), dtype=torch.float64, device=device)
        self.chunks = torch.zeros((n_iters, n_groups, inp.n_tests), dtype=torch.int32,
                                  device=device)
        self.supers = torch.zeros((n_iters, n_groups, inp.n_super), dtype=torch.int32,
                                  device=device)

    def record(self, k: int, group, weight, o, d) -> None:
        self.ran[k].index_fill_(0, group, True)
        self.live.index_add_(0, group, weight.to(torch.float64))
        if not self.inp.n_chunks:
            return
        for r0 in range(0, group.numel(), _STATS_RAYS):
            sl = slice(r0, r0 + _STATS_RAYS)
            chunk_hit, super_hit = _cull_tests(tuple(v[sl] for v in o),
                                               tuple(v[sl] for v in d), self.inp)
            self.chunks[k].index_add_(0, group[sl], chunk_hit.to(torch.int32))
            if super_hit is not None:
                self.supers[k].index_add_(0, group[sl], super_hit.to(torch.int32))

    def table(self, groups_per_tile: int) -> torch.Tensor:
        entered = self.chunks > 0
        supers = self.supers > 0
        if self.inp.n_super:  # a chunk counts only inside an entered super-chunk
            entered &= supers.repeat_interleave(self.inp.super_factor, dim=2)
        per_group = torch.stack([self.ran.sum(0).double(), self.live,
                                 entered.sum((0, 2)).double(),
                                 supers.sum((0, 2)).double()], dim=1)
        per_tile = per_group.reshape(-1, groups_per_tile, 4).sum(1)
        out = torch.zeros((per_tile.shape[0], 8), dtype=_F32, device=per_tile.device)
        out[:, :4] = per_tile.to(_F32)
        return out


class PathState(NamedTuple):
    """Per-ray path state after a run of bounces (the CUDA ``Ray``)."""

    o: torch.Tensor  # [n, 3] origin
    d: torch.Tensor  # [n, 3] unit direction
    tr: torch.Tensor  # [n, 3] throughput
    c: torch.Tensor  # [n, 3] colour of the light that ended the path, else 0
    alive: torch.Tensor  # [n] bool: still bouncing
    state: torch.Tensor  # [n] RNG state (uint32 in int64)


def trace_bounces_plain(o, d, tr, state, inp: KernelInputs, b_lo: int,
                        b_hi: int, counted=None, mxu: bool = False) -> PathState:
    """Bounces [b_lo, b_hi) of live paths (bounce.cuh ``trace_bounces``).

    o and d are (x, y, z) tuples of [n] f32, tr is [n, 3]. Paths that end
    leave the batch; a path's final state is written back at its index. A
    path that ends keeps the ray it ended on and the RNG state it had then
    (after the draws of an emissive hit), as the kernel does, and one still
    alive after b_hi keeps colour 0. ``counted`` = (CullStats, group [n], weight [n])
    records each bounce's live rays there. ``mxu`` sweeps with the MXU chunk
    sweep's twin (``_closest_hit_mxu``), which needs ``inp.amats``."""
    n = o[0].shape[0]
    dev = o[0].device
    out_c = torch.zeros((n, 3), dtype=_F32, device=dev)
    out_t = tr.clone()
    out_o = torch.stack(o, dim=1)
    out_d = torch.stack(d, dim=1)
    out_alive = torch.ones((n,), dtype=torch.bool, device=dev)
    out_state = state.clone()
    live = torch.arange(n, device=dev)
    sky = [_f32(v) for v in inp.sky.tolist()]
    attrs = inp.attrs
    textured = inp.tex_pool is not None
    pink = [_f32(v) for v in _mat.ERROR_PINK]
    ids = {k: float(getattr(_mat, k)) for k in
           ("LAMBERTIAN", "METAL", "DIELECTRIC", "CHECKERBOARD", "EMISSIVE")}
    ox, oy, oz = o
    dx, dy, dz = d
    for bounce in range(b_lo, b_hi):
        if live.numel() == 0:
            break
        if counted is not None:
            counter, group, weight = counted
            counter.record(bounce - b_lo, group[live], weight[live], (ox, oy, oz),
                           (dx, dy, dz))
        if mxu:
            bt, bi = _closest_hit_mxu((ox, oy, oz), (dx, dy, dz), inp)
        else:
            bt, bi = _closest_hit((ox, oy, oz), (dx, dy, dz), inp.sweep)
        hit = bi >= 0

        # miss: sky radiance ends the path
        miss = ~hit
        if bool(miss.any()):
            mdx, mdy, mdz = dx[miss], dy[miss], dz[miss]
            cos_theta = torch.abs(torch.clamp(mdy, -1.0, 1.0))
            cos_gamma = torch.clamp(mdx * sky[30] + mdy * sky[31] + mdz * sky[32],
                                    -1.0, 1.0)
            gamma = acos_approx(cos_gamma)
            rad = torch.stack([
                sky[27 + ch] * _sky_channel(inp.sky[9 * ch:9 * ch + 9],
                                            cos_theta, gamma, cos_gamma)
                for ch in range(3)], dim=1)
            idx = live[miss]
            out_c[idx] = rad
            out_t[idx] = tr[miss]
            out_alive[idx] = False
            out_o[idx] = torch.stack([ox[miss], oy[miss], oz[miss]], dim=1)
            out_d[idx] = torch.stack([mdx, mdy, mdz], dim=1)
            out_state[idx] = state[miss]

        (live, bt, bi, ox, oy, oz, dx, dy, dz, state) = (
            v[hit] for v in (live, bt, bi, ox, oy, oz, dx, dy, dz, state))
        tr = tr[hit]
        if live.numel() == 0:
            break
        a = attrs[:, bi]
        bcx, bcy, bcz, brad, bmid, bmx = a[0], a[1], a[2], a[3], a[4], a[5]
        b1r, b1g, b1b, b2r, b2g, b2b = a[6], a[7], a[8], a[9], a[10], a[11]
        px = ox + bt * dx
        py = oy + bt * dy
        pz = oz + bt * dz
        inv_r = 1.0 / brad
        nx = (px - bcx) * inv_r
        ny = (py - bcy) * inv_r
        nz = (pz - bcz) * inv_r

        if textured:
            theta = acos_approx(torch.clamp(-ny, -1.0, 1.0))
            phi = atan2_approx(-nz, nx) + PI
            u = phi * _f32(1.0 / TWO_PI)
            v = theta * FRAC_1_PI
            b1r, b1g, b1b = _tex_lookup(inp.tex_pool, a[12], a[13], a[14], u, v,
                                        b1r, b1g, b1b)
            b2r, b2g, b2b = _tex_lookup(inp.tex_pool, a[15], a[16], a[17], u, v,
                                        b2r, b2g, b2b)

        state, (r1, r2, r3, r4) = rng.next_floats(state, 4)

        # diffuse direction (pixarOnb + cosine hemisphere)
        sgn = torch.where(nz >= 0.0, 1.0, -1.0).to(_F32)
        ia = -1.0 / (sgn + nz)
        bb = nx * ny * ia
        t1x = 1.0 + sgn * nx * nx * ia
        t1y = sgn * bb
        t1z = -sgn * nx
        t2x = bb
        t2y = sgn + ny * ny * ia
        t2z = -ny
        sqr2 = torch.sqrt(r2)
        zl = torch.sqrt(torch.clamp(1.0 - r2, min=0.0))
        phi = TWO_PI * r1
        xl = torch.cos(phi) * sqr2
        yl = torch.sin(phi) * sqr2
        difx = xl * t1x + yl * t2x + zl * nx
        dify = xl * t1y + yl * t2y + zl * ny
        difz = xl * t1z + yl * t2z + zl * nz
        ndw = nx * difx + ny * dify + nz * difz
        lam_ratio = ((FRAC_1_PI * torch.clamp(ndw, min=EPS))
                     / torch.clamp(ndw * FRAC_1_PI, min=EPS))

        # unit-ball point (metal fuzz / unknown material)
        rr = torch.pow(r1, _f32(1.0 / 3.0))
        cth = 1.0 - 2.0 * r2
        sth = torch.sqrt(torch.clamp(1.0 - cth * cth, min=0.0))
        ph3 = TWO_PI * r3
        ballx = rr * sth * torch.cos(ph3)
        bally = rr * sth * torch.sin(ph3)
        ballz = rr * cth

        # metal
        ddn2 = 2.0 * (dx * nx + dy * ny + dz * nz)
        rflx = dx - ddn2 * nx
        rfly = dy - ddn2 * ny
        rflz = dz - ddn2 * nz
        metx = rflx + bmx * ballx
        mety = rfly + bmx * bally
        metz = rflz + bmx * ballz

        # dielectric (RTiOW-correct)
        ddn = 0.5 * ddn2
        front = ddn < 0.0
        osx = torch.where(front, nx, -nx)
        osy = torch.where(front, ny, -ny)
        osz = torch.where(front, nz, -nz)
        eta = torch.where(front, 1.0 / bmx, bmx)
        cosine = torch.where(front, -ddn, bmx * ddn)
        dt = dx * osx + dy * osy + dz * osz
        disc_d = 1.0 - eta * eta * (1.0 - dt * dt)
        sqd = torch.sqrt(torch.clamp(disc_d, min=0.0))
        refx = eta * (dx - dt * osx) - sqd * osx
        refy = eta * (dy - dt * osy) - sqd * osy
        refz = eta * (dz - dt * osz) - sqd * osz
        r0 = (1.0 - bmx) / (1.0 + bmx)
        r0 = r0 * r0
        omc = 1.0 - torch.clamp(cosine, 0.0, 1.0)
        omc2 = omc * omc
        schlick = r0 + (1.0 - r0) * omc2 * omc2 * omc
        reflect_prob = torch.where(disc_d > 0.0, schlick, torch.ones_like(schlick))
        use_reflect = r4 < reflect_prob
        dlx = torch.where(use_reflect, rflx, refx)
        dly = torch.where(use_reflect, rfly, refy)
        dlz = torch.where(use_reflect, rflz, refz)

        # checkerboard albedo (3D sine parity)
        sines = torch.sin(5.0 * px) * torch.sin(5.0 * py) * torch.sin(5.0 * pz)
        even = sines < 0.0
        chkr = torch.where(even, b1r, b2r)
        chkg = torch.where(even, b1g, b2g)
        chkb = torch.where(even, b1b, b2b)

        is_lam = bmid == ids["LAMBERTIAN"]
        is_met = bmid == ids["METAL"]
        is_die = bmid == ids["DIELECTRIC"]
        is_chk = bmid == ids["CHECKERBOARD"]
        is_dif = is_lam | is_chk
        sel = torch.where
        ndx = sel(is_dif, difx, sel(is_met, metx, sel(is_die, dlx, nx + ballx)))
        ndy = sel(is_dif, dify, sel(is_met, mety, sel(is_die, dly, ny + bally)))
        ndz = sel(is_dif, difz, sel(is_met, metz, sel(is_die, dlz, nz + ballz)))
        one = torch.ones_like(b1r)
        att = torch.stack([
            sel(is_lam, b1 * lam_ratio, sel(is_chk, chk * lam_ratio,
                                             sel(is_met, b1, sel(is_die, one, one * pk))))
            for b1, chk, pk in ((b1r, chkr, pink[0]), (b1g, chkg, pink[1]),
                                (b1b, chkb, pink[2]))], dim=1)
        inv_len = 1.0 / torch.sqrt(
            torch.clamp(ndx * ndx + ndy * ndy + ndz * ndz, min=1.0e-24))

        # emissive area light: the path ends with x * albedo
        lit = bmid == ids["EMISSIVE"]
        if bool(lit.any()):
            idx = live[lit]
            out_c[idx] = torch.stack(
                [bmx[lit] * b1r[lit], bmx[lit] * b1g[lit], bmx[lit] * b1b[lit]],
                dim=1)
            out_t[idx] = tr[lit]
            out_alive[idx] = False
            out_o[idx] = torch.stack([ox[lit], oy[lit], oz[lit]], dim=1)
            out_d[idx] = torch.stack([dx[lit], dy[lit], dz[lit]], dim=1)
            out_state[idx] = state[lit]
        scat = ~lit
        tr = tr[scat] * att[scat]
        live, state = live[scat], state[scat]
        ox, oy, oz = px[scat], py[scat], pz[scat]
        dx = (ndx * inv_len)[scat]
        dy = (ndy * inv_len)[scat]
        dz = (ndz * inv_len)[scat]
    # paths alive after the last bounce keep colour 0 (out_c's zero)
    if live.numel():
        out_o[live] = torch.stack([ox, oy, oz], dim=1)
        out_d[live] = torch.stack([dx, dy, dz], dim=1)
        out_t[live] = tr
        out_state[live] = state
    return PathState(out_o, out_d, out_t, out_c, out_alive, out_state)


def camera_rays_plain(cam, xf, yf, inv_w: float, inv_h: float, state):
    """Jittered thin-lens camera rays (bounce.cuh ``camera_ray``): cam is
    the 20 f32 camera values as Python floats; returns (state, o, d) with
    o and d (x, y, z) tuples of [n] f32, d unit."""
    state, (ju, jv, dr, da) = rng.next_floats(state, 4)
    su = (xf + ju) * inv_w
    sv = 1.0 - (yf + jv) * inv_h
    lr = torch.sqrt(dr)
    la = TWO_PI * da
    lens_x = cam[18] * lr * torch.cos(la)
    lens_y = cam[18] * lr * torch.sin(la)
    ox = cam[0] + lens_x * cam[9] + lens_y * cam[12]
    oy = cam[1] + lens_x * cam[10] + lens_y * cam[13]
    oz = cam[2] + lens_x * cam[11] + lens_y * cam[14]
    dx = cam[15] + su * cam[3] + sv * cam[6] - ox
    dy = cam[16] + su * cam[4] + sv * cam[7] - oy
    dz = cam[17] + su * cam[5] + sv * cam[8] - oz
    inv_len = 1.0 / torch.sqrt(
        torch.clamp(dx * dx + dy * dy + dz * dz, min=1.0e-24))
    return state, (ox, oy, oz), (dx * inv_len, dy * inv_len, dz * inv_len)


def _trace_plain(o, d, state, inp: KernelInputs, num_bounces: int, counted=None,
                 mxu: bool = False):
    """Radiance [n, 3] of one sample per ray: tr * c after every bounce."""
    tr = torch.ones((o[0].shape[0], 3), dtype=_F32, device=o[0].device)
    p = trace_bounces_plain(o, d, tr, state, inp, 0, num_bounces, counted, mxu)
    return p.tr * p.c


def render_image_megakernel_plain(
    accum: torch.Tensor,
    frame,
    clear,
    scene: Scene,
    sky: SkyState,
    basis: CameraBasis,
    *,
    width: int,
    height: int,
    spp: int,
    num_bounces: int,
    chunk_size: Optional[int] = None,
    super_factor: int = 16,
    row_offset: int = 0,
    full_height: Optional[int] = None,
    budget_texels: int = DEFAULT_TEXTURE_BUDGET,
    stats: bool = False,
    mxu_sweep: bool = False,
):
    """The megakernel's computation in plain PyTorch, on ``accum``'s device;
    accumulates in place and returns ``accum`` (and, with ``stats``, the
    TPU kernel's per-tile table, as ``render_image_megakernel``). It reads
    the same prepared inputs and repeats the kernel's arithmetic: the same
    RNG order, the polynomial acos/atan2, the mipped texture LUT and the
    prefolded albedos. Pixels run in blocks of _PIXEL_BLOCK and spheres in
    blocks of _SPHERE_BLOCK, to bound memory."""
    inp = kernel_inputs(scene, sky, basis, chunk_size=chunk_size,
                        super_factor=super_factor, budget_texels=budget_texels,
                        mxu_sweep=mxu_sweep)
    return render_plain_with_inputs(
        accum, inp, frame, clear, width=width, height=height, spp=spp,
        num_bounces=num_bounces, row_offset=row_offset,
        full_height=full_height, stats=stats)


def _lane_weights(x, y, width: int, height: int):
    """How many lanes of the TPU's padded 64 x 64 tiles trace each pixel's
    path: the last column and row stand in for the padding past them
    (megakernel.py:1204-1206)."""
    pad_x = -(-width // TILE_W) * TILE_W - width
    pad_y = -(-height // TILE_H) * TILE_H - height
    return (torch.where(x == width - 1, 1 + pad_x, 1)
            * torch.where(y == height - 1, 1 + pad_y, 1))


def render_plain_with_inputs(accum: torch.Tensor, inp: KernelInputs, frame,
                             clear, *, width: int, height: int, spp: int,
                             num_bounces: int, row_offset: int = 0,
                             full_height: Optional[int] = None, stats: bool = False):
    """The plain version on prepared inputs (``launch_megakernel``'s twin,
    on the MXU route where ``mxu_route(inp)``). The counters do not touch
    the image's arithmetic: with ``stats`` the image is the same in every
    bit."""
    mxu = mxu_route(inp)
    if stats and mxu:
        raise NotImplementedError(STATS_MXU_REFUSAL)
    dev = accum.device
    fh = height if full_height is None else full_height
    inv_w = _f32(1.0 / width)
    inv_h = _f32(1.0 / fh)
    cam = [_f32(v) for v in inp.cam.tolist()]
    frame = int(frame) & rng.MASK32
    n = width * height
    tiles_x = -(-width // TILE_W)
    counter = (CullStats(inp, stats_tiles(width, height) * spp, num_bounces, dev)
               if stats else None)
    total = torch.empty((n, 3), dtype=_F32, device=dev)
    for p0 in range(0, n, _PIXEL_BLOCK):
        idx = torch.arange(p0, min(n, p0 + _PIXEL_BLOCK), device=dev)
        x = idx % width
        y = idx // width
        y_g = (y + int(row_offset)) & rng.MASK32
        pix = (y_g * width + x) & rng.MASK32
        xf = x.to(_F32)
        yf = y_g.to(torch.int32).to(_F32)
        if counter is not None:
            tile = (y // TILE_H) * tiles_x + x // TILE_W
            weight = _lane_weights(x, y, width, height)
        tot = torch.zeros((idx.numel(), 3), dtype=_F32, device=dev)
        for s in range(spp):
            state = rng.init_sample_state(pix, frame, s)
            state, o, d = camera_rays_plain(cam, xf, yf, inv_w, inv_h, state)
            counted = None if counter is None else (counter, tile * spp + s, weight)
            tot = tot + _trace_plain(o, d, state, inp, num_bounces, counted, mxu)
        total[p0:p0 + idx.numel()] = tot
    if clear:
        accum.zero_()
    accum += total
    return (accum, counter.table(spp)) if stats else accum
