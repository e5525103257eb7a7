"""Multi-card rendering: pixel-tile + sample sharding over a grid of ranks.

Counterpart of weekend_raytracer_tpu/parallel/sharding.py. The JAX package
shards one array over a (tiles, spp) device mesh under ``shard_map``; here
each torch.distributed rank is one cell of that grid and owns one card:

 - ``tiles`` axis (data parallel over pixels): the image rows and the
   persistent accumulator are split into horizontal bands; each rank keeps
   its band's accumulator for the whole progressive render, so no pixel
   data moves between ranks during a render.
 - ``spp`` axis (sample parallel): the ranks of one tile draw decorrelated
   sample batches for the same pixels and merge them with one
   ``all_reduce`` (sum) over their process group, where the JAX package
   runs one ``psum``.

The per-shard body, ``render_shard``, is pure: it takes the shard's grid
coordinates and returns its contribution, so any layout can also run one
shard after another in a single process (the tests and chip_smoke.py do).
``render_image_sharded`` calls it with the rank's own coordinates, then
all-reduces and accumulates.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..models.camera import CameraBasis
from ..models.params import RenderParamsValidationError
from ..models.sky import SkyState
from ..ops import rng
from ..ops.tracer import Scene, render_pixels

TILE_AXIS = "tiles"
SPP_AXIS = "spp"

# pixels per render_pixels call of the "xla" body: the Renderer's batch
# (renderer._default_pixel_batch), which bounds the [lanes x sphere_chunk]
# intersection intermediates; no pixel's result depends on it
_XLA_PIXEL_BATCH = 1 << 16


def _world() -> bool:
    return dist.is_available() and dist.is_initialized()


@dataclasses.dataclass(eq=False)
class Mesh:
    """A (tiles, spp) grid of torch.distributed ranks.

    ``ranks[t, s]`` is the global rank of tile ``t``, spp shard ``s``.
    ``tile_groups[t]`` is the process group of tile ``t``'s spp ranks (the
    all-reduce of its sample shards), ``spp_groups[s]`` that of spp index
    ``s``'s tile ranks (the gather of the frame's bands). Without a
    torch.distributed world both are None, and only a single-rank grid can
    render: the grid then only names shapes, for validation and for
    running shards one after another.
    """

    ranks: np.ndarray
    rank: Optional[int]
    tile_groups: Optional[tuple] = None
    spp_groups: Optional[tuple] = None

    @property
    def shape(self) -> dict:
        return {TILE_AXIS: int(self.ranks.shape[0]), SPP_AXIS: int(self.ranks.shape[1])}

    @property
    def distributed(self) -> bool:
        """Whether the grid has process groups (a torch.distributed world)."""
        return self.tile_groups is not None

    def coords(self) -> tuple:
        """This rank's (tile index, spp index)."""
        if self.rank is None:
            raise RenderParamsValidationError(
                f"this process is no rank of the {self.shape} mesh: a mesh of "
                "more than one rank renders only inside a torch.distributed world "
                "(parallel.multihost.initialize) that holds its ranks")
        t, s = np.argwhere(self.ranks == self.rank)[0]
        return int(t), int(s)


def make_mesh(
    devices: Optional[Sequence[int]] = None,
    tile_shards: Optional[int] = None,
    spp_shards: int = 1,
) -> Mesh:
    """Build a (tiles, spp) mesh over ``devices``, a sequence of global
    ranks (default: every rank of the torch.distributed world, or the one
    rank 0 outside a world). Defaults to all ranks on the tile axis.

    Inside a world every rank must call it, in the same order, since it
    creates the grid's process groups."""
    world = _world()
    if devices is None:
        devices = range(dist.get_world_size()) if world else (0,)
    ranks = [int(r) for r in devices]
    n = len(ranks)
    if spp_shards < 1 or n % spp_shards != 0:
        raise RenderParamsValidationError(
            f"spp_shards ({spp_shards}) must divide the device count ({n})"
        )
    if tile_shards is None:
        tile_shards = n // spp_shards
    if tile_shards * spp_shards != n:
        raise RenderParamsValidationError(
            f"tile_shards * spp_shards ({tile_shards}x{spp_shards}) must "
            f"equal the device count ({n})"
        )
    if len(set(ranks)) != n:
        raise RenderParamsValidationError(f"mesh ranks repeat: {ranks}")
    grid = np.asarray(ranks, dtype=np.int64).reshape(tile_shards, spp_shards)
    if not world:
        return Mesh(grid, ranks[0] if n == 1 else None)
    tile_groups = tuple(dist.new_group([int(r) for r in grid[t]])
                        for t in range(tile_shards))
    spp_groups = tuple(dist.new_group([int(r) for r in grid[:, s]])
                       for s in range(spp_shards))
    me = dist.get_rank()
    return Mesh(grid, me if me in ranks else None, tile_groups, spp_groups)


def validate_mesh_config(mesh: Mesh, viewport_size, spp_per_frame: int) -> None:
    """Typed up-front checks for rendering on a mesh (Renderer(mesh=...)).

    Heights that the tile axis doesn't divide are fine — the renderer pads
    rows — but the per-frame sample count must split evenly across the spp
    axis (samples are integers; fractional shards can't be decorrelated).
    """
    shape = getattr(mesh, "shape", {})
    if TILE_AXIS not in shape or SPP_AXIS not in shape:
        raise RenderParamsValidationError(
            f"mesh must have ({TILE_AXIS!r}, {SPP_AXIS!r}) axes, got {shape!r} "
            "(use parallel.sharding.make_mesh)"
        )
    n_spp = shape[SPP_AXIS]
    if spp_per_frame % n_spp != 0:
        raise RenderParamsValidationError(
            f"num_samples_per_pixel ({spp_per_frame}) must be divisible by "
            f"the mesh spp axis ({n_spp})"
        )


def shard_seed(frame, spp_idx: int, n_spp: int) -> int:
    """The RNG frame seed of spp shard ``spp_idx``: frame * n_spp + spp_idx
    in uint32, wrapping as the JAX package's does (sharding.py:143); an
    injective (frame, shard) -> seed map within one period."""
    return (int(frame) * int(n_spp) + int(spp_idx)) & rng.MASK32


def shard_rows(tile_idx: int, n_tiles: int, height: int) -> tuple:
    """(first global row, row count) of tile ``tile_idx``'s band of a
    ``height``-row accumulator (sharding.py:137, :158)."""
    block_rows = height // n_tiles
    return tile_idx * block_rows, block_rows


def _check_split(height: int, spp: int, n_tiles: int, n_spp: int) -> None:
    if height % n_tiles != 0:
        raise RenderParamsValidationError(
            f"accumulator height ({height}) must be divisible by the tile "
            f"axis ({n_tiles}); pad rows first (Renderer(mesh=...) does)"
        )
    if spp % n_spp != 0:
        raise RenderParamsValidationError(
            f"frame spp ({spp}) must be divisible by the spp axis ({n_spp})"
        )


def render_shard(
    frame,  # u32 frame number (int)
    scene: Scene,
    sky: SkyState,
    basis: CameraBasis,
    *,
    tile_idx: int,
    spp_idx: int,
    n_tiles: int,
    n_spp: int,
    width: int,
    height: int,
    spp: int,
    num_bounces: int,
    backend: str = "xla",
    aim_height: Optional[int] = None,
    budget_texels: Optional[int] = None,
    sphere_chunk: int = 512,
    mxu_sweep: Optional[bool] = None,
) -> torch.Tensor:
    """One shard's contribution to a frame: the sum of its ``spp // n_spp``
    samples for each pixel of its band, [height // n_tiles * width, 3] f32
    on the scene's device (the JAX ``shard_fn``, sharding.py:139-187,
    without the psum).

    ``height`` is the (possibly padded) accumulator height, divisible by
    ``n_tiles``; ``aim_height`` the real image height the camera basis was
    made for (defaults to ``height``). The band starts at global row
    ``tile_idx * block_rows``: every backend seeds and aims its rays in
    global image coordinates, and rows at or past ``aim_height`` render
    off-frame content that the caller drops. The shard's RNG frame seed is
    ``shard_seed(frame, spp_idx, n_spp)``.

    Backends: "regroup" (the lane-regrouped wavefront with ``default_cuts``;
    the band's pools are sized from the band), "pallas" (the megakernel)
    and "xla" (``render_pixels`` over the band's global pixel indices).
    CUDA tensors launch the kernels, CPU tensors run their plain twins.
    ``mxu_sweep`` goes to the fused backends (their MXU chunk sweep); "xla"
    ignores it, as the JAX package's does.
    """
    _check_split(height, spp, n_tiles, n_spp)
    if aim_height is None:
        aim_height = height
    row_offset, block_rows = shard_rows(tile_idx, n_tiles, height)
    local_spp = spp // n_spp
    seed = shard_seed(frame, spp_idx, n_spp)
    dev = scene.device
    bt = {} if budget_texels is None else {"budget_texels": budget_texels}
    if backend in ("regroup", "pallas"):
        contrib = torch.zeros((block_rows * width, 3), dtype=torch.float32, device=dev)
        kw = dict(width=width, height=block_rows, spp=local_spp, num_bounces=num_bounces,
                  row_offset=row_offset, full_height=aim_height, mxu_sweep=mxu_sweep, **bt)
        if backend == "regroup":
            from ..ops.cuda.regroup import default_cuts, render_image_regrouped

            n_spheres = int(scene.spheres.centers.shape[0])
            return render_image_regrouped(contrib, seed, True, scene, sky, basis,
                                          cuts=default_cuts(num_bounces, n_spheres), **kw)
        from ..ops.cuda.megakernel import render_image_megakernel

        return render_image_megakernel(contrib, seed, True, scene, sky, basis, **kw)
    if backend == "xla":
        n = block_rows * width
        first = tile_idx * n
        parts = []
        for lo in range(0, n, _XLA_PIXEL_BATCH):
            idx = torch.arange(first + lo, first + min(n, lo + _XLA_PIXEL_BATCH),
                               dtype=torch.int64, device=dev)
            parts.append(render_pixels(idx, seed, scene, sky, basis, width, aim_height,
                                       local_spp, num_bounces, sphere_chunk))
        return parts[0] if len(parts) == 1 else torch.cat(parts)
    raise RenderParamsValidationError(
        f"render_image_sharded backend must be 'xla', 'pallas', "
        f"or 'regroup', got {backend!r}"
    )


def render_image_sharded(
    accum: torch.Tensor,  # this rank's [height // n_tiles * width, 3] block
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
    mesh: Mesh,
    sphere_chunk: int = 512,
    backend: str = "xla",
    aim_height: Optional[int] = None,
    budget_texels: Optional[int] = None,
    on_stage: Optional[Callable[[str], None]] = None,
    mxu_sweep: Optional[bool] = None,
) -> torch.Tensor:
    """One progressive frame of this rank's band; returns ``accum``,
    updated in place to ``base + contrib`` (base = 0 when ``clear``).

    Semantics match ops.tracer.render_image: ``spp`` is the total samples
    per pixel added this frame, split evenly across the spp axis; the
    rank's contribution (``render_shard`` at the rank's own coordinates) is
    summed over its tile's spp ranks with one all_reduce. ``height`` is the
    padded accumulator height, ``aim_height`` the real one (see
    ``render_shard``). Every rank of the mesh must call it. ``on_stage(name)``
    is called after the shard's render ("shard") and after the all_reduce
    ("all_reduce"), e.g. to record a CUDA event. ``mxu_sweep`` as
    ``render_shard``'s.
    """
    n_tiles, n_spp = mesh.shape[TILE_AXIS], mesh.shape[SPP_AXIS]
    _check_split(height, spp, n_tiles, n_spp)
    tile_idx, spp_idx = mesh.coords()
    block = height // n_tiles * width
    if tuple(accum.shape) != (block, 3):
        raise ValueError(f"accum must be this rank's [{block}, 3] block, got "
                         f"{tuple(accum.shape)}")
    mark = on_stage or (lambda name: None)
    contrib = render_shard(frame, scene, sky, basis, tile_idx=tile_idx, spp_idx=spp_idx,
                           n_tiles=n_tiles, n_spp=n_spp, width=width, height=height,
                           spp=spp, num_bounces=num_bounces, backend=backend,
                           aim_height=aim_height, budget_texels=budget_texels,
                           sphere_chunk=sphere_chunk, mxu_sweep=mxu_sweep)
    mark("shard")
    if mesh.distributed:
        dist.all_reduce(contrib, op=dist.ReduceOp.SUM, group=mesh.tile_groups[tile_idx])
        mark("all_reduce")
    if clear:
        accum.zero_()
    accum += contrib
    return accum


def sharded_accumulator(width: int, height: int, mesh: Mesh, *, device) -> torch.Tensor:
    """Allocate this rank's zeroed [height // n_tiles * width, 3] block of
    the tile-sharded accumulator on ``device``."""
    n_tiles = mesh.shape[TILE_AXIS]
    if height % n_tiles != 0:
        raise RenderParamsValidationError(
            f"accumulator height ({height}) must be divisible by the tile "
            f"axis ({n_tiles})")
    return torch.zeros((height // n_tiles * width, 3), dtype=torch.float32,
                       device=device)


def gather_accumulator(block: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole (padded) accumulator, [n_tiles * block rows, 3], on every
    rank: the bands of the rank's spp index gathered in tile order (after a
    frame's all_reduce, every spp index holds the same bands). A mesh
    without process groups is one rank, whose block is the whole."""
    if not mesh.distributed:
        return block
    _, spp_idx = mesh.coords()
    column = [int(r) for r in mesh.ranks[:, spp_idx]]
    parts = [torch.empty_like(block) for _ in column]
    dist.all_gather(parts, block.contiguous(), group=mesh.spp_groups[spp_idx])
    # a group numbers its ranks in ascending global order
    by_rank = dict(zip(sorted(column), parts))
    return torch.cat([by_rank[r] for r in column])
