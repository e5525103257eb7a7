"""The row-compacted wavefront: layout, CUDA wrappers and plain twins.

Counterpart of weekend_raytracer_tpu/ops/pallas/wavefront.py. Per frame:

  K0       camera ray and bounces [0, b1) for every ray slot, where b1 is
           the first cut (or the whole bounce budget with no cuts); writes
           the record pool and each slot's contribution tr * cr.
  COMPACT  stable row-granular compaction: each 128-lane row with any live
           lane, among the rows still counted, is copied whole, in order,
           to a dense pool; the new row count stays on the device.
  K1       bounces [b_lo, b_hi) on the dense rows, in place, and every
           lane's tr * cr into its row's home row of the contributions.
           COMPACT and K1 repeat once per cut.

The contributions are then folded into the scanline accumulator: each
pixel's samples summed in sample order from 0, then added to the
accumulator (or written over it), as regroup's home combine does, so the
same samples give the same bits on both paths.

The three kernels are CUDA C++ (csrc/wavefront.cu) on the megakernel's
per-ray body (csrc/bounce.cuh). K0 and K1 cull their sweep per warp in
scenes with chunks (bounce.cuh ``sweep_culled``; the full sweep's result
in every bit); K0's lanes refill their samples, one slot of each of
``k0_slices(spp)`` slices of 32 slots after another, and K1 regroups the
live lanes of each ``K1_ROWS`` dense rows before it traces them
(``k1_block_order`` is that order in PyTorch); see wavefront.cu for what
bounds them on the card. Each has a plain PyTorch twin here
(``k0_plain``, ``compact_plain``, ``k1_plain``) with the same contract on
the same buffers, and ``render_image_wavefront_plain`` is the frame built
from the twins. ``render_image_wavefront`` launches the kernels for a
CUDA ``accum`` (or raises) and runs the twins for a CPU one. The kernels
before they culled, which sweep every sphere, stay in the library as the
exact reference of the gates, reached only through the private
``_launch_wavefront_full_sweep``. ``cull.wavefront_census`` counts the
culled kernels' work.

Layout, as in the JAX package (wavefront.py:57-61, 338-352): 32-row x
128-lane tiles with spp folded into lanes (``block_w = 128 >> log2(spp)``
pixels per tile row), slot = (tile * 32 + row) * 128 + lane, the same
slots as regroup's; a pool is [tiles, N_COMP, 32, 128] f32 and the
contributions [tiles, 3, 32, 128], so both compare element for element
with the JAX kernels'. A record carries its RNG state (the uint32's bits in
an f32) and its home row (tile * 32 + row, an exact f32 integer). Row
counts stay on the device.

The JAX function's ``mxu_sweep`` runs K0's and K1's culled chunk sweep on
the tensor cores (their ``kMxu`` instantiations; ``mk._closest_hit_mxu``
in the twins) where the JAX condition holds (``mk.mxu_route``,
wavefront.py:390-391); the full-sweep reference has no such route.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ...models.camera import CameraBasis
from ...models.sky import SkyState
from .. import rng
from ..tracer import Scene
from . import megakernel as mk
from . import regroup as rg
from .build import load_library

# Pool record layout (wavefront.py:57-61).
_OX, _OY, _OZ, _DX, _DY, _DZ = 0, 1, 2, 3, 4, 5
_TR, _TG, _TB = 6, 7, 8
_CR, _CG, _CB = 9, 10, 11
_ST, _AL, _HOME = 12, 13, 14
N_COMP = 15
LANES = 128  # lanes of a row
TILE_ROWS = 32  # rows of a tile
_PLANE = TILE_ROWS * LANES

_F32 = torch.float32
_I32 = torch.int32

KERNEL_SOURCE = "weekend_raytracer_tpu_torch/csrc/wavefront.cu"
# (name, compiled sources) for build.load_library
LIBRARY = ("wrt_wavefront", ("wavefront.cu",))
# the pallas_call each kernel replaces
REPLACES = {
    "k0": "weekend_raytracer_tpu/ops/pallas/wavefront.py:404",
    "compact": "weekend_raytracer_tpu/ops/pallas/wavefront.py:427",
    "k1": "weekend_raytracer_tpu/ops/pallas/wavefront.py:461",
}
# csrc/wavefront.cu kK0MaxSlices, kK1Rows and kThreads (the census groups
# lanes by them; tests/test_torch_wavefront_cull.py reads them there): the
# most slices of 32 slots a culled K0 warp walks down a tile
# (``k0_slices``), the dense rows each culled K1 block regroups, and the
# threads of a K1 block
K0_MAX_SLICES = 32
K1_ROWS = 8
_K1_THREADS = 256


def k0_slices(spp: int) -> int:
    """Slices of 32 slots a culled K0 warp walks at ``spp`` samples a pixel
    (csrc/wavefront.cu ``k0_slices``): min(spp, K0_MAX_SLICES), so that its
    slots are 32 pixels' samples."""
    return min(spp, K0_MAX_SLICES)


def plan(width: int, height: int, spp: int) -> rg.Tiling:
    """Validate a frame and lay it out (wavefront.py:355-370). The tiling
    is regroup's: the same slots for the same image."""
    if spp & (spp - 1) or not 1 <= spp <= 128:
        raise ValueError(
            f"wavefront spp must be a power of two <= 128 (samples fold "
            f"into the 128-lane dim), got {spp}")
    spp_shift = spp.bit_length() - 1
    block_w = 128 >> spp_shift
    tiles_x = -(-width // block_w)
    tiles_y = -(-height // TILE_ROWS)
    cap = tiles_x * tiles_y * _PLANE
    if cap >= 1 << 31:
        raise ValueError("the wavefront supports < 2^31 rays/frame (home rows exact in f32)")
    return rg.Tiling(width, height, spp, spp_shift, block_w, tiles_x, tiles_y, cap, 0, height)


def _cuts_within(phase_cuts, num_bounces: int) -> tuple:
    """The cuts that split the bounce budget (wavefront.py:359)."""
    return tuple(c for c in phase_cuts if 0 < c < num_bounces)


class Workspace(NamedTuple):
    """The frame's buffers."""

    pools: tuple  # [tiles, N_COMP, 32, 128] f32: K0's pool, and with cuts a dense one
    contrib: torch.Tensor  # [tiles, 3, 32, 128] f32: each slot's tr * cr
    counts: torch.Tensor  # [phases + 1] i32: counts[0] = rows, then live rows
    tile_sums: torch.Tensor  # [tiles] i32: the CUDA compaction's scan scratch


def _workspace(device, t: rg.Tiling, phases: int) -> Workspace:
    """A frame's buffers on ``device``: at 1080p x 32 spp, 4.01 GB per pool
    and 0.80 GB of contributions. A second pool exists only with cuts, for
    COMPACT to copy into; the dense pools then take turns. They are
    allocated anew for each frame, from PyTorch's caching allocator."""
    n_tiles = t.cap // _PLANE
    pools = tuple(torch.empty((n_tiles, N_COMP, TILE_ROWS, LANES), dtype=_F32, device=device)
                  for _ in range(2 if phases else 1))
    return Workspace(
        pools=pools,
        contrib=torch.empty((n_tiles, 3, TILE_ROWS, LANES), dtype=_F32, device=device),
        counts=torch.full((phases + 1,), t.cap // LANES, dtype=_I32, device=device),
        tile_sums=torch.empty((n_tiles,), dtype=_I32, device=device))


# --------------------------------------------------------------------------
# The CUDA kernels' wrappers
# --------------------------------------------------------------------------

# wavefront.cu wrt_wavefront_attributes index -> kernel ("global": the boxes
# in global memory; "full_sweep": the kCull = false reference)
KERNEL_NAMES = ("k0", "k0_textured", "k0_global", "k0_global_textured", "k0_full_sweep",
                "k0_full_sweep_textured", "k1", "k1_textured", "k1_global",
                "k1_global_textured", "k1_full_sweep", "k1_full_sweep_textured",
                "compact_count", "compact_scan", "compact_scatter", "k0_mxu", "k0_mxu_textured",
                "k0_mxu_global", "k0_mxu_global_textured", "k1_mxu", "k1_mxu_textured",
                "k1_mxu_global", "k1_mxu_global_textured")


def _library():
    """Build (first use) and load the kernel library; raises on failure."""
    built = load_library(*LIBRARY)
    lib = built.lib
    if lib.wrt_wavefront_k0.argtypes is None:
        vp, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
        ll = ctypes.c_longlong
        k0 = [vp] * 5 + [i, vp, vp, ll, i, i, i, i, f, f, u, i]
        k1 = [vp] * 4 + [i, vp, vp, vp, ll, i, i]
        sigs = {
            "wrt_wavefront_k0": k0 + mk.CULL_ARGTYPES + [f, f, vp],
            "wrt_wavefront_k0_full_sweep": k0 + [vp],
            "wrt_wavefront_compact": [vp] * 5 + [ll, vp],
            "wrt_wavefront_k1": k1 + mk.CULL_ARGTYPES + [f, f, vp],
            "wrt_wavefront_k1_full_sweep": k1 + [vp],
            "wrt_wavefront_k0_mxu": k0 + mk.CULL_ARGTYPES + [f, f, vp, vp],
            "wrt_wavefront_k1_mxu": k1 + mk.CULL_ARGTYPES + [f, f, vp, vp],
            "wrt_wavefront_attributes": [i] + [ctypes.POINTER(i)] * 3,
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name in ("wrt_wavefront_launch_bounds", "wrt_wavefront_mxu_launch_bounds"):
            getattr(lib, name).argtypes = [ctypes.POINTER(i)] * 2
            getattr(lib, name).restype = None
        lib.wrt_wavefront_cull_smem.argtypes = [i, i, i, i, ctypes.POINTER(i)]
        lib.wrt_wavefront_cull_smem.restype = ll
    return built


def kernel_attributes() -> dict:
    """Registers per thread, local-memory bytes and static shared-memory
    bytes of each built kernel."""
    lib = _library().lib
    out = {}
    for which, name in enumerate(KERNEL_NAMES):
        regs, local, shared = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
        err = lib.wrt_wavefront_attributes(which, ctypes.byref(regs), ctypes.byref(local),
                                           ctypes.byref(shared))
        if err:
            raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err}")
        out[name] = {"registers": regs.value, "local_bytes": local.value,
                     "shared_bytes": shared.value}
    return out


def launch_bounds(mxu: bool = False) -> tuple:
    """The culled K0's and K1's __launch_bounds__: (threads a block, blocks
    an SM), which fix their register budget (wavefront.cu kMinBlocks;
    ``mxu``: their MXU instantiations', kMxuMinBlocks)."""
    threads, min_blocks = ctypes.c_int(0), ctypes.c_int(0)
    lib = _library().lib
    fn = lib.wrt_wavefront_mxu_launch_bounds if mxu else lib.wrt_wavefront_launch_bounds
    fn(ctypes.byref(threads), ctypes.byref(min_blocks))
    return threads.value, min_blocks.value


def cull_placement(inp: mk.KernelInputs) -> dict:
    """Where the culled K0 and K1 read this scene's cull tables
    (bounce.cuh stage_cull; K1's lane list takes its share of what a block
    stages): per kernel, ``smem_bytes``, the dynamic shared memory of a
    block, and ``boxes``, "shared", "global" or "none"."""
    out = {}
    for k1, name in ((0, "k0"), (1, "k1")):
        staged = ctypes.c_int(0)
        smem = _library().lib.wrt_wavefront_cull_smem(k1, inp.n_chunks, inp.n_tests,
                                                      inp.n_super, ctypes.byref(staged))
        out[name] = {"smem_bytes": int(smem),
                     "boxes": ("shared" if staged.value else "global") if inp.n_chunks
                     else "none"}
    return out


def _stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _device_type(t: torch.Tensor) -> str:
    return t.device.type


def _expect_pool(pool: torch.Tensor, comps: int, device) -> int:
    """Check a [tiles, comps, 32, 128] f32 buffer; returns its slot count."""
    cap = pool.numel() // comps
    rg._expect(pool, (cap // _PLANE, comps, TILE_ROWS, LANES), _F32, device)
    if not 0 < cap < 1 << 31:
        raise ValueError(f"pool of {cap} slots is not 1 to 2^31 - 1 whole tiles")
    return cap


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"wavefront {what} launch failed: CUDA error {err}")


def _k0_args(inp: mk.KernelInputs, pool: torch.Tensor, contrib: torch.Tensor,
             t: rg.Tiling, frame, b_hi: int) -> tuple:
    """K0's arguments before the cull hierarchy, after checking them."""
    dev = pool.device
    rg._expect_scene(inp, dev)
    if _expect_pool(pool, N_COMP, dev) != t.cap or _expect_pool(contrib, 3, dev) != t.cap:
        raise ValueError(f"K0 buffers are not of the tiling's {t.cap} slots")
    return (inp.cam.data_ptr(), *rg._scene_ptrs(inp), pool.data_ptr(), contrib.data_ptr(),
            t.cap, t.width, t.height, t.tiles_x, t.spp_shift, mk._f32(1.0 / t.width),
            mk._f32(1.0 / t.height), int(frame) & rng.MASK32, int(b_hi))


def launch_k0(inp: mk.KernelInputs, pool: torch.Tensor, contrib: torch.Tensor,
              t: rg.Tiling, frame, b_hi: int) -> None:
    """K0 on the current stream: every slot's record into ``pool`` [tiles,
    15, 32, 128] and its tr * cr into ``contrib`` [tiles, 3, 32, 128], the
    sweep culled per warp where ``inp`` has chunks (the library stages the
    boxes in shared memory while they fit, else reads them from global
    memory) and each lane's slots refilled (``k0_slices``). Counts one launch in
    ``launch_k0.launches``; where ``mk.mxu_route(inp)`` it launches K0's
    MXU instantiation, counted in ``launch_k0.mxu_launches``."""
    args = _k0_args(inp, pool, contrib, t, frame, b_hi)
    dev = pool.device
    lib = _library().lib
    if mk.mxu_route(inp):
        err = lib.wrt_wavefront_k0_mxu(*args, *rg._cull_args(inp, dev),
                                       mk.check_amats(inp, dev), _stream_handle(dev))
        _raise_on(err, "K0 MXU")
        launch_k0.mxu_launches += 1
        return
    err = lib.wrt_wavefront_k0(*args, *rg._cull_args(inp, dev), _stream_handle(dev))
    _raise_on(err, "K0")
    launch_k0.launches += 1


def _launch_k0_full_sweep(inp: mk.KernelInputs, pool: torch.Tensor, contrib: torch.Tensor,
                          t: rg.Tiling, frame, b_hi: int) -> None:
    """``launch_k0``'s contract through the kCull = false instantiation
    (one slot a thread, every sphere swept with FMAs, whatever ``inp``
    carries): the gates' exact reference. Counts in
    ``_launch_k0_full_sweep.launches``."""
    args = _k0_args(inp, pool, contrib, t, frame, b_hi)
    err = _library().lib.wrt_wavefront_k0_full_sweep(*args, _stream_handle(pool.device))
    _raise_on(err, "K0 full-sweep")
    _launch_k0_full_sweep.launches += 1


def launch_compact(src: torch.Tensor, dst: torch.Tensor, counts: torch.Tensor, k: int,
                   tile_sums: torch.Tensor) -> None:
    """COMPACT number k (1-based) on the current stream: of the first
    counts[k - 1] rows of ``src``, each with a live lane goes, in order, to
    the next row of ``dst``, and counts[k] gets their number. Rows of
    ``dst`` from counts[k] on are not written. Counts one launch in
    ``launch_compact.launches``."""
    dev = src.device
    cap = _expect_pool(src, N_COMP, dev)
    if _expect_pool(dst, N_COMP, dev) != cap:
        raise ValueError("COMPACT's pools differ in size")
    rg._expect(tile_sums, (cap // _PLANE,), _I32, dev)
    err = _library().lib.wrt_wavefront_compact(
        src.data_ptr(), dst.data_ptr(), rg._count_ptr(counts, k - 1, dev),
        rg._count_ptr(counts, k, dev), tile_sums.data_ptr(), cap, _stream_handle(dev))
    _raise_on(err, "COMPACT")
    launch_compact.launches += 1


def _k1_args(inp: mk.KernelInputs, pool: torch.Tensor, contrib: torch.Tensor,
             counts: torch.Tensor, k: int, b_lo: int, b_hi: int) -> tuple:
    """K1's arguments before the cull hierarchy, after checking them."""
    dev = pool.device
    rg._expect_scene(inp, dev)
    cap = _expect_pool(pool, N_COMP, dev)
    if _expect_pool(contrib, 3, dev) != cap:
        raise ValueError("K1's pool and contributions differ in size")
    return (*rg._scene_ptrs(inp), pool.data_ptr(), contrib.data_ptr(),
            rg._count_ptr(counts, k, dev), cap, int(b_lo), int(b_hi))


def launch_k1(inp: mk.KernelInputs, pool: torch.Tensor, contrib: torch.Tensor,
              counts: torch.Tensor, k: int, b_lo: int, b_hi: int) -> None:
    """K1 of phase k on the current stream: bounces [b_lo, b_hi) of the
    live lanes of the counts[k] dense rows of ``pool``, in place, and every
    lane's tr * cr into its home row of ``contrib``, the live lanes of each
    K1_ROWS rows regrouped and their sweep culled per warp where ``inp``
    has chunks. Counts one launch in ``launch_k1.launches``; where
    ``mk.mxu_route(inp)`` it launches K1's MXU instantiation, counted in
    ``launch_k1.mxu_launches``."""
    args = _k1_args(inp, pool, contrib, counts, k, b_lo, b_hi)
    dev = pool.device
    lib = _library().lib
    if mk.mxu_route(inp):
        err = lib.wrt_wavefront_k1_mxu(*args, *rg._cull_args(inp, dev),
                                       mk.check_amats(inp, dev), _stream_handle(dev))
        _raise_on(err, "K1 MXU")
        launch_k1.mxu_launches += 1
        return
    err = lib.wrt_wavefront_k1(*args, *rg._cull_args(inp, dev), _stream_handle(dev))
    _raise_on(err, "K1")
    launch_k1.launches += 1


def _launch_k1_full_sweep(inp: mk.KernelInputs, pool: torch.Tensor, contrib: torch.Tensor,
                          counts: torch.Tensor, k: int, b_lo: int, b_hi: int) -> None:
    """``launch_k1``'s contract through the kCull = false instantiation
    (one lane a thread, every sphere swept with FMAs, whatever ``inp``
    carries): the gates' exact reference. Counts in
    ``_launch_k1_full_sweep.launches``."""
    args = _k1_args(inp, pool, contrib, counts, k, b_lo, b_hi)
    err = _library().lib.wrt_wavefront_k1_full_sweep(*args, _stream_handle(pool.device))
    _raise_on(err, "K1 full-sweep")
    _launch_k1_full_sweep.launches += 1


for _fn in (launch_k0, launch_compact, launch_k1, _launch_k0_full_sweep,
            _launch_k1_full_sweep):
    _fn.launches = 0
launch_k0.mxu_launches = launch_k1.mxu_launches = 0


# --------------------------------------------------------------------------
# The plain twins: the same contracts on the same buffers, in PyTorch
# --------------------------------------------------------------------------

def _u32_bits(state: torch.Tensor) -> torch.Tensor:
    """uint32 values (in int64) as the int32 of the same bits."""
    return (state - ((state >> 31) << 32)).to(_I32)


def _planes(v: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """Per-slot values [n] or [n, 3] of whole tiles as [tiles, 4096] or
    [tiles, 3, 4096]."""
    if v.dim() == 1:
        return v.reshape(n_tiles, _PLANE)
    return v.T.reshape(3, n_tiles, _PLANE).permute(1, 0, 2)


def k0_plain(inp: mk.KernelInputs, pool: torch.Tensor, contrib: torch.Tensor,
             t: rg.Tiling, frame, b_hi: int) -> None:
    """``launch_k0``'s twin. It traces the slots in regroup's k0_plain's
    batches, so the two give the same bits on the CPU too. It seeds and
    aims rows at ``t.row_offset`` of an image ``t.full_height`` tall, as
    regroup does (0 and the height for every tiling ``plan`` makes), so a
    band of tile rows can be held against the kernel's full image."""
    mxu = mk.mxu_route(inp)
    dev = pool.device
    n_tiles = t.cap // _PLANE
    recs = pool.view(n_tiles, N_COMP, _PLANE)
    con = contrib.view(n_tiles, 3, _PLANE)
    cam = [mk._f32(v) for v in inp.cam.tolist()]
    inv_w, inv_h = mk._f32(1.0 / t.width), mk._f32(1.0 / t.full_height)
    frame = int(frame) & rng.MASK32
    for lo in range(0, t.cap, rg._BLOCK):
        hi = min(t.cap, lo + rg._BLOCK)
        slot = torch.arange(lo, hi, device=dev)
        state, x, y_g = rg._seeds(t, slot, frame)
        yf = y_g.to(torch.int32).to(_F32)
        state, o, d = mk.camera_rays_plain(cam, x.to(_F32), yf, inv_w, inv_h, state)
        tr = torch.ones((hi - lo, 3), dtype=_F32, device=dev)
        p = mk.trace_bounces_plain(o, d, tr, state, inp, 0, b_hi, mxu=mxu)
        nt = (hi - lo) // _PLANE
        blk = recs[lo // _PLANE:hi // _PLANE]
        blk[:, _OX:_OZ + 1] = _planes(p.o, nt)
        blk[:, _DX:_DZ + 1] = _planes(p.d, nt)
        blk[:, _TR:_TB + 1] = _planes(p.tr, nt)
        blk[:, _CR:_CB + 1] = _planes(p.c, nt)
        blk.view(_I32)[:, _ST] = _planes(_u32_bits(p.state), nt)
        blk[:, _AL] = _planes(p.alive.to(_F32), nt)
        blk[:, _HOME] = _planes((slot >> 7).to(_F32), nt)
        con[lo // _PLANE:hi // _PLANE] = _planes(p.tr * p.c, nt)


def _row_index(rows: torch.Tensor):
    """(tile, row in tile) of global row numbers."""
    return rows >> 5, rows & (TILE_ROWS - 1)


def compact_plain(src: torch.Tensor, dst: torch.Tensor, counts: torch.Tensor, k: int,
                  tile_sums=None) -> None:
    """``launch_compact``'s twin (``tile_sums`` is the kernel's scratch and
    not used). Rows are copied as int32, so every bit moves as it is."""
    n_in = int(counts[k - 1])
    alive = src[:, _AL].reshape(-1, LANES)[:n_in]
    live = torch.nonzero((alive > 0.0).any(dim=1)).squeeze(1)
    n = live.numel()
    st, sr = _row_index(live)
    dt, dr = _row_index(torch.arange(n, device=src.device))
    dst.view(_I32)[dt, :, dr] = src.view(_I32)[st, :, sr]
    counts[k] = n


_ROW_BLOCK = 1 << 12  # rows per batch of k1_plain's contributions (bounds its memory)


def k1_plain(inp: mk.KernelInputs, pool: torch.Tensor, contrib: torch.Tensor,
             counts: torch.Tensor, k: int, b_lo: int, b_hi: int) -> None:
    """``launch_k1``'s twin. It traces the live lanes in dense order, which
    is regroup's dense order, in regroup's k1_plain's batches, so the two
    give the same bits on the CPU too."""
    mxu = mk.mxu_route(inp)
    n_rows = int(counts[k])
    flat = pool.view(-1)
    bits = flat.view(_I32)
    alive = pool[:, _AL].reshape(-1, LANES)[:n_rows] > 0.5
    row, lane = torch.nonzero(alive, as_tuple=True)
    tile, trow = _row_index(row)
    base = tile * (N_COMP * _PLANE) + trow * LANES + lane
    for lo in range(0, base.numel(), rg._BLOCK):
        at = base[lo:lo + rg._BLOCK]

        def comp(c, at=at):
            return flat[at + c * _PLANE]

        o = (comp(_OX), comp(_OY), comp(_OZ))
        d = (comp(_DX), comp(_DY), comp(_DZ))
        tr = torch.stack([comp(_TR), comp(_TG), comp(_TB)], dim=1)
        state = bits[at + _ST * _PLANE].to(torch.int64) & rng.MASK32
        p = mk.trace_bounces_plain(o, d, tr, state, inp, b_lo, b_hi, mxu=mxu)
        for c, v in ((_OX, p.o), (_DX, p.d), (_TR, p.tr), (_CR, p.c)):
            for j in range(3):
                flat[at + (c + j) * _PLANE] = v[:, j]
        bits[at + _ST * _PLANE] = _u32_bits(p.state)
        flat[at + _AL * _PLANE] = p.alive.to(_F32)
    for lo in range(0, n_rows, _ROW_BLOCK):
        t0, r0 = _row_index(torch.arange(lo, min(n_rows, lo + _ROW_BLOCK), device=pool.device))
        rec = pool[t0, :, r0]  # [rows, N_COMP, 128]
        home = rec[:, _HOME, 0].to(torch.int64)
        ht, hr = _row_index(home)
        contrib[ht, :, hr] = rec[:, _TR:_TB + 1] * rec[:, _CR:_CB + 1]


def k1_block_order(alive: torch.Tensor, rows_per_block: int = K1_ROWS):
    """The order in which the culled K1 traces the live lanes of its dense
    rows, as csrc/wavefront.cu ranks them: ``alive`` [rows, 128] bool, in
    blocks of ``rows_per_block`` rows (the last one cut at the row count).
    Lane e = it * 256 + thread of a block's rows takes pass ``it``; each
    warp's live lanes are counted (its ballot), the counts summed over
    (pass, warp) into an exclusive prefix, and a live lane's entry is that
    prefix plus its rank among the warp's live lanes: the live lanes in lane
    order. Returns (order [blocks, rows_per_block * 128] i64, the lane index
    of each entry and -1 past the block's live count; n_live [blocks])."""
    rows = alive.shape[0]
    per = rows_per_block * LANES
    if per % _K1_THREADS:
        raise ValueError(f"K1 takes an even number of rows a block, got {rows_per_block}")
    n_blocks = -(-rows // rows_per_block)
    pad = n_blocks * rows_per_block - rows
    a = torch.cat([alive.to(torch.bool), alive.new_zeros((pad, LANES), dtype=torch.bool)])
    warps = a.view(n_blocks, per // 32, 32).to(torch.int64)
    counts = warps.sum(dim=2)  # [blocks, (pass, warp)]: each ballot's popc
    base = torch.cumsum(counts, dim=1) - counts
    rank = torch.cumsum(warps, dim=2) - warps  # popc(ballot & lanes below)
    pos = (base[:, :, None] + rank).view(n_blocks, per)
    b, e = torch.nonzero(a.view(n_blocks, per), as_tuple=True)
    order = torch.full((n_blocks, per), -1, dtype=torch.int64, device=alive.device)
    order[b, pos[b, e]] = e
    return order, counts.sum(dim=1)


def _fold(contrib: torch.Tensor, accum: torch.Tensor, t: rg.Tiling, clear) -> None:
    """Each pixel's spp lanes summed in sample order from 0, then added to
    the scanline accumulator (written over it when ``clear``): the order of
    regroup's home combine. A sum over the spp axis would not promise it."""
    img = contrib.reshape(t.tiles_y, t.tiles_x, 3, TILE_ROWS, t.block_w, t.spp)
    tot = torch.zeros(img.shape[:-1], dtype=_F32, device=contrib.device)
    for s in range(t.spp):
        tot = tot + img[..., s]
    tot = tot.permute(2, 0, 3, 1, 4).reshape(3, t.tiles_y * TILE_ROWS, t.tiles_x * t.block_w)
    tot = tot[:, :t.height, :t.width].reshape(3, -1).T
    if clear:
        accum.zero_()
    accum += tot


# --------------------------------------------------------------------------
# One frame
# --------------------------------------------------------------------------

def _steps(route: str) -> tuple:
    """K0, COMPACT and K1 of a route, looked up when a frame runs: "kernels"
    (the culled kernels), "full_sweep" (K0's and K1's kCull = false
    instantiations) or "twins"."""
    return {"kernels": (launch_k0, launch_compact, launch_k1),
            "full_sweep": (_launch_k0_full_sweep, launch_compact, _launch_k1_full_sweep),
            "twins": (k0_plain, compact_plain, k1_plain)}[route]


def _frame(route: str, accum: torch.Tensor, inp: mk.KernelInputs, frame, clear,
           t: rg.Tiling, cuts: tuple, num_bounces: int, on_stage=None,
           debug_counts: bool = False, mxu=None):
    """K0, then COMPACT and K1 per cut, then the fold, on one route
    (``_steps``); ``mxu`` = (K0's, K1's) MXU route, None: each
    ``mk.mxu_route(inp)`` (the full-sweep route has none and sweeps with FMAs)."""
    k0, compact, k1 = _steps(route)
    mxu0, mxu1 = (None, None) if mxu is None else mxu
    mark = on_stage or (lambda name: None)
    ws = _workspace(accum.device, t, len(cuts))
    inp0, inp1 = mk.with_route(inp, mxu0), mk.with_route(inp, mxu1)
    k0(inp0, ws.pools[0], ws.contrib, t, frame, cuts[0] if cuts else num_bounces)
    mark("k0")
    for k, b_lo in enumerate(cuts, 1):
        b_hi = cuts[k] if k < len(cuts) else num_bounces
        src, dst = ws.pools[(k - 1) % 2], ws.pools[k % 2]
        compact(src, dst, ws.counts, k, ws.tile_sums)
        mark(f"compact{k}")
        k1(inp1, dst, ws.contrib, ws.counts, k, b_lo, b_hi)
        mark(f"k1_{k}")
    _fold(ws.contrib, accum, t, clear)
    mark("fold")
    if debug_counts:
        return accum, tuple(ws.counts[k:k + 1] for k in range(len(cuts) + 1))
    return accum


def launch_wavefront(accum: torch.Tensor, inp: mk.KernelInputs, frame, clear, *,
                     width: int, height: int, spp: int, num_bounces: int,
                     phase_cuts: tuple = (), on_stage=None, debug_counts: bool = False,
                     mxu=None):
    """One frame of the CUDA kernels on prepared inputs, on the current
    stream. ``on_stage(name)`` is called after each step ("k0",
    "compact1", "k1_1", ..., "fold"), e.g. to record a CUDA event. ``mxu`` =
    (K0's, K1's) MXU route; None follows ``inp`` (``mk.mxu_route``)."""
    t = plan(width, height, spp)
    mk._check_accum(accum, width, height, spp, num_bounces)
    return _frame("kernels", accum, inp, frame, clear, t,
                  _cuts_within(phase_cuts, num_bounces), num_bounces, on_stage, debug_counts,
                  mxu)


def _launch_wavefront_full_sweep(accum: torch.Tensor, inp: mk.KernelInputs, frame, clear, *,
                                 width: int, height: int, spp: int, num_bounces: int,
                                 phase_cuts: tuple = (), on_stage=None,
                                 debug_counts: bool = False):
    """``launch_wavefront`` through K0's and K1's kCull = false
    instantiations, which sweep every sphere, one slot or lane a thread (and
    the same COMPACT): the exact full-sweep reference that the gates hold
    the culled kernels to, with FMAs whatever ``inp`` carries. Neither the
    Renderer nor any public entry point reaches it."""
    t = plan(width, height, spp)
    mk._check_accum(accum, width, height, spp, num_bounces)
    return _frame("full_sweep", accum, inp, frame, clear, t,
                  _cuts_within(phase_cuts, num_bounces), num_bounces, on_stage, debug_counts,
                  (False, False))


def wavefront_plain_with_inputs(accum: torch.Tensor, inp: mk.KernelInputs, frame, clear, *,
                                width: int, height: int, spp: int, num_bounces: int,
                                phase_cuts: tuple = (), on_stage=None,
                                debug_counts: bool = False, mxu=None):
    """``launch_wavefront``'s twin, on ``accum``'s device."""
    t = plan(width, height, spp)
    mk._check_accum(accum, width, height, spp, num_bounces)
    return _frame("twins", accum, inp, frame, clear, t, _cuts_within(phase_cuts, num_bounces),
                  num_bounces, on_stage, debug_counts, mxu)


def _texture_budget(budget_texels: Optional[int]) -> int:
    return mk.DEFAULT_TEXTURE_BUDGET if budget_texels is None else budget_texels


def render_image_wavefront(
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
    phase_cuts: tuple = (),
    debug_counts: bool = False,
    budget_texels: Optional[int] = None,
    mxu_sweep=None,
):
    """One progressive frame via the row-compacted wavefront; returns
    ``accum`` (and, with ``debug_counts``, the home pool's row count and the
    live row count after each cut, each an i32 [1] tensor on ``accum``'s
    device, as the JAX function gives them).

    phase_cuts are the bounce indices at which live rows are re-compacted
    (those outside (0, num_bounces) are dropped); the default () runs the
    whole bounce budget in K0, as the JAX Renderer does. The frame
    accumulates in place into ``accum``. A CUDA ``accum`` launches the CUDA
    kernels (each counted on its ``launch_*`` wrapper) or raises; a CPU
    ``accum`` runs the plain twins. ``mxu_sweep`` (None:
    ``mk._default_mxu_sweep``) runs K0's and K1's culled chunk sweeps on
    the tensor cores where ``mk.mxu_route`` holds.
    """
    mxu = mk.resolve_mxu_sweep(mxu_sweep, scene)
    t = plan(width, height, spp)
    mk._check_accum(accum, width, height, spp, num_bounces)
    kind = _device_type(accum)
    if kind == "cuda":
        if scene.device != accum.device:
            raise ValueError(f"scene on {scene.device}, accum on {accum.device}")
    elif kind != "cpu":
        raise ValueError(f"unsupported device {accum.device}")
    inp = mk.kernel_inputs(scene, sky, basis, chunk_size=chunk_size, super_factor=super_factor,
                           budget_texels=_texture_budget(budget_texels), mxu_sweep=mxu)
    return _frame("kernels" if kind == "cuda" else "twins", accum, inp, frame, clear, t,
                  _cuts_within(phase_cuts, num_bounces), num_bounces,
                  debug_counts=debug_counts)


def render_image_wavefront_plain(
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
    phase_cuts: tuple = (),
    debug_counts: bool = False,
    budget_texels: Optional[int] = None,
):
    """The wavefront frame built from the plain twins, on ``accum``'s device
    (CPU or CUDA)."""
    inp = mk.kernel_inputs(scene, sky, basis, chunk_size=chunk_size, super_factor=super_factor,
                           budget_texels=_texture_budget(budget_texels))
    return wavefront_plain_with_inputs(
        accum, inp, frame, clear, width=width, height=height, spp=spp,
        num_bounces=num_bounces, phase_cuts=phase_cuts, debug_counts=debug_counts)


__all__ = ["k0_slices", "k1_block_order", "render_image_wavefront",
           "render_image_wavefront_plain"]
