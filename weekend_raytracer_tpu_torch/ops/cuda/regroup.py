"""The lane-regrouped wavefront: layout, CUDA wrappers and plain twins.

Counterpart of weekend_raytracer_tpu/ops/pallas/regroup.py. Per frame:

  K0       camera ray and bounces [0, cuts[0]) for every ray slot; writes
           the record pool and each slot's contribution tr * cr.
  PACK     stable compaction of the live records into a dense pool, with
           the inverse map (slot -> dense position, or -1) and the count.
  K1       bounces [b_lo, b_hi) on the dense pool, in place, plus the
           base-radiance pool tr * cr. PACK and K1 repeat once per cut.
  COMBINE  once per frame: each home slot's radiance, found by following
           the inverse maps to the phase its record ended in (the value
           the JAX package's reverse-composed levels leave at the home
           level), folded pixel by pixel into the scanline accumulator.

The four kernels are CUDA C++ (csrc/regroup.cu), and K0 and K1 run the
megakernel's own per-ray body (csrc/bounce.cuh), with its closest-hit sweep
culled per warp of 32 records in scenes with chunks (bounce.cuh
``sweep_culled``; the full sweep's result in every bit); see regroup.cu for
what bounds them on the card. Each has a plain PyTorch twin here
(``k0_plain``, ``pack_plain``, ``k1_plain``, ``combine_chain_plain``) with
the same contract on the same buffers, and ``render_image_regrouped_plain``
is the frame built from the twins. ``combine_plain`` is one reverse-combine
level of the JAX package (regroup.py:1396-1483), held against it in the
tests; a chain of it gives ``combine_chain_plain``'s result. ``render_image_regrouped`` launches the
kernels for a CUDA ``accum`` (or raises) and runs the twins for a CPU one.
``launch_k1`` and ``k1_plain`` also take a ``stats=`` table,
``_make_k1(stats=True)``'s counters per dense tile. The cull's own twin is
``cull.warp_cull_plain``; ``cull_census`` runs it over a frame's rays, to
count the work K0 and K1 do (their bounds).

Layout, as in the JAX package (regroup.py:76-127, 1072-1091): 32-row x
128-lane tiles with spp folded into lanes (``block_w = 128 >> log2(spp)``
pixels per tile row), slot = (tile * 32 + row) * 128 + lane; a pool is SoA
[N_COMP, cap] f32 in slot order, so pools, counts and inverse maps compare
element for element with the JAX pipeline. A record's home slot is two
exact f32 integers (HLO, HHI). Counts stay on the device: each launch
after PACK reads its count there (K1 is sized by the capacity, PACK's
persistent blocks stop at the input count), so a frame needs no host
synchronisation.

Knobs of the JAX function that only choose a TPU mechanism, and that its
own tests show bit-identical (``pack_v2``, ``combine_v2``, ``skip_dead``,
``dyn_grid``, ``k1_tsub``, ``k1_chunk_size``), are accepted: the port has
one implementation of their common contract. ``mxu_sweep`` runs K0's and
K1's culled chunk sweep on the tensor cores (their ``kMxu``
instantiations; ``mk._closest_hit_mxu`` in the twins) where the JAX
condition holds for each (regroup.py:1171-1174: K1 reads
``k1_chunk_size``); K1 sweeps K0's prepared chunks either way. The other
TPU sweep variants (``listed``, ``k1_subcull``, ``rowsweep``,
``rowsweep_k0``) and ``profile_stop`` raise ``NotImplementedError`` for any
value but off.
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
from .build import load_library
from .cull import CullCount, warp_cull_plain

# Pool record layout (regroup.py:77-85).
_OX, _OY, _OZ, _DX, _DY, _DZ = 0, 1, 2, 3, 4, 5
_TR, _TG, _TB = 6, 7, 8
_CR, _CG, _CB = 9, 10, 11
_HLO, _AL, _HHI = 12, 13, 14
_SPARE = 15
N_COMP = 16
_HOME_RADIX = 4096  # slot = hhi * 4096 + hlo; both exact in f32
_DEAD_HHI = float(1 << 16)  # HHI of the pad records closing the last dense row
DEAD = -1  # inverse-map entry of a record that ended before the pack

_F32 = torch.float32
_I32 = torch.int32
_BLOCK = 1 << 16  # slots per batch of the plain twins (bounds their memory)
PACK_TILE = 2048  # slots per tile of the CUDA pack (regroup.cu kPackTile)

KERNEL_SOURCE = "weekend_raytracer_tpu_torch/csrc/regroup.cu"
# (name, compiled sources) for build.load_library
LIBRARY = ("wrt_regroup", ("regroup.cu",))
# the pallas_call each kernel replaces (K1's stats instantiation: _make_k1
# with stats=True, as benchmarks/profile_regroup.py:244 launches it)
REPLACES = {
    "k0": "weekend_raytracer_tpu/ops/pallas/regroup.py:1198",
    "pack": "weekend_raytracer_tpu/ops/pallas/regroup.py:1322",
    "k1": "weekend_raytracer_tpu/ops/pallas/regroup.py:1378",
    "combine": "weekend_raytracer_tpu/ops/pallas/regroup.py:1467",
    "k1_stats": "weekend_raytracer_tpu/ops/pallas/regroup.py:618",
}
TILE_RECORDS = 32 * 128  # a dense TPU tile: the rows of K1's stats table

# TPU sweep variants the port does not run yet (ROADMAP Queue 2), and the
# values that leave them off.
_OFF_KNOBS = {
    "listed": (False,),
    "k1_subcull": (0,),
    "rowsweep": (None, False),
    "rowsweep_k0": (None, False),
    "profile_stop": (None,),
}


def default_cuts(num_bounces: int, n_spheres: int = None) -> tuple:
    """The JAX package's recompaction schedule (regroup.py:104-127): cuts at
    bounces 2/4/6 clipped to the bounce budget, or a single cut at 3 for
    scenes of at most 64 spheres."""
    if n_spheres is not None and n_spheres <= 64:
        cuts = tuple(c for c in (3,) if c < num_bounces)
    else:
        cuts = tuple(c for c in (2, 4, 6) if c < num_bounces)
    return cuts or (num_bounces - 1,)


class Tiling(NamedTuple):
    """Where each ray of a frame lives: the lane tiles and the image."""

    width: int
    height: int
    spp: int
    spp_shift: int  # log2(spp)
    block_w: int  # pixels per tile row: 128 >> spp_shift
    tiles_x: int
    tiles_y: int
    cap: int  # slots: tiles * 32 * 128
    row_offset: int  # first global row of this image (seeds and aim)
    full_height: int  # height of the whole image (aim)


def plan(width: int, height: int, spp: int, num_bounces: int, cuts=(2,),
         k1_tsub: int = 32, row_offset: int = 0,
         full_height: Optional[int] = None):
    """Validate a frame and lay it out (regroup.py:1072-1091); returns
    (Tiling, cuts) with the cuts outside (0, num_bounces) dropped."""
    if spp & (spp - 1) or not 1 <= spp <= 128:
        raise ValueError(
            f"regroup spp must be a power of two <= 128 (samples fold "
            f"into the 128-lane dim), got {spp}")
    if 32 % k1_tsub:
        raise ValueError(f"k1_tsub must divide 32, got {k1_tsub}")
    cuts = tuple(c for c in cuts if 0 < c < num_bounces)
    if not cuts:
        raise ValueError("regrouped wavefront needs at least one cut")
    spp_shift = spp.bit_length() - 1
    block_w = 128 >> spp_shift
    tiles_x = -(-width // block_w)
    tiles_y = -(-height // 32)
    cap = tiles_x * tiles_y * 32 * 128
    if cap >= 1 << 28:
        raise ValueError("regrouped wavefront supports < 2^28 rays/frame")
    return Tiling(width, height, spp, spp_shift, block_w, tiles_x, tiles_y,
                  cap, int(row_offset), height if full_height is None
                  else int(full_height)), cuts


class Workspace(NamedTuple):
    """The frame's buffers."""

    pools: tuple  # two [N_COMP, cap] f32: K0's pool, then the dense pools in turn
    contrib: torch.Tensor  # [3, cap] f32: K0's tr * cr per slot
    r8: torch.Tensor  # [phases, 3, cap] f32: each K1's tr * cr per dense record
    inv: torch.Tensor  # [phases, cap] i32: each PACK's inverse map
    counts: torch.Tensor  # [phases + 1] i32: counts[0] = cap, then live records
    pack_status: torch.Tensor  # the CUDA pack's scratch (pack_scratch)


def _workspace(device, cap: int, phases: int) -> Workspace:
    """A frame's buffers on ``device`` (12.6 GB at 1080p x 32 spp with three
    cuts). They are allocated anew for each frame: after the first frame
    of a shape PyTorch's caching allocator hands back the same device
    blocks, so no later frame allocates device memory."""

    def f32(*shape):
        return torch.empty(shape, dtype=_F32, device=device)

    return Workspace(
        pools=(f32(N_COMP, cap), f32(N_COMP, cap)), contrib=f32(3, cap),
        r8=f32(phases, 3, cap),
        inv=torch.empty((phases, cap), dtype=_I32, device=device),
        counts=torch.full((phases + 1,), cap, dtype=_I32, device=device),
        pack_status=pack_scratch(cap, device))


def pack_scratch(cap: int, device) -> torch.Tensor:
    """The CUDA pack's scratch for a pool of ``cap`` slots: a u64 status
    word per tile of PACK_TILE slots and the tile ticket (i64 here); the
    kernel clears it on the stream before each launch."""
    return torch.empty((cap // PACK_TILE + 1,), dtype=torch.int64, device=device)


# --------------------------------------------------------------------------
# The CUDA kernels' wrappers
# --------------------------------------------------------------------------

# regroup.cu wrt_regroup_attributes index -> kernel
KERNEL_NAMES = ("k0", "k0_textured", "k1", "k1_textured", "pack", "combine",
                "k1_stats", "k1_stats_textured", "k0_global", "k0_global_textured",
                "k1_global", "k1_global_textured", "k1_stats_global",
                "k1_stats_global_textured", "k1_stats_windowed", "k1_stats_windowed_textured",
                "k1_stats_global_windowed", "k1_stats_global_windowed_textured",
                "k0_mxu", "k0_mxu_textured", "k1_mxu", "k1_mxu_textured", "k0_mxu_global",
                "k0_mxu_global_textured", "k1_mxu_global", "k1_mxu_global_textured")


def _library():
    """Build (first use) and load the kernel library; raises on failure."""
    built = load_library(*LIBRARY)
    lib = built.lib
    if lib.wrt_regroup_k0.argtypes is None:
        vp, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
        ll = ctypes.c_longlong
        sigs = {
            "wrt_regroup_k0": ([vp] * 5 + [i, vp, vp, ll, i, i, i, i, f, f, u, u, i]
                               + mk.CULL_ARGTYPES + [f, f, vp]),
            "wrt_regroup_pack": [vp] * 6 + [ll, vp],
            "wrt_regroup_k1": ([vp] * 4 + [i, vp, vp, vp, ll, i, i, i, i, u, u, i, i]
                               + mk.CULL_ARGTYPES + [f, f, vp]),
            "wrt_regroup_k1_stats": ([vp] * 4 + [i, vp, vp, vp, ll, i, i, i, i, u, u, i, i]
                                     + mk.CULL_ARGTYPES + [vp, ll, vp, vp]),
            "wrt_regroup_k0_mxu": ([vp] * 5 + [i, vp, vp, ll, i, i, i, i, f, f, u, u, i]
                                   + mk.CULL_ARGTYPES + [f, f, vp, vp]),
            "wrt_regroup_k1_mxu": ([vp] * 4 + [i, vp, vp, vp, ll, i, i, i, i, u, u, i, i]
                                   + mk.CULL_ARGTYPES + [f, f, vp, vp]),
            "wrt_regroup_combine": [vp] * 4 + [i, ll, i, i, i, i, i, vp],
            "wrt_regroup_attributes": [i] + [ctypes.POINTER(i)] * 3,
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.wrt_regroup_cull_smem.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.wrt_regroup_cull_smem.restype = ll
        for name in ("wrt_regroup_launch_bounds", "wrt_regroup_mxu_launch_bounds"):
            getattr(lib, name).argtypes = [ctypes.POINTER(i)] * 2
            getattr(lib, name).restype = None
    return built


def launch_bounds(mxu: bool = False) -> tuple:
    """K0's and K1's __launch_bounds__: (threads a block, blocks an SM),
    which fix their register budget (regroup.cu kTraceMinBlocks; ``mxu``:
    their MXU instantiations', kMxuMinBlocks)."""
    threads, min_blocks = ctypes.c_int(0), ctypes.c_int(0)
    lib = _library().lib
    fn = lib.wrt_regroup_mxu_launch_bounds if mxu else lib.wrt_regroup_launch_bounds
    fn(ctypes.byref(threads), ctypes.byref(min_blocks))
    return threads.value, min_blocks.value


def kernel_attributes() -> dict:
    """Registers per thread, local-memory bytes and static shared-memory
    bytes of each built kernel."""
    lib = _library().lib
    out = {}
    for which, name in enumerate(KERNEL_NAMES):
        regs, local, shared = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
        err = lib.wrt_regroup_attributes(which, ctypes.byref(regs), ctypes.byref(local),
                                         ctypes.byref(shared))
        if err:
            raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err}")
        out[name] = {"registers": regs.value, "local_bytes": local.value,
                     "shared_bytes": shared.value}
    return out


def cull_placement(inp: mk.KernelInputs) -> dict:
    """Where K0 and K1 read this scene's cull tables (regroup.cu
    stage_cull): ``smem_bytes``, the dynamic shared memory of a block (the
    priors' four sweep rows and indices, and the chunk and super-chunk
    boxes where they fit; 0 without chunks), and ``boxes``, "shared",
    "global" or "none"."""
    staged = ctypes.c_int(0)
    smem = _library().lib.wrt_regroup_cull_smem(inp.n_chunks, inp.n_tests, inp.n_super,
                                                ctypes.byref(staged))
    boxes = ("shared" if staged.value else "global") if inp.n_chunks else "none"
    return {"smem_bytes": int(smem), "boxes": boxes}


def _cull_args(inp: mk.KernelInputs, device) -> tuple:
    """K0's and K1's cull arguments: the chunk hierarchy (mk.cull_args) and
    the two scene terms of each lane's box margin."""
    return (*mk.cull_args(inp, device), mk._f32(inp.cull_reach), mk._f32(inp.cull_scale))


def _stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _device_type(t: torch.Tensor) -> str:
    return t.device.type


def _expect(t: torch.Tensor, shape, dtype, device) -> None:
    if (t.device != device or tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or not t.is_contiguous()):
        raise ValueError(
            f"kernel input {tuple(t.shape)} {t.dtype} on {t.device} does not "
            f"match {tuple(shape)} {dtype} contiguous on {device}")


def _expect_scene(inp: mk.KernelInputs, device) -> None:
    n = inp.n_spheres
    _expect(inp.cam, (20,), _F32, device)
    _expect(inp.sky, (33,), _F32, device)
    _expect(inp.sweep, (n, 4), _F32, device)
    _expect(inp.attrs, (18 if inp.tex_pool is not None else 12, n), _F32, device)
    if inp.tex_pool is not None:
        _expect(inp.tex_pool, tuple(inp.tex_pool.shape), torch.int32, device)


def _scene_ptrs(inp: mk.KernelInputs):
    return (inp.sky.data_ptr(), inp.sweep.data_ptr(), inp.attrs.data_ptr(),
            None if inp.tex_pool is None else inp.tex_pool.data_ptr(),
            inp.n_spheres)


def _count_ptr(counts: torch.Tensor, k: int, device) -> int:
    """Device address of counts[k], after checking that it exists."""
    _expect(counts, tuple(counts.shape), _I32, device)
    if not 0 <= k < counts.numel():
        raise ValueError(f"counts has {counts.numel()} entries, no entry {k}")
    return counts.data_ptr() + 4 * k


def _expect_cap(cap: int) -> None:
    if cap % 4096 or not 0 < cap < 1 << 28:
        raise ValueError(f"pool capacity {cap} is not whole tiles below 2^28 slots")


def _expect_aligned(*tensors) -> None:
    """The CUDA pack reads and writes 16 bytes at a time."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"kernel input at {t.data_ptr():#x} is not 16-byte aligned")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"regroup {what} launch failed: CUDA error {err}")


def launch_k0(inp: mk.KernelInputs, pool: torch.Tensor, contrib: torch.Tensor,
              t: Tiling, frame, b_hi: int) -> None:
    """K0 on the current stream: every slot's record into ``pool`` [16, cap]
    and its tr * cr into ``contrib`` [3, cap], the sweep culled per warp
    where ``inp`` has chunks. Counts one launch in ``launch_k0.launches``;
    where ``mk.mxu_route(inp)`` it launches K0's MXU instantiation, counted
    in ``launch_k0.mxu_launches``."""
    dev = pool.device
    _expect_scene(inp, dev)
    _expect(pool, (N_COMP, t.cap), _F32, dev)
    _expect(contrib, (3, t.cap), _F32, dev)
    mxu = mk.mxu_route(inp)
    lib = _library().lib
    args = (inp.cam.data_ptr(), *_scene_ptrs(inp), pool.data_ptr(), contrib.data_ptr(),
            t.cap, t.width, t.height, t.tiles_x, t.spp_shift,
            mk._f32(1.0 / t.width), mk._f32(1.0 / t.full_height),
            int(frame) & rng.MASK32, t.row_offset & rng.MASK32, int(b_hi),
            *_cull_args(inp, dev))
    if mxu:
        _raise_on(lib.wrt_regroup_k0_mxu(*args, mk.check_amats(inp, dev), _stream_handle(dev)),
                  "K0 MXU")
        launch_k0.mxu_launches += 1
        return
    _raise_on(lib.wrt_regroup_k0(*args, _stream_handle(dev)), "K0")
    launch_k0.launches += 1


def launch_pack(src: torch.Tensor, dst: torch.Tensor, inv: torch.Tensor,
                counts: torch.Tensor, k: int, status: torch.Tensor) -> None:
    """PACK number k (1-based) on the current stream, one launch: the
    counts[k - 1] records of ``src`` whose alive component is set go to
    ``dst`` in slot order; ``inv`` gets each input record's dense position
    (or DEAD) and counts[k] the live count. The last dense row is padded
    with dead records. ``status`` is ``pack_scratch(cap)``. Counts one
    launch in ``launch_pack.launches``."""
    dev = src.device
    cap = src.shape[1]
    _expect_cap(cap)
    _expect(src, (N_COMP, cap), _F32, dev)
    _expect(dst, (N_COMP, cap), _F32, dev)
    _expect(inv, (cap,), _I32, dev)
    _expect(status, (cap // PACK_TILE + 1,), torch.int64, dev)
    _expect_aligned(src, inv)
    err = _library().lib.wrt_regroup_pack(
        src.data_ptr(), dst.data_ptr(), inv.data_ptr(), _count_ptr(counts, k - 1, dev),
        _count_ptr(counts, k, dev), status.data_ptr(), cap, _stream_handle(dev))
    _raise_on(err, "PACK")
    launch_pack.launches += 1


def _check_k1_stats(stats, t: Tiling, b_lo: int, b_hi: int, device) -> None:
    if stats is None:
        return
    if b_hi <= b_lo:
        raise ValueError(f"K1 stats need at least one bounce, got [{b_lo}, {b_hi})")
    _expect(stats, (t.cap // TILE_RECORDS, 8), _F32, device)


def launch_k1(inp: mk.KernelInputs, pool: torch.Tensor, r8: torch.Tensor,
              counts: torch.Tensor, k: int, t: Tiling, frame, b_lo: int,
              b_hi: int, stats: Optional[torch.Tensor] = None) -> None:
    """K1 of phase k on the current stream: bounces [b_lo, b_hi) of the
    counts[k] dense records of ``pool``, in place, and their tr * cr into
    ``r8`` [3, cap], the sweep culled per warp where ``inp`` has chunks.
    Counts one launch in ``launch_k1.launches``; where ``mk.mxu_route(inp)``
    it launches K1's MXU instantiation, counted in
    ``launch_k1.mxu_launches``.

    With ``stats`` [cap / 4096, 8] f32 it launches the stats
    kernel instead (counted in ``launch_k1.stats_launches``), which
    also writes _make_k1(stats=True)'s counters per dense tile of 4096
    records: col 0 the tile's loop iterations from b_lo, col 1 live lanes
    summed over them, cols 2-3 chunk and super-chunk bodies the TPU's
    whole-tile cull enters, the rest 0 (and every column of a tile past
    the count). These are the counters of the JAX kernel's k1_tsub = 32
    layout, which profile_regroup.py runs; at a smaller k1_tsub it writes
    each sub-block's counters over the last one's (regroup.py:698-758)."""
    dev = pool.device
    _expect_scene(inp, dev)
    _expect(pool, (N_COMP, t.cap), _F32, dev)
    _expect(r8, (3, t.cap), _F32, dev)
    _check_k1_stats(stats, t, b_lo, b_hi, dev)
    mxu = mk.mxu_route(inp)
    if stats is not None and mxu:
        raise NotImplementedError(mk.STATS_MXU_REFUSAL)
    lib = _library().lib
    args = (*_scene_ptrs(inp), pool.data_ptr(), r8.data_ptr(), _count_ptr(counts, k, dev),
            t.cap, t.width, t.height, t.tiles_x, t.spp_shift, int(frame) & rng.MASK32,
            t.row_offset & rng.MASK32, int(b_lo), int(b_hi))
    if mxu:
        _raise_on(lib.wrt_regroup_k1_mxu(*args, *_cull_args(inp, dev),
                                         mk.check_amats(inp, dev), _stream_handle(dev)),
                  "K1 MXU")
        launch_k1.mxu_launches += 1
        return
    if stats is None:
        _raise_on(lib.wrt_regroup_k1(*args, *_cull_args(inp, dev), _stream_handle(dev)), "K1")
        launch_k1.launches += 1
        return
    words = mk.stats_scratch_words(t.cap // TILE_RECORDS, b_hi - b_lo, inp)
    scratch = torch.empty((words,), dtype=_I32, device=dev)
    err = lib.wrt_regroup_k1_stats(*args, *mk.cull_args(inp, dev), scratch.data_ptr(), words,
                                   stats.data_ptr(), _stream_handle(dev))
    _raise_on(err, "K1 stats")
    launch_k1.stats_launches += 1


def _expect_chain(inv: torch.Tensor, r8: torch.Tensor, contrib: torch.Tensor,
                  accum: torch.Tensor, t: Tiling, device) -> None:
    phases = inv.shape[0] if inv.dim() == 2 else 0
    if phases < 1:
        raise ValueError(f"COMBINE needs the inverse maps of one PACK or more, got "
                         f"{tuple(inv.shape)}")
    _expect(inv, (phases, t.cap), _I32, device)
    _expect(r8, (phases, 3, t.cap), _F32, device)
    _expect(contrib, (3, t.cap), _F32, device)
    _expect(accum, (t.width * t.height, 3), _F32, device)


def launch_combine(inv: torch.Tensor, r8: torch.Tensor, contrib: torch.Tensor,
                   accum: torch.Tensor, t: Tiling, clear=False) -> None:
    """COMBINE on the current stream, one launch a frame: each home slot's
    radiance, found by following the inverse maps ``inv`` [phases, cap]
    from the slot (inv[0][slot], then inv[1] at that position, ...) to the
    phase its record ended in and read there (``contrib`` [3, cap], K0's,
    where it ended before the first PACK; else ``r8`` [phases, 3, cap]),
    summed per pixel in sample order from 0 into ``accum`` [H*W, 3]
    (written over it when ``clear``). Nothing else is written. Counts one
    launch in ``launch_combine.launches``."""
    dev = accum.device
    _expect_cap(t.cap)
    _expect_chain(inv, r8, contrib, accum, t, dev)
    err = _library().lib.wrt_regroup_combine(
        inv.data_ptr(), r8.data_ptr(), contrib.data_ptr(), accum.data_ptr(), inv.shape[0],
        t.cap, t.width, t.height, t.tiles_x, t.spp_shift, int(bool(clear)),
        _stream_handle(dev))
    _raise_on(err, "COMBINE")
    launch_combine.launches += 1


for _fn in (launch_k0, launch_pack, launch_k1, launch_combine):
    _fn.launches = 0
launch_k1.stats_launches = 0
launch_k0.mxu_launches = launch_k1.mxu_launches = 0


# --------------------------------------------------------------------------
# The plain twins: the same contracts on the same buffers, in PyTorch
# --------------------------------------------------------------------------

def _slot_pixels(t: Tiling, slot: torch.Tensor):
    """Pixel column, row and sample of each slot, clamped into the image
    (regroup.py:184-199, 723-736)."""
    lane = slot & 127
    srow = slot >> 7
    tile = srow >> 5
    x = torch.clamp((tile % t.tiles_x) * t.block_w + (lane >> t.spp_shift),
                    max=t.width - 1)
    y = torch.clamp((tile // t.tiles_x) * 32 + (srow & 31), max=t.height - 1)
    return x, y, lane & (t.spp - 1)


def _seeds(t: Tiling, slot: torch.Tensor, frame: int):
    """(RNG seed, x, global row) of each slot's path."""
    x, y, smp = _slot_pixels(t, slot)
    y_g = (y + t.row_offset) & rng.MASK32
    pix = (y_g * t.width + x) & rng.MASK32
    return rng.init_sample_state(pix, frame, smp), x, y_g


def _store(pool: torch.Tensor, lo: int, hi: int, p: mk.PathState) -> None:
    pool[_OX:_OZ + 1, lo:hi] = p.o.T
    pool[_DX:_DZ + 1, lo:hi] = p.d.T
    pool[_TR:_TB + 1, lo:hi] = p.tr.T
    pool[_CR:_CB + 1, lo:hi] = p.c.T
    pool[_AL, lo:hi] = p.alive.to(_F32)


def k0_plain(inp: mk.KernelInputs, pool: torch.Tensor, contrib: torch.Tensor,
             t: Tiling, frame, b_hi: int) -> None:
    """``launch_k0``'s twin."""
    mxu = mk.mxu_route(inp)
    dev = pool.device
    cam = [mk._f32(v) for v in inp.cam.tolist()]
    inv_w, inv_h = mk._f32(1.0 / t.width), mk._f32(1.0 / t.full_height)
    frame = int(frame) & rng.MASK32
    for lo in range(0, t.cap, _BLOCK):
        hi = min(t.cap, lo + _BLOCK)
        slot = torch.arange(lo, hi, device=dev)
        state, x, y_g = _seeds(t, slot, frame)
        yf = y_g.to(torch.int32).to(_F32)
        state, o, d = mk.camera_rays_plain(cam, x.to(_F32), yf, inv_w, inv_h, state)
        tr = torch.ones((hi - lo, 3), dtype=_F32, device=dev)
        p = mk.trace_bounces_plain(o, d, tr, state, inp, 0, b_hi, mxu=mxu)
        _store(pool, lo, hi, p)
        pool[_HLO, lo:hi] = (slot & (_HOME_RADIX - 1)).to(_F32)
        pool[_HHI, lo:hi] = (slot >> 12).to(_F32)
        pool[_SPARE, lo:hi] = 0.0
        contrib[:, lo:hi] = (p.tr * p.c).T


def pack_plain(src: torch.Tensor, dst: torch.Tensor, inv: torch.Tensor,
               counts: torch.Tensor, k: int, status=None) -> None:
    """``launch_pack``'s twin (``status`` is the kernel's scratch and not
    used)."""
    n_in = int(counts[k - 1])
    alive = src[_AL, :n_in] > 0.5
    pos = torch.cumsum(alive.to(torch.int64), 0) - 1
    total = int(alive.sum())
    inv[:n_in] = torch.where(alive, pos, torch.full_like(pos, DEAD)).to(_I32)
    dst[:, :total] = src[:, :n_in][:, alive]
    end = -(-total // 128) * 128
    dst[:, total:end] = 0.0
    dst[_HHI, total:end] = _DEAD_HHI
    counts[k] = total


def k1_plain(inp: mk.KernelInputs, pool: torch.Tensor, r8: torch.Tensor,
             counts: torch.Tensor, k: int, t: Tiling, frame, b_lo: int,
             b_hi: int, stats: Optional[torch.Tensor] = None) -> None:
    """``launch_k1``'s twin, with the counters when given ``stats``."""
    _check_k1_stats(stats, t, b_lo, b_hi, pool.device)
    mxu = mk.mxu_route(inp)
    if stats is not None and mxu:
        raise NotImplementedError(mk.STATS_MXU_REFUSAL)
    n = int(counts[k])
    frame = int(frame) & rng.MASK32
    counter = (mk.CullStats(inp, t.cap // TILE_RECORDS, b_hi - b_lo, pool.device)
               if stats is not None else None)
    for lo in range(0, n, _BLOCK):
        hi = min(n, lo + _BLOCK)
        rec = pool[:, lo:hi]
        slot = rec[_HHI].to(torch.int64) * _HOME_RADIX + rec[_HLO].to(torch.int64)
        state = _seeds(t, slot, frame)[0]
        for _ in range(4 * (b_lo + 1)):
            state = rng.next_state(state)
        o = (rec[_OX], rec[_OY], rec[_OZ])
        d = (rec[_DX], rec[_DY], rec[_DZ])
        tr = rec[_TR:_TB + 1].T.contiguous()
        counted = None
        if counter is not None:
            tile = torch.arange(lo, hi, device=pool.device) // TILE_RECORDS
            counted = (counter, tile, torch.ones_like(tile))
        p = mk.trace_bounces_plain(o, d, tr, state, inp, b_lo, b_hi, counted, mxu)
        _store(pool, lo, hi, p)
        r8[:, lo:hi] = (p.tr * p.c).T
    if counter is not None:
        stats.copy_(counter.table(1))


_CENSUS_BLOCK = 1 << 21  # rays per batch of cull_census (a multiple of 32)


def _phases(cuts: tuple, num_bounces: int) -> list:
    """[b_lo, b_hi) of K0 and of each phase's K1."""
    ends = list(cuts[1:]) + [num_bounces]
    return [(0, cuts[0])] + list(zip(cuts, ends))


def cull_census(inp: mk.KernelInputs, t: Tiling, frame, cuts: tuple, num_bounces: int,
                group: int = 32) -> list:
    """The work of K0 and of each phase's K1 under the per-warp cull (what
    each live lane's own decisions need, and what the lanes do under the
    warp vote), on the twins' rays of one frame: per kernel ((b_lo, b_hi),
    [CullCount of each bounce]). K0's groups are 32 consecutive slots; each K1's are 32
    consecutive records of its dense pool, the live records in slot order
    as PACK leaves them. The rays come from ``trace_bounces_plain`` run one
    bounce at a time, which gives a bounce's rays as a run over many does;
    they differ from the kernels' by nvcc's FMA contraction alone."""
    dev = inp.sweep.device
    frame = int(frame) & rng.MASK32
    cam = [mk._f32(v) for v in inp.cam.tolist()]
    inv_w, inv_h = mk._f32(1.0 / t.width), mk._f32(1.0 / t.full_height)
    o = torch.empty((3, t.cap), dtype=_F32, device=dev)
    d = torch.empty_like(o)
    state = torch.empty((t.cap,), dtype=torch.int64, device=dev)
    for lo in range(0, t.cap, _CENSUS_BLOCK):
        hi = min(t.cap, lo + _CENSUS_BLOCK)
        st, x, y_g = _seeds(t, torch.arange(lo, hi, device=dev), frame)
        st, ob, db = mk.camera_rays_plain(cam, x.to(_F32), y_g.to(torch.int32).to(_F32),
                                          inv_w, inv_h, st)
        o[:, lo:hi], d[:, lo:hi], state[lo:hi] = torch.stack(ob), torch.stack(db), st
    tr = torch.ones((t.cap, 3), dtype=_F32, device=dev)
    alive = torch.ones((t.cap,), dtype=torch.bool, device=dev)
    out = []
    for k, (b_lo, b_hi) in enumerate(_phases(cuts, num_bounces)):
        if k:  # PACK: the live records, in slot order
            keep = torch.nonzero(alive).squeeze(1)
            o, d, tr, state = o[:, keep], d[:, keep], tr[keep], state[keep]
            alive = torch.ones((keep.numel(),), dtype=torch.bool, device=dev)
        counts = []
        for b in range(b_lo, b_hi):
            count = CullCount(0, 0, 0, 0, 0, 0)
            for lo in range(0, alive.numel(), _CENSUS_BLOCK):
                sl = slice(lo, lo + _CENSUS_BLOCK)
                count = count.plus(warp_cull_plain(tuple(o[:, sl]), tuple(d[:, sl]),
                                                   alive[sl], inp, group).count)
            counts.append(count)
            live = torch.nonzero(alive).squeeze(1)
            for lo in range(0, live.numel(), _CENSUS_BLOCK):
                idx = live[lo:lo + _CENSUS_BLOCK]
                p = mk.trace_bounces_plain(tuple(o[:, idx]), tuple(d[:, idx]), tr[idx],
                                           state[idx], inp, b, b + 1)
                o[:, idx], d[:, idx], tr[idx] = p.o.T, p.d.T, p.tr
                state[idx], alive[idx] = p.state, p.alive
        out.append(((b_lo, b_hi), counts))
    return out


def _fold_plain(contrib: torch.Tensor, accum: torch.Tensor, t: Tiling,
                clear) -> None:
    """Each pixel's spp contiguous lanes summed in sample order from 0,
    into the scanline accumulator (written over it when ``clear``)."""
    img = contrib.reshape(3, t.tiles_y, t.tiles_x, 32, t.block_w, t.spp)
    tot = torch.zeros(img.shape[:-1], dtype=_F32, device=contrib.device)
    for s in range(t.spp):
        tot = tot + img[..., s]
    tot = tot.permute(0, 1, 3, 2, 4).reshape(3, t.tiles_y * 32, t.tiles_x * t.block_w)
    tot = tot[:, :t.height, :t.width].reshape(3, -1).T
    if clear:
        accum.zero_()
    accum += tot


def combine_plain(inv: torch.Tensor, src: torch.Tensor, base: torch.Tensor,
                  counts: torch.Tensor, k: int, *, accum: torch.Tensor = None,
                  t: Tiling = None, clear=False) -> None:
    """One reverse-combine level of the JAX package (regroup.py:1396-1483):
    for each of the counts[k - 1] positions p of phase k's input space
    whose record lived on, base[:, p] = src[:, inv[p]]. At the home level
    (k = 1) it combines into a copy and folds that into ``accum`` (written
    over it when ``clear``), leaving ``base`` (K0's contributions) as it
    is. The levels from the last phase to the home level give
    ``combine_chain_plain``'s result, the frame's COMBINE."""
    n = int(counts[k - 1])
    j = inv[:n].to(torch.int64)
    live = j >= 0
    out = base.clone() if k == 1 else base
    view = out[:, :n]
    view[:, live] = src[:, j[live]]
    if k == 1:
        _fold_plain(out, accum, t, clear)


# --------------------------------------------------------------------------
# One frame
# --------------------------------------------------------------------------

def combine_chain_plain(inv: torch.Tensor, r8: torch.Tensor, contrib: torch.Tensor,
                        accum: torch.Tensor, t: Tiling, clear=False) -> None:
    """``launch_combine``'s twin: the inverse maps followed with gathers,
    then ``_fold_plain``."""
    _expect_chain(inv, r8, contrib, accum, t, accum.device)
    per_slot = contrib.clone()
    sel = torch.nonzero(inv[0] >= 0).squeeze(1)  # slots whose record reached phase 1
    pos = inv[0][sel].long()  # and its position there
    for k in range(1, inv.shape[0]):
        nxt = inv[k][pos].long()
        ended = nxt < 0
        per_slot[:, sel[ended]] = r8[k - 1][:, pos[ended]]
        sel, pos = sel[~ended], nxt[~ended]
    per_slot[:, sel] = r8[-1][:, pos]
    _fold_plain(per_slot, accum, t, clear)


def _frame(kernels: bool, accum: torch.Tensor, inp: mk.KernelInputs, frame,
           clear, t: Tiling, cuts: tuple, num_bounces: int, on_stage=None,
           debug_counts: bool = False, mxu=None):
    """K0, then PACK and K1 per cut, then COMBINE, on the kernels or on
    their twins; ``mxu`` = (K0's, K1's) route (``mk.with_route``), None:
    each ``mk.mxu_route(inp)``."""
    k0, pack, k1, combine = ((launch_k0, launch_pack, launch_k1, launch_combine)
                             if kernels else
                             (k0_plain, pack_plain, k1_plain, combine_chain_plain))
    mxu0, mxu1 = (None, None) if mxu is None else mxu
    inp0, inp1 = mk.with_route(inp, mxu0), mk.with_route(inp, mxu1)
    mark = on_stage or (lambda name: None)
    ws = _workspace(accum.device, t.cap, len(cuts))
    k0(inp0, ws.pools[0], ws.contrib, t, frame, cuts[0])
    mark("k0")
    for k, b_lo in enumerate(cuts, 1):
        b_hi = cuts[k] if k < len(cuts) else num_bounces
        src, dst = ws.pools[(k - 1) % 2], ws.pools[k % 2]
        pack(src, dst, ws.inv[k - 1], ws.counts, k, ws.pack_status)
        mark(f"pack{k}")
        k1(inp1, dst, ws.r8[k - 1], ws.counts, k, t, frame, b_lo, b_hi)
        mark(f"k1_{k}")
    combine(ws.inv, ws.r8, ws.contrib, accum, t, clear)
    mark("combine")
    if debug_counts:
        live = ws.counts.tolist()
        return accum, (t.cap // 128,) + tuple(-(-c // 128) for c in live[1:])
    return accum


def launch_regrouped(accum: torch.Tensor, inp: mk.KernelInputs, frame, clear, *,
                     width: int, height: int, spp: int, num_bounces: int,
                     cuts=(2,), row_offset: int = 0,
                     full_height: Optional[int] = None, on_stage=None,
                     debug_counts: bool = False, mxu=None):
    """One frame of the CUDA kernels on prepared inputs, on the current
    stream. ``on_stage(name)`` is called after each launch ("k0", "pack1",
    "k1_1", ..., "combine"), e.g. to record a CUDA event. ``mxu`` = (K0's,
    K1's) MXU route; None follows ``inp`` (``mk.mxu_route``)."""
    t, cuts = plan(width, height, spp, num_bounces, cuts, row_offset=row_offset,
                   full_height=full_height)
    mk._check_accum(accum, width, height, spp, num_bounces)
    return _frame(True, accum, inp, frame, clear, t, cuts, num_bounces,
                  on_stage, debug_counts, mxu)


def regrouped_plain_with_inputs(accum: torch.Tensor, inp: mk.KernelInputs, frame,
                                clear, *, width: int, height: int, spp: int,
                                num_bounces: int, cuts=(2,), row_offset: int = 0,
                                full_height: Optional[int] = None, on_stage=None,
                                debug_counts: bool = False, mxu=None):
    """``launch_regrouped``'s twin, on ``accum``'s device."""
    t, cuts = plan(width, height, spp, num_bounces, cuts, row_offset=row_offset,
                   full_height=full_height)
    mk._check_accum(accum, width, height, spp, num_bounces)
    return _frame(False, accum, inp, frame, clear, t, cuts, num_bounces,
                  on_stage, debug_counts, mxu)


def render_image_regrouped(
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
    cuts: tuple = (2,),
    k1_chunk_size: Optional[int] = None,
    k1_tsub: int = 32,
    k1_subcull: int = 0,
    row_offset: int = 0,
    full_height: Optional[int] = None,
    debug_counts: bool = False,
    budget_texels: int = mk.DEFAULT_TEXTURE_BUDGET,
    listed: bool = False,
    mxu_sweep=None,
    profile_stop=None,
    dyn_grid=None,
    combine_v2=None,
    pack_v2=None,
    skip_dead=None,
    rowsweep=None,
    rowsweep_k0=None,
):
    """One progressive frame via the lane-regrouped wavefront; returns
    ``accum`` (and, with ``debug_counts``, the row counts of the home pool
    and of each dense pool, ceil(records / 128), as the JAX function gives
    them).

    cuts are the bounce indices at which live rays are recompacted; at
    least one must lie inside (0, num_bounces). The kernels accumulate in
    place into ``accum``. A CUDA ``accum`` launches the CUDA kernels (each
    counted on its ``launch_*`` wrapper) or raises; a CPU ``accum`` runs the
    plain twins. ``k1_chunk_size`` picks the JAX package's cull granularity
    for K1; the port's K1 culls the prepared chunks per warp, exactly, so
    it changes nothing here but whether K1 takes the MXU chunk sweep.
    ``mxu_sweep`` (None: ``mk._default_mxu_sweep``) runs K0's and K1's
    culled chunk sweeps on the tensor cores where ``mk.mxu_route`` holds
    for each (K1 with ``k1_chunk_size``, the JAX condition; the port's K1
    needs K0's chunks too).
    """
    knobs = dict(listed=listed, k1_subcull=k1_subcull,
                 rowsweep=rowsweep, rowsweep_k0=rowsweep_k0,
                 profile_stop=profile_stop)
    for name, value in knobs.items():
        if value not in _OFF_KNOBS[name]:
            raise NotImplementedError(
                f"{name}={value!r} is a TPU-only knob of render_image_regrouped; "
                f"the port takes only its off value {_OFF_KNOBS[name][-1]!r} "
                "(ROADMAP Queue 2, still to port)")
    t, cuts = plan(width, height, spp, num_bounces, cuts, k1_tsub, row_offset,
                   full_height)
    mk._check_accum(accum, width, height, spp, num_bounces)
    kind = _device_type(accum)
    if kind == "cuda":
        if scene.device != accum.device:
            raise ValueError(f"scene on {scene.device}, accum on {accum.device}")
    elif kind != "cpu":
        raise ValueError(f"unsupported device {accum.device}")
    mxu = mk.resolve_mxu_sweep(mxu_sweep, scene)
    inp = mk.kernel_inputs(scene, sky, basis, chunk_size=chunk_size,
                           super_factor=super_factor, budget_texels=budget_texels,
                           mxu_sweep=mxu)
    k1_cs = inp.chunk_size if k1_chunk_size is None else int(k1_chunk_size)
    mxu1 = _k1_chunked(scene, k1_cs) and mk.mxu_route(inp, k1_cs)
    return _frame(kind == "cuda", accum, inp, frame, clear, t, cuts, num_bounces,
                  debug_counts=debug_counts, mxu=(mk.mxu_route(inp), mxu1))


def _k1_chunked(scene: Scene, k1_chunk_size: int) -> bool:
    """Whether the JAX package's K1 prepares chunks of ``k1_chunk_size``
    for this scene (n_chunks1 > 0; prepare_scene_arrays' rule)."""
    return k1_chunk_size > 0 and scene.spheres.num_spheres >= 2 * k1_chunk_size


def render_image_regrouped_plain(
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
    cuts: tuple = (2,),
    row_offset: int = 0,
    full_height: Optional[int] = None,
    debug_counts: bool = False,
    budget_texels: int = mk.DEFAULT_TEXTURE_BUDGET,
):
    """The regrouped frame built from the plain twins, on ``accum``'s
    device (CPU or CUDA)."""
    inp = mk.kernel_inputs(scene, sky, basis, chunk_size=chunk_size,
                           super_factor=super_factor, budget_texels=budget_texels)
    return regrouped_plain_with_inputs(
        accum, inp, frame, clear, width=width, height=height, spp=spp,
        num_bounces=num_bounces, cuts=cuts, row_offset=row_offset,
        full_height=full_height, debug_counts=debug_counts)


__all__ = ["cull_census", "default_cuts", "render_image_regrouped",
           "render_image_regrouped_plain", "warp_cull_plain"]
