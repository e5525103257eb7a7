"""Closest-hit sweep probe kernels: the sweep as FMAs or on the tensor cores.

Counterparts of the nine pallas_calls of benchmarks/probe_mxu_sweep.py
(csrc/sweep.cu says what bounds each on the card):

  sweep_fma    the closest hit of each ray over a sphere table [n, 4]
               (cx, cy, cz, kq), in bounce.cuh's sweep_sphere rounding
               (p5's and p8's VPU forms); its launch plan is ``fma_plan``.
  sweep_mma    the same, with c.d and -2 c.o + kq from TF32 mma.sync at
               "tf32" (one product; the probe's default precision, bf16
               passes on the TPU) or "3xtf32" (three; its "highest"), from
               the probe's per-chunk sphere matrix ``amats`` (p5, p7, p8's
               MXU forms).
  dot_mma      A[M, 8] . B[8, N] at "fp32" (multiply, then add, in k order),
               "tf32" or "3xtf32" (p3).
  layout       ``layout_remap``: a copy under the probe's index map (p1's
               2x + 1, p2's reversed rows); ``layout_chain``: p4's 256-step
               acc = acc * v + 1e-7.

Rays are the six SoA planes [6, R] (ox, oy, oz, dx, dy, dz) or, for
``sweep_mma``, the probe's packed B [8, R] (dx, dy, dz, ox, oy, oz, 1, 0).
A sweep returns (t [R] float32, index [R] int32): MAX_T and -1 for a miss.
Each wrapper launches its CUDA kernel for CUDA tensors (counted in its
launch counter) or raises, and runs its plain PyTorch twin for CPU
tensors. The library is loaded and bound once, and the stream read as a
raw handle: at the probes' shapes a call's host side is most of its time.
"""
from __future__ import annotations

import ctypes

import torch

from .build import load_library

_F32 = torch.float32
_I32 = torch.int32

KERNEL_SOURCE = "weekend_raytracer_tpu_torch/csrc/sweep.cu"
# (name, compiled sources) for build.load_library
LIBRARY = ("wrt_sweep", ("sweep.cu",))
# the pallas_calls each kernel replaces (benchmarks/probe_mxu_sweep.py)
REPLACES = {
    "sweep_fma": "benchmarks/probe_mxu_sweep.py:273, :561",
    "sweep_mma_tf32": "benchmarks/probe_mxu_sweep.py:293, :394, :577 (precision=None)",
    "sweep_mma_3xtf32": "benchmarks/probe_mxu_sweep.py:293, :394, :577 (precision='highest')",
    "dot_mma": "benchmarks/probe_mxu_sweep.py:108",
    "layout": "benchmarks/probe_mxu_sweep.py:70, :87, :140",
}
KERNELS = tuple(REPLACES)
MIN_T = 1.0e-3  # probe_mxu_sweep.py:45, bounce.cuh's kMinT
MAX_T = 3.0e38  # probe_mxu_sweep.py:44, the miss value
PRECISIONS = ("fp32", "tf32", "3xtf32")  # sweep.cu's Prec: 0, 1, 2
MMA_TILE = 16  # spheres of an A tile: a chunk of sweep_mma is a multiple
MMA_GROUP_RAYS = 16  # a warp's rays in a census launch (sweep.cu kWideTiles 8-ray tiles)
MAX_FMA_CHUNK = 2048  # the largest chunk sweep_fma takes (it names the TPU kernel's chunk)
# sweep.cu's sweep_fma constants, which fma_plan mirrors: rays a thread
# where the rays fill the card, threads a block there and its blocks an SM
# (its register budget), threads a block at one ray a thread and its
# blocks an SM, spheres a block stages at once, the most warps that share a
# ray group
FMA_RAYS = 4
FMA_THREADS = 256
FMA_BLOCKS = 3
FMA_NARROW_THREADS = 1024
FMA_BLOCKS_NARROW = 1
FMA_WINDOW = 1024
FMA_MAX_SPLITS = 32
CHAIN_C = 1.0e-7  # p4's addend

# sweep.cu wrt_sweep_attributes index -> kernel ("narrow": one 8-ray tile
# a warp, sweep_mma's launch at the probe's 4,096 rays, or one ray a
# thread, sweep_fma's there; "census": the counting instantiation of
# sweep_mma_census)
KERNEL_NAMES = ("sweep_fma", "sweep_mma_tf32", "sweep_mma_3xtf32", "dot_mma_fp32",
                "dot_mma_tf32", "dot_mma_3xtf32", "layout_remap", "layout_chain",
                "sweep_mma_tf32_narrow", "sweep_mma_3xtf32_narrow", "sweep_mma_tf32_census",
                "sweep_mma_3xtf32_census", "sweep_fma_narrow")


_BUILT = None  # the loaded library, its functions bound, after the first call
_vp, _i, _f, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# the library's C functions and their arguments (each returns an int)
SIGNATURES = {
    "wrt_sweep_fma": [_vp, _i, _i, _vp, _i, _i, _vp, _vp, _vp],
    "wrt_sweep_fma_plan": [_i, _i, _i, _i, ctypes.POINTER(_ll)],
    "wrt_sweep_mma": [_vp, _i, _i, _vp, _i, _i, _i, _i, _vp, _vp, _vp],
    "wrt_sweep_mma_census": [_vp, _i, _i, _vp, _i, _i, _i, _i, _vp, _vp, _vp, _vp],
    "wrt_sweep_mma_launch_bounds": [_i, ctypes.POINTER(_i), ctypes.POINTER(_i)],
    "wrt_dot_mma": [_vp, _vp, _vp, _i, _i, _i, _vp],
    "wrt_layout_remap": [_vp, _vp, _i, _i, _i, _i, _f, _f, _vp],
    "wrt_layout_chain": [_vp, _vp, _ll, _i, _i, _f, _vp],
    "wrt_sweep_attributes": [_i, ctypes.POINTER(_i), ctypes.POINTER(_i)],
}


def bind(lib) -> None:
    """Set SIGNATURES on the functions ``lib`` (a ctypes.CDLL of sweep.cu)
    exports."""
    for name, argtypes in SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int


def _library():
    """Build (first use) and load the kernel library; raises on failure.
    The library, its functions bound, is kept after the first call."""
    global _BUILT
    if _BUILT is not None:
        return _BUILT
    built = load_library(*LIBRARY)
    bind(built.lib)
    _BUILT = built
    return built


def kernel_attributes() -> dict:
    """Registers per thread and local-memory bytes of each built kernel."""
    lib = _library().lib
    out = {}
    for which, name in enumerate(KERNEL_NAMES):
        regs, local = ctypes.c_int(0), ctypes.c_int(0)
        err = lib.wrt_sweep_attributes(which, ctypes.byref(regs), ctypes.byref(local))
        if err:
            raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err}")
        out[name] = {"registers": regs.value, "local_bytes": local.value}
    return out


def launch_bounds() -> dict:
    """sweep_mma's ``__launch_bounds__`` per precision: (threads a block,
    blocks an SM), which fix its register budget (sweep.cu kMmaBlocks*)."""
    out = {}
    for prec in PRECISIONS[1:]:
        threads, blocks = ctypes.c_int(0), ctypes.c_int(0)
        if _library().lib.wrt_sweep_mma_launch_bounds(PRECISIONS.index(prec),
                                                      ctypes.byref(threads), ctypes.byref(blocks)):
            raise RuntimeError(f"wrt_sweep_mma_launch_bounds refused {prec!r}")
        out[prec] = (threads.value, blocks.value)
    return out


def fma_plan(n_rays: int, n_spheres: int, iters: int, sms: int) -> dict:
    """sweep_fma's launch on a card of ``sms`` SMs, as sweep.cu fma_plan
    derives it: ``rays`` a thread and ``threads`` a block (FMA_RAYS in
    blocks of FMA_THREADS where those warps fill the warps the card holds at
    once, else 1 in blocks of FMA_NARROW_THREADS); at one ray a thread
    ``splits``, the warps that share a ray group (a power of two up to
    FMA_MAX_SPLITS, a block's warps and the (pass, sphere) pairs of a
    window, doubled while the groups' warps fit the card), ``pass_parts`` of
    them over runs of passes and the rest over runs of each window's spheres;
    ``window``, the spheres a block stages at once; ``blocks``, each of
    threads / 32 / splits ray groups."""
    window = min(n_spheres, FMA_WINDOW)
    wide = -(-n_rays // (32 * FMA_RAYS)) >= sms * FMA_BLOCKS * (FMA_THREADS // 32)
    rays = FMA_RAYS if wide else 1
    threads = FMA_THREADS if wide else FMA_NARROW_THREADS
    warps = threads // 32
    n_groups = -(-n_rays // (32 * rays))
    resident = sms * (FMA_BLOCKS if wide else FMA_BLOCKS_NARROW) * warps
    splits = 1
    while (not wide and 2 * splits <= min(FMA_MAX_SPLITS, warps) and 2 * splits <= iters * window
           and n_groups * 2 * splits <= resident):
        splits *= 2
    pass_parts = 1
    while 2 * pass_parts <= splits and 2 * pass_parts <= iters:
        pass_parts *= 2
    return {"rays": rays, "threads": threads, "splits": splits, "pass_parts": pass_parts,
            "window": window, "blocks": -(-n_groups // (warps // splits))}


def fma_plan_built(n_rays: int, n_spheres: int, iters: int, sms: int) -> dict:
    """``fma_plan`` as the built library derives it (wrt_sweep_fma_plan)."""
    plan = (ctypes.c_longlong * 6)()
    err = _library().lib.wrt_sweep_fma_plan(n_rays, n_spheres, iters, sms, plan)
    if err:
        raise RuntimeError(f"wrt_sweep_fma_plan refused {(n_rays, n_spheres, iters, sms)}")
    return dict(zip(("rays", "threads", "splits", "pass_parts", "window", "blocks"), plan))


def _stream_handle(device: torch.device) -> int:
    """The current stream of ``device`` as a raw handle, with no Stream
    object built."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _device_type(t: torch.Tensor) -> str:
    return t.device.type


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _check(t: torch.Tensor, what: str, dims: int, dtype=_F32) -> None:
    if t.dtype != dtype or t.dim() != dims or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {dims}-D {dtype} tensor, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _same_device(*ts) -> str:
    """The device type ("cpu" or "cuda") the tensors share; raises if they
    lie on different devices or on another kind."""
    for t in ts[1:]:
        if t.device != ts[0].device:
            raise ValueError(f"tensors on {ts[0].device} and {t.device}")
    kind = _device_type(ts[0])
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {ts[0].device}")
    return kind


def _rays(rays: torch.Tensor, packed_ok: bool) -> bool:
    """Check a ray array; True for the packed B [8, R]."""
    _check(rays, "rays", 2)
    rows = (6, 8) if packed_ok else (6,)
    if rays.shape[0] not in rows or rays.shape[1] == 0 or rays.shape[1] >= 1 << 31:
        raise ValueError(f"rays must be [{' or '.join(map(str, rows))}, R], 0 < R < 2^31, got "
                         f"{tuple(rays.shape)}")
    return rays.shape[0] == 8


def _outputs(rays: torch.Tensor):
    n = rays.shape[1]
    return (torch.empty((n,), dtype=_F32, device=rays.device),
            torch.empty((n,), dtype=_I32, device=rays.device))


# --------------------------------------------------------------------------
# Plain PyTorch twins
# --------------------------------------------------------------------------

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits) as cvt.rna.tf32.f32 rounds it:
    to nearest, ties away from zero, on the bit pattern; inf and NaN kept."""
    bits = x.contiguous().view(_I32)
    rounded = (bits + 0x1000) & ~0x1FFF
    finite = (bits & 0x7F800000) != 0x7F800000
    return torch.where(finite, rounded, bits).view(_F32)


def _split(x: torch.Tensor, prec: str):
    """The operand terms of a product at ``prec``: [x] for fp32, [tf32(x)]
    for tf32, [hi, lo] for 3xtf32."""
    if prec == "fp32":
        return [x]
    hi = tf32_round(x)
    return [hi] if prec == "tf32" else [hi, tf32_round(x - hi)]


def dot_plain(a: torch.Tensor, b: torch.Tensor, prec: str = "fp32") -> torch.Tensor:
    """``dot_mma``'s twin: a [M, K] . b [K, N] in float32, each term summed
    in k order from 0 (the probe's reference ``ref += a[:, k] * b[k, :]``),
    multiply and add rounded apart. tf32 rounds both operands first;
    3xtf32 sums the terms lo.hi, then hi.lo, then hi.hi, as the kernel
    runs its three products (their exact product is a float32, so only
    the order of the sums differs from the tensor cores')."""
    if prec not in PRECISIONS:
        raise ValueError(f"precision {prec!r} is not one of {PRECISIONS}")
    sa, sb = _split(a, prec), _split(b, prec)
    pairs = [(0, 0)] if prec != "3xtf32" else [(1, 0), (0, 1), (0, 0)]
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=_F32, device=a.device)
    for i, j in pairs:
        for k in range(a.shape[1]):
            acc = acc + sa[i][:, k:k + 1] * sb[j][k:k + 1, :]
    return acc


def packed_b(rays: torch.Tensor) -> torch.Tensor:
    """The probe's B [8, R] (dx, dy, dz, ox, oy, oz, 1, 0) of SoA planes [6, R]."""
    n = rays.shape[1]
    return torch.cat([rays[3:6], rays[0:3], torch.ones((1, n), dtype=_F32, device=rays.device),
                      torch.zeros((1, n), dtype=_F32, device=rays.device)]).contiguous()


def sphere_amats(table: torch.Tensor, cs: int) -> torch.Tensor:
    """The probe's per-chunk sphere matrix (probe_mxu_sweep.py:551-556)
    [n / cs, 8, 2 cs] of a sphere table [n, 4] (cx, cy, cz, kq), n a
    multiple of cs: rows 0-2 of columns [0, cs) are c (against d), rows 3-5
    of [cs, 2 cs) are -2c (against o) and row 6 is kq (against 1)."""
    n = table.shape[0]
    if n % cs:
        raise ValueError(f"{n} spheres are not whole chunks of {cs}")
    blk = table.reshape(n // cs, cs, 4).transpose(1, 2)  # [chunks, 4, cs]
    amats = torch.zeros((n // cs, 8, 2 * cs), dtype=_F32, device=table.device)
    amats[:, 0:3, 0:cs] = blk[:, 0:3]
    amats[:, 3:6, cs:] = -2.0 * blk[:, 0:3]
    amats[:, 6, cs:] = blk[:, 3]
    return amats


def _take(bt, bi, ts, valid, s):
    """Running best with a strict <: the first index wins."""
    take = valid & (ts < bt)
    return torch.where(take, ts, bt), torch.where(take, torch.full_like(bi, s), bi)


def _roots(b, cq):
    sq = torch.sqrt(b * b - cq)
    t0, t1 = b - sq, b + sq
    ts = torch.where(t0 > MIN_T, t0, t1)
    return ts, (sq > 0.0) & (ts > MIN_T)


def sweep_plain(spheres: torch.Tensor, rays: torch.Tensor, prec: str = "fma"):
    """The sweeps' twin: (t [R], index [R] int32) of the closest hit, with
    a strict < so that the first index wins, MAX_T and -1 for a miss.

    ``prec="fma"``: ``spheres`` is the table [n, 4] (cx, cy, cz, kq) and
    ``rays`` the planes [6, R]; each sphere as bounce.cuh's sweep_sphere and
    the probe's VPU form compute it, multiply and add rounded apart (the
    kernel contracts them into FMAs). Otherwise ``spheres`` is ``amats``
    [n_chunks, 8, 2 cs] and ``rays`` the planes or the packed B [8, R]: the
    products c.d and -2 c.o + kq as ``dot_plain`` at ``prec`` ("fp32",
    "tf32", "3xtf32"), then the probe's MXU epilogue. Passes of the kernels
    repeat one sweep, so the twin runs one."""
    if prec == "fma":
        o, d = rays[0:3], rays[3:6]
        od = o[0] * d[0] + o[1] * d[1] + o[2] * d[2]
        oo = o[0] * o[0] + o[1] * o[1] + o[2] * o[2]
        bt = torch.full_like(od, MAX_T)
        bi = torch.full(od.shape, -1, dtype=_I32, device=od.device)
        for s in range(spheres.shape[0]):
            cx, cy, cz, kq = spheres[s]
            cd = cx * d[0] + cy * d[1] + cz * d[2]
            co2 = (cx + cx) * o[0] + (cy + cy) * o[1] + (cz + cz) * o[2]
            ts, valid = _roots(cd - od, oo - co2 + kq)
            bt, bi = _take(bt, bi, ts, valid, s)
        return bt, bi
    bm = rays if rays.shape[0] == 8 else packed_b(rays)
    od = bm[0] * bm[3] + bm[1] * bm[4] + bm[2] * bm[5]
    oo = bm[3] * bm[3] + bm[4] * bm[4] + bm[5] * bm[5]
    bt = torch.full_like(od, MAX_T)
    bi = torch.full(od.shape, -1, dtype=_I32, device=od.device)
    cs = spheres.shape[2] // 2
    for c in range(spheres.shape[0]):
        out = dot_plain(spheres[c].transpose(0, 1), bm, prec)  # [2 cs, R]
        for j in range(cs):
            ts, valid = _roots(out[j] - od, oo + out[cs + j])
            bt, bi = _take(bt, bi, ts, valid, c * cs + j)
    return bt, bi


def survivor_plain(amats: torch.Tensor, rays: torch.Tensor, prec: str = "3xtf32",
                   iters: int = 1):
    """``sweep_mma_census``'s twin: the kernel's survivor walk on the
    twin's products (``dot_plain`` at ``prec``), rays in groups of
    MMA_GROUP_RAYS. Lane (g, q) of a warp takes spheres 16 j + g and
    16 j + g + 8 of each 16-sphere tile j against rays 2q and 2q + 1 of
    each 8-ray tile, keeps the pairs the pre-test passes (a real root:
    disc > 0, which is sq > 0), takes their roots in sphere order against
    a running best of its own, and the eight lanes of a ray merge on (t,
    index), the first index winning. A warp takes a root round for each of
    its four pairs of an 8-ray tile that any lane keeps. Returns ((t [R],
    index [R]), census) with ``sweep_mma_census``'s counts; passes repeat
    one sweep, so ``iters`` scales the counts."""
    bm = rays if rays.shape[0] == 8 else packed_b(rays)
    n = bm.shape[1]
    padded = -(-n // MMA_GROUP_RAYS) * MMA_GROUP_RAYS
    od = bm[0] * bm[3] + bm[1] * bm[4] + bm[2] * bm[5]
    oo = bm[3] * bm[3] + bm[4] * bm[4] + bm[5] * bm[5]
    bt = torch.full((8, n), MAX_T, dtype=_F32, device=bm.device)  # a running best per g
    bi = torch.full((8, n), -1, dtype=_I32, device=bm.device)
    cs = amats.shape[2] // 2
    kept = rounds = 0
    for c in range(amats.shape[0]):
        out = dot_plain(amats[c].transpose(0, 1), bm, prec)  # [2 cs, R]
        b = out[:cs] - od
        disc = b * b - (oo + out[cs:])
        keep = disc > 0.0
        # [tile, sphere g or g + 8, g, 8-ray tile, q, ray 2q or 2q + 1]:
        # a round for each pair (sphere g or g + 8, ray 2q or 2q + 1) of an
        # 8-ray tile that any lane (g, q) keeps
        lanes = torch.nn.functional.pad(keep, (0, padded - n)).reshape(
            cs // MMA_TILE, 2, 8, padded // 8, 4, 2)
        kept += int(lanes.sum())
        rounds += int(lanes.any(dim=4).any(dim=2).sum())
        for j in range(cs):
            sq = torch.sqrt(disc[j])
            t0, t1 = b[j] - sq, b[j] + sq
            ts = torch.where(t0 > MIN_T, t0, t1)
            valid = keep[j] & (sq > 0.0) & (ts > MIN_T)
            g = j % 8
            bt[g], bi[g] = _take(bt[g], bi[g], ts, valid, c * cs + j)
    t = bt.min(dim=0).values
    idx = torch.where(bt == t, bi, torch.iinfo(torch.int32).max).min(dim=0).values
    steps = amats.shape[0] * cs // MMA_TILE * padded // 8
    census = {"pairs": padded * amats.shape[0] * cs * iters, "kept": kept * iters,
              "rounds": rounds * iters, "steps": steps * iters}
    return (t, idx.to(_I32)), census


def remap_plain(x: torch.Tensor, reverse: bool = False, affine=None) -> torch.Tensor:
    """``layout_remap``'s twin: rows reversed, and x * scale + bias with
    the multiply and the add rounded apart."""
    y = x.flip(0) if reverse else x.clone()
    if affine is not None:
        y = y * affine[0] + affine[1]
    return y


def chain_plain(x: torch.Tensor, steps: int = 256, c: float = CHAIN_C) -> torch.Tensor:
    """``layout_chain``'s twin: acc = acc * x + c, ``steps`` times from x,
    rounded twice a step (the kernel's FMA rounds once)."""
    acc = x.clone()
    for _ in range(steps):
        acc = acc * x + c
    return acc


# --------------------------------------------------------------------------
# The kernels' wrappers
# --------------------------------------------------------------------------

def sweep_fma(table: torch.Tensor, rays: torch.Tensor, chunk: int = None, iters: int = 1):
    """The closest hit of each ray of ``rays`` [6, R] over ``table`` [n, 4]
    (cx, cy, cz, kq), ``iters`` passes: (t [R], index [R]). ``chunk`` (n
    when None; at most MAX_FMA_CHUNK) names the TPU kernel's chunk; the
    kernel stages its own window (``fma_plan``), and no bit depends on it."""
    _check(table, "sphere table", 2)
    _rays(rays, packed_ok=False)
    n = table.shape[0]
    chunk = n if chunk is None else chunk
    if table.shape[1] != 4 or n == 0 or not 0 < chunk <= MAX_FMA_CHUNK or iters < 1:
        raise ValueError(f"sweep_fma takes a table [n > 0, 4], 0 < chunk <= {MAX_FMA_CHUNK} "
                         f"and iters >= 1, got {tuple(table.shape)}, {chunk}, {iters}")
    kind = _same_device(table, rays)
    if kind == "cpu":
        return sweep_plain(table, rays, "fma")
    t, idx = _outputs(rays)
    err = _library().lib.wrt_sweep_fma(table.data_ptr(), n, chunk, rays.data_ptr(),
                                       rays.shape[1], iters, t.data_ptr(), idx.data_ptr(),
                                       _stream_handle(rays.device))
    _raise_on(err, "sweep_fma")
    sweep_fma.launches += 1
    return t, idx


def _mma_args(amats: torch.Tensor, rays: torch.Tensor, prec: str, iters: int):
    """Check sweep_mma's inputs: (n_chunks, cs, packed, device type)."""
    _check(amats, "amats", 3)
    packed = _rays(rays, packed_ok=True)
    nc, k, cs2 = amats.shape
    if (prec not in PRECISIONS[1:] or k != 8 or nc == 0 or cs2 == 0
            or cs2 % (2 * MMA_TILE) or iters < 1):
        raise ValueError(f"sweep_mma takes amats [n_chunks > 0, 8, 2 cs], cs a multiple of "
                         f"{MMA_TILE}, precision tf32 or 3xtf32 and iters >= 1, got "
                         f"{tuple(amats.shape)}, {prec!r}, {iters}")
    return nc, cs2 // 2, packed, _same_device(amats, rays)


def _count_mma(prec: str) -> None:
    if prec == "tf32":
        sweep_mma.tf32_launches += 1
    else:
        sweep_mma.tf32x3_launches += 1


def sweep_mma(amats: torch.Tensor, rays: torch.Tensor, prec: str = "3xtf32", iters: int = 1):
    """The closest hit of each ray over the spheres of ``amats`` [n_chunks,
    8, 2 cs] (``sphere_amats``; cs a multiple of 16), the products on the
    tensor cores at ``prec`` ("tf32" or "3xtf32"), ``iters`` passes. Rays:
    planes [6, R] or the packed B [8, R]. Returns (t [R], index [R])."""
    nc, cs, packed, kind = _mma_args(amats, rays, prec, iters)
    if kind == "cpu":
        return sweep_plain(amats, rays, prec)
    t, idx = _outputs(rays)
    err = _library().lib.wrt_sweep_mma(amats.data_ptr(), nc, cs, rays.data_ptr(), int(packed),
                                       rays.shape[1], iters, PRECISIONS.index(prec),
                                       t.data_ptr(), idx.data_ptr(), _stream_handle(rays.device))
    _raise_on(err, f"sweep_mma ({prec})")
    _count_mma(prec)
    return t, idx


def sweep_mma_census(amats: torch.Tensor, rays: torch.Tensor, prec: str = "3xtf32",
                     iters: int = 1):
    """``sweep_mma`` through its census instantiation (rays in groups of
    MMA_GROUP_RAYS): ((t [R], index [R]), census), census = {"pairs": the
    pairs tested (R rounded up to the group, times the spheres and
    ``iters``), "kept": those the pre-test kept, "rounds": the root rounds
    the warps took (one for each of a lane's four pairs of an 8-ray tile
    that any lane of the warp keeps), "steps": their (16-sphere tile, 8-ray
    tile) steps, 128 pairs each}. Counted as a launch of sweep_mma at
    ``prec``. For CPU tensors, ``survivor_plain``."""
    nc, cs, packed, kind = _mma_args(amats, rays, prec, iters)
    if kind == "cpu":
        return survivor_plain(amats, rays, prec, iters)
    t, idx = _outputs(rays)
    counts = torch.zeros(3, dtype=torch.int64, device=rays.device)
    err = _library().lib.wrt_sweep_mma_census(
        amats.data_ptr(), nc, cs, rays.data_ptr(), int(packed), rays.shape[1], iters,
        PRECISIONS.index(prec), t.data_ptr(), idx.data_ptr(), counts.data_ptr(),
        _stream_handle(rays.device))
    _raise_on(err, f"sweep_mma census ({prec})")
    _count_mma(prec)
    kept, rounds, steps = (int(c) for c in counts.cpu())
    return (t, idx), {"pairs": 128 * steps, "kept": kept, "rounds": rounds, "steps": steps}


def dot_mma(a: torch.Tensor, b: torch.Tensor, prec: str = "fp32") -> torch.Tensor:
    """a [M, 8] . b [8, N] (M a multiple of 16, N of 8; b 16-byte
    aligned) at ``prec``."""
    _check(a, "a", 2)
    _check(b, "b", 2)
    m, n = a.shape[0], b.shape[1]
    if (prec not in PRECISIONS or a.shape[1] != 8 or b.shape[0] != 8 or m == 0 or m % 16
            or m // 16 > 65535 or n == 0 or n % 8 or m * n >= 1 << 31):
        raise ValueError(f"dot_mma takes a [M, 8] and b [8, N], M a multiple of 16 (at most "
                         f"2^20), N of 8, and a precision in {PRECISIONS}, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, {prec!r}")
    kind = _same_device(a, b)
    if kind == "cpu":
        return dot_plain(a, b, prec)
    if b.data_ptr() % 16:
        raise ValueError("dot_mma reads b 16 bytes at a time: b must be 16-byte aligned")
    c = a.new_empty((m, n))
    err = _library().lib.wrt_dot_mma(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n,
                                     PRECISIONS.index(prec), _stream_handle(a.device))
    if err:
        _raise_on(err, f"dot_mma ({prec})")
    dot_mma.launches += 1
    return c


def layout_remap(x: torch.Tensor, reverse: bool = False, affine=None) -> torch.Tensor:
    """x [rows, cols] (cols a multiple of 4, rows at most 65,535) copied
    with its rows reversed if ``reverse`` and, with
    ``affine = (scale, bias)``, each value as x * scale + bias."""
    _check(x, "x", 2)
    rows, cols = x.shape
    if rows == 0 or rows > 65535 or cols == 0 or cols % 4:
        raise ValueError(f"layout_remap takes [rows <= 65535, cols], cols a multiple of 4, "
                         f"got {tuple(x.shape)}")
    kind = _same_device(x)
    if kind == "cpu":
        return remap_plain(x, reverse, affine)
    out = torch.empty_like(x)
    if x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("layout_remap moves 16 bytes at a time: x must be 16-byte aligned")
    scale, bias = affine if affine is not None else (1.0, 0.0)
    err = _library().lib.wrt_layout_remap(x.data_ptr(), out.data_ptr(), rows, cols,
                                          int(reverse), int(affine is not None), scale, bias,
                                          _stream_handle(x.device))
    _raise_on(err, "layout_remap")
    layout_remap.launches += 1
    return out


def layout_chain(x: torch.Tensor, steps: int = 256, chains: int = 1,
                 c: float = CHAIN_C) -> torch.Tensor:
    """p4's chain on every value of x: acc = acc * x + c, ``steps`` times
    from x, one FMA a step; ``chains`` (1 or 4) independent values a
    thread."""
    if x.dtype != _F32 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"layout_chain takes a contiguous float32 tensor, got {x.dtype}")
    if chains not in (1, 4) or steps < 0:
        raise ValueError(f"layout_chain takes 1 or 4 chains a thread and steps >= 0, got "
                         f"{chains}, {steps}")
    kind = _same_device(x)
    if kind == "cpu":
        return chain_plain(x, steps, c)
    out = torch.empty_like(x)
    err = _library().lib.wrt_layout_chain(x.data_ptr(), out.data_ptr(), x.numel(), steps,
                                          chains, c, _stream_handle(x.device))
    _raise_on(err, "layout_chain")
    layout_chain.launches += 1
    return out


def launch_counts() -> dict:
    """Launches of each kernel of KERNELS since the last zero_launch_counts."""
    return {"sweep_fma": sweep_fma.launches, "sweep_mma_tf32": sweep_mma.tf32_launches,
            "sweep_mma_3xtf32": sweep_mma.tf32x3_launches, "dot_mma": dot_mma.launches,
            "layout": layout_remap.launches + layout_chain.launches}


def zero_launch_counts() -> None:
    for fn in (sweep_fma, dot_mma, layout_remap, layout_chain):
        fn.launches = 0
    sweep_mma.tf32_launches = sweep_mma.tf32x3_launches = 0


zero_launch_counts()


__all__ = ["sweep_fma", "sweep_mma", "sweep_mma_census", "dot_mma", "layout_remap",
           "layout_chain", "sweep_plain", "survivor_plain", "dot_plain", "remap_plain",
           "chain_plain", "tf32_round", "sphere_amats", "packed_b", "launch_counts",
           "zero_launch_counts", "fma_plan"]
