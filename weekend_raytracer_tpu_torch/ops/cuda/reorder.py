"""Record reorder kernels: gather and scatter whole records by an index list.

Counterparts of the record-DMA probes of benchmarks/probe_dma.py and
probe_mosaic.py (csrc/reorder.cu says what bounds them on the card):

  record_gather   out record i = src record idx[i].
  record_scatter  dst record idx[j] = src record j, in place; records not
                  named keep what dst held.
  dma_rate        probe_dma_rate's kernel: per tile of 32 records picked by
                  a permutation, the sum of their component 0, broadcast to
                  an (8, 128) block.

A record is a row of an array (``dim=0``: ``src[r]``, all trailing values
of row r, contiguous) or a column of a 2-D SoA array (``dim=1``:
``src[:, r]``, as in the regroup pipeline's pool [16, cap]). Each wrapper
launches the CUDA kernel for CUDA tensors (each launch counted in its
``.launches``) or raises, and runs its plain PyTorch twin for CPU tensors.
The index list is int32 and in range; a scatter's indices must not repeat
(a permutation's never do); the library refuses a move of 2^31 values or
more (a RuntimeError). A wrapper's host side is most of a call at the
probes' shapes, so the library is loaded and bound once and the stream is
read as a raw handle.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .build import load_library

_F32 = torch.float32
_I32 = torch.int32

KERNEL_SOURCE = "weekend_raytracer_tpu_torch/csrc/reorder.cu"
# (name, compiled sources) for build.load_library
LIBRARY = ("wrt_reorder", ("reorder.cu",))
# the pallas_calls each kernel replaces
REPLACES = {
    "record_gather": ("benchmarks/probe_dma.py:36, :63, :104; "
                      "benchmarks/probe_mosaic.py:143"),
    "record_scatter": "benchmarks/probe_dma.py:145",
    "dma_rate": "benchmarks/probe_dma.py:199",
}
RATE_RECORDS = 32  # records per dma_rate tile (probe_dma.py:180-194)
RATE_THREADS = 256  # dma_rate's block: the sum order depends on it
RATE_OUT = (8, 128)  # each tile's output block
# a block's 227 KiB of shared memory, less 1 KiB for dma_rate's static arrays
MAX_RATE_RECORD_FLOATS = (232448 - 1024) // (4 * RATE_RECORDS)

# reorder.cu wrt_reorder_attributes index -> kernel
KERNEL_NAMES = ("gather_cols", "scatter_cols", "invert",
                *(f"{k}_rows{v}_{u}" for u in ("one", "vecs") for k in ("gather", "scatter")
                  for v in ("", "_vec4")),
                "dma_rate")
# a record narrower than an L2 sector (32 bytes): a direct scatter's stores
# would be partial sectors, so a scatter that names every record of dst
# inverts the list and gathers through it (reorder.cu)
SECTOR_FLOATS = 8

_BUILT = None  # the loaded library, its functions bound, after the first call
_vp, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the library's C functions and their arguments (each returns an int)
SIGNATURES = {
    "wrt_record_gather": [_vp, _vp, _vp, _ll, _i, _ll, _ll, _ll, _vp],
    "wrt_record_scatter": [_vp, _vp, _vp, _ll, _i, _ll, _ll, _ll, _vp, _vp],
    "wrt_dma_rate": [_vp, _vp, _vp, _i, _i, _i, _vp],
    "wrt_reorder_attributes": [_i, ctypes.POINTER(_i), ctypes.POINTER(_i), ctypes.POINTER(_i)],
}


def bind(lib) -> None:
    """Set SIGNATURES on the functions ``lib`` (a ctypes.CDLL of
    reorder.cu) exports."""
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
    """Registers per thread, local-memory bytes per thread and the blocks
    the card holds at once (what a row kernel's grid is sized by; 0 for the
    column kernels and dma_rate, whose grid is their tiles) of each built
    kernel."""
    lib = _library().lib
    out = {}
    for which, name in enumerate(KERNEL_NAMES):
        regs, local, blocks = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
        err = lib.wrt_reorder_attributes(which, ctypes.byref(regs), ctypes.byref(local),
                                         ctypes.byref(blocks))
        if err:
            raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err}")
        out[name] = {"registers": regs.value, "local_bytes": local.value,
                     "resident_blocks": blocks.value}
    return out


def _stream_handle(device: torch.device) -> int:
    """The current stream of ``device`` as a raw handle, with no Stream
    object built."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _device_type(t: torch.Tensor) -> str:
    return t.device.type


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _pair(src, dst, idx, dim: int, n_dst_min: int, n_src_min: int):
    """(planes, width, src plane stride, dst plane stride, dst records) of
    a move between contiguous float32 arrays whose records lie along
    ``dim`` (0: rows; 1: columns of a 2-D array) by a contiguous 1-D int32
    list; raises ValueError for anything else."""
    if (src.dtype != _F32 or dst.dtype != _F32 or not src.is_contiguous()
            or not dst.is_contiguous()):
        raise ValueError(f"source and destination must be contiguous float32, got "
                         f"{src.dtype} and {dst.dtype}")
    if idx.dtype != _I32 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(f"index list must be a contiguous 1-D int32 tensor, got {idx.dtype}")
    device = src.device
    if dst.device != device or idx.device != device:
        raise ValueError(f"tensors on {device}, {dst.device} and {idx.device}")
    ss, ds = src.shape, dst.shape
    if dim == 0 and len(ss) >= 1 and ss[1:] == ds[1:]:
        rs, rd, planes, width, lds, ldd = ss[0], ds[0], 1, math.prod(ss[1:]), 0, 0
    elif dim == 1 and len(ss) == 2 and len(ds) == 2 and ss[0] == ds[0]:
        rs, rd, planes, width, lds, ldd = ss[1], ds[1], ss[0], 1, ss[1], ds[1]
    else:
        raise ValueError(f"records along dim {dim} of {tuple(ss)} and {tuple(ds)} differ or are "
                         "not supported (dim 0: rows; dim 1: columns of a 2-D array)")
    if rd < n_dst_min or rs < n_src_min:
        raise ValueError(f"{idx.numel()} records do not fit {tuple(ss)} -> {tuple(ds)} along "
                         f"dim {dim}")
    return planes, width, lds, ldd, rd


def gather_plain(src: torch.Tensor, idx: torch.Tensor, out: torch.Tensor,
                 dim: int = 0) -> torch.Tensor:
    """``record_gather``'s twin: out's first n records along ``dim`` are
    src's records idx."""
    n = idx.numel()
    if dim == 0:
        out[:n] = src[idx.long()]
    else:
        out[:, :n] = src[:, idx.long()]
    return out


def scatter_plain(src: torch.Tensor, idx: torch.Tensor, dst: torch.Tensor,
                  dim: int = 0) -> torch.Tensor:
    """``record_scatter``'s twin: dst's records idx are src's first n."""
    n = idx.numel()
    if dim == 0:
        dst[idx.long()] = src[:n]
    else:
        dst[:, idx.long()] = src[:, :n]
    return dst


def record_gather(src: torch.Tensor, idx: torch.Tensor, out: torch.Tensor = None,
                  dim: int = 0) -> torch.Tensor:
    """Records idx of ``src`` (along ``dim``) into the first idx.numel()
    records of ``out`` (allocated with just those records when None); the
    rest of ``out`` is left as it is. Returns ``out``."""
    n = idx.numel()
    if out is None:
        shape = (n, *src.shape[1:]) if dim == 0 else (src.shape[0], n)
        out = torch.empty(shape, dtype=src.dtype, device=src.device)
    planes, width, lds, ldd, _ = _pair(src, out, idx, dim, n, 0)
    kind = _device_type(src)
    if kind == "cpu":
        return gather_plain(src, idx, out, dim)
    if kind != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    if n:
        err = _library().lib.wrt_record_gather(src.data_ptr(), out.data_ptr(), idx.data_ptr(),
                                               n, planes, width, lds, ldd,
                                               _stream_handle(src.device))
        _raise_on(err, "record_gather")
        record_gather.launches += 1
    return out


def inverts(n: int, dst_records: int, width: int) -> bool:
    """Whether record_scatter takes its inverse route: the list names every
    record of dst (n of them; indices never repeat) and a record is
    narrower than an L2 sector. A shorter list must leave the records it
    does not name as they were, so it stores where the list points. On the
    card a list of full length must be a permutation: one with a repeated
    index leaves inverse entries unwritten, and the gather through them
    reads out of bounds."""
    return n == dst_records and width < SECTOR_FLOATS


def record_scatter(src: torch.Tensor, idx: torch.Tensor, dst: torch.Tensor,
                   dim: int = 0) -> torch.Tensor:
    """The first idx.numel() records of ``src`` (along ``dim``) into
    records idx of ``dst``, in place; the others keep what they held.
    Returns ``dst``. On the card a list that names every record of a
    narrow-record dst (``inverts``) is inverted into int32 scratch and dst
    gathered through it: two launches, both counted. Such a list must be a
    permutation of dst's records: with a repeated index the kernels read
    out of bounds (the callers pass sort orders, which are permutations)."""
    n = idx.numel()
    planes, width, lds, ldd, rd = _pair(src, dst, idx, dim, 0, n)
    kind = _device_type(src)
    if kind == "cpu":
        return scatter_plain(src, idx, dst, dim)
    if kind != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    if n:
        inverse = (torch.empty(n, dtype=_I32, device=src.device) if inverts(n, rd, width)
                   else None)
        err = _library().lib.wrt_record_scatter(
            src.data_ptr(), dst.data_ptr(), idx.data_ptr(), n, planes, width, lds, ldd,
            None if inverse is None else inverse.data_ptr(), _stream_handle(src.device))
        _raise_on(err, "record_scatter")
        record_scatter.launches += 1 if inverse is None else 2
    return dst


def _rate_shape(pool: torch.Tensor, perm: torch.Tensor):
    """(tiles, record floats, component-0 floats) of a dma_rate call."""
    if pool.dtype != _F32 or pool.dim() != 3 or not pool.is_contiguous():
        raise ValueError("dma_rate takes a contiguous float32 pool [records, comps, width]")
    if perm.dtype != _I32 or perm.dim() != 1 or perm.device != pool.device:
        raise ValueError("dma_rate takes an int32 index list on the pool's device")
    n = perm.numel()
    rec = pool.shape[1] * pool.shape[2]
    comp = pool.shape[2]
    if n == 0 or n % RATE_RECORDS:
        raise ValueError(f"{n} indices are not whole tiles of {RATE_RECORDS}")
    if rec % 4 or comp % 8 or rec > MAX_RATE_RECORD_FLOATS:
        raise ValueError(f"records of {pool.shape[1]} x {comp} f32: dma_rate takes a width "
                         f"that is a multiple of 8 and at most {MAX_RATE_RECORD_FLOATS} "
                         "values a record")
    return n // RATE_RECORDS, rec, comp


def dma_rate_plain(pool: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``dma_rate``'s twin, summing in the kernel's order (reorder.cu):
    per thread of 256 its values in turn from 0, each warp's 32 partial
    sums halved five times, then the 8 warp sums in order."""
    tiles, _, comp = _rate_shape(pool, perm)
    vals = pool[perm.long(), 0].reshape(tiles, RATE_RECORDS * comp // RATE_THREADS,
                                        RATE_THREADS)
    s = torch.zeros((tiles, RATE_THREADS), dtype=_F32, device=pool.device)
    for m in range(vals.shape[1]):
        s = s + vals[:, m]
    s = s.reshape(tiles, RATE_THREADS // 32, 32)
    for off in (16, 8, 4, 2, 1):
        s = s[..., :off] + s[..., off:2 * off]
    total = s[..., 0, 0]
    for w in range(1, RATE_THREADS // 32):
        total = total + s[:, w, 0]
    return total[:, None, None].expand(tiles, *RATE_OUT).reshape(tiles * RATE_OUT[0],
                                                                 RATE_OUT[1]).contiguous()


def dma_rate(pool: torch.Tensor, perm: torch.Tensor, out: torch.Tensor = None) -> torch.Tensor:
    """probe_dma_rate's kernel: for tile t of the records perm[32 t : 32 t +
    32] of ``pool`` [records, comps, width], the sum of their component 0
    written over rows [8 t, 8 t + 8) of ``out`` [tiles * 8, 128]. Every
    record is moved whole into shared memory."""
    tiles, rec, comp = _rate_shape(pool, perm)
    shape = (tiles * RATE_OUT[0], RATE_OUT[1])
    if out is None:
        out = torch.empty(shape, dtype=_F32, device=pool.device)
    if (out.device != pool.device or tuple(out.shape) != shape or out.dtype != _F32
            or not out.is_contiguous()):
        raise ValueError(f"dma_rate output must be contiguous float32 {shape} on {pool.device}")
    kind = _device_type(pool)
    if kind == "cpu":
        out.copy_(dma_rate_plain(pool, perm))
        return out
    if kind != "cuda":
        raise ValueError(f"unsupported device {pool.device}")
    if pool.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("dma_rate copies 16 bytes at a time: pool and output must be "
                         "16-byte aligned")
    err = _library().lib.wrt_dma_rate(pool.data_ptr(), perm.data_ptr(), out.data_ptr(), tiles,
                                      rec, comp, _stream_handle(pool.device))
    _raise_on(err, "dma_rate")
    dma_rate.launches += 1
    return out


for _fn in (record_gather, record_scatter, dma_rate):
    _fn.launches = 0


__all__ = ["record_gather", "record_scatter", "dma_rate", "gather_plain", "scatter_plain",
           "dma_rate_plain", "inverts", "kernel_attributes"]
