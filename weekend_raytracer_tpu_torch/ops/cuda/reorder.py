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
launches the CUDA kernel for CUDA tensors (counted in its ``.launches``)
or raises, and runs its plain PyTorch twin for CPU tensors. The index list
is int32 and in range; a scatter's indices must not repeat (a permutation's
never do).
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
KERNEL_NAMES = ("record_gather", "record_gather_vec4", "record_scatter",
                "record_scatter_vec4", "dma_rate")


def _library():
    """Build (first use) and load the kernel library; raises on failure."""
    built = load_library(*LIBRARY)
    lib = built.lib
    if lib.wrt_record_gather.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        sigs = {
            "wrt_record_gather": [vp, vp, vp, ll, i, ll, ll, ll, i, vp],
            "wrt_record_scatter": [vp, vp, vp, ll, i, ll, ll, ll, i, vp],
            "wrt_dma_rate": [vp, vp, vp, i, i, i, vp],
            "wrt_reorder_attributes": [i, ctypes.POINTER(i), ctypes.POINTER(i)],
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return built


def kernel_attributes() -> dict:
    """Registers per thread and local-memory bytes of each built kernel."""
    lib = _library().lib
    out = {}
    for which, name in enumerate(KERNEL_NAMES):
        regs, local = ctypes.c_int(0), ctypes.c_int(0)
        err = lib.wrt_reorder_attributes(which, ctypes.byref(regs), ctypes.byref(local))
        if err:
            raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err}")
        out[name] = {"registers": regs.value, "local_bytes": local.value}
    return out


def _stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _device_type(t: torch.Tensor) -> str:
    return t.device.type


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _layout(t: torch.Tensor, dim: int, what: str):
    """(records, planes, width, plane stride) of a contiguous f32 array
    whose records lie along ``dim``."""
    if t.dtype != _F32 or not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous float32, got {t.dtype}")
    if dim == 0 and t.dim() >= 1:
        return t.shape[0], 1, math.prod(t.shape[1:]), 0
    if dim == 1 and t.dim() == 2:
        return t.shape[1], t.shape[0], 1, t.shape[1]
    raise ValueError(f"records along dim {dim} of a {t.dim()}-D {what} are not supported "
                     "(dim 0: rows; dim 1: columns of a 2-D array)")


def _check_pair(src, dst, idx, dim, n_dst_min: int, n_src_min: int):
    for t in (src, dst, idx):
        if t.device != src.device:
            raise ValueError(f"tensors on {src.device} and {t.device}")
    if idx.dtype != _I32 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(f"index list must be a contiguous 1-D int32 tensor, got {idx.dtype}")
    rs, ps, ws, lds = _layout(src, dim, "source")
    rd, pd, wd, ldd = _layout(dst, dim, "destination")
    if (ps, ws) != (pd, wd) or (dim == 0 and src.shape[1:] != dst.shape[1:]):
        raise ValueError(f"records of {tuple(src.shape)} and {tuple(dst.shape)} differ")
    if rd < n_dst_min or rs < n_src_min:
        raise ValueError(f"{idx.numel()} records do not fit {tuple(src.shape)} -> "
                         f"{tuple(dst.shape)} along dim {dim}")
    return ps, ws, lds, ldd


def _vec4(src, dst, width: int, lds: int, ldd: int) -> int:
    """1 where every access can be 16 bytes wide."""
    return int(width % 4 == 0 and lds % 4 == 0 and ldd % 4 == 0
               and src.data_ptr() % 16 == 0 and dst.data_ptr() % 16 == 0)


def _launch(name: str, src, dst, idx, planes, width, lds, ldd) -> None:
    n = idx.numel()
    if n * width >= 1 << 31:
        raise ValueError(f"{n} records of {width} values: {name} takes fewer than 2^31")
    if n == 0:
        return
    fn = getattr(_library().lib, f"wrt_{name}")
    err = fn(src.data_ptr(), dst.data_ptr(), idx.data_ptr(), n, planes, width, lds, ldd,
             _vec4(src, dst, width, lds, ldd), _stream_handle(src.device))
    _raise_on(err, name)


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
    planes, width, lds, ldd = _check_pair(src, out, idx, dim, n, 0)
    kind = _device_type(src)
    if kind == "cpu":
        return gather_plain(src, idx, out, dim)
    if kind != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    _launch("record_gather", src, out, idx, planes, width, lds, ldd)
    if n:
        record_gather.launches += 1
    return out


def record_scatter(src: torch.Tensor, idx: torch.Tensor, dst: torch.Tensor,
                   dim: int = 0) -> torch.Tensor:
    """The first idx.numel() records of ``src`` (along ``dim``) into
    records idx of ``dst``, in place; the others keep what they held.
    Returns ``dst``."""
    planes, width, lds, ldd = _check_pair(src, dst, idx, dim, 0, idx.numel())
    kind = _device_type(src)
    if kind == "cpu":
        return scatter_plain(src, idx, dst, dim)
    if kind != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    _launch("record_scatter", src, dst, idx, planes, width, lds, ldd)
    if idx.numel():
        record_scatter.launches += 1
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
           "dma_rate_plain"]
