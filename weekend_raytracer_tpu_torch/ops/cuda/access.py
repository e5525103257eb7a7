"""Indexed-access probe kernels: what a per-lane indexed access costs.

Counterparts of the fifteen pallas_calls of benchmarks/probe_gather_cost.py,
benchmarks/probe_place.py and benchmarks/probe_mosaic.py (csrc/access.cu
says what bounds each on the card):

  table_gather  per lane of each (32, 128) tile, 16 fetches from a table
                of 128-wide rows over the span of rows the tile touches,
                summed in fetch order: route "global" (loads through the
                L1), "shared" (the span staged in shared memory) or
                "arith" (the index math alone, adding the value the
                probe's arange table holds at each address).
  lane_gather   take_along_axis per tile: along the lanes of each row (an
                index array, or each row rotated by its own shift, from a
                row picked at run time if asked), or along the rows of
                each (32, 128) tile; route "shfl", "smem" or "local".
  smem_rw       a scratch of words, written and read at run-time offsets;
                route "shfl" (scratches of 32 to 1024 words in a warp's
                registers), "smem" (each scratch staged in shared memory)
                or "direct" (no copy: each output word read where it
                lies, in the base or in the last write that covers it).
  row_sort      probe_place.py p3's bitonic network along each row of 128.
  lane_scan     an inclusive sum along each row of 128.

lane_gather and smem_rw move 32-bit words (float32 or int32 tensors, the
same bits out), never through float arithmetic. Indices are taken modulo
what they index: a lane modulo 128, a row of a tile modulo 32, a row pick
or a scratch offset modulo its size (floor modulo, as jnp's ``%``), so no
input reads out of bounds. Each wrapper launches its CUDA kernel for CUDA
tensors (counted in its launch counter) or raises, and runs its plain
PyTorch twin for CPU tensors; every twin repeats its kernel's order of
operations, so the two agree in every bit. A wrapper's host side is most
of a call at the probes' shapes, so the library is loaded and bound once
and the stream is read as a raw handle.
"""
from __future__ import annotations

import ctypes

import torch

from .build import load_library

_F32 = torch.float32
_I32 = torch.int32

KERNEL_SOURCE = "weekend_raytracer_tpu_torch/csrc/access.cu"
# (name, compiled sources) for build.load_library
LIBRARY = ("wrt_access", ("access.cu",))
# the pallas_calls each kernel replaces
REPLACES = {
    "table_gather": "benchmarks/probe_gather_cost.py:66 (make_fn, :20)",
    "lane_gather": "benchmarks/probe_mosaic.py:33, :49, :66, :277, :296; "
                   "benchmarks/probe_place.py:52, :126",
    "smem_rw": "benchmarks/probe_place.py:72; benchmarks/probe_mosaic.py:83, :104, :231, :251",
    "row_sort": "benchmarks/probe_place.py:104",
    "lane_scan": "benchmarks/probe_mosaic.py:213",
}
KERNELS = tuple(REPLACES)
WIDTH = 128  # lanes of a row
TILE_ROWS = 32  # rows of a table_gather tile and of an axis-0 lane_gather tile
FETCH_STRIDE = 37  # probe_gather_cost.py:32
N_FETCH = 16  # probe_gather_cost.py:54
GATHER_ROUTES = ("global", "shared", "arith")
LANE_ROUTES = ("shfl", "smem", "local")
RW_ROUTES = ("shfl", "smem", "direct")
MAX_SHARED_BYTES = 232448  # a block's shared memory on an H100
# the rows of a span table_gather "shared" can stage beside its 128 B of
# warp minima
MAX_SHARED_SPAN = (MAX_SHARED_BYTES - 128) // (WIDTH * 4)
SHFL_WORDS = (32, 64, 128, 256, 512, 1024)  # scratch sizes smem_rw "shfl" holds
MAX_DIRECT_WRITES = 1024  # writes smem_rw "direct" takes (their offsets staged a block)

# access.cu wrt_access_attributes index -> kernel
KERNEL_NAMES = ("table_gather_global", "table_gather_shared", "table_gather_arith",
                "lane_gather_rows_shfl", "lane_gather_rows_smem", "lane_gather_rows_local",
                "lane_gather_cols_shfl", "lane_gather_cols_smem", "lane_gather_cols_local",
                *(f"smem_rw_shfl_{w}" for w in SHFL_WORDS), "smem_rw_smem",
                "smem_rw_direct_1", "smem_rw_direct_4", "row_sort", "lane_scan")

_BUILT = None  # the loaded library, its functions bound, after the first call
_vp, _i = ctypes.c_void_p, ctypes.c_int
# the library's C functions and their arguments (each returns an int)
SIGNATURES = {
    "wrt_table_gather": [_vp, _i, _vp, _i, _i, _i, _i, _vp, _vp],
    "wrt_lane_gather": [_vp, _i, _vp, _vp, _vp, _i, _i, _i, _vp, _vp],
    "wrt_smem_rw": [_vp, _i, _i, _vp, _vp, _i, _i, _vp, _i, _i, _i, _vp, _vp],
    "wrt_row_sort": [_vp, _i, _vp, _vp],
    "wrt_lane_scan": [_vp, _i, _vp, _vp],
    "wrt_access_attributes": [_i, ctypes.POINTER(_i), ctypes.POINTER(_i), ctypes.POINTER(_i)],
}


def bind(lib) -> None:
    """Set SIGNATURES on the functions ``lib`` (a ctypes.CDLL of access.cu)
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
    """Registers per thread, local-memory bytes per thread and static
    shared-memory bytes of each built kernel."""
    lib = _library().lib
    out = {}
    for which, name in enumerate(KERNEL_NAMES):
        regs, local, shared = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
        err = lib.wrt_access_attributes(which, ctypes.byref(regs), ctypes.byref(local),
                                        ctypes.byref(shared))
        if err:
            raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err}")
        out[name] = {"registers": regs.value, "local_bytes": local.value,
                     "shared_bytes": shared.value}
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


def _check(t: torch.Tensor, what: str, dims: int, dtypes=(_F32,)) -> None:
    if t.dtype not in dtypes or t.dim() != dims or not t.is_contiguous() or t.numel() == 0:
        raise ValueError(f"{what} must be a non-empty contiguous {dims}-D "
                         f"{' or '.join(map(str, dtypes))} tensor, got {t.dtype} "
                         f"{tuple(t.shape)}")


def _same_device(*ts) -> str:
    """The device type ("cpu" or "cuda") the tensors (None skipped; the
    first is one) share; raises if they lie on different devices or on
    another kind."""
    first = ts[0].device
    for t in ts[1:]:
        if t is not None and t.device != first:
            raise ValueError(f"tensors on {first} and {t.device}")
    kind = _device_type(ts[0])
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {ts[0].device}")
    return kind


def _ptr(t) -> int:
    return None if t is None else t.data_ptr()


def _route(route: str, routes: tuple, what: str) -> int:
    if route not in routes:
        raise ValueError(f"{what} route {route!r} is not one of {routes}")
    return routes.index(route)


_WORDS = (_F32, _I32)  # the 32-bit types the word-moving kernels take


# --------------------------------------------------------------------------
# Plain PyTorch twins
# --------------------------------------------------------------------------

def table_gather_plain(tab: torch.Tensor, idx: torch.Tensor, span_rows: int,
                       n_fetch: int = N_FETCH, route: str = "global") -> torch.Tensor:
    """``table_gather``'s twin, probe_gather_cost.py's make_fn: per (32,
    128) tile of ``idx``, span_base = min(tile) & ~127; for k < n_fetch,
    flat = span_base + (idx - span_base + 37 k) mod (span_rows * 128) and
    the lane adds tab[(flat >> 7) mod rows, flat & 127] (for "arith", that
    address as a float: the probe's arange table) to its sum, from 0.0 in
    k order. "shared" fetches what "global" does."""
    tiles = idx.reshape(-1, TILE_ROWS * WIDTH)
    span_base = tiles.min(dim=1, keepdim=True).values & ~(WIDTH - 1)
    words = span_rows * WIDTH
    flat_tab = tab.reshape(-1)
    acc = torch.zeros(tiles.shape, dtype=_F32, device=idx.device)
    for k in range(n_fetch):
        flat = span_base + torch.remainder(tiles - span_base + FETCH_STRIDE * k, words)
        at = torch.remainder(flat >> 7, tab.shape[0]) * WIDTH + (flat & (WIDTH - 1))
        acc = acc + (at.to(_F32) if route == "arith" else flat_tab[at.long()])
    return acc.reshape(idx.shape)


def lane_gather_plain(x: torch.Tensor, idx: torch.Tensor = None, shift: torch.Tensor = None,
                      rows: torch.Tensor = None, axis: int = 1) -> torch.Tensor:
    """``lane_gather``'s twin: with axis 1, out[r, c] = x[sr, j], sr =
    rows[r] mod x_rows (or r) and j = idx[r, c] mod 128 or (c - shift[r])
    & 127; with axis 0, per (32, 128) tile, out[r, c] = x[idx[r, c] mod 32,
    c]. The words move as int32, so every bit is kept."""
    words = x.view(_I32)
    if axis == 0:
        tiles = words.reshape(-1, TILE_ROWS, WIDTH)
        j = (idx & (TILE_ROWS - 1)).reshape(tiles.shape).long()
        return torch.gather(tiles, 1, j).reshape(x.shape).view(x.dtype)
    src = words if rows is None else words[torch.remainder(rows, x.shape[0]).long()]
    if idx is None:
        lane = torch.arange(WIDTH, dtype=_I32, device=x.device)
        j = (lane[None, :] - shift[:, None]) & (WIDTH - 1)
    else:
        j = idx & (WIDTH - 1)
    return torch.gather(src, 1, j.long()).view(x.dtype)


def smem_rw_plain(base: torch.Tensor, read_idx: torch.Tensor, read_width: int = 1,
                  vals: torch.Tensor = None, write_idx: torch.Tensor = None) -> torch.Tensor:
    """``smem_rw``'s twin: each scratch (a row of ``base`` [batch, words])
    takes write k's words vals[k, w] at (write_idx[k] + w) mod words, in k
    order, then out[b, m, w] = scratch[(read_idx[m] + w) mod words], [batch,
    n_reads, read_width]. The words move as int32."""
    scratch = base.view(_I32).clone()
    words = scratch.shape[1]
    if write_idx is not None:
        v = vals.view(_I32)
        w = torch.arange(v.shape[1], dtype=_I32, device=base.device)
        for k in range(write_idx.shape[0]):
            scratch[:, torch.remainder(write_idx[k] + w, words).long()] = v[k]
    w = torch.arange(read_width, dtype=_I32, device=base.device)
    at = torch.remainder(read_idx[:, None] + w[None, :], words).long()
    return scratch[:, at].view(base.dtype)


def row_sort_plain(x: torch.Tensor) -> torch.Tensor:
    """``row_sort``'s twin, stage by stage: probe_place.py p3's network
    (:88-99) with the kernel's compare form: lane l pairs with l ^ j, the
    pair's lower-lane value lo and higher-lane value hi swap when hi < lo
    (l & k == 0) or lo < hi (otherwise)."""
    v = x.clone()
    lane = torch.arange(WIDTH, device=x.device)
    k = 2
    while k <= WIDTH:
        j = k // 2
        while j >= 1:
            pv = v[:, lane ^ j]
            lower = (lane & j) == 0
            lo = torch.where(lower, v, pv)
            hi = torch.where(lower, pv, v)
            swap = torch.where((lane & k) == 0, hi < lo, lo < hi)
            v = torch.where(swap, pv, v)
            j //= 2
        k *= 2
    return v


def lane_scan_plain(x: torch.Tensor) -> torch.Tensor:
    """``lane_scan``'s twin in the kernel's order: each group of four lanes
    summed in order; the groups' totals scanned Kogge-Stone (offsets 1, 2,
    4, 8, 16, each group adding the total from that many groups down); each
    group after the first adds the inclusive total of the group before."""
    a = x.reshape(x.shape[0], WIDTH // 4, 4)
    s = [a[..., 0]]
    for i in range(1, 4):
        s.append(s[-1] + a[..., i])
    incl = s[3]
    off = 1
    while off < WIDTH // 4:
        nxt = incl.clone()
        nxt[:, off:] = incl[:, off:] + incl[:, :-off]
        incl = nxt
        off *= 2
    out = torch.stack(s, dim=2)
    out[:, 1:] = incl[:, :-1, None] + out[:, 1:]
    return out.reshape(x.shape)


# --------------------------------------------------------------------------
# The kernels' wrappers
# --------------------------------------------------------------------------

def table_gather(tab: torch.Tensor, idx: torch.Tensor, span_rows: int,
                 n_fetch: int = N_FETCH, route: str = "global") -> torch.Tensor:
    """Per (32, 128) tile of ``idx`` [n_tiles * 32, 128] int32, each lane's
    sum of ``n_fetch`` fetches from ``tab`` [table_rows, 128] float32 over
    ``span_rows`` rows from the tile's first (probe_gather_cost.py's
    make_fn); route "global", "shared" (span_rows <= MAX_SHARED_SPAN) or
    "arith". Returns float32 of idx's shape."""
    _check(tab, "table", 2)
    _check(idx, "indices", 2, (_I32,))
    which = _route(route, GATHER_ROUTES, "table_gather")
    if (tab.shape[1] != WIDTH or idx.shape[1] != WIDTH or idx.shape[0] % TILE_ROWS
            or idx.shape[0] // TILE_ROWS >= 1 << 31 or not 0 < span_rows < 1 << 24
            or n_fetch < 0 or (route == "shared" and span_rows > MAX_SHARED_SPAN)):
        raise ValueError(f"table_gather takes a table [rows, {WIDTH}], indices [32 n, {WIDTH}], "
                         f"0 < span_rows (at most {MAX_SHARED_SPAN} for 'shared') and "
                         f"n_fetch >= 0, got {tuple(tab.shape)}, {tuple(idx.shape)}, "
                         f"{span_rows}, {n_fetch}")
    if _same_device(tab, idx) == "cpu":
        return table_gather_plain(tab, idx, span_rows, n_fetch, route)
    out = torch.empty(idx.shape, dtype=_F32, device=idx.device)
    err = _library().lib.wrt_table_gather(tab.data_ptr(), tab.shape[0], idx.data_ptr(),
                                          idx.shape[0] // TILE_ROWS, span_rows, n_fetch, which,
                                          out.data_ptr(), _stream_handle(idx.device))
    _raise_on(err, f"table_gather ({route})")
    table_gather.launches += 1
    return out


def lane_gather(x: torch.Tensor, idx: torch.Tensor = None, *, shift: torch.Tensor = None,
                rows: torch.Tensor = None, axis: int = 1, route: str = "shfl") -> torch.Tensor:
    """take_along_axis on ``x`` [x_rows, 128] (float32 or int32 words, kept
    bit for bit). Axis 1: out [n, 128] with out[r, c] = x[sr, j], j =
    idx[r, c] mod 128 (``idx`` [n, 128] int32) or (c - shift[r]) & 127
    (``shift`` [n] int32), sr = rows[r] mod x_rows (``rows`` [n] int32) or
    r. Axis 0: ``idx`` like x, x_rows a multiple of 32, and per (32, 128)
    tile out[r, c] = x[idx[r, c] mod 32, c]. Route "shfl", "smem" or
    "local"."""
    _check(x, "x", 2, _WORDS)
    which = _route(route, LANE_ROUTES, "lane_gather")
    if (idx is None) == (shift is None):
        raise ValueError("lane_gather takes an index array or a shift, not both or neither")
    if idx is not None:
        _check(idx, "indices", 2, (_I32,))
        n = idx.shape[0]
        shape_ok = idx.shape[1] == WIDTH
    else:
        _check(shift, "shift", 1, (_I32,))
        n = shift.shape[0]
        shape_ok = True
    if rows is not None:
        _check(rows, "rows", 1, (_I32,))
        shape_ok = shape_ok and rows.shape[0] == n
    if axis == 0:
        shape_ok = (shape_ok and idx is not None and rows is None and n == x.shape[0]
                    and n % TILE_ROWS == 0)
    if (x.shape[1] != WIDTH or axis not in (0, 1) or not shape_ok
            or max(n, x.shape[0]) >= (1 << 31) // WIDTH):
        raise ValueError(f"lane_gather takes x [rows, {WIDTH}] with idx [n, {WIDTH}] or shift "
                         f"[n] (and rows [n]) along axis 1, or idx shaped as x (rows a "
                         f"multiple of {TILE_ROWS}) along axis 0, got x {tuple(x.shape)}, "
                         f"idx {None if idx is None else tuple(idx.shape)}, shift "
                         f"{None if shift is None else tuple(shift.shape)}, rows "
                         f"{None if rows is None else tuple(rows.shape)}, axis {axis}")
    if _same_device(x, idx, shift, rows) == "cpu":
        return lane_gather_plain(x, idx, shift, rows, axis)
    out = torch.empty((n, WIDTH), dtype=x.dtype, device=x.device)
    err = _library().lib.wrt_lane_gather(x.data_ptr(), x.shape[0], _ptr(idx), _ptr(shift),
                                         _ptr(rows), n, axis, which, out.data_ptr(),
                                         _stream_handle(x.device))
    _raise_on(err, f"lane_gather ({route}, axis {axis})")
    lane_gather.launches += 1
    return out


def smem_rw(base: torch.Tensor, read_idx: torch.Tensor, read_width: int = 1, *,
            vals: torch.Tensor = None, write_idx: torch.Tensor = None,
            route: str = "smem") -> torch.Tensor:
    """Scratches written and read at run-time offsets: each row of ``base``
    [batch, words] (float32 or int32 words) takes the writes of ``vals``
    [n, width] at ``write_idx`` [n] int32 in order, then is read at
    ``read_idx`` [m] int32, ``read_width`` words from each offset, all
    offsets modulo words: out [batch, m, read_width]. An offset plus a
    width is an int32 sum, as the twin takes it. Route "shfl" (words one
    of SHFL_WORDS), "smem" (words * 4 <= MAX_SHARED_BYTES) or "direct" (at
    most MAX_DIRECT_WRITES writes, fewer than 2^31 output words)."""
    _check(base, "base", 2, _WORDS)
    _check(read_idx, "read indices", 1, (_I32,))
    which = _route(route, RW_ROUTES, "smem_rw")
    batch, words = base.shape
    n_reads = read_idx.shape[0]
    if (vals is None) != (write_idx is None):
        raise ValueError("smem_rw takes vals and write_idx together")
    n_writes, write_width, width_ok = 0, 1, True
    if vals is not None:
        _check(vals, "vals", 2, (base.dtype,))
        _check(write_idx, "write indices", 1, (_I32,))
        n_writes, write_width = vals.shape
        width_ok = n_writes == write_idx.shape[0] and write_width <= words
    if route == "shfl":
        fits = words in SHFL_WORDS
    elif route == "smem":
        fits = words * 4 <= MAX_SHARED_BYTES
    else:
        fits = n_writes <= MAX_DIRECT_WRITES and batch * n_reads * read_width < 1 << 31
    if (not width_ok or not fits or read_width <= 0 or batch >= 1 << 31
            or n_reads * read_width * batch >= 1 << 62):
        raise ValueError(f"smem_rw takes base [batch, words] (words in {SHFL_WORDS} for 'shfl',"
                         f" at most {MAX_SHARED_BYTES // 4} for 'smem'), vals [n, width <= "
                         f"words] with write_idx [n] (n <= {MAX_DIRECT_WRITES} and fewer than "
                         f"2^31 output words for 'direct'), read_idx [m] and read_width > 0, "
                         f"got base {tuple(base.shape)}, vals "
                         f"{None if vals is None else tuple(vals.shape)}, read_width "
                         f"{read_width}, route {route!r}")
    if _same_device(base, read_idx, vals, write_idx) == "cpu":
        return smem_rw_plain(base, read_idx, read_width, vals, write_idx)
    out = base.new_empty((batch, n_reads, read_width))
    err = _library().lib.wrt_smem_rw(base.data_ptr(), batch, words, _ptr(vals),
                                     _ptr(write_idx), n_writes, write_width,
                                     read_idx.data_ptr(), n_reads, read_width, which,
                                     out.data_ptr(), _stream_handle(base.device))
    if err:
        _raise_on(err, f"smem_rw ({route})")
    smem_rw.launches += 1
    return out


def _rows_of_128(x: torch.Tensor, what: str) -> None:
    _check(x, what, 2)
    if x.shape[1] != WIDTH or x.shape[0] >= (1 << 31) // WIDTH:
        raise ValueError(f"{what} takes x [rows, {WIDTH}], got {tuple(x.shape)}")


def row_sort(x: torch.Tensor) -> torch.Tensor:
    """Each row of ``x`` [rows, 128] float32 (16-byte aligned) through
    probe_place.py p3's bitonic network (ascending).

    A CUDA ``x`` must start on a 16-byte boundary, since the kernel moves a
    thread's 16 keys as four 16-byte words. This narrows the contract: the
    earlier kernel, one key a lane, took any float32 address. A view that
    starts inside a word raises ValueError; ``.clone()`` it first. The
    kernel keeps no scalar path for such views: every caller in the port
    passes a tensor of its own allocation, and a second load path would
    double the kernel's variants for none of them."""
    _rows_of_128(x, "row_sort")
    if _same_device(x) == "cpu":
        return row_sort_plain(x)
    out = torch.empty_like(x)
    if x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("row_sort moves 16 bytes at a time: x must be 16-byte aligned")
    err = _library().lib.wrt_row_sort(x.data_ptr(), x.shape[0], out.data_ptr(),
                                      _stream_handle(x.device))
    _raise_on(err, "row_sort")
    row_sort.launches += 1
    return out


def lane_scan(x: torch.Tensor) -> torch.Tensor:
    """The inclusive sum along each row of ``x`` [rows, 128] float32, in
    the order ``lane_scan_plain`` states."""
    _rows_of_128(x, "lane_scan")
    if _same_device(x) == "cpu":
        return lane_scan_plain(x)
    out = torch.empty_like(x)
    if x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("lane_scan moves 16 bytes at a time: x must be 16-byte aligned")
    err = _library().lib.wrt_lane_scan(x.data_ptr(), x.shape[0], out.data_ptr(),
                                       _stream_handle(x.device))
    _raise_on(err, "lane_scan")
    lane_scan.launches += 1
    return out


_WRAPPERS = (table_gather, lane_gather, smem_rw, row_sort, lane_scan)


def launch_counts() -> dict:
    """Launches of each kernel of KERNELS since the last zero_launch_counts."""
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


def zero_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0


zero_launch_counts()


__all__ = ["table_gather", "lane_gather", "smem_rw", "row_sort", "lane_scan",
           "table_gather_plain", "lane_gather_plain", "smem_rw_plain", "row_sort_plain",
           "lane_scan_plain", "launch_counts", "zero_launch_counts", "kernel_attributes"]
