"""benchmarks/probe_mosaic.py's lowering probes on the port's indexed-access
kernels: what each op costs on the card, in every route, and that it keeps
every bit.

Each probe is built from the TPU probe's own inputs (the same shapes,
indices and ``default_rng(0)`` draws) and runs through
``ops/cuda/access.py``:

    take_along_sublane       (32, 128) rows reversed, along axis 0       lane_gather
    take_along_lane          (8, 128) lanes reversed                     lane_gather
    take_along_lane_32       (32, 128) at seeded lanes                   lane_gather
    scalar_dynamic_read      tab[i, 0] of (32, 128) at i = 7             smem_rw
    dynamic_slice_sublane    the (8, 128) slice at row 8 i, i = 2        smem_rw
    cumsum_lanes             the lane cumsum of (32, 128) 0/1 values     lane_scan
    dynamic_store_leading    a (1, 128) row stored at [i, 2, :] of       smem_rw
                             (8, 4, 128), i = 5
    dynamic_read_leading_3d  the row [i, 2, :] of (8, 4, 128), i = 5     smem_rw
    gather_bit_preserving    a lane gather of random int32 patterns      lane_gather
                             viewed as float32 (NaN payloads,
                             denormals, -0.0)
    take_along_lane_1row     the lanes of one (1, 128) row               lane_gather

probe_mosaic.py:143 is probes/dma.py's ``manual_dma_gather_rows``; its two
XLA-level probes are probes/dma.py's yardsticks. Every route is held
against the probe's own expectation and the twin, bit for bit, and timed
as probes/place.py times it (device time under the profiler at the probe's
shape); each probe then runs at a card-filling shape, 2^24 values with its
pattern repeated: (FILL_ROWS, 128) for the lane gathers and the scan, 4096
scratches of the probe's 4096 words for the scratch reads and writes
("smem" and "direct", RW_PROBE_ROUTES: "shfl" holds at most 1024 words;
there also under the profiler and the host clock beside the library
call). The scan's fill also runs
seeded floats, held to the twin bit for bit and to torch.cumsum within
SCAN_ULPS units of the prefix's magnitude.

    python -m weekend_raytracer_tpu_torch.probes.mosaic [take_along_sublane ...]

One JSON line per probe. Runs on the CUDA device; ``device="cpu"`` runs the
twins (no timing means anything there).
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..ops.cuda import access as ac
from . import card
from .place import (DEVICE_REPS, FILL_ROWS, REPS, byte_bound, case_launches, dev, equal_to,
                    gather_library, lane_case, nbytes, routes_case, run as _run, rw_case)

_F32 = torch.float32
RW_PROBE_ROUTES = ("smem", "direct")  # smem_rw's routes that take 4096-word scratches
# torch.cumsum against the kernel: two sums of the same prefix of n <= 128
# terms in two orders each err by at most (n - 1) u sum |x| (u = 2^-24), so
# they differ by at most 2 * 127 u of the prefix's sum of magnitudes
SCAN_ULPS = 2 * 127


def _tiles(pattern: np.ndarray, rows: int) -> np.ndarray:
    """A probe's index block repeated down ``rows`` rows."""
    reps = -(-rows // pattern.shape[0])
    return np.tile(pattern, (reps, 1))[:rows]


def _lane_probe(x_np, idx_np, fill_x, device, reps, what, axis=1, view=None) -> dict:
    """A take_along_axis probe: at the probe's shape and at (rows, 128)
    with its index block repeated, every route against the probe's
    np.take_along_axis (axis 0 per (32, 128) tile) and the twin."""
    out = {}
    for label, x_host, idx_host, dreps in (
            ("probe_shape", x_np, idx_np, DEVICE_REPS),
            ("fill", fill_x, _tiles(idx_np, fill_x.shape[0]), 0)):
        x = dev(x_host, device) if view is None else dev(x_host, device).view(view)
        idx = dev(idx_host, device)
        if axis == 0:
            t = x_host.reshape(-1, 32, ac.WIDTH)
            want = np.take_along_axis(t, idx_host.reshape(t.shape), 1).reshape(x_host.shape)
            rows_abs = (np.arange(x_host.shape[0]) // 32 * 32)[:, None] + idx_host
            library = gather_library(x, dev(rows_abs.astype(np.int32), device), axis=0)
        else:
            want = np.take_along_axis(x_host, idx_host, 1)
            library = gather_library(x, idx)
        expect = equal_to(want if view is None else want.view(np.float32))
        out[label] = lane_case(x, expect, device, reps, dreps, (what, label), idx=idx,
                                axis=axis, library=library if label == "fill" else None)
    return out


def _arange_np(rows: int) -> np.ndarray:
    return np.arange(rows * ac.WIDTH, dtype=np.float32).reshape(rows, ac.WIDTH)


def take_along_sublane(device="cuda", fill_rows: int = FILL_ROWS, reps: int = REPS) -> dict:
    """(32, 128) arange gathered along axis 0 by reversed rows (:26-41)."""
    idx = np.broadcast_to(np.arange(32, dtype=np.int32)[::-1, None], (32, 128))
    out = _lane_probe(_arange_np(32), idx, _arange_np(fill_rows), device, reps,
                      "take_along_sublane", axis=0)
    return {**out, "message": "sublane gather works"}


def take_along_lane(device="cuda", fill_rows: int = FILL_ROWS, reps: int = REPS) -> dict:
    """(8, 128) arange gathered along the lanes by reversed lanes (:44-57)."""
    idx = np.broadcast_to(np.arange(128, dtype=np.int32)[::-1][None, :], (8, 128))
    out = _lane_probe(_arange_np(8), idx, _arange_np(fill_rows), device, reps,
                      "take_along_lane")
    return {**out, "message": "lane gather works"}


def seeded_lanes(rows: int) -> np.ndarray:
    """rng(0)'s (rows, 128) lane indices, as :64 and :301 draw them."""
    return np.random.default_rng(0).integers(0, 128, size=(rows, 128), dtype=np.int32)


def take_along_lane_32(device="cuda", fill_rows: int = FILL_ROWS, reps: int = REPS) -> dict:
    """(32, 128) arange gathered along the lanes at seeded lanes (:60-74)."""
    out = _lane_probe(_arange_np(32), seeded_lanes(32), _arange_np(fill_rows), device, reps,
                      "take_along_lane_32")
    return {**out, "message": "lane gather (32,128) works"}


def _scratch_fill(host: np.ndarray, rows: int) -> np.ndarray:
    """``rows`` * 128 words as scratches of the probe's own (its words
    repeated, offset so that no two scratches hold the same values)."""
    batch = max(rows * ac.WIDTH // host.size, 1)
    return host.reshape(1, -1) + np.arange(batch, dtype=np.float32)[:, None] * 0.5


def _rw_probe(base_np, read_at, read_width, fill_rows, device, reps, what, vals=None,
              write_at=None) -> dict:
    """A scratch probe at the probe's shape (one scratch) and at the fill
    (its pattern repeated over 4096 scratches), in RW_PROBE_ROUTES: the
    scratches hold 4096 words. Both under the profiler; the fill's calls
    rotate over copies of its scratches (``place.rw_case``). ``read_at`` and
    ``write_at`` make the offsets on the device from the probe's index
    array."""
    out = {}
    for label, host in (("probe_shape", base_np.reshape(1, -1)),
                        ("fill", _scratch_fill(base_np, fill_rows))):
        base = dev(host, device)
        i = dev(np.asarray([_INDEX[what]], np.int32), device)
        read_idx = read_at(i)
        write_idx = None if write_at is None else write_at(i)
        v = None if vals is None else dev(vals, device)
        scratch = host.copy()
        if vals is not None:
            at = int(write_at(torch.as_tensor([_INDEX[what]]))[0])
            scratch[:, at:at + vals.shape[1]] = vals[0]
        r0 = int(read_at(torch.as_tensor([_INDEX[what]]))[0])
        want = scratch[:, None, r0:r0 + read_width]
        library = None
        if label == "fill":
            cols = (r0 + torch.arange(read_width, device=device)).long()
            if vals is None:
                library = (lambda b, cols=cols: b.index_select(1, cols))
            else:
                wcols = (at + torch.arange(vals.shape[1], device=device)).long()
                src = v.expand(base.shape[0], -1)

                def library(b, wcols=wcols, src=src, cols=cols):
                    return b.clone().index_copy_(1, wcols, src).index_select(1, cols)
        out[label] = rw_case(base, read_idx, equal_to(want), device, reps, DEVICE_REPS,
                             (what, label), read_width=read_width, vals=v,
                             write_idx=write_idx, routes=RW_PROBE_ROUTES, library=library)
    return out


# the probes' traced scalar i (probe_mosaic.py :95, :115, :243, :263)
_INDEX = {"scalar_dynamic_read": 7, "dynamic_slice_sublane": 2, "dynamic_store_leading": 5,
          "dynamic_read_leading_3d": 5}


def scalar_dynamic_read(device="cuda", fill_rows: int = FILL_ROWS, reps: int = REPS) -> dict:
    """tab[i, 0] of (32, 128) arange at i = 7 (:77-97): 896.0."""
    out = _rw_probe(_arange_np(32), lambda i: i * ac.WIDTH, 1, fill_rows, device, reps,
                    "scalar_dynamic_read")
    return {**out, "message": "scalar dynamic VMEM read works"}


def dynamic_slice_sublane(device="cuda", fill_rows: int = FILL_ROWS, reps: int = REPS) -> dict:
    """The (8, 128) slice of (32, 128) arange at row 8 i, i = 2 (:100-118):
    one read of 1024 words."""
    out = _rw_probe(_arange_np(32), lambda i: i * 8 * ac.WIDTH, 8 * ac.WIDTH, fill_rows,
                    device, reps, "dynamic_slice_sublane")
    return {**out, "message": "dynamic sublane slice works"}


def dynamic_store_leading(device="cuda", fill_rows: int = FILL_ROWS, reps: int = REPS) -> dict:
    """arange(128) stored at [i, 2, :] of an (8, 4, 128) scratch, i = 5
    (:225-245), the whole scratch read back. The probe's output holds
    nothing else it writes; the port's scratch starts at zero."""
    out = _rw_probe(np.zeros((8, 4, 128), np.float32), lambda i: i * 0, 4 * 8 * ac.WIDTH,
                    fill_rows, device, reps, "dynamic_store_leading",
                    vals=np.arange(128, dtype=np.float32).reshape(1, 128),
                    write_at=lambda i: (i * 4 + 2) * ac.WIDTH)
    return {**out, "message": "dynamic leading-dim VMEM store works"}


def dynamic_read_leading_3d(device="cuda", fill_rows: int = FILL_ROWS,
                            reps: int = REPS) -> dict:
    """The row [i, 2, :] of (8, 4, 128) arange, i = 5 (:248-265)."""
    out = _rw_probe(_arange_np(32).reshape(8, 4, 128), lambda i: (i * 4 + 2) * ac.WIDTH,
                    ac.WIDTH, fill_rows, device, reps, "dynamic_read_leading_3d")
    return {**out, "message": "dynamic leading-dim 3D VMEM read works"}


def scan_case(x, expect, device, reps, device_reps, what) -> dict:
    bound = byte_bound(2 * nbytes(x))
    return routes_case({"shfl": lambda: ac.lane_scan(x)}, lambda: ac.lane_scan_plain(x), expect,
                       bound, device, reps, lambda: torch.cumsum(x, 1), what, device_reps)


def within_cumsum(x: torch.Tensor):
    """The scan within SCAN_ULPS units of each prefix's sum of magnitudes of
    torch.cumsum (in float64 on the host, the tolerance's reference)."""
    ref = torch.cumsum(x.double().cpu(), 1)
    mag = torch.cumsum(x.double().abs().cpu(), 1)
    return lambda got: bool(((got.double() - ref).abs() <= SCAN_ULPS * 2.0 ** -24 * mag).all())


def cumsum_lanes(device="cuda", fill_rows: int = FILL_ROWS, reps: int = REPS) -> dict:
    """The lane cumsum of rng(0)'s (32, 128) 0/1 values (:206-221):
    np.cumsum's bits. Fill: (rows, 128) 0/1 values (np.cumsum's bits) and
    seeded normal floats (the twin's bits; torch.cumsum within SCAN_ULPS)."""
    rng = np.random.default_rng(0)
    x = (rng.random((32, 128)) < 0.5).astype(np.float32)
    probe = scan_case(dev(x, device), equal_to(np.cumsum(x, axis=1)), device, reps, DEVICE_REPS,
                      "cumsum_lanes")
    bits = (rng.random((fill_rows, 128)) < 0.5).astype(np.float32)
    fill = scan_case(dev(bits, device), equal_to(np.cumsum(bits, axis=1)), device, reps, 0,
                     "cumsum_lanes fill")
    floats = dev(rng.standard_normal((fill_rows, 128)).astype(np.float32), device)
    seeded = scan_case(floats, within_cumsum(floats), device, reps, 0, "cumsum_lanes floats")
    return {"probe_shape": probe, "fill": fill, "fill_floats": seeded,
            "message": "lane cumsum works"}


def bit_patterns(rows: int, rng) -> np.ndarray:
    """rng's (rows, 128) int32 bit patterns, as :282-284 draw them."""
    return rng.integers(-(1 << 31), 1 << 31, size=(rows, 128), dtype=np.int64).astype(np.int32)


# float32 words a random draw rarely holds: -0.0, a quiet NaN with a
# payload, a signalling NaN, the smallest denormal and -inf
SPECIAL_WORDS = np.asarray([0x80000000, 0x7FC00001, 0x7F800001, 0x00000001, 0xFF800000],
                           np.uint32).view(np.int32)


def gather_bit_preserving(device="cuda", fill_rows: int = FILL_ROWS, reps: int = REPS) -> dict:
    """A lane gather of rng(0)'s (8, 128) int32 patterns viewed as float32
    at rng(0)'s next (8, 128) lanes (:268-288), compared as int32. Fill:
    seeded patterns led by SPECIAL_WORDS, the probe's lanes repeated."""
    rng = np.random.default_rng(0)
    tab = bit_patterns(8, rng)
    idx = rng.integers(0, 128, size=(8, 128), dtype=np.int32)
    fill = bit_patterns(fill_rows, np.random.default_rng(1))
    fill[:, :SPECIAL_WORDS.size] = SPECIAL_WORDS  # every row leads with them
    out = _lane_probe(tab, idx, fill, device, reps, "gather_bit_preserving", view=_F32)
    return {**out, "message": "f32 lane gather preserves raw bit patterns"}


def take_along_lane_1row(device="cuda", fill_rows: int = FILL_ROWS, reps: int = REPS) -> dict:
    """Row 0 of (8, 128) arange gathered at row 0 of rng(0)'s lanes
    (:291-309). Fill: that row's lanes for every row."""
    out = _lane_probe(_arange_np(1), seeded_lanes(8)[:1], _arange_np(fill_rows), device, reps,
                      "take_along_lane_1row")
    return {**out, "message": "(1,128) lane gather works"}


PROBES = [
    ("take_along_sublane", take_along_sublane),
    ("take_along_lane", take_along_lane),
    ("take_along_lane_32", take_along_lane_32),
    ("scalar_dynamic_read", scalar_dynamic_read),
    ("dynamic_slice_sublane", dynamic_slice_sublane),
    ("cumsum_lanes", cumsum_lanes),
    ("dynamic_store_leading", dynamic_store_leading),
    ("dynamic_read_leading_3d", dynamic_read_leading_3d),
    ("gather_bit_preserving", gather_bit_preserving),
    ("take_along_lane_1row", take_along_lane_1row),
]
ROWS = {"take_along_sublane": "10a", "take_along_lane": "10b", "take_along_lane_32": "10c",
        "scalar_dynamic_read": "10d", "dynamic_slice_sublane": "10e", "cumsum_lanes": "10g",
        "dynamic_store_leading": "10h", "dynamic_read_leading_3d": "10i",
        "gather_bit_preserving": "10j", "take_along_lane_1row": "10k"}


def launches(name: str, reps: int = REPS, device_reps: int = DEVICE_REPS) -> dict:
    """The launches of each kernel that probe ``name`` makes (``device_reps``
    a probe-shape kernel under the profiler)."""
    out = dict.fromkeys(ac.KERNELS, 0)
    if name == "cumsum_lanes":  # the probe's shape, 0/1 and float fills
        out["lane_scan"] = case_launches(1, reps, device_reps) + 2 * case_launches(1, reps)
    elif name in _INDEX:  # RW_PROBE_ROUTES at the probe's shape and the fill
        out["smem_rw"] = 2 * case_launches(len(RW_PROBE_ROUTES), reps, device_reps, host=True)
    else:
        lanes = len(ac.LANE_ROUTES)
        out["lane_gather"] = case_launches(lanes, reps, device_reps) + case_launches(lanes, reps)
    return out


def run(name, fn, device="cuda", **kw) -> bool:
    """One probe, printed as one JSON line; True if it held."""
    return _run(name, fn, device, rows=ROWS, **kw)


def main(argv=None) -> int:
    only = (sys.argv[1:] if argv is None else argv) or None
    if not torch.cuda.is_available():
        print("probes.mosaic: no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps({"card": card()}), flush=True)
    ok = [run(name, fn) for name, fn in PROBES if not only or name in only]
    return 0 if all(ok) else 1


if __name__ == "__main__":
    raise SystemExit(main())
