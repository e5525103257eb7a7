"""benchmarks/probe_place.py's probes on the port's indexed-access kernels:
what a per-lane dynamic index costs on the card.

Each probe is built from the TPU probe's own inputs and runs through
``ops/cuda/access.py``:

    p1   x[r, j] of an (8, 128) table at (r, j) = (5, 37), both read      lane_gather
         from a device array: a row picked at run time, every lane of
         it reading lane j
    p2   four int32 written to a 128-word scratch at [7, 93, 12, 64],      smem_rw
         read back at the indices rotated by one: [101, 102, 103, 100]
    p3   the per-row bitonic sort of an (8, 128) table of seeded          row_sort
         integers, against np.sort; then edge keys (NaN payloads,
         both zeros, infinities, denormals, runs) against the twin
    p4   each row of (8, 128) rotated by its own shift (row r by r)       lane_gather

Every route of each kernel ("shfl", "smem", "local" for lane_gather;
"shfl", "smem" for smem_rw) is held against the probe's own expectation
and the kernel's twin, bit for bit, then timed (CUDA events over REPS
calls) beside its bound (the least time the card could take: bytes over
HBM_RATE, or operations over FP32_PEAK) and one library call that computes
the same function. At the probe's shape the kernels' device time comes
from the profiler (``probes.device_times``) beside the event time, which
also counts each call's host side. Each probe then runs at a card-filling
shape, 2^24 values as (FILL_ROWS, 128) with the probe's pattern repeated
per row; p2's fill reads 16,384 scratches of 1024 words at a rotation
(each warp's reads on 32 banks) and at stride 32 (all on one bank).

    python -m weekend_raytracer_tpu_torch.probes.place [p1 p2 p3 p4]

One JSON line per probe. Runs on the CUDA device; ``device="cpu"`` runs the
twins (no timing means anything there).
"""
from __future__ import annotations

import itertools
import json
import sys

import numpy as np
import torch

from ..ops.cuda import access as ac
from . import (FP32_PEAK, HBM_RATE, card, check, device_times, host_ms, same_bits, sync,
               time_call, time_mean)

_F32 = torch.float32
_I32 = torch.int32
REPS = 20  # calls a timing averages
DEVICE_REPS = 10  # calls of each probe-shape kernel under the profiler
FILL_ROWS = 131072  # 2^24 values as (FILL_ROWS, 128)
EDGE_ROWS = 4096  # p3's edge keys (edge_keys)
# compare-exchanges of the bitonic network over 128 keys: 7 * 8 / 2 stages,
# each a min or a max for every key
SORT_OPS_PER_KEY = 28
RW_FILL_WORDS = 1024  # p2's fill: scratches of 1024 words (the largest "shfl" holds)
# a scratch case's calls rotate over copies of its base until a round of
# them moves ROTATE_BYTES, twice an H100's 50 MB L2, within ROTATE_COPIES
# copies and ROTATE_LIMIT bytes of them (``rotation``)
ROTATE_BYTES = 2 * 50 * 2**20
ROTATE_COPIES = 32
ROTATE_LIMIT = 2 * 2**30


def dev(x, device, dtype=None) -> torch.Tensor:
    """A numpy array on ``device`` (its own dtype unless one is given)."""
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)


def byte_bound(nbytes: float, ops: float = 0.0) -> dict:
    """The least time the card could take: ``nbytes`` over HBM_RATE or
    ``ops`` over FP32_PEAK, whichever is larger."""
    byte_ms, ops_ms = nbytes / HBM_RATE * 1e3, ops / FP32_PEAK * 1e3
    return {"bound_ms": max(byte_ms, ops_ms),
            "bound_by": "operations" if ops_ms > byte_ms else "bytes"}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def hold(kernel, plain, expect, what="", device="cuda") -> float:
    """One kernel and route: its result equal to its twin's in every bit
    and passing ``expect`` (the probe's own expectation, on a host copy).
    Returns the twin's milliseconds. Makes one launch."""
    got = kernel()
    want, plain_ms = time_call(plain, device)
    sync(device)
    check(same_bits(got, want), (what, "kernel against its twin"))
    check(expect(got.cpu()), (what, "the probe's expectation"))
    return plain_ms


def in_turns(fns: dict, reps: int, device) -> dict:
    """Each function's mean milliseconds over ``reps`` calls, timed in order
    and then in reverse, the smaller of the two (a stall of the host
    between launches shows in a CUDA-event window of short kernels). Makes
    2 (reps + 1) calls of each."""
    order = list(fns)
    times = {k: [] for k in order}
    for k in order + order[::-1]:
        times[k].append(time_mean(fns[k], reps, device))
    return {k: min(v) for k, v in times.items()}


def routes_case(kernels: dict, plain, expect, bound: dict, device, reps: int, library=None,
                what="", device_reps: int = 0, host: bool = False) -> dict:
    """``hold`` for each route of ``kernels`` ({route: fn}), each timed in
    turns beside its bound, the twin and ``library``; then, with
    ``device_reps``, the device time of each (and of ``library``, which may
    launch several kernels) under the profiler (at the probe's shape a
    call's host side is most of its event time); with ``host``, the host
    time of a call of each (``probes.host_ms``). A route's ``library_*``
    numbers are the library call's (its device time only where its trace
    kept every event)."""
    plain_ms = {route: hold(fn, plain, expect, (what, route), device)
                for route, fn in kernels.items()}
    timed = dict(kernels, **({"library": library} if library is not None else {}))
    ms = in_turns(timed, reps, device)
    out = {route: {"ms": ms[route], "plain_ms": plain_ms[route], "library_ms": ms.get("library"),
                   "share": bound["bound_ms"] / ms[route] if ms[route] else None,
                   "max_abs_err": 0.0, **bound} for route in kernels}
    lib = {}
    if host:
        for label, fn in timed.items():
            (lib if label == "library" else out[label])["host_ms"] = host_ms(fn, reps, device)
    if device_reps:
        for label, dev_ms in (device_times(timed, device_reps, device, several=("library",))
                              or {}).items():
            if label != "library":
                out[label].update(dev_ms)
            elif dev_ms["device_ms_by"] == "profiler":
                lib["device_ms"] = dev_ms["device_ms"]
    for route in kernels:
        out[route].update({f"library_{k}": v for k, v in lib.items()})
    return out


def case_launches(routes: int, reps: int, device_reps: int = 0, host: bool = False) -> int:
    """Launches ``routes_case`` makes: a check, two timings, the profiler's
    calls and, with ``host``, a host timing a route."""
    return routes * (1 + 2 * (reps + 1) + device_reps + (reps + 1 if host else 0))


def equal_to(expect: np.ndarray):
    """The probe's expectation as a check: the same shape and bits."""
    return lambda got: same_bits(got, torch.from_numpy(np.ascontiguousarray(expect)))


def lane_routes(x, idx=None, shift=None, rows=None, axis=1) -> dict:
    return {route: (lambda route=route: ac.lane_gather(x, idx, shift=shift, rows=rows,
                                                       axis=axis, route=route))
            for route in ac.LANE_ROUTES}


def arange_table(rows: int, device) -> torch.Tensor:
    """The probes' table: arange(rows * 128) as float32 (exact below 2^24)."""
    return torch.arange(rows * ac.WIDTH, dtype=_F32, device=device).reshape(rows, ac.WIDTH)


def lane_sources(x, idx=None, shift=None, rows=None, axis=1) -> torch.Tensor:
    """The flat word of x that each output of ``lane_gather`` reads."""
    n = (idx if idx is not None else shift).shape[0]
    lane = torch.arange(ac.WIDTH, device=x.device)
    if axis == 0:
        tile = torch.arange(n, device=x.device) // ac.TILE_ROWS * ac.TILE_ROWS
        return (tile[:, None] + (idx & (ac.TILE_ROWS - 1)).long()) * ac.WIDTH + lane
    sr = (torch.arange(n, device=x.device) if rows is None
          else torch.remainder(rows, x.shape[0]).long())
    j = (idx & (ac.WIDTH - 1)) if idx is not None else (lane[None, :] - shift[:, None]) & 127
    return sr[:, None] * ac.WIDTH + j.long()


def lane_case(x, expect, device, reps, device_reps, what, idx=None, shift=None, rows=None,
              axis=1, library=None) -> dict:
    """Every route of lane_gather on one input, its bound the distinct
    words of x it reads, its indices and its output."""
    n = (idx if idx is not None else shift).shape[0]
    words = torch.unique(lane_sources(x, idx, shift, rows, axis)).numel()
    bound = byte_bound(words * 4 + nbytes(idx, shift, rows) + n * ac.WIDTH * 4)
    return routes_case(lane_routes(x, idx, shift, rows, axis),
                       lambda: ac.lane_gather_plain(x, idx, shift, rows, axis), expect, bound,
                       device, reps, library, what, device_reps)


def gather_library(x, idx, axis=1):
    """torch.gather at the same addresses (idx as int64, made once)."""
    j = idx.long()
    return lambda: torch.gather(x, axis, j)


# --- the probes ----------------------------------------------------------

def p1(device="cuda", fill_rows: int = FILL_ROWS, reps: int = REPS) -> dict:
    """x[r, j] of arange (8, 128) at the device array i = [37, 5] (:46-62):
    lane_gather of row i[1] (``rows``) with every lane at lane i[0]; every
    lane of the result is 5 * 128 + 37. Fill: every row's lane 37,
    broadcast along its row."""
    x = arange_table(8, device)
    i = dev(np.asarray([37, 5], np.int32), device)
    idx = i[0:1].repeat(ac.WIDTH).reshape(1, ac.WIDTH)  # on the device
    rows = i[1:2].contiguous()
    want = np.full((1, ac.WIDTH), 5 * 128 + 37, np.float32)
    probe = lane_case(x, equal_to(want), device, reps, DEVICE_REPS, "p1", idx=idx, rows=rows)
    xf = arange_table(fill_rows, device)
    idx_f = torch.full((fill_rows, ac.WIDTH), 37, dtype=_I32, device=device)
    want_f = np.repeat(xf.cpu().numpy()[:, 37:38], ac.WIDTH, axis=1)
    fill = lane_case(xf, equal_to(want_f), device, reps, 0, "p1 fill", idx=idx_f,
                      library=gather_library(xf, idx_f))
    return {"probe_shape": probe, "fill": fill,
            "message": f"x[5, 37] = {5 * 128 + 37}.0 on every lane and route"}


def rotating(fn, bases: list):
    """A call of ``fn`` on each of ``bases`` in turn, one base a call."""
    turn = itertools.cycle(bases)
    return lambda: fn(next(turn))


def rotation(base_bytes: int, call_bytes: int) -> int:
    """Copies of a base a case's calls rotate over: as many as make the
    bytes of one round (``call_bytes`` each) reach ROTATE_BYTES, so that a
    call finds its base's words in HBM and not in the L2; 1 where that would
    take more than ROTATE_COPIES copies or ROTATE_LIMIT bytes of them (the
    case then reads a warm L2)."""
    copies = -(-ROTATE_BYTES // max(call_bytes, 1))
    return copies if copies <= ROTATE_COPIES and copies * base_bytes <= ROTATE_LIMIT else 1


def base_words_read(words: int, read_idx, read_width: int, write_idx=None,
                    write_width: int = 0) -> int:
    """The words of one scratch's base that smem_rw's reads return: the
    distinct offsets read that no write covers."""
    def offsets(at, width):
        return {(int(a) + w) % words for a in at.tolist() for w in range(width)}

    written = offsets(write_idx, write_width) if write_idx is not None else set()
    return len(offsets(read_idx, read_width) - written)


def rw_case(base, read_idx, expect, device, reps, device_reps, what, read_width=1, vals=None,
            write_idx=None, routes=ac.RW_ROUTES, library=None) -> dict:
    """Every route of smem_rw on one input, its bound the base words its
    reads return (each scratch), the writes, the indices and the output;
    each route and ``library`` (a function of the base) with its host time
    a call. The calls rotate over ``rotation``'s copies of the base (each
    case's ``copies``); ``warm_l2`` marks a case whose round of calls fits
    in ROTATE_BYTES, whose words the L2 can serve faster than the HBM rate
    its bound assumes."""
    batch, words = base.shape
    needed = base_words_read(words, read_idx, read_width, write_idx,
                             0 if vals is None else vals.shape[1])
    out_bytes = batch * read_idx.shape[0] * read_width * 4
    call_bytes = batch * needed * 4 + nbytes(read_idx, vals, write_idx) + out_bytes
    copies = rotation(nbytes(base), call_bytes)
    bases = [base] + [base.clone() for _ in range(copies - 1)]
    bound = dict(byte_bound(call_bytes), copies=copies,
                 warm_l2=copies * call_bytes < ROTATE_BYTES)
    kernels = {route: rotating(lambda b, route=route: ac.smem_rw(
        b, read_idx, read_width, vals=vals, write_idx=write_idx, route=route), bases)
        for route in routes}
    return routes_case(kernels,
                       lambda: ac.smem_rw_plain(base, read_idx, read_width, vals, write_idx),
                       expect, bound, device, reps,
                       None if library is None else rotating(library, bases), what,
                       device_reps, host=True)


def rw_fill_patterns(words: int = RW_FILL_WORDS) -> dict:
    """Read orders of a scratch of ``words`` words (32 w): "rotate", m ->
    (m + 37) mod words (a warp's 32 consecutive reads on 32 banks), and
    "stride32", m -> 32 (m mod 32) + m // 32 (a warp's 32 reads 32 words
    apart, all on one bank)."""
    m = np.arange(words)
    return {"rotate": ((m + 37) % words).astype(np.int32),
            "stride32": ((m % 32) * (words // 32) + m // 32).astype(np.int32)}


def p2(device="cuda", fill_rows: int = FILL_ROWS, reps: int = REPS) -> dict:
    """Four int32 (100 + k) written to a 128-word scratch at the device
    indices [7, 93, 12, 64], read back at the indices rotated by one
    (:64-83): [101, 102, 103, 100]. Fill: 2^24 words as scratches of 1024,
    each read whole at a rotation and at stride 32, every route also under
    the profiler beside index_select."""
    idx = dev(np.asarray([7, 93, 12, 64], np.int32), device)
    base = torch.zeros((1, 128), dtype=_I32, device=device)
    vals = torch.arange(100, 104, dtype=_I32, device=device).reshape(4, 1)
    read_idx = idx[[1, 2, 3, 0]]  # on the device
    want = np.asarray([101, 102, 103, 100], np.int32).reshape(1, 4, 1)
    probe = rw_case(base, read_idx, equal_to(want), device, reps, DEVICE_REPS, "p2",
                    vals=vals, write_idx=idx)
    batch = max(fill_rows * ac.WIDTH // RW_FILL_WORDS, 1)
    fb = torch.arange(batch * RW_FILL_WORDS, dtype=_I32, device=device).reshape(batch, -1)
    host = fb.cpu().numpy()
    fill = {}
    for name, pattern in rw_fill_patterns().items():
        at = dev(pattern, device)
        at_long = at.long()
        fill[name] = rw_case(fb, at, equal_to(host[:, pattern, None]), device, reps,
                             DEVICE_REPS, f"p2 fill {name}", library=lambda b, at_long=at_long:
                             b.index_select(1, at_long))
    return {"probe_shape": probe, "fill": fill, "host_parts": host_parts(device),
            "message": "read back [101, 102, 103, 100]"}


def host_parts(device, reps: int = 200):
    """A smem_rw call's host side by piece, each timed alone
    (``probes.host_ms``): its output's ``torch.empty``; the stream handle as
    the wrapper reads it ("stream_raw") and as a ``torch.cuda.current_stream``
    object ("stream_object"); the kept library (``_library``) and a
    ``load_library`` walk ("load_library"), which a call made before the
    library was kept; a ctypes call of ``wrt_smem_rw`` that the library
    refuses before any launch (batch 0: the arguments' conversion and the C
    call). Beside a whole call's ``host_ms`` (a route's, in each case), the
    pieces leave the wrapper's Python checks. Launches nothing; None off
    the card."""
    if torch.device(device).type != "cuda":
        return None
    from ..ops.cuda.build import load_library

    base = torch.zeros((4096, 4096), dtype=_F32, device=device)
    idx = torch.zeros(1, dtype=_I32, device=device)
    lib = ac._library().lib
    pieces = {
        "empty": lambda: torch.empty((4096, 1, 1), dtype=_F32, device=base.device),
        "stream_raw": lambda: ac._stream_handle(base.device),
        "stream_object": lambda: torch.cuda.current_stream(base.device).cuda_stream,
        "library": ac._library,
        "load_library": lambda: load_library(*ac.LIBRARY),
        "ctypes_refused": lambda: lib.wrt_smem_rw(base.data_ptr(), 0, 4096, None, None, 0, 1,
                                                  idx.data_ptr(), 1, 1, 2, base.data_ptr(),
                                                  None),
    }
    return {k: host_ms(fn, reps, device) for k, fn in pieces.items()}


def sort_case(x, expect, device, reps, device_reps, what) -> dict:
    bound = byte_bound(2 * nbytes(x), SORT_OPS_PER_KEY * x.numel())
    return routes_case({"shfl": lambda: ac.row_sort(x)}, lambda: ac.row_sort_plain(x), expect,
                       bound, device, reps, lambda: torch.sort(x, 1).values, what, device_reps)


def sorted_in_value(x: np.ndarray):
    """np.sort's result in value: -0.0 and +0.0 compare equal, so the two
    zeros keep their places in the kernel and the twin."""
    want = np.sort(x, axis=1)
    return lambda got: got.shape == want.shape and bool((got.numpy() == want).all())


def fill_keys(rows: int, seed: int = 0) -> np.ndarray:
    """Seeded finite float32 keys [rows, 128], about one in seven +0.0 and
    one in eleven -0.0."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, ac.WIDTH)).astype(np.float32)
    flat = x.reshape(-1)
    flat[::7] = 0.0
    flat[3::11] = -0.0
    return x


def edge_keys(rows: int = EDGE_ROWS, seed: int = 0) -> np.ndarray:
    """Seeded keys [rows, 128] that test the compare form: NaNs of several
    payloads and both signs, both zeros, both infinities, denormals of both
    signs, long runs of one repeated value, and normal keys; a quarter of
    the rows are one repeated key with its zeros flipped in sign, so a
    stage that swapped equal keys would move a bit."""
    rng = np.random.default_rng(seed)
    special = np.array([0x7FC00000, 0x7FC00001, 0x7FA00000, 0x7F800001, 0xFFC00000,
                        0xFFFFFFFF, 0x00000000, 0x80000000, 0x7F800000, 0xFF800000,
                        0x00000001, 0x807FFFFF, 0x00400000, 0x80000010], np.uint32)
    bits = rng.standard_normal((rows, ac.WIDTH)).astype(np.float32).view(np.uint32)
    pick = rng.random((rows, ac.WIDTH)) < 0.4
    bits[pick] = rng.choice(special, size=int(pick.sum()))
    for r in range(0, rows, 3):  # a run of one value, 8 to 64 keys long
        n = int(rng.integers(8, 65))
        at = int(rng.integers(0, ac.WIDTH - n + 1))
        bits[r, at:at + n] = bits[r, at]
    flat = bits[::4]
    flat[:] = np.float32(1.5).view(np.uint32)
    flat[:, ::5] = 0x00000000
    flat[:, 2::5] = 0x80000000
    return bits.view(np.float32)


def same_keys_per_row(x: np.ndarray):
    """The check that each row of the output is a permutation of its input's
    32-bit patterns."""
    want = np.sort(x.view(np.uint32), axis=1)
    return lambda got: bool((np.sort(got.numpy().view(np.uint32), axis=1) == want).all())


def p3(device="cuda", fill_rows: int = FILL_ROWS, reps: int = REPS) -> dict:
    """The bitonic network of :85-115 on rng(0)'s (8, 128) integers: every
    row sorted, np.sort's bits. Fill: seeded finite keys with both zeros,
    sorted in value as np.sort sorts them. Edge keys (``edge_keys``): held
    to the twin in every bit once, each row a permutation of its input."""
    x = np.random.default_rng(0).integers(0, 128, size=(8, 128)).astype(np.float32)
    probe = sort_case(dev(x, device), equal_to(np.sort(x, axis=1)), device, reps, DEVICE_REPS,
                      "p3")
    keys = fill_keys(fill_rows)
    fill = sort_case(dev(keys, device), sorted_in_value(keys), device, reps, 0, "p3 fill")
    edge = edge_keys()
    xe = dev(edge, device)
    hold(lambda: ac.row_sort(xe), lambda: ac.row_sort_plain(xe), same_keys_per_row(edge),
         "p3 edge keys", device)
    return {"probe_shape": probe, "fill": fill, "edge_rows": edge.shape[0],
            "message": "rows sorted; edge keys as the twin, each row a permutation"}


def rotations(x: np.ndarray, shift: np.ndarray) -> np.ndarray:
    """Row r of x rolled by shift[r], as np.roll rolls it."""
    lane = np.arange(x.shape[1])
    return np.take_along_axis(x, (lane[None, :] - shift[:, None]) % x.shape[1], 1)


def p4(device="cuda", fill_rows: int = FILL_ROWS, reps: int = REPS) -> dict:
    """Each row of arange (8, 128) rotated by its shift, the first lane of
    the probe's (8, 128) float shifts (:117-140): np.roll of row r by r.
    Fill: the eight shifts repeated down 2^24 values."""
    x = arange_table(8, device)
    sh = np.arange(8, dtype=np.float32)[:, None] * np.ones((1, 128), np.float32)
    shift = dev(sh, device)[:, 0].to(_I32)  # the probe's s_ref[:, :1].astype(int32)
    want = rotations(x.cpu().numpy(), np.arange(8))
    probe = lane_case(x, equal_to(want), device, reps, DEVICE_REPS, "p4", shift=shift)
    xf = arange_table(fill_rows, device)
    sf = torch.arange(fill_rows, dtype=_I32, device=device) % 8
    lane = torch.arange(ac.WIDTH, dtype=_I32, device=device)
    idx_f = (lane[None, :] - sf[:, None]) & (ac.WIDTH - 1)
    fill = lane_case(xf, equal_to(rotations(xf.cpu().numpy(), np.arange(fill_rows) % 8)),
                      device, reps, 0, "p4 fill", shift=sf, library=gather_library(xf, idx_f))
    return {"probe_shape": probe, "fill": fill, "message": "rotated"}


PROBES = [("p1", p1), ("p2", p2), ("p3", p3), ("p4", p4)]
ROWS = {"p1": "11a", "p2": "11b", "p3": "11c", "p4": "11d"}


def launches(name: str, reps: int = REPS, device_reps: int = DEVICE_REPS) -> dict:
    """The launches of each kernel that probe ``name`` makes (``device_reps``
    a probe-shape kernel under the profiler)."""
    out = dict.fromkeys(ac.KERNELS, 0)
    lanes = len(ac.LANE_ROUTES)
    if name in ("p1", "p4"):  # the probe's shape, the fill
        out["lane_gather"] = case_launches(lanes, reps, device_reps) + case_launches(lanes, reps)
    elif name == "p2":  # the probe's shape, two fill patterns, each with the profiler
        out["smem_rw"] = 3 * case_launches(len(ac.RW_ROUTES), reps, device_reps, host=True)
    elif name == "p3":
        out["row_sort"] = case_launches(1, reps, device_reps) + case_launches(1, reps) + 1
    return out


def public(out) -> dict:
    """A probe's result as JSON numbers."""
    return json.loads(json.dumps(out, default=float))


def run(name, fn, device="cuda", rows=ROWS, **kw) -> bool:
    """One probe, printed as one JSON line with its row of PERF.md's kernel
    table (``rows``); True if it held."""
    try:
        out = fn(device, **kw)
        print(json.dumps({"probe": name, "row": rows.get(name), "ok": True, **public(out)}),
              flush=True)
        return True
    except Exception as e:  # noqa: BLE001
        msg = " | ".join(str(e).splitlines()[:3])[:300]
        print(json.dumps({"probe": name, "row": rows.get(name), "ok": False,
                          "error": f"{type(e).__name__}: {msg}"}), flush=True)
        return False


def main(argv=None) -> int:
    only = (sys.argv[1:] if argv is None else argv) or None
    if not torch.cuda.is_available():
        print("probes.place: no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps({"card": card()}), flush=True)
    ok = [run(name, fn) for name, fn in PROBES if not only or name in only]
    return 0 if all(ok) else 1


if __name__ == "__main__":
    raise SystemExit(main())
