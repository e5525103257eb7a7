"""benchmarks/probe_dma.py's record-DMA probes on the port's reorder kernels.

Each probe moves whole records of a device array by an index list, at the
TPU probe's own shapes and indices, through ``ops/cuda/reorder.py``:

    single_dma_2d           row 7 of a (64, 128) table           record_gather
    single_dma_3d           record 13 of a (64, 8, 128) table    record_gather
    gather32_pipelined      32 seeded records of (300, 8, 128)   record_gather
    scatter_dma             4 (8, 128) records into (40, 8, 128) record_scatter
    dma_rate                32-record tiles of a permuted        dma_rate
                            (64800, 11, 128) pool, timed
    manual_dma_gather_rows  8 rows of a (64 * 128,) table        record_gather
                            (probe_mosaic.py:143)

Each gather and scatter probe checks its result against the probe's own
expectation and against the kernel's plain twin on the same inputs, bit for
bit. ``dma_rate`` prints records/s, GB/s and ms beside the byte bound and
one library call (``index_select`` + ``sum``). Two library yardsticks
follow probe_mosaic.py's XLA-level probes (:157-203): ``index_select``
row-gather bandwidth, beside ``record_gather`` at the same shapes, and a
stable ``torch.sort`` of (key, iota).

    python -m weekend_raytracer_tpu_torch.probes.dma [name ...]

Runs on the CUDA device; ``device="cpu"`` runs the twins (no timing means
anything there).
"""
from __future__ import annotations

import math
import sys

import numpy as np
import torch

from ..ops.cuda import reorder as ro
from . import HBM_RATE, card, check, same_bits, sync, time_mean

_F32 = torch.float32
_I32 = torch.int32
RATE_PROBE = dict(records=64800, comps=11, width=128, reps=10)  # probe_dma.py:171, 216
# the gather and scatter probes at the TPU probes' tiny shapes (probe_inputs)
RECORD_PROBES = ("single_dma_2d", "single_dma_3d", "gather32_pipelined", "scatter_dma",
                 "manual_dma_gather_rows")
# (rows, row values) of the row-gather bandwidth probe (probe_mosaic.py:157-179)
INDEX_SELECT_BW = ((65536, 128), (8192, 1024), (2048, 4096))


def probe_inputs(name: str, device="cuda"):
    """(source, int32 indices, destination or None) of a gather or scatter
    probe, at the TPU probe's shapes and indices: a gather's destination is
    new, the scatter's is the (40, 8, 128) array it writes into, filled
    with -7.0 (the records not named must keep it)."""
    def table(*shape):
        return torch.arange(math.prod(shape), dtype=_F32, device=device).reshape(shape)

    def index(values):
        return torch.as_tensor(np.asarray(values, np.int32), device=device)

    if name == "single_dma_2d":  # probe_dma.py:24-50
        return table(64, 128), index([7]), None
    if name == "single_dma_3d":  # :53-77
        return table(64, 8, 128), index([13]), None
    if name == "gather32_pipelined":  # :80-119, the wavefront tile gather
        return (table(300, 8, 128),
                index(np.random.default_rng(0).integers(0, 300, size=32, dtype=np.int32)), None)
    if name == "manual_dma_gather_rows":  # probe_mosaic.py:117-154: 8 rows of (64 * 128,)
        return table(64, 128), index([5, 3, 60, 0, 1, 9, 33, 2]), None
    if name == "scatter_dma":  # probe_dma.py:122-162
        return (table(4, 8, 128) + 1000, index([9, 2, 31, 17]),
                torch.full((40, 8, 128), -7.0, device=device))
    raise ValueError(f"no record probe named {name!r}")


def _gather_probe(name: str, what: str) -> dict:
    """record_gather at a probe's shape, held against the probe's
    expectation (numpy indexing on the host) and the twin, bit for bit."""
    def run(device="cuda") -> dict:
        tab, idx, _ = probe_inputs(name, device)
        out = ro.record_gather(tab, idx)
        plain = ro.gather_plain(tab, idx, torch.empty_like(out))
        sync(device)
        expect = torch.from_numpy(tab.cpu().numpy()[idx.cpu().numpy()])
        check(same_bits(out.cpu(), expect), what)
        check(same_bits(out, plain), (what, "kernel against its twin"))
        return {"message": f"{what} works", "shape": list(out.shape), "max_abs_err": 0.0}

    run.__doc__ = f"{what} at the TPU probe's shape and indices (probe_inputs)."
    return run


probe_single_dma_2d = _gather_probe("single_dma_2d", "single 2D-row record gather")
probe_single_dma_3d = _gather_probe("single_dma_3d", "single 3D-record gather")
probe_gather32_pipelined = _gather_probe("gather32_pipelined", "32-record gather")
probe_manual_dma_gather_rows = _gather_probe("manual_dma_gather_rows", "manual row gather")


def probe_scatter_dma(device="cuda") -> dict:
    """4 (8, 128) records into records 9, 2, 31, 17 of a (40, 8, 128)
    array; the records not named keep what they held."""
    src, idx, held = probe_inputs("scatter_dma", device)
    out = ro.record_scatter(src, idx, held.clone())
    plain = ro.scatter_plain(src, idx, held.clone())
    sync(device)
    named = np.zeros(held.shape[0], bool)
    named[idx.cpu().numpy()] = True
    host = out.cpu()
    check(all(same_bits(host[int(i)], src[j].cpu()) for j, i in enumerate(idx.tolist())),
           "record scatter")
    check(bool((host[torch.from_numpy(~named)] == -7.0).all()), "records not named changed")
    check(same_bits(out, plain), ("record scatter", "kernel against its twin"))
    return {"message": "record scatter works", "shape": list(out.shape), "max_abs_err": 0.0}


def rate_inputs(device="cuda", records: int = RATE_PROBE["records"], fill=None):
    """probe_dma_rate's pool (all ones, or ``fill`` values) and its seeded
    permutation."""
    shape = (records, RATE_PROBE["comps"], RATE_PROBE["width"])
    pool = (torch.ones(shape, dtype=_F32, device=device) if fill is None
            else torch.as_tensor(fill, dtype=_F32, device=device).reshape(shape))
    perm = np.random.default_rng(0).permutation(records).astype(np.int32)
    return pool, torch.from_numpy(perm).to(device)


def rate_bound(pool: torch.Tensor, perm: torch.Tensor) -> dict:
    """The least time the card could take: each pool record and index read
    once, each output block written once, at HBM_RATE."""
    read = pool.numel() * 4 + perm.numel() * 4
    written = perm.numel() // ro.RATE_RECORDS * ro.RATE_OUT[0] * ro.RATE_OUT[1] * 4
    return {"read_bytes": read, "written_bytes": written,
            "bound_ms": (read + written) / HBM_RATE * 1e3, "bound_by": "bytes"}


def rate_library(pool: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """One PyTorch call chain computing dma_rate's sums: index_select of the
    permuted records, then the sum of each tile's component 0."""
    tiles = perm.numel() // ro.RATE_RECORDS
    return pool.index_select(0, perm.long())[:, 0].reshape(tiles, -1).sum(1)


def probe_dma_rate(device="cuda", reps: int = RATE_PROBE["reps"]) -> dict:
    """Whole-record gather rate over the full pool, 32 records per tile
    (:165-224): the kernel against its twin in every bit (each tile sums
    4096 ones), then its time beside the byte bound and the library call."""
    pool, perm = rate_inputs(device)
    out = ro.dma_rate(pool, perm)
    plain = ro.dma_rate_plain(pool, perm)
    sync(device)
    check(same_bits(out, plain), ("dma_rate", "kernel against its twin"))
    check(bool((out == float(ro.RATE_RECORDS * RATE_PROBE["width"])).all()), "dma_rate sums")
    ms = time_mean(lambda: ro.dma_rate(pool, perm, out), reps, device)
    library_ms = time_mean(lambda: rate_library(pool, perm), reps, device)
    bound = rate_bound(pool, perm)
    n = perm.numel()
    return {"message": (f"{n / ms / 1e3:.2f}M records/s, {bound['read_bytes'] / ms / 1e6:.1f} "
                        f"GB/s read, {ms:.4f} ms per full-pool gather (bound "
                        f"{bound['bound_ms']:.4f} ms)"),
            "records": n, "ms": ms, "records_per_s": n / ms * 1e3,
            "read_gb_per_s": bound["read_bytes"] / ms / 1e6, "library_ms": library_ms,
            "max_abs_err": 0.0, **bound}


def index_select_bw_inputs(rows: int, row_elems: int, device="cuda"):
    """(arange table [rows, row_elems], int32 seeded permutation of its
    rows) of the row-gather bandwidth probe."""
    src = torch.arange(rows * row_elems, dtype=_F32, device=device).reshape(rows, row_elems)
    perm = np.random.default_rng(0).permutation(rows).astype(np.int32)
    return src, torch.from_numpy(perm).to(device)


def probe_index_select_bw(device="cuda", reps: int = 5) -> dict:
    """Row-gather bandwidth by a permutation (probe_mosaic.py:157-179),
    read + written bytes, of index_select and of record_gather."""
    out = {}
    for rows, row_elems in INDEX_SELECT_BW:
        src, idx = index_select_bw_inputs(rows, row_elems, device)
        idx_long = idx.long()
        gb = rows * row_elems * 4 * 2 / 1e9
        lib = time_mean(lambda: src.index_select(0, idx_long), reps, device)
        dst = torch.empty_like(src)
        kern = time_mean(lambda: ro.record_gather(src, idx, dst), reps, device)
        check(torch.equal(dst, src.index_select(0, idx_long)), ("record_gather", rows))
        out[f"{rows}x{row_elems}"] = {"index_select_gb_per_s": gb / lib * 1e3,
                                      "record_gather_gb_per_s": gb / kern * 1e3,
                                      "index_select_ms": lib, "record_gather_ms": kern}
    out["message"] = "; ".join(f"{k}: {v['index_select_gb_per_s']:.1f} GB/s index_select, "
                               f"{v['record_gather_gb_per_s']:.1f} GB/s record_gather"
                               for k, v in out.items())
    return out


def probe_sort_cost(device="cuda", reps: int = 5) -> dict:
    """Stable sort of (key, iota) at regroup-relevant sizes
    (probe_mosaic.py:182-203)."""
    out = {}
    for n in [65536, 1 << 20, 1 << 23]:
        keys = torch.from_numpy(np.random.default_rng(0).integers(
            0, 1 << 30, size=n, dtype=np.int32)).to(device)
        out[f"n={n}"] = time_mean(lambda: torch.sort(keys, stable=True), reps, device)
    return {"ms": out, "message": "; ".join(f"{k}: {v:.4f} ms" for k, v in out.items())}


PROBES = [
    ("single_dma_2d", probe_single_dma_2d),
    ("single_dma_3d", probe_single_dma_3d),
    ("gather32_pipelined", probe_gather32_pipelined),
    ("scatter_dma", probe_scatter_dma),
    ("dma_rate", probe_dma_rate),
    ("manual_dma_gather_rows", probe_manual_dma_gather_rows),
    ("index_select_bw", probe_index_select_bw),
    ("sort_cost", probe_sort_cost),
]


def run(name, fn, device="cuda") -> bool:
    """One probe, printed as the TPU probe prints it; True if it held."""
    try:
        out = fn(device)
        print(f"[ok]   {name}: {out['message']}", flush=True)
        return True
    except Exception as e:  # noqa: BLE001
        msg = " | ".join(str(e).splitlines()[:3])[:300]
        print(f"[FAIL] {name}: {type(e).__name__}: {msg}", flush=True)
        return False


def main(argv=None) -> int:
    only = (sys.argv[1:] if argv is None else argv) or None
    if not torch.cuda.is_available():
        print("probes.dma: no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {card()}", flush=True)
    ok = [run(name, fn) for name, fn in PROBES if not only or name in only]
    return 0 if all(ok) else 1


if __name__ == "__main__":
    raise SystemExit(main())
