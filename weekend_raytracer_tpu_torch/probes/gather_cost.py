"""benchmarks/probe_gather_cost.py on the port's table_gather: what a
per-lane fetch from a table of 128-wide rows costs against the span of rows
a (32, 128) tile touches, the texture LUT's primitive.

    gather_cost  the probe's own run (main, :47-99): a (128, 128) arange
                 table, 512 tiles of seeded indices (its ``default_rng(0)``
                 draws, in its order) over spans of 1, 2, 4, 8 and 16 rows,
                 16 fetches a lane
    texture      the port's own texture pool for ``textured_spheres``
                 (``build_kernel_texture_pool``, packed RGB8 as float32,
                 exact below 2^24): at DEFAULT_TEXTURE_BUDGET (the mipped
                 LUT, 128 rows) and at full procedural size (2048 rows),
                 spans 1, 2, 4, ... up to the whole pool
    fill         the card-filling case: 4,096 tiles (2^24 lanes) of the
                 probe's index distribution over its table, spans 1-16

Each span runs every route: "global" (each lane loads its own address
through the L1), "shared" (the tile's span staged in shared memory first;
while span x 512 B fits a block) and "arith" (the same index math with no
load: the probe's pure-arithmetic baseline, which adds the value an arange
table holds at each address). Each is held bit for bit against its twin
and, for ``gather_cost`` and ``fill`` (on every ORACLE_EVERY-th tile),
the probe's numpy oracle (every sum an exact integer), then timed beside
its bound: the larger of the bytes that must cross HBM (the table, the
indices and the sums, once) and the 16 lookups a lane at the
shared-memory rate (128 B a clock on each SM at the card's maximum SM
clock). ``gather_cost`` and ``fill`` add each kernel's device time from
the profiler (``fill`` only from traces that kept every event). No one
library call computes the function.

    python -m weekend_raytracer_tpu_torch.probes.gather_cost [gather_cost texture fill]

One JSON line per probe. Runs on the CUDA device; ``device="cpu"`` runs the
twins (no timing means anything there).
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..ops.cuda import access as ac
from . import HBM_RATE, card, device_times, smem_rate
from .place import (DEVICE_REPS, REPS, case_launches, check, dev, equal_to, hold, in_turns,
                    run as _run, sync)

_F32 = torch.float32
PROBE = dict(table_rows=128, n_tiles=512, spans=(1, 2, 4, 8, 16))  # :52-57
FILL_TILES = 4096  # the card-filling case: 2^24 lanes, 134 MB of indices and sums
ORACLE_EVERY = 32  # of the fill's tiles, those held to the numpy oracle as well
TEXTURE_SCENE = "textured"
FULL_TEXTURE_BUDGET = 512 * 256  # the procedural earth's and moon's texels: no mip


def span_indices(rng, table_rows: int, span: int, n_tiles: int) -> np.ndarray:
    """The probe's indices (:58-62): per tile a first row lo, then lanes
    uniform over span rows from it; lo < table_rows - span (0 when the
    span is the whole table). int32 [n_tiles * 32, 128]."""
    lo = rng.integers(0, max(table_rows - span, 1), size=(n_tiles,))
    idx = lo[:, None, None] * 128 + rng.integers(0, span * 128, size=(n_tiles, 32, 128))
    return idx.astype(np.int32).reshape(n_tiles * 32, 128)


def oracle(tab: np.ndarray, idx: np.ndarray, span: int, n_fetch: int = ac.N_FETCH):
    """The probe's numpy oracle (:85-91): sum_k tab[row_k, col_k] a lane,
    in float32, k in order."""
    base = idx.reshape(-1, 32, 128)
    sb = (base.min(axis=(1, 2), keepdims=True) >> 7) << 7
    want = np.zeros_like(base, np.float32)
    for k in range(n_fetch):
        flat = sb + (base - sb + k * ac.FETCH_STRIDE) % (span * 128)
        want += tab[(flat >> 7) % tab.shape[0], flat & 127]
    return want.reshape(idx.shape)


def gather_bound(tab: torch.Tensor, idx: torch.Tensor, rate: dict,
                 n_fetch: int = ac.N_FETCH) -> dict:
    """The larger of the bytes that must cross HBM (the table, the indices
    and the sums, once) over HBM_RATE and the lookups (4 B each, n_fetch a
    lane) over the shared-memory rate."""
    byte_ms = (tab.numel() + 2 * idx.numel()) * 4 / HBM_RATE * 1e3
    lookup_ms = idx.numel() * n_fetch * 4 / rate["bytes_per_s"] * 1e3
    return {"bound_ms": max(byte_ms, lookup_ms), "bound_by": "bytes", "hbm_ms": byte_ms,
            "lookup_ms": lookup_ms}


def routes_for(span: int, routes=ac.GATHER_ROUTES) -> tuple:
    """The routes a span runs: "shared" while the span fits a block."""
    return tuple(r for r in routes if r != "shared" or span <= ac.MAX_SHARED_SPAN)


def span_cases(tab: torch.Tensor, idx: torch.Tensor, span: int, rate: dict, device, reps: int,
               expect=None) -> dict:
    """Every route of one span: held bit for bit against its twin and, with
    ``expect``, the probe's oracle (on the probe's arange table, "arith"
    adds what the table holds), timed beside the bound; ps a lane fetch."""
    bound = gather_bound(tab, idx, rate)
    expect = expect or (lambda got: True)
    kernels = {route: (lambda route=route: ac.table_gather(tab, idx, span, route=route))
               for route in routes_for(span)}
    plain_ms = {route: hold(fn, lambda route=route: ac.table_gather_plain(tab, idx, span,
                                                                          route=route),
                            expect, ("table_gather", span, route), device)
                for route, fn in kernels.items()}
    out = {}
    for route, ms in in_turns(kernels, reps, device).items():
        out[route] = {"ms": ms, "plain_ms": plain_ms[route], "library_ms": None,
                      "share": bound["bound_ms"] / ms, "max_abs_err": 0.0, **bound,
                      "ps_per_fetch": ms * 1e9 / (idx.numel() * ac.N_FETCH)}
    return out


def span_launches(span: int, reps: int, device_reps: int = 0) -> int:
    """Launches ``span_cases`` (and the device times) make at one span."""
    return case_launches(len(routes_for(span)), reps, device_reps)


def probe_indices(n_tiles: int = PROBE["n_tiles"]) -> dict:
    """{span: int32 [n_tiles * 32, 128]}: each of the probe's spans'
    seeded indices over its table, in the probe's draw order."""
    rng = np.random.default_rng(0)
    return {span: span_indices(rng, PROBE["table_rows"], span, n_tiles)
            for span in PROBE["spans"]}


def gather_cost(device="cuda", n_tiles: int = PROBE["n_tiles"], reps: int = REPS) -> dict:
    """The probe's run: each span's seeded indices (in the probe's draw
    order) against the (128, 128) arange table, every route, then the
    device time of each kernel under the profiler."""
    rate = smem_rate(device)
    rows = PROBE["table_rows"]
    tab_np = np.arange(rows * 128, dtype=np.float32).reshape(rows, 128)
    tab = dev(tab_np, device)
    out, timed = {"smem_rate": rate}, {}
    for span, idx_np in probe_indices(n_tiles).items():
        idx = dev(idx_np, device)
        out[f"span{span}"] = span_cases(tab, idx, span, rate, device, reps,
                                        equal_to(oracle(tab_np, idx_np, span)))
        for route in routes_for(span):
            timed[(span, route)] = (lambda idx=idx, span=span, route=route:
                                    ac.table_gather(tab, idx, span, route=route))
    for (span, route), dev_ms in (device_times(timed, DEVICE_REPS, device) or {}).items():
        out[f"span{span}"][route].update(dev_ms)
    out["message"] = "; ".join(
        f"span {s}: " + ", ".join(f"{r} {c['ms'] * 1e3:.1f} us" for r, c in
                                  out[f"span{s}"].items()) for s in PROBE["spans"])
    return out


def texture_pools(device) -> dict:
    """{texels budget: the textured scene's kernel texture pool [rows, 128]
    as float32} at DEFAULT_TEXTURE_BUDGET and at full size."""
    from ..models.scenes import SCENES
    from ..ops.cuda.megakernel import DEFAULT_TEXTURE_BUDGET, build_kernel_texture_pool

    mat = SCENES[TEXTURE_SCENE][0]().build(device=device).materials
    out = {}
    for budget in (DEFAULT_TEXTURE_BUDGET, FULL_TEXTURE_BUDGET):
        pool = build_kernel_texture_pool(mat, budget)[0]
        check(int(pool.max()) < 1 << 24, ("packed texels are exact in float32", budget))
        out[budget] = pool.to(_F32).contiguous()
    return out


def pool_spans(rows: int) -> tuple:
    """1, 2, 4, ... up to the whole pool."""
    spans, s = [], 1
    while s < rows:
        spans.append(s)
        s *= 2
    return (*spans, rows)


def texture_cases(device, n_tiles: int = PROBE["n_tiles"]) -> dict:
    """{rows: (texels budget, pool, {span: indices})}: each texture pool
    with its spans' seeded indices, in ``texture``'s draw order."""
    rng = np.random.default_rng(1)
    out = {}
    for budget, tab in texture_pools(device).items():
        rows = tab.shape[0]
        out[rows] = (budget, tab, {span: dev(span_indices(rng, rows, span, n_tiles), device)
                                   for span in pool_spans(rows)})
    return out


def texture(device="cuda", n_tiles: int = PROBE["n_tiles"], reps: int = REPS) -> dict:
    """The texture pools' spans, every route, held against the twin and
    timed (the card-filling shape: the probe's 512 tiles)."""
    rate = smem_rate(device)
    out = {"smem_rate": rate}
    for rows, (budget, tab, spans) in texture_cases(device, n_tiles).items():
        cases = {}
        for span, idx in spans.items():
            cases[f"span{span}"] = span_cases(tab, idx, span, rate, device, reps)
        sync(device)
        out[f"pool{rows}"] = {"budget_texels": budget, "rows": rows, **cases}
    out["message"] = "; ".join(
        f"{k}: global " + ", ".join(f"{s[4:]} {c['global']['ps_per_fetch']:.2f}" for s, c in
                                    v.items() if s.startswith("span")) + " ps a fetch"
        for k, v in out.items() if k.startswith("pool"))
    return out


def fill_indices(gen: torch.Generator, table_rows: int, span: int, n_tiles: int,
                 device) -> torch.Tensor:
    """``span_indices``' distribution drawn on ``device`` from ``gen``: per
    tile a first row lo < table_rows - span, then lanes uniform over span
    rows from it. int32 [n_tiles * 32, 128]."""
    lo = torch.randint(0, max(table_rows - span, 1), (n_tiles, 1, 1), generator=gen,
                       device=device)
    lanes = torch.randint(0, span * 128, (n_tiles, 32, 128), generator=gen, device=device)
    return (lo * 128 + lanes).to(torch.int32).reshape(n_tiles * 32, 128)


def fill_cases(device, n_tiles: int = FILL_TILES) -> dict:
    """{span: indices}: the card-filling case's seeded draws, in ``fill``'s
    order."""
    gen = torch.Generator(device=device).manual_seed(2)
    return {span: fill_indices(gen, PROBE["table_rows"], span, n_tiles, device)
            for span in PROBE["spans"]}


def edge_cases(device) -> dict:
    """{name: (table, indices, span, n_fetch)} where the kernel's stepped
    walk must wrap or give way to the two modulos: spans longer than the
    table, tables of 24 and 100 rows (not powers of two), negative
    indices, n_fetch 0 and 1, a tile near 2^31 (its span passes it) and a
    tile spread over 2^31 (seeded)."""
    rng = np.random.default_rng(5)
    top = rng.integers(2**31 - 3000, 2**31 - 1, size=(32, 128)).astype(np.int32)
    spread = rng.integers(-2**31, 2**31 - 1, size=(32, 128), dtype=np.int64).astype(np.int32)
    spread[0, :2] = (-2**31, 2**31 - 1)
    out = {}
    for rows in (24, 100):
        tab = dev(rng.standard_normal((rows, 128)).astype(np.float32), device)
        negative = rng.integers(-40 * 128, 40 * 128, size=(8 * 32, 128)).astype(np.int32)
        for name, idx_np in (("negative", negative), ("top", top), ("spread", spread)):
            idx = torch.as_tensor(idx_np, device=device)
            for span in (3, rows, 40):
                for n_fetch in (0, 1, ac.N_FETCH):
                    out[f"rows{rows}_{name}_span{span}_fetch{n_fetch}"] = (tab, idx, span,
                                                                           n_fetch)
    return out


def fill(device="cuda", n_tiles: int = FILL_TILES, reps: int = REPS) -> dict:
    """The card-filling case (the probe's 512 tiles move 16.8 MB, less than
    a call's host side takes): ``n_tiles`` tiles of the probe's index
    distribution (``fill_indices``, seeded) against its (128, 128) arange
    table, spans 1-16, every route held bit for bit against its twin on
    every tile and against the probe's oracle on every ORACLE_EVERY-th,
    timed in turns beside the bound; then each kernel's device time from
    the profiler, kept only where its trace recorded every event."""
    rate = smem_rate(device)
    rows = PROBE["table_rows"]
    tab_np = np.arange(rows * 128, dtype=np.float32).reshape(rows, 128)
    tab = dev(tab_np, device)
    out, timed = {"smem_rate": rate, "n_tiles": n_tiles, "oracle_every": ORACLE_EVERY}, {}
    for span, idx in fill_cases(device, n_tiles).items():
        sampled = idx.reshape(n_tiles, 32, 128)[::ORACLE_EVERY].reshape(-1, 128)
        want = equal_to(oracle(tab_np, sampled.cpu().numpy(), span))

        def expect(got, want=want):
            return want(got.reshape(n_tiles, 32, 128)[::ORACLE_EVERY].reshape(-1, 128))

        out[f"span{span}"] = span_cases(tab, idx, span, rate, device, reps, expect)
        for route in routes_for(span):
            timed[(span, route)] = (lambda idx=idx, span=span, route=route:
                                    ac.table_gather(tab, idx, span, route=route))
    for (span, route), dev_ms in (device_times(timed, DEVICE_REPS, device, several=tuple(timed))
                                  or {}).items():
        if dev_ms["device_ms_by"] == "profiler":
            out[f"span{span}"][route].update(dev_ms)
    out["message"] = f"{n_tiles} tiles: " + "; ".join(
        f"span {s}: " + ", ".join(f"{r} {c['ms'] * 1e3:.1f} us ({c['share']:.1%})"
                                  for r, c in out[f"span{s}"].items())
        for s in PROBE["spans"])
    return out


PROBES = [("gather_cost", gather_cost), ("texture", texture), ("fill", fill)]
ROWS = {"gather_cost": "12", "texture": "12", "fill": "12"}


def launches(name: str, reps: int = REPS, device_reps: int = DEVICE_REPS,
             pool_rows=(128, 2048)) -> dict:
    """The launches of each kernel that probe ``name`` makes (``device_reps``
    a kernel under the profiler; ``texture`` at pools of ``pool_rows``
    rows)."""
    out = dict.fromkeys(ac.KERNELS, 0)
    if name == "gather_cost":
        out["table_gather"] = sum(span_launches(s, reps, device_reps) for s in PROBE["spans"])
    elif name == "fill":  # each device time also traces one call alone
        out["table_gather"] = sum(span_launches(s, reps, device_reps)
                                  + (len(routes_for(s)) if device_reps else 0)
                                  for s in PROBE["spans"])
    elif name == "texture":
        out["table_gather"] = sum(span_launches(s, reps) for rows in pool_rows
                                  for s in pool_spans(rows))
    return out


def run(name, fn, device="cuda", **kw) -> bool:
    """One probe, printed as one JSON line; True if it held."""
    return _run(name, fn, device, rows=ROWS, **kw)


def main(argv=None) -> int:
    only = (sys.argv[1:] if argv is None else argv) or None
    if not torch.cuda.is_available():
        print("probes.gather_cost: no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps({"card": card()}), flush=True)
    ok = [run(name, fn) for name, fn in PROBES if not only or name in only]
    return 0 if all(ok) else 1


if __name__ == "__main__":
    raise SystemExit(main())
