#!/usr/bin/env python3
"""Time record_gather and record_scatter (csrc/reorder.cu) against other
builds of them, in turns, on one CUDA card, and hold every build's outputs
to the reference build's in every bit.

    python3 tools/reorder_steps.py [--baseline NAME=ROOT ...] [--out DIR] [--reps N]

Builds reorder.cu from this checkout ("change") and from the csrc/ of each
``--baseline`` (ROOT a repository root or a csrc/ directory, e.g. the
parent commit unpacked by ``git archive`` under the git-ignored
``_checkout/parent``), and variants of this checkout's source, one nvcc
each, all started together (tools/variants.py), into
weekend_raytracer_tpu_torch/_build/reorder_steps/:

  records2, records8   a column thread's records (kColRecords; the source: 4)
  rowvecs1, rowvecs2, rowvecs8   a row thread's vectors in flight where
                       the items outnumber the card's resident threads
                       (kRowVecs; the source: 4)
  loads_only           timing only: the column gather's random loads, its
                       stores dropped (the L2's random-read rate)
  stores_only          timing only: the column gather's coalesced stores
                       of its indices, no random load
  random_stores        timing only: the direct column scatter's random
                       stores of its indices, no load of src

A baseline whose reorder.cu still takes the ``vec4`` argument (the parent's
C interface) is called with it, as its wrapper called it. The change and
its variants run the scatter by both routes: "direct" (stores where the
list points) and "inverse" (the list inverted, then gathered through).

The shapes:

  binned     the binned path's pool, RTiOW 1920x1080 x 4 spp at cut 3 (K0
             and PACK to the cut, as chip_smoke's _binned_kernels makes
             it: 1.6 M live records of 16 planes), permuted by the
             chunkxoct order (bin_keys, stable_order) and by a uniformly
             random permutation; the gather (with the dead tail, dim 1)
             and the scatter back, each beside index_select / index_copy_
  rows       probes/dma.py's index_select_bw shapes (65536 x 128, 8192 x
             1024, 2048 x 4096), the gather beside index_select
  probes     the five TPU probe shapes (dma.probe_inputs), beside
             index_select / index_copy_
  widths     chip_smoke's further widths, rows of (4099, 3), (2048, 128),
             (1024, 11, 128), (777, 5, 16) and columns of (16, 4099), (5,
             1031), by a shorter list and a permutation (bits only, not
             timed)

Designs this source no longer builds (a column thread's plane group, 4
vectors a row thread where one each covers the items) are timed as
``--baseline`` trees of the commits that had them.

Every build's output (timing-only variants aside) must equal the reference
build's (the first baseline, else this checkout) and the twin's in every
bit. Each case is timed with CUDA events (the mean of REPS calls after a
warm one; the builds in order, then in reverse) and under the profiler
(device ms from traces that kept every event), beside its byte bound.
Prints the card's name and power limit, one JSON line per build (ptxas
registers and spills) and one per case; exits 1 if an output differs.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from variants import build_all, copy_csrc, csrc_of  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import build  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import regroup as rg  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import reorder as ro  # noqa: E402
from weekend_raytracer_tpu_torch.probes import (HBM_RATE, binned, card, device_times,  # noqa: E402
                                                dma, same_bits, time_mean)

OUT = build.BUILD_DIR / "reorder_steps"
REPS = 20  # calls a timing averages
DEVICE_REPS = 10  # calls a device time traces
SOURCE = "reorder.cu"
VARIANTS = {"records2": {"kColRecords": 2}, "records8": {"kColRecords": 8},
            "rowvecs1": {"kRowVecs": 1}, "rowvecs2": {"kRowVecs": 2}, "rowvecs8": {"kRowVecs": 8}}
# timing-only variants: (line of the source, its replacement)
TIMING_ONLY = {
    "loads_only": ("d[static_cast<long long>(first) + u * threads] = v[u];",
                   "if (__float_as_uint(v[u]) == 0x7fc0dead) "
                   "d[static_cast<long long>(first) + u * threads] = v[u];"),
    "stores_only": ("v[u] = __ldg(s + at[u]);", "v[u] = __int_as_float(at[u]);"),
    "random_stores": ("dst[c * dst_ld + idx[j]] = src[c * src_ld + j];",
                      "dst[c * dst_ld + idx[j]] = __int_as_float(j);"),
}
COLUMN_RECORD = 4 * rg.N_COMP  # bytes of a binned record
# chip_smoke's [reorder] widths: (shape, the dim its records lie along)
WIDTHS = (((4099, 3), 0), ((2048, 128), 0), ((1024, 11, 128), 0), ((777, 5, 16), 0),
          ((16, 4099), 1), ((5, 1031), 1))


class Build:
    """One build's gather and scatter, called through its C interface."""

    def __init__(self, lib, old_abi: bool):
        ro.bind(lib)
        if old_abi:  # the parent's interface: a vec4 flag before the stream
            lib.wrt_record_gather.argtypes = ro.SIGNATURES["wrt_record_gather"][:-1] + [
                ro._i, ro._vp]
            lib.wrt_record_scatter.argtypes = ro.SIGNATURES["wrt_record_gather"][:-1] + [
                ro._i, ro._vp]
        self.lib, self.old_abi = lib, old_abi

    def _args(self, src, dst, idx, dim, n_dst, n_src):
        """The C functions' leading arguments, and the parent's vec4 flag."""
        planes, width, lds, ldd, _ = ro._pair(src, dst, idx, dim, n_dst, n_src)
        head = (src.data_ptr(), dst.data_ptr(), idx.data_ptr(), idx.numel(), planes, width,
                lds, ldd)
        vec4 = int(width % 4 == 0 and lds % 4 == 0 and ldd % 4 == 0
                   and src.data_ptr() % 16 == 0 and dst.data_ptr() % 16 == 0)
        return head, vec4

    def gather(self, src, idx, dst, dim=0):
        head, vec4 = self._args(src, dst, idx, dim, idx.numel(), 0)
        tail = (vec4,) if self.old_abi else ()
        err = self.lib.wrt_record_gather(*head, *tail, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"wrt_record_gather: CUDA error {err}")
        return dst

    def scatter(self, src, idx, dst, dim=0, route="direct", scratch=None):
        head, vec4 = self._args(src, dst, idx, dim, 0, idx.numel())
        if self.old_abi:
            tail = (vec4,)
        else:
            tail = (scratch.data_ptr() if route == "inverse" else None,)
        err = self.lib.wrt_record_scatter(*head, *tail, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"wrt_record_scatter ({route}): CUDA error {err}")
        return dst


def _turns(fns: dict, reps: int) -> dict:
    """{name: [ms in order, ms in reverse]} (``probes.time_mean``)."""
    out = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        out[k].append(time_mean(fns[k], reps, "cuda"))
    return out


def _whole_device_ms(fns: dict) -> dict:
    """Device ms of each function from traces that kept every event."""
    got = device_times(fns, DEVICE_REPS, "cuda", several=tuple(fns)) or {}
    return {k: v["device_ms"] for k, v in got.items() if v["device_ms_by"] == "profiler"}


def _bound_ms(nbytes: float) -> float:
    return nbytes / HBM_RATE * 1e3


def _case(key: str, fns: dict, reps: int, bound_ms: float, record: dict) -> None:
    rec = {"ms": _turns(fns, reps), "device_ms": _whole_device_ms(fns), "bound_ms": bound_ms}
    record[key] = rec
    print(json.dumps({"case": key, **rec}), flush=True)


def _binned_pool():
    """The binned path's dense pool at cut 3 and its live record count."""
    w, h = binned.SHAPES["rtiow"]
    inp, _ = binned.scene_inputs("rtiow", w, h, "cuda")
    t, _ = rg.plan(w, h, binned.SPP, binned.BOUNCES, (binned.CUT,))
    dense, _, n = binned.dense_pool(inp, t, binned.CUT, "cuda")
    chunkxoct = binned.stable_order(binned.bin_keys(dense, n, inp, ("chunkxoct",))["chunkxoct"])
    gen = torch.Generator(device="cuda").manual_seed(18)
    rand = torch.randperm(n, generator=gen, device="cuda").to(torch.int32)
    return dense, n, {"chunkxoct": chunkxoct, "random": rand}


def _timed_routes(name: str, bld: Build) -> tuple:
    """The scatter routes a build is timed by: the variants change only the
    gather_cols and invert the inverse route runs, so only this checkout
    (and the timing-only random_stores) is timed by both."""
    if bld.old_abi:
        return ("direct",)
    return ("direct", "inverse") if name in ("change", "random_stores") else ("inverse",)


def _binned(builds: dict, timed: dict, ref: str, reps: int, differ: list) -> dict:
    dense, n, orders = _binned_pool()
    end = -(-n // 128) * 128
    record = {"records": n, "gathered": end}
    scratch = torch.empty(n, dtype=torch.int32, device="cuda")
    for name, order in orders.items():
        index = binned.with_tail(order, n, end)
        plain = ro.gather_plain(dense, index, torch.empty_like(dense), dim=1)
        perm = torch.empty_like(dense)
        want = builds[ref].gather(dense, index, perm.clone(), dim=1)
        src = want[:, :n].contiguous()
        back_plain = ro.scatter_plain(src, order, torch.empty_like(src), dim=1)
        for b, bld in builds.items():
            got = bld.gather(dense, index, perm.clone(), dim=1)
            routes = ("direct",) if bld.old_abi else ("direct", "inverse")
            backs = {r: bld.scatter(src, order, torch.empty_like(src), 1, r, scratch)
                     for r in routes}
            torch.cuda.synchronize()
            if b not in timed:
                continue
            if not (same_bits(got[:, :end], want[:, :end])
                    and same_bits(got[:, :end], plain[:, :end])):
                differ.append((b, "binned_gather", name))
            for r, back in backs.items():
                if not (same_bits(back, back_plain) and same_bits(back, dense[:, :n])):
                    differ.append((b, "binned_scatter", name, r))
        index_long, order_long = index.long(), order.long()
        fns = {b: (lambda bld=bld: bld.gather(dense, index, perm, dim=1))
               for b, bld in builds.items()}
        fns["index_select"] = lambda: torch.index_select(dense, 1, index_long)
        _case(f"binned_gather_{name}", fns, reps,
              _bound_ms(end * (2 * COLUMN_RECORD + 4)), record)
        back = torch.empty_like(src)
        fns = {}
        for b, bld in builds.items():
            for r in _timed_routes(b, bld):
                fns[f"{b}:{r}"] = (lambda bld=bld, r=r: bld.scatter(src, order, back, 1, r,
                                                                     scratch))
        fns["index_copy_"] = lambda: back.index_copy_(1, order_long, src)
        _case(f"binned_scatter_{name}", fns, reps, _bound_ms(n * (2 * COLUMN_RECORD + 4)),
              record)
    return record


def _rows(builds: dict, timed: dict, ref: str, reps: int, differ: list) -> dict:
    record = {}
    for rows, width in dma.INDEX_SELECT_BW:
        src, idx = dma.index_select_bw_inputs(rows, width, "cuda")
        want = src.index_select(0, idx.long())
        dst = torch.empty_like(src)
        for b, bld in builds.items():
            got = bld.gather(src, idx, torch.empty_like(src))
            torch.cuda.synchronize()
            if b in timed and not same_bits(got, want):
                differ.append((b, "rows", rows, width))
        fns = {b: (lambda bld=bld: bld.gather(src, idx, dst)) for b, bld in builds.items()}
        idx_long = idx.long()
        fns["index_select"] = lambda: src.index_select(0, idx_long)
        _case(f"rows_{rows}x{width}", fns, reps, _bound_ms(2 * src.numel() * 4 + idx.numel() * 4),
              record)
    return record


def _probes(builds: dict, timed: dict, ref: str, reps: int, differ: list) -> dict:
    record = {}
    for name in dma.RECORD_PROBES:
        src, idx, held = dma.probe_inputs(name, "cuda")
        idx_long = idx.long()
        if held is None:
            want = ro.gather_plain(src, idx, torch.empty((idx.numel(), *src.shape[1:]),
                                                          device="cuda"))
            dst = torch.empty_like(want)
            run = {b: (lambda bld=bld: bld.gather(src, idx, dst)) for b, bld in builds.items()}
            library = ("index_select", lambda: src.index_select(0, idx_long))
        else:
            want = ro.scatter_plain(src, idx, held.clone())
            dst = held.clone()
            run = {b: (lambda bld=bld: bld.scatter(src, idx, dst)) for b, bld in builds.items()}
            library = ("index_copy_", lambda: dst.index_copy_(0, idx_long, src))
        for b, fn in run.items():
            dst.copy_(held if held is not None else torch.zeros_like(dst))
            fn()
            torch.cuda.synchronize()
            if b in timed and not same_bits(dst, want):
                differ.append((b, "probe", name))
        moved = idx.numel() * (src.numel() // src.shape[0])
        _case(f"probe_{name}", {**run, library[0]: library[1]}, reps,
              _bound_ms(2 * moved * 4 + idx.numel() * 4), record)
    return record


def _widths(builds: dict, timed: dict, ref: str, reps: int, differ: list) -> dict:
    """chip_smoke's further widths (not timed): each build's gather and
    scatter by a shorter list and by a permutation against the reference
    build's and the twin's, in every bit."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    checked = []
    for shape, dim in WIDTHS:
        records = shape[dim]
        src = torch.randn(shape, generator=gen, device="cuda")
        held = torch.randn(shape, generator=gen, device="cuda")
        perm = torch.randperm(records, generator=gen, device="cuda").to(torch.int32)
        scratch = torch.empty(records, dtype=torch.int32, device="cuda")
        for cover, idx in (("short", perm[:records - 3]), ("permutation", perm)):
            n = idx.numel()
            plain_g = ro.gather_plain(src, idx, torch.zeros_like(src), dim)
            plain_s = ro.scatter_plain(src, idx, held.clone(), dim)
            want_g = builds[ref].gather(src, idx, torch.zeros_like(src), dim)
            want_s = builds[ref].scatter(src, idx, held.clone(), dim)
            for b, bld in builds.items():
                if b not in timed:
                    continue
                routes = ("direct",) if bld.old_abi or n < records else ("direct", "inverse")
                got = {"gather": bld.gather(src, idx, torch.zeros_like(src), dim),
                       **{r: bld.scatter(src, idx, held.clone(), dim, r, scratch)
                          for r in routes}}
                torch.cuda.synchronize()
                for k, v in got.items():
                    want, plain = (want_g, plain_g) if k == "gather" else (want_s, plain_s)
                    if not (same_bits(v, want) and same_bits(v, plain)):
                        differ.append((b, "widths", str(shape), dim, cover, k))
            checked.append(f"{shape} dim {dim} {cover}")
    print(json.dumps({"case": "widths", "checked": checked}), flush=True)
    return {"checked": checked}


def _usage(log: str) -> dict:
    return {k: v for k, v in build.parse_ptxas(log).items()
            if any(s in k for s in ("gather_cols", "scatter_cols", "invert", "reorder_rows",
                                    "record_gather", "record_scatter"))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", action="append", default=[], metavar="NAME=ROOT")
    ap.add_argument("--out", default=None)
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("reorder_steps: no CUDA device", file=sys.stderr)
        return 2
    smi = card()
    print(smi, flush=True)
    t0 = time.perf_counter()
    roots = {"change": ROOT, **{name: pathlib.Path(r) for name, r in
                               (b.split("=", 1) for b in args.baseline)}}
    sources = {name: copy_csrc(root, OUT / name, SOURCE) for name, root in roots.items()}
    for name, edits in VARIANTS.items():
        sources[name] = copy_csrc(ROOT, OUT / name, SOURCE, edits)
    for name, (line, new) in TIMING_ONLY.items():
        sources[name] = copy_csrc(ROOT, OUT / name, SOURCE)
        text = sources[name].read_text()
        if text.count(line) != 1:
            raise RuntimeError(f"{name}: the line {line!r} is not in {SOURCE} once")
        sources[name].write_text(text.replace(line, new))
    built = build_all(sources)
    record = {"card": smi, "build_s": time.perf_counter() - t0, "builds": {}}
    builds = {}
    for name, (lib, log) in built.items():
        text = (csrc_of(roots[name]) if name in roots else sources[name].parent) / SOURCE
        builds[name] = Build(lib, "int vec4" in text.read_text())
        record["builds"][name] = _usage(log)
        print(json.dumps({"build": name, "ptxas": record["builds"][name]}), flush=True)
    ref = next(iter(roots)) if len(roots) == 1 else list(roots)[1]
    timed = {b for b in builds if b not in TIMING_ONLY}
    differ = []
    for key, fn in (("binned", _binned), ("rows", _rows), ("probes", _probes),
                    ("widths", _widths)):
        record[key] = fn(builds, timed, ref, args.reps, differ)
    record["differ"] = differ
    record["card_after"] = card()
    if args.out:
        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "reorder_steps.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"ok": not differ, "differ": differ, "reference": ref,
                      "seconds": time.perf_counter() - t0, "card": smi}), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
