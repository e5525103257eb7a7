#!/usr/bin/env python3
"""Time sweep_mma (csrc/sweep.cu) and table_gather (csrc/access.cu) against
other builds of them, in turns, on one CUDA card, and hold every build's
outputs to the reference build's in every bit.

    python3 tools/sweep_steps.py [--baseline NAME=ROOT ...] [--out DIR] [--reps N]

Builds sweep.cu and access.cu from this checkout ("change") and from the
csrc/ of each ``--baseline`` (ROOT a repository root or a csrc/ directory,
e.g. the parent commit unpacked by ``git archive`` under the git-ignored
``_checkout/``, or a copy of this checkout's csrc/ with another design
choice written in), and variants of this checkout's tuning constants, one
nvcc each, all started together (tools/variants.py), into
weekend_raytracer_tpu_torch/_build/sweep_steps/:

  sweep.cu    blocks_up    a register budget of one block an SM more at
                           each precision (the source: 3 TF32, 2 3xTF32)
              blocks0      no minimum of blocks an SM
              rays32       four 8-ray tiles a warp where rays fill the
                           card, 2 blocks an SM at TF32 (kWideTiles; the
                           source: 2)
  access.cu   threads512, threads1024   table_gather's block (the source: 256)
              sort_all, sort8, unsorted   the lanes sorted by offset from
                           spans of 1 or 8 rows, or never (kSortMinSpan;
                           the source: 4)

The reference build is the first baseline (else this checkout). sweep_mma:
every build's (t, index) at every shape chip_smoke's [sweep] runs, made by
probes/mxu_sweep.py's ``mma_inputs`` (p5/p7's 32 spheres x 64 passes, p8's
10 chunks of 32 and p8c16's 20 of 16 x 16 passes, window's 64 tiles,
fill's 2,097,152 rays x RTiOW's 496 spheres), at TF32 and 3xTF32, from the planes and from the packed B, must equal the
reference build's in every bit. Then every build is timed at fill and p8,
both precisions and both layouts, with CUDA events (the mean of REPS
launches after a warm one), the builds in order and then in reverse; at
fill, this checkout's sweep_fma joins the turns; at p8 also the device
time under the profiler.

table_gather: every access build's routes on probes/gather_cost.py's
cases (``probe_indices``: 512 tiles, spans 1-16; ``fill_cases``: 4,096
tiles; ``texture_cases``: the 2,048-row pool's whole span; ``edge_cases``:
spans longer than the table, 24 and 100 rows, negative indices, tiles near
and spread over 2^31, n_fetch 0 and 1) must equal table_gather_plain's in
every bit (the twin stands for the reference build). Then each is timed at
512 tiles (spans 1 and 16) and 4,096 tiles in turns, and its device time
taken under the profiler (kept only from traces that recorded every
event).

Prints the card's name and power limit, one JSON line per build (ptxas
registers and spills of its sweep_mma or table_gather instantiations) and
one per case; exits 1 if any output of a build not named by
``--timing-only`` differs. A parent from before 2^31-span tiles were
repaired parts from the twin on ``edge_cases``' "top" tiles ("shared"):
name it with ``--timing-only``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from variants import build_all, copy_csrc  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import access as ac  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import build  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import sweep as sw  # noqa: E402
from weekend_raytracer_tpu_torch.probes import (card, device_times, same_bits,  # noqa: E402
                                                time_mean)
from weekend_raytracer_tpu_torch.probes import gather_cost as gc  # noqa: E402
from weekend_raytracer_tpu_torch.probes import mxu_sweep as ms  # noqa: E402

OUT = build.BUILD_DIR / "sweep_steps"
REPS = 20  # launches a timing averages
DEVICE_REPS = 10  # calls a device time traces
SWEEP_VARIANTS = {"blocks_up": {"kMmaBlocksTf32": 4, "kMmaBlocks3x": 3},
                  "blocks0": {"kMmaBlocksTf32": 0, "kMmaBlocks3x": 0},
                  "rays32": {"kWideTiles": 4, "kMmaBlocksTf32": 2}}
GATHER_VARIANTS = {"threads512": {"kGatherThreads": 512},
                   "threads1024": {"kGatherThreads": 1024},
                   "sort_all": {"kSortMinSpan": 1}, "sort8": {"kSortMinSpan": 8},
                   "unsorted": {"kSortMinSpan": 1 << 30}}
PRECS = ("tf32", "3xtf32")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _mma(lib, amats, rays, prec, iters=1, out=None):
    t, i = out if out is not None else sw._outputs(rays)
    err = lib.wrt_sweep_mma(amats.data_ptr(), amats.shape[0], amats.shape[2] // 2,
                            rays.data_ptr(), int(rays.shape[0] == 8), rays.shape[1], iters,
                            sw.PRECISIONS.index(prec), t.data_ptr(), i.data_ptr(), _stream())
    if err:
        raise RuntimeError(f"wrt_sweep_mma: CUDA error {err}")
    return t, i


def _fma(lib, table, planes, chunk, out):
    t, i = out
    err = lib.wrt_sweep_fma(table.data_ptr(), table.shape[0], chunk, planes.data_ptr(),
                            planes.shape[1], 1, t.data_ptr(), i.data_ptr(), _stream())
    if err:
        raise RuntimeError(f"wrt_sweep_fma: CUDA error {err}")


def _gather(lib, tab, idx, span, route, n_fetch=ac.N_FETCH, out=None):
    out = out if out is not None else torch.empty(idx.shape, dtype=torch.float32,
                                                  device=idx.device)
    err = lib.wrt_table_gather(tab.data_ptr(), tab.shape[0], idx.data_ptr(),
                               idx.shape[0] // ac.TILE_ROWS, span, n_fetch,
                               ac.GATHER_ROUTES.index(route), out.data_ptr(), _stream())
    if err:
        raise RuntimeError(f"wrt_table_gather ({route}): CUDA error {err}")
    return out


def _turns(fns: dict, reps: int) -> dict:
    """{name: [ms in order, ms in reverse]}: each the mean of ``reps`` calls
    in a row after a warm one (``probes.time_mean``, CUDA events)."""
    out = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        out[k].append(time_mean(fns[k], reps, "cuda"))
    return out


def _whole_device_ms(fns: dict) -> dict:
    """Device ms of each function from traces that kept every event."""
    got = device_times(fns, DEVICE_REPS, "cuda", several=tuple(fns)) or {}
    return {k: v["device_ms"] for k, v in got.items() if v["device_ms_by"] == "profiler"}


def _sweep(libs: dict, ref: str, reps: int) -> dict:
    shapes = {name: ms.mma_inputs(name, "cuda") for name in ms.MMA_INPUTS}
    record, differ = {}, []
    for shape, (amats, _, planes, iters) in shapes.items():
        for prec in PRECS:
            for layout, rays in (("planes", planes), ("packed", sw.packed_b(planes))):
                want = _mma(libs[ref], amats, rays, prec, iters)
                for name, lib in libs.items():
                    got = _mma(lib, amats, rays, prec, iters)
                    torch.cuda.synchronize()
                    if not (same_bits(got[0], want[0]) and torch.equal(got[1], want[1])):
                        differ.append((name, shape, prec, layout))
    record["bits"] = {"reference": ref, "differ": differ,
                      "shapes": list(shapes), "builds": list(libs)}
    print(json.dumps({"case": "sweep_mma_bits", **record["bits"]}), flush=True)
    _, table, planes, _ = shapes["fill"]
    for shape in ("fill", "p8"):
        amats, _, planes_s, iters = shapes[shape]
        for prec in PRECS:
            for layout, rays in (("planes", planes_s), ("packed", sw.packed_b(planes_s))):
                outs = sw._outputs(rays)
                fns = {name: (lambda lib=lib: _mma(lib, amats, rays, prec, iters, outs))
                       for name, lib in libs.items()}
                if shape == "fill" and layout == "planes":
                    fns["sweep_fma"] = lambda: _fma(libs["change"], table, planes,
                                                    ms.FILL["cs"], outs)
                case = {"ms": _turns(fns, reps)}
                if shape == "p8":
                    case["device_ms"] = _whole_device_ms(fns)
                key = f"sweep_mma_{shape}_{prec}_{layout}"
                record[key] = case
                print(json.dumps({"case": key, **case}), flush=True)
    return record


def _gather_cases() -> dict:
    """{name: (table, indices, span, n_fetch)} of probes/gather_cost.py's
    cases: the timed ones first."""
    dev = "cuda"
    arange = ms._dev(np.arange(gc.PROBE["table_rows"] * 128, dtype=np.float32).reshape(-1, 128),
                     dev)
    out = {f"tiles512_span{span}": (arange, torch.as_tensor(idx, device=dev), span, ac.N_FETCH)
           for span, idx in gc.probe_indices().items()}
    out.update({f"tiles4096_span{span}": (arange, idx, span, ac.N_FETCH)
                for span, idx in gc.fill_cases(dev).items()})
    _, pool, spans = gc.texture_cases(dev)[2048]
    out["pool2048_whole"] = (pool, spans[2048], 2048, ac.N_FETCH)
    out.update(gc.edge_cases(dev))
    return out


TIMED_GATHER = ("tiles512_span1", "tiles512_span16",
                *(f"tiles4096_span{s}" for s in gc.PROBE["spans"]))


def _table_gather(libs: dict, ref: str, reps: int) -> dict:
    cases = _gather_cases()
    record, differ = {}, []
    for case, (tab, idx, span, n_fetch) in cases.items():
        for route in gc.routes_for(span):
            want = ac.table_gather_plain(tab, idx, span, n_fetch, route)
            for name, lib in libs.items():
                try:
                    got = _gather(lib, tab, idx, span, route, n_fetch)
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    differ.append((name, case, route, str(e)))
                    continue
                if not same_bits(got, want):
                    differ.append((name, case, route, "twin"))
    record["bits"] = {"reference": ref, "differ": differ, "cases": list(cases),
                      "builds": list(libs)}
    print(json.dumps({"case": "table_gather_bits", **record["bits"]}), flush=True)
    for case in TIMED_GATHER:
        tab, idx, span, n_fetch = cases[case]
        out = torch.empty(idx.shape, dtype=torch.float32, device="cuda")
        for route in gc.routes_for(span):
            fns = {name: (lambda lib=lib: _gather(lib, tab, idx, span, route, n_fetch, out))
                   for name, lib in libs.items()}
            rec = {"ms": _turns(fns, reps), "device_ms": _whole_device_ms(fns),
                   "bound_ms": gc.gather_bound(tab, idx, gc.smem_rate("cuda"))["bound_ms"]}
            key = f"table_gather_{case}_{route}"
            record[key] = rec
            print(json.dumps({"case": key, **rec}), flush=True)
    return record


def _usage(log: str, kernel: str) -> dict:
    return {k[k.index(kernel):][:len(kernel) + 16]: v for k, v in build.parse_ptxas(log).items()
            if kernel in k}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", action="append", default=[], metavar="NAME=ROOT")
    ap.add_argument("--out", default=None)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--timing-only", action="append", default=[], metavar="NAME",
                    help="a baseline timed but not held to the reference's bits or the "
                         "twin's (a step that computes something else, e.g. with no roots, "
                         "or a parent with a fault since repaired)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_steps: no CUDA device", file=sys.stderr)
        return 2
    smi = card()
    print(smi, flush=True)
    t0 = time.perf_counter()
    roots = {"change": ROOT, **{name: pathlib.Path(r) for name, r in
                               (b.split("=", 1) for b in args.baseline)}}
    sources = {}
    for name, root in roots.items():
        for src in ("sweep.cu", "access.cu"):
            sources[(src, name)] = copy_csrc(root, OUT / f"{name}_{src[:-3]}", src)
    for variants, src in ((SWEEP_VARIANTS, "sweep.cu"), (GATHER_VARIANTS, "access.cu")):
        for name, edits in variants.items():
            sources[(src, name)] = copy_csrc(ROOT, OUT / name, src, edits)
    built = build_all(sources)
    record = {"card": smi, "build_s": time.perf_counter() - t0, "builds": {}}
    libs = {"sweep.cu": {}, "access.cu": {}}
    for (src, name), (lib, log) in built.items():
        (sw if src == "sweep.cu" else ac).bind(lib)
        libs[src][name] = lib
        kernel = "sweep_mma" if src == "sweep.cu" else "table_gather"
        record["builds"][f"{name}:{src}"] = _usage(log, kernel)
        print(json.dumps({"build": name, "source": src, "ptxas": _usage(log, kernel)}),
              flush=True)
    ref = next(iter(roots)) if len(roots) == 1 else list(roots)[1]
    record["sweep_mma"] = _sweep(libs["sweep.cu"], ref, args.reps)
    record["table_gather"] = _table_gather(libs["access.cu"], ref, args.reps)
    record["card_after"] = card()
    if args.out:
        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "sweep_steps.json").write_text(json.dumps(record, indent=1))
    differ = [d for d in record["sweep_mma"]["bits"]["differ"]
              + record["table_gather"]["bits"]["differ"] if d[0] not in args.timing_only]
    print(json.dumps({"ok": not differ, "seconds": time.perf_counter() - t0, "card": smi}),
          flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
