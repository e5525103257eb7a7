#!/usr/bin/env python3
"""Time sweep_fma (csrc/sweep.cu) and row_sort (csrc/access.cu) against
other builds of them, in turns, on one CUDA card, and hold every build's
outputs to the reference build's in every bit.

    python3 tools/fma_sort_steps.py [--baseline NAME=ROOT ...] [--out DIR] [--reps N]

Builds sweep.cu and access.cu from this checkout ("change") and from the
csrc/ of each ``--baseline`` (ROOT a repository root or a csrc/ directory:
the parent commit unpacked by ``git archive`` under the git-ignored
``_checkout/``, or a copy of a csrc/ with another design written in; a
baseline whose csrc/ lacks one of the two sources is built for the other
alone), and variants of this checkout's tuning constants, one nvcc each,
all started together (tools/variants.py), into
weekend_raytracer_tpu_torch/_build/fma_sort_steps/:

  sweep.cu  the design's steps that this source's constants can set, each
            adding one to the one before:
            step_table     one ray a thread in blocks of 256, 4 blocks an
                           SM, the whole table (kFmaWindow) staged once
                           with 2c, each pair's root tested alone, no split
            step_rays      ... and kFmaRays rays a thread at the fill
            step_unroll    ... and kFmaUnroll spheres' discriminants before
                           their roots (this checkout with no split)
            and "change" adds the split of a ray group over 32 warps at
            the probes' 4,096 rays (split8, split16: over 8 warps of a
            256-thread block, 16 of 512). Tuning: rays2 (2 rays a thread,
            4 blocks an SM), blocks2 (the register budget at kFmaRays),
            narrow_unroll2 (2 spheres' discriminants first at one ray a
            thread). Steps this source no longer holds (16 spheres staged
            between two barriers; c + c in every pair) are baselines.
  access.cu tuning: blocks3 (the register budget and grid), keys8, keys32
            (8 or 32 keys a thread; 32 at 2 blocks an SM),
            shfl_two_compares (a shuffled key's swap from a compare each
            way, as the first design had it); timing only, not held to any
            bits: sort_copy_only (no network: the loads and stores alone),
            sort_no_shuffle (a register in place of each shuffle).

The reference build is the first baseline (else this checkout); it
holds both sources.
sweep_fma: every build's (t, index) at every shape chip_smoke's [sweep]
runs it (probes/mxu_sweep.py's inputs: p5's 32 spheres x 64 passes, p8's
320 in chunks of 32 and p8c16's in chunks of 16 x 16 passes, window's 1024
x 1 pass, and fill's 2,097,152 rays x RTiOW's 496 spheres in chunks of 16
and in one chunk) must equal the reference's in every bit, and this
checkout's is held to the twin (``hold_sweep``: no ray parted at the
probes' shapes, at most FILL_WRONG_SHARE at the fill). row_sort: every
build's output on p3's (8, 128) input, the fill keys (2^24) and the edge
keys (probes/place.py ``edge_keys``, at 4,096 and at 131,072 rows) must
equal the reference's and the twin's in every bit, each row a permutation
of its input. Then each kernel is timed at each shape by CUDA events (the
mean of REPS launches after a warm one), the builds in order, in reverse,
in order and in reverse; at the probes' shapes also by device time under
the profiler (kept only from traces that recorded every event). At the
fill, sweep_mma TF32 from this checkout and torch.sort join the turns.

Prints the card's name and power limit, one JSON line per build (ptxas
registers and spills of its sweep_fma or row_sort instantiations) and one
per case; with ``--out``, also the SASS of this checkout's and each
baseline's sweep_fma and row_sort (cuobjdump). Exits 1 if any output of a
build not named by ``--timing-only`` (or timing-only by design) differs.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from variants import LIB, build_all, copy_csrc, csrc_of  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import access as ac  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import build  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import sweep as sw  # noqa: E402
from weekend_raytracer_tpu_torch.probes import card, device_times, same_bits, time_mean  # noqa: E402
from weekend_raytracer_tpu_torch.probes import mxu_sweep as ms  # noqa: E402
from weekend_raytracer_tpu_torch.probes import place  # noqa: E402

OUT = build.BUILD_DIR / "fma_sort_steps"
REPS = 20  # launches a timing averages
DEVICE_REPS = 10  # calls a device time traces
# one ray a thread in blocks of 256, 4 blocks an SM, the table staged once
# with 2c, a pair's root tested alone, no split
_STEP_TABLE = {"kFmaRays": 1, "kFmaBlocks": 4, "kFmaNarrowThreads": 256, "kFmaBlocksNarrow": 4,
               "kFmaMaxSplits": 1, "kFmaUnroll": 1}
SWEEP_VARIANTS = {
    "step_table": _STEP_TABLE,
    "step_rays": {"kFmaMaxSplits": 1, "kFmaUnroll": 1},
    "step_unroll": {"kFmaMaxSplits": 1},
    "split8": {"kFmaNarrowThreads": 256, "kFmaBlocksNarrow": 4, "kFmaMaxSplits": 8},
    "split16": {"kFmaNarrowThreads": 512, "kFmaBlocksNarrow": 2, "kFmaMaxSplits": 16},
    "rays2": {"kFmaRays": 2, "kFmaBlocks": 4},
    "blocks2": {"kFmaBlocks": 2},
    "narrow_unroll2": {"kFmaUnrollNarrow": 2},
}
SORT_VARIANTS = {"blocks3": {"kSortBlocks": 3}, "keys8": {"kSortKeys": 8},
                 "keys32": {"kSortKeys": 32, "kSortBlocks": 2}}
# builds of access.cu with a line of the source replaced: (line, its
# replacement); held to the reference's bits
SORT_EDITS = {
    "shfl_two_compares": ("          v[q] = a < b ? pv : v[q];",
                          "          v[q] = (keep_min ? pv < v[q] : v[q] < pv) ? pv : v[q];"),
}
# and timing-only ones, not held to any bits
SORT_TIMING_ONLY = {
    "sort_copy_only": ("for (int ks = 1; ks <= 7; ++ks) {",
                       "for (int ks = 1; ks <= 0; ++ks) {"),
    "sort_no_shuffle": ("const float pv = __shfl_xor_sync(kFull, v[q], tj);",
                        "const float pv = v[q ^ 1];"),
}
# sweep_fma's shapes: (probes/mxu_sweep.py mma_inputs' name, chunk)
FMA_SHAPES = {"p5": ("p5_p7", 32), "p8": ("p8", ms.P8["cs"]), "p8c16": ("p8c16", 16),
              "window": ("window", ms.WINDOW["cs"]), "fill": ("fill", ms.FILL["cs"]),
              "fill_one_chunk": ("fill", None)}
FMA_TIMED = ("fill", "p5", "p8", "p8c16")
FMA_DEVICE = ("p5", "p8", "p8c16")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _fma(lib, table, planes, chunk, iters, out=None):
    t, i = out if out is not None else sw._outputs(planes)
    err = lib.wrt_sweep_fma(table.data_ptr(), table.shape[0], chunk, planes.data_ptr(),
                            planes.shape[1], iters, t.data_ptr(), i.data_ptr(), _stream())
    if err:
        raise RuntimeError(f"wrt_sweep_fma: CUDA error {err}")
    return t, i


def _sort(lib, x, out=None):
    out = out if out is not None else torch.empty_like(x)
    err = lib.wrt_row_sort(x.data_ptr(), x.shape[0], out.data_ptr(), _stream())
    if err:
        raise RuntimeError(f"wrt_row_sort: CUDA error {err}")
    return out


def _turns(fns: dict, reps: int, rounds: int = 2) -> dict:
    """{name: [ms, ...]}: each the mean of ``reps`` calls in a row after a
    warm one (``probes.time_mean``, CUDA events), the functions in order and
    then in reverse, ``rounds`` times."""
    out = {k: [] for k in fns}
    for _ in range(rounds):
        for k in list(fns) + list(fns)[::-1]:
            out[k].append(time_mean(fns[k], reps, "cuda"))
    return out


def _whole_device_ms(fns: dict, several=()) -> dict:
    """Device ms of each function from traces that kept every event."""
    got = device_times(fns, DEVICE_REPS, "cuda", several=several) or {}
    return {k: v["device_ms"] for k, v in got.items() if v["device_ms_by"] == "profiler"}


def _sweep(libs: dict, ref: str, reps: int, mma_lib) -> dict:
    inputs = {name: ms.mma_inputs(name, "cuda") for name in set(n for n, _ in
                                                                FMA_SHAPES.values())}
    record, differ = {}, []
    for shape, (name, chunk) in FMA_SHAPES.items():
        _, table, planes, iters = inputs[name]
        chunk = chunk or table.shape[0]
        want = _fma(libs[ref], table, planes, chunk, iters)
        for build_name, lib in libs.items():
            got = _fma(lib, table, planes, chunk, iters)
            torch.cuda.synchronize()
            if not (same_bits(got[0], want[0]) and torch.equal(got[1], want[1])):
                parted = int(((got[0].view(torch.int32) != want[0].view(torch.int32))
                              | (got[1] != want[1])).sum())
                differ.append((build_name, shape, parted))
        share = ms.FILL_WRONG_SHARE if name == "fill" else 0.0
        try:
            record[f"twin_{shape}"] = ms.hold_sweep(
                _fma(libs["change"], table, planes, chunk, iters),
                sw.sweep_plain(table, planes, "fma"), table, planes, ("twin", shape), share)
        except AssertionError as e:
            differ.append(("change", shape, f"twin: {e}"[:300]))
    record["bits"] = {"reference": ref, "differ": differ, "shapes": list(FMA_SHAPES),
                      "builds": list(libs)}
    print(json.dumps({"case": "sweep_fma_bits", **record["bits"]}), flush=True)
    for shape in FMA_TIMED:
        name, chunk = FMA_SHAPES[shape]
        amats, table, planes, iters = inputs[name]
        outs = sw._outputs(planes)
        fns = {b: (lambda lib=lib: _fma(lib, table, planes, chunk, iters, outs))
               for b, lib in libs.items()}
        if shape == "fill":
            fns["sweep_mma_tf32"] = lambda: _mma_tf32(mma_lib, amats, planes, outs)
        case = {"ms": _turns(fns, reps),
                "bound_ms": ms.fma_bound(table.shape[0], planes.shape[1], iters,
                                         ms.real_root_pairs(table, planes))["bound_ms"]}
        if shape in FMA_DEVICE:
            case["device_ms"] = _whole_device_ms(fns)
        record[f"sweep_fma_{shape}"] = case
        print(json.dumps({"case": f"sweep_fma_{shape}", **case}), flush=True)
    return record


def _mma_tf32(lib, amats, planes, out):
    t, i = out
    err = lib.wrt_sweep_mma(amats.data_ptr(), amats.shape[0], amats.shape[2] // 2,
                            planes.data_ptr(), 0, planes.shape[1], 1,
                            sw.PRECISIONS.index("tf32"), t.data_ptr(), i.data_ptr(), _stream())
    if err:
        raise RuntimeError(f"wrt_sweep_mma: CUDA error {err}")


def _sort_inputs() -> dict:
    dev = "cuda"
    probe = np.random.default_rng(0).integers(0, 128, size=(8, 128)).astype(np.float32)
    return {"probe": place.dev(probe, dev),
            "fill": place.dev(place.fill_keys(place.FILL_ROWS), dev),
            "edge": place.dev(place.edge_keys(), dev),
            "edge_fill": place.dev(place.edge_keys(place.FILL_ROWS, seed=1), dev)}


def _row_sort(libs: dict, ref: str, reps: int) -> dict:
    cases = _sort_inputs()
    record, differ = {}, []
    for case, x in cases.items():
        want = _sort(libs[ref], x)
        twin = ac.row_sort_plain(x)
        keys = np.sort(x.cpu().numpy().view(np.uint32), axis=1)
        for name, lib in libs.items():
            got = _sort(lib, x)
            torch.cuda.synchronize()
            perm = bool((np.sort(got.cpu().numpy().view(np.uint32), axis=1) == keys).all())
            if not (same_bits(got, want) and same_bits(got, twin) and perm):
                differ.append((name, case, same_bits(got, want), same_bits(got, twin), perm))
    record["bits"] = {"reference": ref, "differ": differ, "cases": list(cases),
                      "builds": list(libs)}
    print(json.dumps({"case": "row_sort_bits", **record["bits"]}), flush=True)
    for case in ("fill", "probe"):
        x = cases[case]
        out = torch.empty_like(x)
        fns = {name: (lambda lib=lib: _sort(lib, x, out)) for name, lib in libs.items()}
        fns["torch_sort"] = lambda: torch.sort(x, 1).values
        rec = {"ms": _turns(fns, reps),
               "bound_ms": place.byte_bound(2 * place.nbytes(x),
                                            place.SORT_OPS_PER_KEY * x.numel())["bound_ms"],
               "device_ms": _whole_device_ms(fns, several=("torch_sort",))}
        record[f"row_sort_{case}"] = rec
        print(json.dumps({"case": f"row_sort_{case}", **rec}), flush=True)
    return record


def _usage(log: str, kernel: str) -> dict:
    return {k[k.index(kernel):][:len(kernel) + 16]: v for k, v in build.parse_ptxas(log).items()
            if kernel in k}


def _sass(lib_path: pathlib.Path, kernel: str) -> str:
    """The SASS of the functions of ``lib_path`` whose name holds ``kernel``
    (cuobjdump), or why there is none."""
    tool = shutil.which("cuobjdump") or str(pathlib.Path(build.find_nvcc()).parent / "cuobjdump")
    try:
        text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                              timeout=300).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"cuobjdump failed: {e!r}"
    parts = text.split("Function : ")
    return "".join("Function : " + p for p in parts[1:] if kernel in p.splitlines()[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", action="append", default=[], metavar="NAME=ROOT")
    ap.add_argument("--out", default=None)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--timing-only", action="append", default=[], metavar="NAME",
                    help="a build timed but not held to the reference's bits")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fma_sort_steps: no CUDA device", file=sys.stderr)
        return 2
    smi = card()
    print(smi, flush=True)
    t0 = time.perf_counter()
    roots = {"change": ROOT, **{name: pathlib.Path(r) for name, r in
                               (b.split("=", 1) for b in args.baseline)}}
    sources = {}
    for name, root in roots.items():
        for src in ("sweep.cu", "access.cu"):
            if (csrc_of(root) / src).is_file():
                sources[(src, name)] = copy_csrc(root, OUT / f"{name}_{src[:-3]}", src)
    for variants, src in ((SWEEP_VARIANTS, "sweep.cu"), (SORT_VARIANTS, "access.cu")):
        for name, edits in variants.items():
            sources[(src, name)] = copy_csrc(ROOT, OUT / f"{name}_{src[:-3]}", src, edits)
    for name, (line, new) in {**SORT_EDITS, **SORT_TIMING_ONLY}.items():
        path = copy_csrc(ROOT, OUT / f"{name}_access", "access.cu")
        text = path.read_text()
        if text.count(line) != 1:
            raise RuntimeError(f"{name}: the line {line!r} is not in access.cu once")
        path.write_text(text.replace(line, new))
        sources[("access.cu", name)] = path
    built = build_all(sources)
    record = {"card": smi, "build_s": time.perf_counter() - t0, "builds": {}}
    libs = {"sweep.cu": {}, "access.cu": {}}
    order = list(roots)[1:] + list(roots)[:1]  # the reference first in every turn
    for (src, name), (lib, log) in sorted(built.items(), key=lambda kv: (
            kv[0][0], order.index(kv[0][1]) if kv[0][1] in order else len(order))):
        (sw if src == "sweep.cu" else ac).bind(lib)
        libs[src][name] = lib
        kernel = "sweep_fma" if src == "sweep.cu" else "row_sort"
        record["builds"][f"{name}:{src}"] = _usage(log, kernel)
        print(json.dumps({"build": name, "source": src, "ptxas": _usage(log, kernel)}),
              flush=True)
        if args.out and name in roots:
            out = pathlib.Path(args.out)
            out.mkdir(parents=True, exist_ok=True)
            (out / f"sass_{kernel}_{name}.txt").write_text(
                _sass(sources[(src, name)].parent / LIB, kernel))
    ref = next(iter(roots)) if len(roots) == 1 else list(roots)[1]
    record["sweep_fma"] = _sweep(libs["sweep.cu"], ref, args.reps, libs["sweep.cu"]["change"])
    record["row_sort"] = _row_sort(libs["access.cu"], ref, args.reps)
    record["card_after"] = card()
    if args.out:
        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "fma_sort_steps.json").write_text(json.dumps(record, indent=1))
    differ = [d for d in record["sweep_fma"]["bits"]["differ"]
              + record["row_sort"]["bits"]["differ"]
              if d[0] not in args.timing_only and d[0] not in SORT_TIMING_ONLY]
    print(json.dumps({"ok": not differ, "seconds": time.perf_counter() - t0, "card": smi}),
          flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
