#!/usr/bin/env python3
"""Time the stats kernels (csrc/megakernel.cu ``megakernel_stats``,
csrc/regroup.cu ``regroup_k1_stats``) against other builds of them, in
turns, on one CUDA card.

    python3 tools/stats_steps.py [--baseline NAME=ROOT ...] [--variants] [--out DIR]

Builds megakernel.cu and regroup.cu from this checkout's csrc/ and from
the csrc/ of each ``--baseline`` checkout (ROOT is a repository root, or a
directory holding its weekend_raytracer_tpu_torch/csrc/, under the
git-ignored ``_checkout/``: e.g. the parent commit unpacked by ``git
archive``, or a step of the design), one nvcc each, all started together,
into weekend_raytracer_tpu_torch/_build/stats_steps/. Their stats entry
points take the same arguments in every tree. ``--variants`` also builds
this csrc/ with the design's tuning constants changed:

  unroll4, unroll8   four or eight spheres' discriminants before any root
                     (the source: kStatsUnroll = 2)
  whole3             the register budget of the instantiations that stage
                     the table whole at 3 blocks of 256 threads an SM (the
                     source: kStatsMinBlocks = 4, up to 64 registers)
  windowed4          that of the windowed ones at 4 (the source:
                     kWindowedMinBlocks = 3, up to 80 registers)

The stats megakernel renders RTiOW 1920x1080 at 4 and 32 spp, the chip
smoke's [timing] shape (RTiOW 480x270 x 4 spp), random_spheres(10000) at
3840x2160 x 4 spp, random_spheres(60000) at 1920x1080 x 1 spp (boxes in
global memory), the first-hit scene (no chunks, one bounce) and the
textured scene (no chunks) at 1920x1080 x 4 spp, and the super-chunk case
(random_spheres(1200) at 256x128 x 4 spp in 75 chunks of 16 and 5
super-chunks), 8 bounces, frame 0. K1's stats kernel runs bounces [2, 4)
of RTiOW 1920x1080 x 32 spp and of the [timing] shape, and the binned
probe's [3, 8) of RTiOW 1920x1080 x 4 spp, on the dense pool of K0 and
PACK (this checkout's). Every build's image and counter table (K1: its
table, pool and radiance) must equal this checkout's in every bit. Then
every build is timed on every case with CUDA events around one launch, the
least of REPS launches after a warm one (K1 on a fresh copy of the pool
each, the copy untimed): the builds in order, then in the reverse order.

Each case's bound is probes.stats_bound on this run's data: the live path
segments (the megakernel: the real pixels' paths alive at the start of
each bounce, K0 run to each depth, which is its table's col 1 less the
padded lanes' weight; K1: its table's col 1) and the pairs of those
segments with a real root (chip_smoke._real_root_pairs). Prints the card's
name and power limit, one JSON line per build (registers and spills of
the stats kernels from ptxas) and one per case (ms per build and turn,
bound and share).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from chip_smoke import (_CUTS, RECORD_BYTES, _case, _dense_pool, _live_per_bounce,  # noqa: E402
                        _nvidia_smi, _real_root_pairs, _stats_inputs)
from variants import copy_csrc, csrc_of, finish, set_constant, start  # noqa: E402
from weekend_raytracer_tpu_torch.ops import rng  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import build  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import megakernel as mk  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import regroup as rg  # noqa: E402
from weekend_raytracer_tpu_torch.probes import binned, stats_bound  # noqa: E402

OUT = build.BUILD_DIR / "stats_steps"
BOUNCES = 8
REPS = 2  # launches timed a build, a case and a turn
# name: (scene, width, height, spp, bounces) of the stats megakernel
MK_CASES = {"rtiow_1080p_spp4": ("rtiow", 1920, 1080, 4, BOUNCES),
            "rtiow_1080p_spp32": ("rtiow", 1920, 1080, 32, BOUNCES),
            "timing_480x270_spp4": ("rtiow", 480, 270, 4, BOUNCES),
            "random10k_4k_spp4": ("random10k", 3840, 2160, 4, BOUNCES),
            "random60k_1080p_spp1": ("random60k", 1920, 1080, 1, BOUNCES),
            "first_hit_1080p_spp4": ("first_hit", 1920, 1080, 4, 1),
            "textured_1080p_spp4": ("textured", 1920, 1080, 4, BOUNCES),
            "super_256x128_spp4": ("super", 256, 128, 4, BOUNCES)}
# name: (scene, width, height, spp, b_lo, b_hi) of K1's stats kernel
K1_CASES = {"k1_rtiow_1080p_spp32": ("rtiow", 1920, 1080, 32, _CUTS[0], _CUTS[1]),
            "k1_timing_480x270_spp4": ("rtiow", 480, 270, 4, _CUTS[0], _CUTS[1]),
            "k1_binned_1080p_spp4": ("rtiow", *binned.SHAPES["rtiow"], binned.SPP, binned.CUT,
                                     binned.BOUNCES)}
# name: {csrc file: {constant: value}} edits of this checkout's csrc/
_WHOLE3 = {f: {"kStatsMinBlocks": 3} for f in ("megakernel.cu", "regroup.cu")}
_WINDOWED4 = {f: {"kWindowedMinBlocks": 4} for f in ("megakernel.cu", "regroup.cu")}
VARIANTS = {"unroll4": {"bounce.cuh": {"kStatsUnroll": 4}},
            "unroll8": {"bounce.cuh": {"kStatsUnroll": 8}},
            "whole3": _WHOLE3,
            "windowed4": _WINDOWED4}
LIBS = ("megakernel.cu", "regroup.cu")


def _trees(roots: dict, variants: bool) -> dict:
    """{build: {library source: its path in a fresh copy of the build's csrc/}}."""
    edits_of = {name: {} for name in roots}
    roots = dict(roots)
    if variants:
        edits_of.update(VARIANTS)
        roots.update({name: ROOT for name in VARIANTS})
    out = {}
    for name, root in roots.items():
        out[name] = {}
        for source in LIBS:
            path = copy_csrc(root, OUT / f"{name}_{source.split('.')[0]}", source)
            for file, consts in edits_of[name].items():
                f = path.parent / file
                text = f.read_text()
                for const, value in consts.items():
                    text = set_constant(text, const, value)
                f.write_text(text)
            out[name][source] = path
    return out


def _bind(lib):
    """``lib`` with its stats entry points' argument types set."""
    vp, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    ll = ctypes.c_longlong
    sigs = {"wrt_megakernel_stats_launch": [vp, vp, vp, vp, vp, vp, i, i, i, f, f, u, u, i, i, i],
            "wrt_regroup_k1_stats": [vp] * 4 + [i, vp, vp, vp, ll, i, i, i, i, u, u, i, i]}
    for name, head in sigs.items():
        if hasattr(lib, name):  # each library holds one of the two
            fn = getattr(lib, name)
            fn.argtypes = head + mk.CULL_ARGTYPES + [vp, ll, vp, vp]
            fn.restype = i
    return lib


def _ptxas(built_mk, built_rg) -> dict:
    """Registers and spills of a build's stats kernels (the parent's have
    kStats as a template argument of megakernel and regroup_k1)."""
    out = {}
    for log, lib in ((built_mk[1], "megakernel"), (built_rg[1], "regroup_k1")):
        for k, v in build.parse_ptxas(log).items():
            if "stats_finish" in k:
                continue
            if f"{lib}_stats" in k or re.match(r"\dELb1ELb\d", k.split(f"{lib}ILb")[-1]):
                name = k[k.rindex(lib):]
                out[name[:name.index("EEEv") + 3] if "EEEv" in name else name] = v
    return out


def _stats_launch(lib, inp, acc, scratch, words, table, w, h, spp, bounces) -> None:
    err = lib.wrt_megakernel_stats_launch(
        inp.cam.data_ptr(), inp.sky.data_ptr(), inp.sweep.data_ptr(), inp.attrs.data_ptr(),
        None if inp.tex_pool is None else inp.tex_pool.data_ptr(), acc.data_ptr(),
        inp.n_spheres, w, h, float(np.float32(1.0 / w)), float(np.float32(1.0 / h)),
        0 & rng.MASK32, 0, 1, spp, bounces, *mk.cull_args(inp, acc.device),
        scratch.data_ptr(), words, table.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"megakernel stats launch failed: CUDA error {err}")


def _k1_launch(lib, inp, t, pool, r8, counts, scratch, words, table, b_lo, b_hi) -> None:
    err = lib.wrt_regroup_k1_stats(
        inp.sky.data_ptr(), inp.sweep.data_ptr(), inp.attrs.data_ptr(),
        None if inp.tex_pool is None else inp.tex_pool.data_ptr(), inp.n_spheres,
        pool.data_ptr(), r8.data_ptr(), counts.data_ptr() + 4, t.cap, t.width, t.height,
        t.tiles_x, t.spp_shift, 0, t.row_offset & rng.MASK32, b_lo, b_hi,
        *mk.cull_args(inp, pool.device), scratch.data_ptr(), words, table.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K1 stats launch failed: CUDA error {err}")


def _ms(fn, reps: int, setup=None) -> float:
    """The least CUDA-event time of ``fn`` over ``reps`` launches after a
    warm one; ``setup`` runs untimed before each."""
    best = float("inf")
    for k in range(reps + 1):
        if setup:
            setup()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        if k:
            best = min(best, a.elapsed_time(b))
    return best


def _mk_case(name, scene, w, h, spp, bounces):
    """A megakernel case: its inputs, buffers, launch and bound's data."""
    dev = torch.device("cuda")
    inp = (_stats_inputs(mk, "super", w, h, dev) if scene == "super"
           else mk.kernel_inputs(*_case(scene, w, h, dev)))
    n_tiles = mk.stats_tiles(w, h)
    words = mk.stats_scratch_words(n_tiles * spp, bounces, inp)
    bufs = dict(acc=torch.zeros((w * h, 3), device=dev),
                scratch=torch.empty((words,), dtype=torch.int32, device=dev),
                table=torch.empty((n_tiles, 8), device=dev))
    t, _ = rg.plan(w, h, spp, max(bounces, 2), (1,))
    segments = float(sum(_live_per_bounce(rg, inp, t, 0, bounces)[1]))
    kept = _real_root_pairs(rg, inp, t, 0, 0, bounces, real_only=True)
    run = lambda lib: _stats_launch(lib, inp, bufs["acc"], bufs["scratch"], words,  # noqa: E731
                                    bufs["table"], w, h, spp, bounces)
    out = lambda: (bufs["acc"].clone(), bufs["table"].clone())  # noqa: E731
    nbytes = w * h * 12 + n_tiles * 32
    return inp, run, out, None, segments, kept, nbytes


def _k1_case(name, scene, w, h, spp, b_lo, b_hi):
    """A K1 case: its inputs, dense pool, launch and bound's data."""
    dev = torch.device("cuda")
    inp = mk.kernel_inputs(*_case(scene, w, h, dev))
    t, _ = rg.plan(w, h, spp, BOUNCES, (b_lo,))
    dense, counts, n = _dense_pool(rg, inp, t, 0, b_lo)
    n_tiles = t.cap // rg.TILE_RECORDS
    words = mk.stats_scratch_words(n_tiles, b_hi - b_lo, inp)
    bufs = dict(pool=dense.clone(), r8=torch.empty((3, t.cap), device=dev),
                scratch=torch.empty((words,), dtype=torch.int32, device=dev),
                table=torch.empty((n_tiles, 8), device=dev))
    run = lambda lib: _k1_launch(lib, inp, t, bufs["pool"], bufs["r8"], counts,  # noqa: E731
                                 bufs["scratch"], words, bufs["table"], b_lo, b_hi)
    setup = lambda: bufs["pool"].copy_(dense)  # noqa: E731
    out = lambda: (bufs["table"].clone(), bufs["pool"][:, :n].clone(),  # noqa: E731
                   bufs["r8"][:, :n].clone())
    kept = _real_root_pairs(rg, inp, t, 0, b_lo, b_hi)
    nbytes = n * (2 * RECORD_BYTES + 12) + n_tiles * 32
    return inp, run, out, setup, None, kept, nbytes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", action="append", default=[], metavar="NAME=ROOT")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stats_steps: no CUDA device", file=sys.stderr)
        return 2
    smi = _nvidia_smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    roots = {"change": ROOT, **{name: pathlib.Path(r)
                                for name, r in (b.split("=", 1) for b in args.baseline)}}
    for name, root in roots.items():
        if not (csrc_of(root) / "megakernel.cu").is_file():
            raise SystemExit(f"stats_steps: {root} holds no csrc/megakernel.cu")
    trees = _trees(roots, args.variants)
    sources = {(name, src): path for name, paths in trees.items() for src, path in paths.items()}
    keyed = {f"{name}|{src}": path for (name, src), path in sources.items()}
    built = finish(keyed, start(keyed))
    builds = {}
    record = {"card": smi, "build_s": time.perf_counter() - t0, "builds": {}, "cases": {}}
    for name in trees:
        mk_lib, rg_lib = (built[f"{name}|{src}"] for src in LIBS)
        builds[name] = {"megakernel": _bind(mk_lib[0]), "regroup": _bind(rg_lib[0])}
        usage = _ptxas(mk_lib, rg_lib)
        record["builds"][name] = {"ptxas": usage}
        print(json.dumps({"build": name, "ptxas": usage}), flush=True)
    cases = {}
    for name, spec in MK_CASES.items():
        cases[name] = ("megakernel", *_mk_case(name, *spec))
    for name, spec in K1_CASES.items():
        cases[name] = ("regroup", *_k1_case(name, *spec))
    for name, (lib_key, inp, run, out, setup, segments, kept, nbytes) in cases.items():
        ref = None
        for bname, libs in builds.items():
            if setup:
                setup()
            run(libs[lib_key])
            torch.cuda.synchronize()
            got = out()
            if ref is None:
                ref = got
                continue
            for a, b in zip(got, ref):
                if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                    raise RuntimeError(f"{bname} on {name}: not this checkout's bits")
        table = ref[0] if lib_key == "regroup" else ref[1]
        if segments is None:
            segments = float(table[:, 1].double().sum())
        bound = stats_bound(segments, kept, nbytes, inp.n_spheres, inp.n_tests, inp.n_super,
                            mk.N_PRIORS if inp.n_chunks else 0)
        record["cases"][name] = {
            "spheres": inp.n_spheres, "chunks": inp.n_chunks, "supers": inp.n_super,
            "plan": mk.stats_plan_of(inp), "vs_change": "bit-exact", "segments": segments,
            "real_root_pairs": kept, "table_col1": float(table[:, 1].double().sum()),
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "ms": {b: [] for b in builds}}
    order = list(builds)
    for turn in (order, order[::-1]):
        for bname in turn:
            for name, (lib_key, _, run, _, setup, *_rest) in cases.items():
                lib = builds[bname][lib_key]
                record["cases"][name]["ms"][bname].append(
                    _ms(lambda: run(lib), REPS, setup))
    for name, rec in record["cases"].items():
        rec["share"] = {b: rec["bound_ms"] / min(v) for b, v in rec["ms"].items()}
        print(json.dumps({"case": name, **rec, "card": smi}), flush=True)
    if args.out:
        out_dir = pathlib.Path(args.out)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "stats_steps.json").write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
