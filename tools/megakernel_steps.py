#!/usr/bin/env python3
"""Time the megakernel (csrc/megakernel.cu ``megakernel<*, false>``) against
other builds of it, in turns, on one CUDA card.

    python3 tools/megakernel_steps.py [--baseline NAME=ROOT ...] [--out DIR]

Builds the megakernel library from this checkout's csrc/ and from the
csrc/ of each ``--baseline`` checkout (ROOT is a repository root, e.g. the
parent commit unpacked by ``git archive`` under the git-ignored
``_checkout/``), one nvcc each, all started together, into
weekend_raytracer_tpu_torch/_build/megakernel_steps/. A baseline whose
``wrt_megakernel_launch`` takes no cull hierarchy (before the megakernel
culled) is called without one. It also builds variants of this csrc/
with other register budgets (``kMinBlocks``: 0, no minimum; 3 and 5
blocks of 256 threads an SM, up to 80 and 48 registers, where the source
asks for 4, up to 64) and another block shape (8 x 32: a warp is an 8 x 4
pixel patch where 16 x 16 gives 16 x 2).

Each build renders each case (RTiOW 1920x1080 at 32, 24, 4 and 1 spp; the
chip smoke's [timing] shape, RTiOW 480x270 x 4 spp; random_spheres(10000)
at 3840x2160 x 4 spp; random_spheres(60000) at 1920x1080 x 1 spp, whose
boxes pass what a block stages and are read from global memory; 8 bounces,
frame 0) and its image must equal the stats megakernel's (``stats=True``,
which sweeps every sphere from a staged table) in every bit. Then every
build is timed on every case with CUDA events around one launch, the least
of REPS launches after a warm one: the builds in order, then in the
reverse order. Prints the card's name and power limit, one JSON line per
build (registers and spills from ptxas) and one per case (cull placement,
ms per build and turn).

It also builds regroup.cu from this checkout and each baseline (its
entry points take the same arguments in both) and times a regroup
frame (K0, PACK and K1 at cuts (2, 4, 6), COMBINE) at RTiOW 1920x1080 x 32
spp with each, in the same turns, per stage with CUDA events; every
build's accumulator must equal this checkout's in every bit. It prints
K0's and K1's registers and spills from ptxas.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from chip_smoke import _CUTS, _case, _nvidia_smi, _per_kernel, _stage_ms  # noqa: E402
from variants import copy_csrc, finish, start  # noqa: E402
from weekend_raytracer_tpu_torch.ops import rng  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import build  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import megakernel as mk  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import regroup as rg  # noqa: E402

OUT = build.BUILD_DIR / "megakernel_steps"
# name: (scene, width, height, spp)
CASES = {"rtiow_1080p_spp32": ("rtiow", 1920, 1080, 32),
         "rtiow_1080p_spp24": ("rtiow", 1920, 1080, 24),
         "rtiow_1080p_spp4": ("rtiow", 1920, 1080, 4),
         "rtiow_1080p_spp1": ("rtiow", 1920, 1080, 1),
         "timing_480x270_spp4": ("rtiow", 480, 270, 4),
         "random10k_4k_spp4": ("random10k", 3840, 2160, 4),
         "random60k_1080p_spp1": ("random60k", 1920, 1080, 1)}
BOUNCES = 8
REPS = 2  # launches timed a build, a case and a turn
# name: {constant: value} edits of megakernel.cu
VARIANTS = {"blocks0": {"kMinBlocks": 0}, "blocks3": {"kMinBlocks": 3},
            "blocks5": {"kMinBlocks": 5}, "block8x32": {"kBlockX": 8, "kBlockY": 32}}
REGROUP_CASE = ("rtiow", 1920, 1080, 32)


def _sources(roots: dict, variants: bool, source: str) -> dict:
    """{build name: path of its ``source``}, each beside a copy of its csrc/."""
    out = {name: copy_csrc(root, OUT / f"{name}_{source.split('.')[0]}", source)
           for name, root in roots.items()}
    if variants:
        out.update({name: copy_csrc(ROOT, OUT / name, "megakernel.cu", edits)
                    for name, edits in VARIANTS.items()})
    return out


def _megakernels(built: dict) -> dict:
    """{name: (CDLL, culled ABI, ptxas usage)} of built megakernel libraries."""
    out = {}
    for name, (lib, log) in built.items():
        culled = hasattr(lib, "wrt_megakernel_launch_bounds")
        vp, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
        frame = [vp, vp, vp, vp, vp, vp, i, i, i, f, f, u, u, i, i, i]
        lib.wrt_megakernel_launch.argtypes = frame + (
            mk.CULL_ARGTYPES + [f, f, vp] if culled else [vp])
        lib.wrt_megakernel_launch.restype = ctypes.c_int
        usage = {k.split("megakernelILb")[1][:12] if "megakernelILb" in k else k: v
                 for k, v in build.parse_ptxas(log).items() if "megakernel" in k}
        out[name] = (lib, culled, usage)
    return out


def _regroups(built: dict) -> dict:
    """{name: (loaded library as rg._library gives it, K0/K1 ptxas usage)}."""
    out = {}
    load = rg.load_library
    try:
        for name, (lib, log) in built.items():
            wrapped = build.BuiltLibrary(lib=lib, path=pathlib.Path(lib._name),
                                         build_seconds=0.0, log=log)
            rg.load_library = lambda *a, w=wrapped: w
            out[name] = (rg._library(), {
                k[k.index("regroup_k"):][:24]: v for k, v in build.parse_ptxas(log).items()
                if "regroup_k0" in k or "regroup_k1" in k})
    finally:
        rg.load_library = load
    return out


def _regroup_stages(built, acc, inp, w, h, spp) -> dict:
    """Stage ms of one regroup frame through ``built`` (rg._library's)."""
    library = rg._library
    rg._library = lambda: built
    try:
        run = lambda mark: rg.launch_regrouped(acc, inp, 0, True, cuts=_CUTS,  # noqa: E731
                                               on_stage=mark, width=w, height=h, spp=spp,
                                               num_bounces=BOUNCES)
        run(lambda name: None)
        return _per_kernel(_stage_ms(run))
    finally:
        rg._library = library


def _launch(lib, culled: bool, acc, inp, spp: int, w: int, h: int) -> None:
    args = [inp.cam.data_ptr(), inp.sky.data_ptr(), inp.sweep.data_ptr(), inp.attrs.data_ptr(),
            None if inp.tex_pool is None else inp.tex_pool.data_ptr(), acc.data_ptr(),
            inp.n_spheres, w, h, float(np.float32(1.0 / w)), float(np.float32(1.0 / h)),
            0 & rng.MASK32, 0, 1, spp, BOUNCES]
    if culled:
        args += [*mk.cull_args(inp, acc.device), mk._f32(inp.cull_reach),
                 mk._f32(inp.cull_scale)]
    err = lib.wrt_megakernel_launch(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"megakernel launch failed: CUDA error {err}")


def _ms(fn, reps: int) -> float:
    fn()
    best = float("inf")
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b))
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", action="append", default=[], metavar="NAME=ROOT")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("megakernel_steps: no CUDA device", file=sys.stderr)
        return 2
    smi = _nvidia_smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    roots = {"change": ROOT, **{name: pathlib.Path(r)
                                for name, r in (b.split("=", 1) for b in args.baseline)}}
    mk_src = _sources(roots, True, "megakernel.cu")
    rg_src = _sources(roots, False, "regroup.cu")
    mk_procs, rg_procs = start(mk_src), start(rg_src)
    builds = _megakernels(finish(mk_src, mk_procs))
    regroups = _regroups(finish(rg_src, rg_procs))
    record = {"card": smi, "build_s": time.perf_counter() - t0, "builds": {}, "cases": {},
              "regroup": {}}
    for name, (_, culled, usage) in builds.items():
        record["builds"][name] = {"culled": culled, "ptxas": usage}
        print(json.dumps({"build": name, "culled": culled, "ptxas": usage}), flush=True)
    inputs = {}
    for case, (scene, w, h, spp) in CASES.items():
        inp = mk.kernel_inputs(*_case(scene, w, h, "cuda"))
        ref = torch.zeros((w * h, 3), device="cuda")
        mk.launch_megakernel(ref, inp, 0, True, width=w, height=h, spp=spp,
                             num_bounces=BOUNCES, stats=True)
        acc = torch.zeros_like(ref)
        for name, (lib, culled, _) in builds.items():
            acc.fill_(float("nan"))
            _launch(lib, culled, acc, inp, spp, w, h)
            torch.cuda.synchronize()
            differ = int((acc != ref).any(dim=1).sum())
            if differ:
                raise RuntimeError(f"{name} on {case}: {differ} pixels differ from the "
                                   "full-sweep stats megakernel")
        inputs[case] = (inp, acc, spp, w, h)
        record["cases"][case] = {"placement": rg.cull_placement(inp), "chunks": inp.n_chunks,
                                 "spheres": inp.n_spheres, "vs_full_sweep": "bit-exact",
                                 "ms": {name: [] for name in builds}}
        del ref
    scene, w, h, spp = REGROUP_CASE
    rg_inp = mk.kernel_inputs(*_case(scene, w, h, "cuda"))
    rg_acc = torch.zeros((w * h, 3), device="cuda")
    ref = None
    for name, (built, usage) in regroups.items():
        _regroup_stages(built, rg_acc, rg_inp, w, h, spp)
        torch.cuda.synchronize()
        if ref is None:
            ref = rg_acc.clone()
        elif not torch.equal(rg_acc, ref):
            raise RuntimeError(f"regroup of {name} is not this checkout's in every bit")
        record["regroup"][name] = {"ptxas": usage, "stages_ms": []}
    del ref
    order = list(builds)
    for turn in (order, order[::-1]):
        for name in turn:
            lib, culled, _ = builds[name]
            for case, (inp, acc, spp, w, h) in inputs.items():
                record["cases"][case]["ms"][name].append(_ms(
                    lambda: _launch(lib, culled, acc, inp, spp, w, h), REPS))
            if name in regroups:
                for _ in range(REPS):
                    record["regroup"][name]["stages_ms"].append(_regroup_stages(
                        regroups[name][0], rg_acc, rg_inp, *REGROUP_CASE[1:]))
    for case, rec in record["cases"].items():
        print(json.dumps({"case": case, **rec, "card": smi}), flush=True)
    for name, rec in record["regroup"].items():
        print(json.dumps({"regroup": name, "shape": "rtiow 1920x1080 spp32 b8",
                          "vs_change": "bit-exact", **rec, "card": smi}), flush=True)
    if args.out:
        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "megakernel_steps.json").write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
