#!/usr/bin/env python3
"""Time the wavefront's K0 and K1 (csrc/wavefront.cu) against other builds
of them, in turns, on one CUDA card.

    python3 tools/wavefront_steps.py [--baseline NAME=ROOT ...] [--out DIR]

Builds the wavefront library from this checkout's csrc/ and from the csrc/
of each ``--baseline`` checkout (ROOT is a repository root, or a directory
holding its weekend_raytracer_tpu_torch/csrc/, under the git-ignored
``_checkout/``: e.g. the parent commit unpacked by ``git archive``, or a
step of the design), one nvcc each, all started together, into
weekend_raytracer_tpu_torch/_build/wavefront_steps/. A baseline whose K0
and K1 take no cull hierarchy (before they culled) runs through the
full-sweep route, whose entry points take the arguments they took then;
one that culls (its wrt_wavefront_k0 takes the hierarchy) runs through
the culled launchers. It also builds variants of this csrc/ that try the
design's alternatives:

  rows2, rows32      K1 regrouping 2 or 32 dense rows a block (the source: 8)
  slices8, slices16  K0 warps walking at most 8 or 16 slices of 32 slots
                     down a tile (the source: min(spp, 32))
  blocks3, blocks5   the culled kernels' register budget at 3 or 5 blocks
                     of 256 threads an SM (the source: 4, up to 64 registers)

Each build renders each case (RTiOW 1920x1080 x 32 spp with no cuts, the
Renderer's one K0 a frame, and at cuts (2, 4, 6); RTiOW 1920x1080 at 4 and
1 spp with no cuts; random_spheres(10000) at
3840x2160 x 4 spp and random_spheres(60000) at 1920x1080 x 1 spp, whose
boxes are read from global memory, with no cuts; 8 bounces, frame 0), and
its accumulator must equal this checkout's full-sweep wavefront's (K0's
and K1's kCull = false instantiations) in every bit. Then every build is
timed on every case, per stage with CUDA events (K0, each COMPACT, each
K1, the fold), REPS frames after a warm one: the builds in order, then in
the reverse order. Prints the card's name and power limit, one JSON line
per build (K0's and K1's registers and spills from ptxas) and one per case
(cull placement, the stage ms of each build's frames in turn).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from chip_smoke import _CUTS, _case, _nvidia_smi, _stage_ms  # noqa: E402
from variants import LIB, build_all, copy_csrc  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import build  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import megakernel as mk  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import wavefront as wf  # noqa: E402

OUT = build.BUILD_DIR / "wavefront_steps"
# name: (scene, width, height, spp, phase_cuts)
CASES = {"rtiow_1080p_spp32_nocut": ("rtiow", 1920, 1080, 32, ()),
         "rtiow_1080p_spp32_cuts": ("rtiow", 1920, 1080, 32, _CUTS),
         "rtiow_1080p_spp4_nocut": ("rtiow", 1920, 1080, 4, ()),
         "rtiow_1080p_spp1_nocut": ("rtiow", 1920, 1080, 1, ()),
         "random10k_4k_spp4_nocut": ("random10k", 3840, 2160, 4, ()),
         "random60k_1080p_spp1_nocut": ("random60k", 1920, 1080, 1, ())}
BOUNCES = 8
REPS = 2  # frames timed a build, a case and a turn
# name: {constant: value} edits of wavefront.cu
VARIANTS = {"rows2": {"kK1Rows": 2}, "rows32": {"kK1Rows": 32},
            "slices8": {"kK0MaxSlices": 8}, "slices16": {"kK0MaxSlices": 16},
            "blocks3": {"kMinBlocks": 3}, "blocks5": {"kMinBlocks": 5}}


def _sources(roots: dict) -> dict:
    """{build name: path of its wavefront.cu}, each beside a copy of its csrc/."""
    return {name: copy_csrc(root, OUT / name, "wavefront.cu", edits)
            for name, (root, edits) in roots.items()}


def _build(sources: dict) -> dict:
    """One nvcc per build, all started at once: {name: BuiltLibrary}."""
    return {name: build.BuiltLibrary(lib=lib, path=sources[name].parent / LIB,
                                     build_seconds=0.0, log=log)
            for name, (lib, log) in build_all(sources).items()}


class _FullSweepABI:
    """A library from before K0 and K1 culled, under the names of the
    full-sweep entry points, which take the arguments its K0 and K1 took."""

    def __init__(self, lib):
        vp, i, f, u, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint,
                           ctypes.c_longlong)
        sigs = {"wrt_wavefront_k0": [vp] * 5 + [i, vp, vp, ll, i, i, i, i, f, f, u, i, vp],
                "wrt_wavefront_compact": [vp] * 5 + [ll, vp],
                "wrt_wavefront_k1": [vp] * 4 + [i, vp, vp, vp, ll, i, i, vp]}
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self.wrt_wavefront_k0_full_sweep = lib.wrt_wavefront_k0
        self.wrt_wavefront_k1_full_sweep = lib.wrt_wavefront_k1
        self.wrt_wavefront_compact = lib.wrt_wavefront_compact


def _routes(built: dict) -> dict:
    """{name: (the loaded library as wf._library gives it, route, K0/K1 ptxas)}:
    route "kernels" (the culled launchers) or, for a library from before K0
    and K1 culled, "full_sweep"."""
    out = {}
    library, load = wf._library, wf.load_library
    try:
        for name, b in built.items():
            usage = {k[k.index("wavefront_k"):][:25]: v for k, v in build.parse_ptxas(b.log).items()
                     if "wavefront_k" in k}
            if hasattr(b.lib, "wrt_wavefront_k0_full_sweep"):
                wf.load_library = lambda *a, b=b: b
                out[name] = (library(), "kernels", usage)
            else:
                out[name] = (build.BuiltLibrary(lib=_FullSweepABI(b.lib), path=b.path,
                                                build_seconds=0.0, log=b.log),
                             "full_sweep", usage)
    finally:
        wf.load_library = load
    return out


def _frame(route, acc, inp, kw, cuts, on_stage=None):
    """One frame through ``route`` = (library, "kernels" | "full_sweep")."""
    library = wf._library
    wf._library = lambda: route[0]
    try:
        fn = wf.launch_wavefront if route[1] == "kernels" else wf._launch_wavefront_full_sweep
        fn(acc, inp, 0, True, phase_cuts=cuts, on_stage=on_stage, **kw)
    finally:
        wf._library = library


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", action="append", default=[], metavar="NAME=ROOT")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wavefront_steps: no CUDA device", file=sys.stderr)
        return 2
    smi = _nvidia_smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    roots = {"change": (ROOT, {}),
             **{name: (pathlib.Path(r), {}) for name, r in (b.split("=", 1)
                                                            for b in args.baseline)},
             **{name: (ROOT, edits) for name, edits in VARIANTS.items()}}
    routes = _routes(_build(_sources(roots)))
    record = {"card": smi, "build_s": time.perf_counter() - t0, "builds": {}, "cases": {}}
    for name, (_, route, usage) in routes.items():
        record["builds"][name] = {"route": route, "ptxas": usage}
        print(json.dumps({"build": name, "route": route, "ptxas": usage}), flush=True)
    inputs = {}
    for case, (scene, w, h, spp, cuts) in CASES.items():
        inp = mk.kernel_inputs(*_case(scene, w, h, "cuda"))
        kw = dict(width=w, height=h, spp=spp, num_bounces=BOUNCES)
        ref = torch.zeros((w * h, 3), device="cuda")
        wf._launch_wavefront_full_sweep(ref, inp, 0, True, **kw)
        acc = torch.zeros_like(ref)
        for name, route in routes.items():
            acc.fill_(float("nan"))
            _frame(route, acc, inp, kw, cuts)
            torch.cuda.synchronize()
            differ = int((acc != ref).any(dim=1).sum())
            if differ:
                raise RuntimeError(f"{name} on {case}: {differ} pixels differ from the "
                                   "full-sweep wavefront")
        inputs[case] = (inp, acc, kw, cuts)
        record["cases"][case] = {"placement": wf.cull_placement(inp), "chunks": inp.n_chunks,
                                 "spheres": inp.n_spheres, "vs_full_sweep": "bit-exact",
                                 "ms": {name: [] for name in routes}}
        del ref
    order = list(routes)
    for turn in (order, order[::-1]):
        for name in turn:
            for case, (inp, acc, kw, cuts) in inputs.items():
                run = lambda mark: _frame(routes[name], acc, inp, kw, cuts, mark)  # noqa: E731
                run(lambda stage: None)
                for _ in range(REPS):
                    record["cases"][case]["ms"][name].append(
                        {k: round(v, 3) for k, v in _stage_ms(run).items()})
    for case, rec in record["cases"].items():
        print(json.dumps({"case": case, **rec, "card": smi}), flush=True)
    if args.out:
        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "wavefront_steps.json").write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
