#!/usr/bin/env python3
"""The MXU chunk sweep's kernels (csrc/mxu.cuh, the kMxu instantiations of
the megakernel, regroup's K0 and K1 and the wavefront's culled K0 and K1)
on the card, without the rest of chip_smoke.py.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    python3 tools/mxu_steps.py [--quick] [--out DIR]

It builds the megakernel, regroup and wavefront libraries, prints the MXU
instantiations' launch bounds, registers and local bytes beside the FMA
ones', then runs chip_smoke.py's holds: each MXU kernel against its twin
at the main path's shape (``_mxu_band_holds``), against its twin and the
FMA kernel at the image gates on a small case (``_mxu_vs_twins``) and
against the JAX package's MXU images (``_reference_mxu``). Without
``--quick`` it also drives the main paths with ``mxu_sweep=True``
(``_mxu_main``) and times the FMA and MXU routes in turns at chip_smoke.py's
[timing] shape and at RTiOW 1920x1080 x 32 spp (``_mxu_times``). Every
line carries the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="build and holds only")
    ap.add_argument("--out", default=None, help="directory for mxu_steps.json")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from weekend_raytracer_tpu_torch.ops.cuda import build
    from weekend_raytracer_tpu_torch.ops.cuda import megakernel as mk
    from weekend_raytracer_tpu_torch.ops.cuda import regroup as rg
    from weekend_raytracer_tpu_torch.ops.cuda import reorder as ro
    from weekend_raytracer_tpu_torch.ops.cuda import sweep as sw
    from weekend_raytracer_tpu_torch.ops.cuda import wavefront as wf

    if not torch.cuda.is_available():
        print("mxu_steps: no CUDA device", file=sys.stderr)
        return 2
    card = cs._nvidia_smi()
    t0 = time.perf_counter()
    built = dict(zip(("megakernel", "regroup", "wavefront"),
                     build.load_libraries([mk.LIBRARY, rg.LIBRARY, wf.LIBRARY])))
    ptxas = {k: b.ptxas_usage() for k, b in built.items()}
    attrs = {"megakernel": {**{("textured" if t else "plain") + ("" if st else "_global"):
                               mk.kernel_attributes(t, False, st)
                               for t in (False, True) for st in (True, False)},
                            **{"mxu_" + ("textured" if t else "plain") + ("" if st else "_global"):
                               mk.mxu_kernel_attributes(t, st)
                               for t in (False, True) for st in (True, False)}},
             "regroup": {k: v for k, v in rg.kernel_attributes().items()
                         if k.startswith(("k0", "k1")) and "stats" not in k},
             "wavefront": {k: v for k, v in wf.kernel_attributes().items()
                           if k.startswith(("k0", "k1"))}}
    bounds = {name: (m.launch_bounds(), m.launch_bounds(mxu=True))
              for name, m in (("megakernel", mk), ("regroup", rg), ("wavefront", wf))}
    spills = [k for lib in ptxas.values() for k, u in lib.items()
              if u.get("spill_stores") or u.get("spill_loads")]
    cs._say("build", seconds=f"{time.perf_counter() - t0:.1f}",
            launch_bounds_fma_mxu=json.dumps(bounds), attributes=json.dumps(attrs),
            spills=json.dumps(spills), card=repr(card))
    record = {"card": card, "attributes": attrs, "launch_bounds": bounds, "spills": spills}
    t0 = time.perf_counter()
    record["band"] = cs._mxu_band_holds(mk, rg, wf, gate=False)
    for key, st in record["band"].items():
        cs._say("mxu", case=f"band_{key}", rows=list(cs.MXU_BAND),
                vs_twin=json.dumps({k: v if isinstance(v, dict) else cs._sig(v)
                                    for k, v in st.items()}))
    record["holds"] = cs._mxu_vs_twins(mk, rg, wf, gate=False)
    for key, res in record["holds"].items():
        cs._say("mxu", case=key, **{k: json.dumps({f: cs._sig(v) for f, v in st.items()})
                                    for k, st in res.items()})
    record["reference"] = cs._reference_mxu(mk, rg, wf, gate=False)
    for key, res in record["reference"].items():
        cs._say("reference", case=key, shape=res["shape"], mxu_route=res["mxu_route"],
                mxu_launches=res["mxu_launches"],
                **{r: json.dumps({k: cs._sig(v) for k, v in res[r].items()})
                   for r in ("kernel", "twin")})
    held = list(record["band"].values())
    held += [st for res in record["holds"].values() for st in res.values()]
    held += [res["kernel"] for res in record["reference"].values()]
    failed = sum(not (st["rmse"] < cs.RMSE_GATE and st["mean_rel"] < cs.MEAN_REL_GATE)
                 for st in held)
    cs._say("mxu", holds_seconds=f"{time.perf_counter() - t0:.1f}", held=len(held),
            outside_the_gates=failed, card=repr(card))
    if not args.quick:
        record["main"] = cs._mxu_main(mk, rg, wf, ro, sw)
        for key, res in record["main"].items():
            cs._say("mxu", case=f"main_{key}", **{k: json.dumps(v) for k, v in res.items()})
        for name, shape, reps in (("timing", cs._TIMING, 10), ("timing_1080p", cs._MAIN, 3)):
            kw = dict(width=shape["width"], height=shape["height"], spp=shape["spp"],
                      num_bounces=shape["bounces"])
            case = cs._case(shape.get("scene", "rtiow"), kw["width"], kw["height"], "cuda")
            res = cs._mxu_times(mk, rg, wf, mk.kernel_inputs(*case),
                                mk.kernel_inputs(*case, mxu_sweep=True), kw, reps)
            record[name] = res
            cs._say("mxu", case=name, shape=json.dumps(kw),
                    fma_mxu_ms=json.dumps({k: [cs._sig(res["fma"][k]), cs._sig(res["mxu"][k])]
                                           for k in cs.MXU_KERNELS}), card=repr(card))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "mxu_steps.json"), "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps({"ok": failed == 0 and not spills, "card": card}))
    return 0 if failed == 0 and not spills else 1


if __name__ == "__main__":
    sys.exit(main())
