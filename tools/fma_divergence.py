#!/usr/bin/env python3
"""How far the CUDA megakernel and its plain PyTorch twin diverge, and how
much of that is nvcc's FMA contraction.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    python3 tools/fma_divergence.py [--out DIR]

nvcc contracts a * b + c into one FMA by default; the twin rounds every
product and sum. For each case the script renders one frame (frame 1,
4 spp, 8 bounces) with the stats megakernel and with its twin, and compares
the images (tonemapped RMSE, mean radiance, pixels that differ) and the
cull counters' column sums. It does so twice: with the package's build
flags, and with the megakernel library rebuilt with -fmad=false, each in a
process of its own (a process loads a library once). The cases are
chip_smoke.py's counter cases: RTiOW 96x64 and random_spheres(1200) at
256x128 through a narrow lens, and the last row of 64-pixel tiles of
RTiOW 1920x1080 and of random_spheres(10000) at 3840x2160.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _measure(no_fma: bool) -> dict:
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from weekend_raytracer_tpu_torch.ops.cuda import build
    from weekend_raytracer_tpu_torch.ops.cuda import megakernel as mk

    if no_fma:
        build.NVCC_FLAGS = build.NVCC_FLAGS + ("-fmad=false",)
    build.load_libraries([mk.LIBRARY])
    dev = torch.device("cuda")
    cases = [(name, cs._stats_inputs(mk, name, w, h, dev), w, h, 0, h, spp)
             for name, w, h, spp in cs._STATS_PLAIN_CASES]
    for name, w, h in cs._STATS_MK:
        top = (h - 1) // mk.TILE_H * mk.TILE_H
        cases.append((f"{name}_last_tile_row", mk.kernel_inputs(*cs._case(name, w, h, dev)),
                      w, h - top, top, h, 4))
    out = {}
    for name, inp, w, h, top, full_h, spp in cases:
        kw = dict(width=w, height=h, spp=spp, num_bounces=8, row_offset=top,
                  full_height=full_h, stats=True)
        img, st = mk.launch_megakernel(torch.zeros((w * h, 3), device=dev), inp, 1, True, **kw)
        ref_img, ref = mk.render_plain_with_inputs(torch.zeros((w * h, 3), device=dev), inp, 1,
                                                   True, **kw)
        torch.cuda.synchronize()
        out[name] = {"size": [w, h], "rows": [top, top + h], "spp": spp,
                     "image": cs._compare(ref_img / spp, img / spp, w, h),
                     "sums": st[:, :4].sum(0).tolist(), "twin_sums": ref[:, :4].sum(0).tolist(),
                     "sum_rel": cs._sum_rel(st, ref)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", choices=("fma", "no_fma"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(_measure(args.child == "no_fma")), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    record = {"card": smi}
    for mode in ("fma", "no_fma"):
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", mode],
                             capture_output=True, text=True, check=True, cwd=ROOT)
        record[mode] = json.loads(run.stdout.strip().splitlines()[-1])
        for name, r in record[mode].items():
            print(f"[{mode}] case={name} rows={r['rows']} "
                  f"sum_rel={json.dumps([round(v, 6) for v in r['sum_rel']])} "
                  f"image={json.dumps(r['image'])}", flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "fma_divergence.json"), "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
