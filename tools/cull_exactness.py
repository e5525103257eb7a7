#!/usr/bin/env python3
"""Search a frame's rays for lanes whose per-warp cull parts from the full
sweep, with each lane's boxes widened by its cull margin and with the
exact boxes.

Run from the repository root, on a machine with an NVIDIA GPU (or on the
CPU, slowly, with ``--device cpu``):

    python3 tools/cull_exactness.py [--rows 8] [--device cuda] [--out DIR]

Regroup K0 and K1 cull their closest-hit sweep per warp
(csrc/bounce.cuh ``sweep_culled``); a lane's own decisions must keep its
winner, whatever its warp-mates enter. This script traces, with the plain
twins (``trace_bounces_plain``, one bounce at a time), the rays of
``--rows`` rows of 32-pixel tiles from the middle of random_spheres(10000)
at 3840x2160 x 4 spp, 8 bounces, frame 0, and at every bounce holds each
live lane alone (``warp_cull_plain`` with groups of one) against the full
sweep (``megakernel._closest_hit``) in every bit: once with each lane's
margin (``cull.lane_margin``, megakernel.py CULL_MARGIN_ULPS), once with
the exact boxes of the JAX slab test (``cull_scale`` 0). It prints
one JSON line per row of tiles and a summary with the card's name, and
the first parting rays of each kind (origin, direction, the full sweep's
sphere and t).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 1 << 18  # lanes per comparison


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("cull_exactness: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from weekend_raytracer_tpu_torch.ops.cuda import cull
    from weekend_raytracer_tpu_torch.ops.cuda import megakernel as mk
    from weekend_raytracer_tpu_torch.ops.cuda import regroup as rg

    dev = torch.device(args.device)
    w, h, spp, bounces = 3840, 2160, 4, 8
    inp = mk.kernel_inputs(*cs._case("random10k", w, h, dev))
    cases = {"margin": inp, "exact": inp._replace(cull_scale=0.0)}
    card = cs._nvidia_smi() if dev.type == "cuda" else "cpu"
    cam = [mk._f32(v) for v in inp.cam.tolist()]
    first = h // 2 // 32 * 32 - args.rows // 2 * 32
    total = {"segments": 0, **{k: 0 for k in cases}}
    parting = {k: [] for k in cases}
    t0 = time.perf_counter()
    for row0 in range(first, first + 32 * args.rows, 32):
        t = rg.plan(w, 32, spp, bounces, cs._CUTS, row_offset=row0, full_height=h)[0]
        state, x, y_g = rg._seeds(t, torch.arange(t.cap, device=dev), 0)
        state, o, d = mk.camera_rays_plain(cam, x.to(torch.float32),
                                           y_g.to(torch.int32).to(torch.float32),
                                           mk._f32(1.0 / w), mk._f32(1.0 / h), state)
        o, d = torch.stack(o), torch.stack(d)
        tr = torch.ones((t.cap, 3), device=dev)
        alive = torch.ones((t.cap,), dtype=torch.bool, device=dev)
        row = {"rows": [row0, row0 + 32], "segments": 0, **{k: 0 for k in cases}}
        for b in range(bounces):
            live = torch.nonzero(alive).squeeze(1)
            if not live.numel():
                break
            for lo in range(0, live.numel(), BATCH):
                idx = live[lo:lo + BATCH]
                ob, db = tuple(o[:, idx]), tuple(d[:, idx])
                one = torch.ones((idx.numel(),), dtype=torch.bool, device=dev)
                bt, bi = mk._closest_hit(ob, db, inp.sweep)
                row["segments"] += idx.numel()
                for name, case in cases.items():
                    wc = cull.warp_cull_plain(ob, db, one, case, group=1)
                    bad = torch.nonzero((wc.bt.view(torch.int32) != bt.view(torch.int32))
                                        | (wc.bi != bi)).squeeze(1)
                    row[name] += bad.numel()
                    for k in bad[:max(0, 3 - len(parting[name]))].tolist():
                        parting[name].append({
                            "bounce": b, "origin": [float(v[k]) for v in ob],
                            "direction": [float(v[k]) for v in db],
                            "full_sweep": [int(bi[k]), float(bt[k])],
                            "culled": [int(wc.bi[k]), float(wc.bt[k])]})
            p = mk.trace_bounces_plain(tuple(o[:, live]), tuple(d[:, live]), tr[live],
                                       state[live], inp, b, b + 1)
            o[:, live], d[:, live], tr[live], state[live] = p.o.T, p.d.T, p.tr, p.state
            alive[live] = p.alive
        for k in total:
            total[k] += row[k]
        print(json.dumps(row), flush=True)
    summary = {"scene": "random10k", "size": [w, h], "spp": spp, "bounces": bounces,
               "cull_reach": inp.cull_reach, "cull_scale": inp.cull_scale,
               "lanes_parting": total,
               "first_parting": parting, "seconds": round(time.perf_counter() - t0, 1),
               "card": card}
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "cull_exactness.json"), "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
