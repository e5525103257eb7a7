#!/usr/bin/env python3
"""How far the CUDA megakernel and the wavefront's K0 and K1 diverge from
their plain PyTorch twins, and how much of that is nvcc's FMA contraction.

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

The wavefront's K0 and K1 are held against their twins record by record,
with the wavefront library rebuilt in the same way: on chip_smoke.py's
first-hit scene (K0 over bounce 0, then COMPACT and K1 over bounce 1), and
on RTiOW 1920x1080 x 32 spp at the main path's first cut, where K0 runs the
whole image and its twin one band of tile rows (rows 512-543), and K1 runs
the whole dense pool and its twin the last 32 tiles of dense rows. Each
case counts the lanes whose record differs in any bit (the home row aside)
and the lanes whose contribution differs.

With ``--jax`` it measures instead how far the megakernel, regroup and the
wavefront, built both ways, and their twins sit from the JAX package's own
images (tests/data/jax_images.npz, written by tools/jax_images.py; read
with numpy, so no JAX is needed here): chip_smoke.py's ``[reference]``
cases, each kernel's tonemapped RMSE, relative mean and share of differing
pixels beside its twin's, with and without -fmad=false.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _measure_jax(no_fma: bool) -> dict:
    """chip_smoke.py's [reference] distances, with this build's flags."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from weekend_raytracer_tpu_torch.ops.cuda import build
    from weekend_raytracer_tpu_torch.ops.cuda import megakernel as mk
    from weekend_raytracer_tpu_torch.ops.cuda import regroup as rg
    from weekend_raytracer_tpu_torch.ops.cuda import wavefront as wf

    if no_fma:
        build.NVCC_FLAGS = build.NVCC_FLAGS + ("-fmad=false",)
    build.load_libraries([mk.LIBRARY, rg.LIBRARY, wf.LIBRARY])
    return cs._reference_paths(mk, rg, wf, gate=False)


def _measure(no_fma: bool) -> dict:
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from weekend_raytracer_tpu_torch.ops.cuda import build
    from weekend_raytracer_tpu_torch.ops.cuda import megakernel as mk
    from weekend_raytracer_tpu_torch.ops.cuda import wavefront as wf

    if no_fma:
        build.NVCC_FLAGS = build.NVCC_FLAGS + ("-fmad=false",)
    build.load_libraries([mk.LIBRARY, wf.LIBRARY])
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
    out.update(_wavefront(cs, mk, wf, dev))
    return out


def _differing(a, b, c: int) -> dict:
    """Lanes of two [tiles, c, 32, 128] buffers that differ in any bit of
    their c components, and the largest difference."""
    import torch

    same = (a.view(torch.int32) == b.view(torch.int32)).all(dim=1)
    return {"lanes": int(same.numel()), "differing": int((~same).sum()),
            "max_abs_err": float((a - b).nan_to_num(0.0).abs().max())}


def _wavefront(cs, mk, wf, dev) -> dict:
    """K0 and K1 of the wavefront against their twins (the module
    docstring's cases)."""
    import torch

    from weekend_raytracer_tpu_torch.ops.cuda import regroup as rg

    def buffers(t, comps):
        return torch.zeros((t.cap // 4096, comps, 32, 128), device=dev)

    def compact(pool, t):
        dense = torch.zeros_like(pool)
        counts = torch.tensor([t.cap // 128, 0], dtype=torch.int32, device=dev)
        wf.launch_compact(pool, dense, counts, 1,
                          torch.empty((t.cap // 4096,), dtype=torch.int32, device=dev))
        return dense, counts

    out = {}
    # first hit: K0 over bounce 0 on the whole image, COMPACT, K1 over bounce 1
    w, h = 64, 48
    inp = mk.kernel_inputs(*cs._case("first_hit", w, h, dev))
    t = wf.plan(w, h, 1)
    pk, ck, pt, ct = buffers(t, wf.N_COMP), buffers(t, 3), buffers(t, wf.N_COMP), buffers(t, 3)
    wf.launch_k0(inp, pk, ck, t, 0, 1)
    wf.k0_plain(inp, pt, ct, t, 0, 1)
    dense, counts = compact(pk, t)
    dk, dt, ck1, ct1 = dense.clone(), dense.clone(), ck.clone(), ck.clone()
    wf.launch_k1(inp, dk, ck1, counts, 1, 1, 2)
    wf.k1_plain(inp, dt, ct1, counts, 1, 1, 2)
    torch.cuda.synchronize()
    out["wavefront_first_hit"] = {"k0_records": _differing(pk, pt, wf.N_COMP),
                                  "k0_contrib": _differing(ck, ct, 3),
                                  "k1_records": _differing(dk, dt, wf.N_COMP),
                                  "k1_contrib": _differing(ck1, ct1, 3)}
    # RTiOW 1080p x 32 spp, cut 2: K0 on a band of tile rows, K1 on a span
    w, h, spp, cut, ty = 1920, 1080, 32, 2, 16
    inp = mk.kernel_inputs(*cs._case("rtiow", w, h, dev))
    t = wf.plan(w, h, spp)
    pk, ck = buffers(t, wf.N_COMP), buffers(t, 3)
    wf.launch_k0(inp, pk, ck, t, 0, cut)
    band = rg.Tiling(w, 32, spp, t.spp_shift, t.block_w, t.tiles_x, 1, t.tiles_x * 4096,
                     ty * 32, h)
    pt, ct = buffers(band, wf.N_COMP), buffers(band, 3)
    wf.k0_plain(inp, pt, ct, band, 0, cut)
    tiles = slice(ty * t.tiles_x, (ty + 1) * t.tiles_x)
    records = [c for c in range(wf.N_COMP) if c != wf._HOME]
    home_ok = torch.equal(pk[tiles, wf._HOME] - ty * t.tiles_x * 32, pt[:, wf._HOME])
    rec = {"rows": [ty * 32, ty * 32 + 32], "home_rows_equal": home_ok,
           "k0_records": _differing(pk[tiles][:, records], pt[:, records], len(records)),
           "k0_contrib": _differing(ck[tiles], ct, 3)}
    dense, counts = compact(pk, t)
    del pk, pt
    n = int(counts[1])
    span_rows = 32 * 32
    src = torch.arange(n - span_rows, n, device=dev)
    dst = torch.arange(span_rows, device=dev)
    span = torch.zeros_like(dense)
    span[dst >> 5, :, dst & 31] = dense[src >> 5, :, src & 31]
    ck1, ct1 = ck.clone(), ck.clone()
    wf.launch_k1(inp, dense, ck1, counts, 1, cut, cut + 2)
    wf.k1_plain(inp, span, ct1, torch.tensor([0, span_rows], dtype=torch.int32, device=dev), 1,
                cut, cut + 2)
    torch.cuda.synchronize()
    home = span[dst >> 5, wf._HOME, dst & 31][:, 0].long()
    kernel_rows = dense[src >> 5, :, src & 31]
    twin_rows = span[dst >> 5, :, dst & 31]
    same = (kernel_rows.view(torch.int32) == twin_rows.view(torch.int32)).all(dim=1)
    c_same = (ck1[home >> 5, :, home & 31] == ct1[home >> 5, :, home & 31]).all(dim=1)
    rec.update(k1_dense_rows=[n - span_rows, n], k1_records={
        "lanes": int(same.numel()), "differing": int((~same).sum())},
        k1_contrib={"lanes": int(c_same.numel()), "differing": int((~c_same).sum()),
                    "max_abs_err": float((ck1[home >> 5, :, home & 31]
                                          - ct1[home >> 5, :, home & 31]).abs().max())})
    out["wavefront_1080p_band"] = rec
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--jax", action="store_true",
                    help="the distances from the JAX package's images instead")
    ap.add_argument("--child", choices=("fma", "no_fma"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        measure = _measure_jax if args.jax else _measure
        print(json.dumps(measure(args.child == "no_fma")), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    record = {"card": smi}
    for mode in ("fma", "no_fma"):
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", mode]
                             + (["--jax"] if args.jax else []),
                             capture_output=True, text=True, check=True, cwd=ROOT)
        record[mode] = json.loads(run.stdout.strip().splitlines()[-1])
        for name, r in record[mode].items():
            if args.jax:
                if name != "jax_version":
                    print(f"[{mode}] case=jax.{name} shape={r['shape']!r} "
                          f"kernel={json.dumps(r['kernel'])} twin={json.dumps(r['twin'])}",
                          flush=True)
                continue
            if name.startswith("wavefront"):
                print(f"[{mode}] case={name} {json.dumps(r)}", flush=True)
                continue
            print(f"[{mode}] case={name} rows={r['rows']} "
                  f"sum_rel={json.dumps([round(v, 6) for v in r['sum_rel']])} "
                  f"image={json.dumps(r['image'])}", flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        name = "fma_divergence_jax.json" if args.jax else "fma_divergence.json"
        with open(os.path.join(args.out, name), "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
