#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA libraries from the sources in the checkout (the
megakernel and the regroup pipeline, one nvcc each, in parallel), holds
every kernel against its plain PyTorch version on the card, holds the
regroup pipeline against the megakernel, and renders the RTiOW final scene
at 1920x1080 (32 spp per frame, 96 spp, 8 bounces) twice:
through ``Renderer(backend="auto", device="cuda")``, which resolves to the
regroup pipeline (K0, PACK, K1, COMBINE), and through
``Renderer(backend="pallas")``, the megakernel. For each it checks that
every frame went through the kernels and that the image is right, and it
times the kernels against their plain versions. Each phase prints one line;
any failure exits non-zero without the final ``ok`` line. It needs a CUDA
device and imports nothing of JAX. Options: ``--png PATH`` (default:
chip_smoke_rtiow.png in the temporary directory) and ``--out DIR`` (also
write every number as JSON there).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

# name, w, h, frames, spp, bounces of the kernel-against-plain cases
_PLAIN_CASES = (("first_hit", 64, 48, 1, 1, 1),
                ("rtiow", 96, 64, 4, 4, 8),
                ("textured", 96, 64, 4, 4, 8))
_REGROUP_CASES = (("rtiow", 96, 64, 4, 4, 8), ("textured", 96, 64, 4, 4, 8))
_CUTS = (2, 4, 6)  # default_cuts(8, 486), the main path's schedule
_MAIN = dict(width=1920, height=1080, spp=32, max_spp=96, bounces=8)
_TIMING = dict(scene="rtiow", width=480, height=270, spp=4, bounces=8)
RMSE_GATE = 5e-3  # tonemapped RMSE (tests/test_pallas.py's gate)
MEAN_REL_GATE = 1e-3  # relative linear mean radiance
FIRST_HIT_GATE = 0.01  # fraction of first-hit pixels allowed to differ
REGROUP_KERNELS = ("k0", "pack", "k1", "combine")


def _check(ok: bool, what) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def _tonemapped(img, w, h):
    from weekend_raytracer_tpu_torch.ops import tonemap

    return tonemap.to_srgb_u8(img.reshape(h, w, 3)).float() / 255.0


def _compare(a, b, w, h) -> dict:
    """Statistics of two [H*W, 3] mean-radiance images on the card."""
    rmse = float(((_tonemapped(a, w, h) - _tonemapped(b, w, h)) ** 2).mean().sqrt())
    ma, mb = float(a.mean()), float(b.mean())
    return {"rmse": rmse, "mean_rel": abs(ma - mb) / max(ma, 1e-6),
            "max_abs_err": float((a - b).abs().max()),
            "pixel_mismatch": float(((a - b).abs() > 1e-6).any(dim=1).float().mean())}


def _case(name, w, h, device):
    import numpy as np

    from weekend_raytracer_tpu_torch import (SCENES, Camera, CameraBasis, Material,
                                             SceneDesc, SkyParams, SkyState, Sphere,
                                             to_sky_state)

    if name == "first_hit":
        desc = SceneDesc(materials=[Material.lambertian((0.3, 0.4, 0.5))],
                         spheres=[Sphere((0.0, 0.0, -3.0), 1.0, 0)])
        cam = Camera.look_at((0, 0, 1), (0, 0, -3), vfov_degrees=40.0, aperture=0.0)
        params = np.zeros((3, 9), np.float32)
        params[:, 2] = 1.0
        sky = SkyState.from_raw(params, np.ones(3), np.array([0.0, 1.0, 0.0]),
                                device=device)
    else:
        desc, cam = SCENES[name][0](), SCENES[name][1]()
        sky = to_sky_state(SkyParams(), device=device)
    return (desc.build(device=device), sky,
            CameraBasis.create(cam, (w, h), device=device))


def _render(fn, inp, w, h, frames, spp, bounces, **kw):
    import torch

    acc = torch.zeros((w * h, 3), dtype=torch.float32, device="cuda")
    for f in range(frames):
        fn(acc, inp, f, f == 0, width=w, height=h, spp=spp, num_bounces=bounces, **kw)
    torch.cuda.synchronize()
    return acc / (frames * spp)


def _time_ms(fn, reps: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _stage_ms(run) -> dict:
    """CUDA-event time of each stage of one regrouped frame: ``run`` takes
    an on_stage callback."""
    import torch

    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    mark("start")
    run(mark)
    torch.cuda.synchronize()
    return {name: marks[i - 1][1].elapsed_time(ev)
            for i, (name, ev) in enumerate(marks) if i}


def _per_kernel(stages: dict) -> dict:
    """Stage times summed per kernel: {"k0": ms, "pack": ms, ...}."""
    out = dict.fromkeys(REGROUP_KERNELS, 0.0)
    for name, ms in stages.items():
        out[next(k for k in REGROUP_KERNELS if name.startswith(k))] += ms
    return out


def _launch_counts(mk, rg) -> dict:
    return {"megakernel": mk.render_image_megakernel.launches,
            **{k: getattr(rg, f"launch_{k}").launches for k in REGROUP_KERNELS}}


def _zero_launch_counts(mk, rg) -> None:
    mk.render_image_megakernel.launches = 0
    for k in REGROUP_KERNELS:
        getattr(rg, f"launch_{k}").launches = 0


def _bitwise_max_err(a, b, what) -> float:
    """Check that a and b are equal in every bit, +0.0 and -0.0 held equal;
    returns max |a - b| (0.0 then)."""
    import torch

    same = a.shape == b.shape and torch.equal((a + 0.0).view(torch.int32),
                                              (b + 0.0).view(torch.int32))
    _check(same, (what, "not bit for bit"))
    return float((a - b).nan_to_num(0.0).abs().max()) if a.numel() else 0.0


def _k0_k1_vs_plain(mk, rg) -> dict:
    """K0 and K1 against their twins on the first-hit scene (two bounces
    into a constant sky, so every path is decided), cut after bounce 0.
    K0's alive flags and home slots must agree exactly, K1's alive flags on
    99% of the records, and the radiance of both with an error of 0."""
    import torch

    dev = torch.device("cuda")
    out = {}
    w, h = 64, 48
    scene, sky, basis = _case("first_hit", w, h, dev)
    inp = mk.kernel_inputs(scene, sky, basis)
    t, _ = rg.plan(w, h, 1, 2, (1,))
    pools = [torch.empty((rg.N_COMP, t.cap), device=dev) for _ in range(2)]
    contribs = [torch.empty((3, t.cap), device=dev) for _ in range(2)]
    rg.launch_k0(inp, pools[0], contribs[0], t, 0, 1)
    rg.k0_plain(inp, pools[1], contribs[1], t, 0, 1)
    torch.cuda.synchronize()
    _check(torch.equal(pools[0][rg._AL], pools[1][rg._AL]), "K0 alive")
    _check(torch.equal(pools[0][[rg._HLO, rg._HHI]], pools[1][[rg._HLO, rg._HHI]]),
           "K0 home slots")
    out["k0"] = float((contribs[0] - contribs[1]).abs().max())
    _check(out["k0"] == 0.0, ("K0 contributions", out["k0"]))
    counts = torch.tensor([t.cap, 0], dtype=torch.int32, device=dev)
    dense = torch.empty_like(pools[0])
    inv = torch.empty((t.cap,), dtype=torch.int32, device=dev)
    rg.pack_plain(pools[0], dense, inv, counts, 1)
    n = int(counts[1])
    _check(n > 0, "first hit: no live path after bounce 0")
    dk, dp = dense.clone(), dense.clone()
    r8 = [torch.zeros((3, t.cap), device=dev) for _ in range(2)]
    rg.launch_k1(inp, dk, r8[0], counts, 1, t, 0, 1, 2)
    rg.k1_plain(inp, dp, r8[1], counts, 1, t, 0, 1, 2)
    torch.cuda.synchronize()
    same = dk[rg._AL, :n] == dp[rg._AL, :n]
    _check(float(same.float().mean()) >= 0.99, ("K1 alive agreement", float(same.float().mean())))
    out["k1"] = float((r8[0][:, :n] - r8[1][:, :n]).abs()[:, same].max())
    _check(out["k1"] == 0.0, ("K1 base radiance", out["k1"]))
    return out


def _pack_combine_vs_plain(rg, inp, t, seed: int) -> dict:
    """PACK and COMBINE against their twins, bit for bit, on the K0 pool of
    tiling ``t`` with its own, a random, an all-live and an all-dead alive
    mask: the live count, the dense pool (+-0 equal), the inverse map, a
    combine level, and the home level's fold into the accumulator (which
    must leave K0's contributions untouched)."""
    import torch

    dev = torch.device("cuda")
    pool = torch.empty((rg.N_COMP, t.cap), device=dev)
    contrib = torch.empty((3, t.cap), device=dev)
    rg.launch_k0(inp, pool, contrib, t, 0, _CUTS[0])
    gen = torch.Generator(device=dev).manual_seed(seed)
    masks = {"k0": pool[rg._AL].clone(),
             "random": (torch.rand(t.cap, device=dev, generator=gen) < 0.3).float(),
             "all_live": torch.ones(t.cap, device=dev),
             "all_dead": torch.zeros(t.cap, device=dev)}
    del contrib
    pack_err, combine_err, live = 0.0, 0.0, {}
    block_sums = torch.empty((t.cap // 1024,), dtype=torch.int32, device=dev)
    for label, mask in masks.items():
        pool[rg._AL] = mask
        res = []
        for pack in (rg.launch_pack, rg.pack_plain):
            counts = torch.tensor([t.cap, 0], dtype=torch.int32, device=dev)
            dst = torch.full((rg.N_COMP, t.cap), 7.0, device=dev)
            inv = torch.full((t.cap,), -7, dtype=torch.int32, device=dev)
            pack(pool, dst, inv, counts, 1, block_sums)
            res.append((counts, dst, inv))
        torch.cuda.synchronize()
        n = int(res[1][0][1])
        live[label] = n
        _check(int(res[0][0][1]) == n, (label, "pack count", int(res[0][0][1]), n))
        end = -(-n // 128) * 128
        pack_err = max(pack_err, _bitwise_max_err(res[0][1][:, :end], res[1][1][:, :end],
                                                  (label, "dense pool")))
        _check(torch.equal(res[0][2], res[1][2]), (label, "inverse map"))
        counts, inv = res[1][0], res[1][2]
        del res
        # COMBINE through this inverse map: a level (k = 2) and the home level
        src = torch.rand((3, t.cap), device=dev, generator=gen)
        base = torch.rand((3, t.cap), device=dev, generator=gen)
        accum = torch.rand((t.width * t.height, 3), device=dev, generator=gen)
        level = [base.clone(), base.clone()]
        counts2 = torch.tensor([t.cap, t.cap], dtype=torch.int32, device=dev)
        rg.launch_combine(inv, src, level[0], counts2, 2)
        rg.combine_plain(inv, src, level[1], counts2, 2)
        combine_err = max(combine_err, _bitwise_max_err(level[0], level[1],
                                                        (label, "combine level")))
        del level
        home, home_base = [accum.clone(), accum.clone()], [base.clone(), base.clone()]
        rg.launch_combine(inv, src, home_base[0], counts, 1, accum=home[0], t=t)
        rg.combine_plain(inv, src, home_base[1], counts, 1, accum=home[1], t=t)
        torch.cuda.synchronize()
        combine_err = max(combine_err, _bitwise_max_err(home[0], home[1],
                                                        (label, "home fold")))
        _check(torch.equal(home_base[0], base) and torch.equal(home_base[1], base),
               (label, "the home level changed K0's contributions"))
    return {"pack": pack_err, "combine": combine_err, "live": live}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--png", default=os.path.join(tempfile.gettempdir(),
                                                  "chip_smoke_rtiow.png"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    record = {}

    # 1. environment
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from weekend_raytracer_tpu_torch import (SCENES, RenderParams, Renderer,
                                             SamplingParams)
    from weekend_raytracer_tpu_torch.ops.cuda import build
    from weekend_raytracer_tpu_torch.ops.cuda import megakernel as mk
    from weekend_raytracer_tpu_torch.ops.cuda import regroup as rg

    _check("jax" not in sys.modules, "the port imported jax")
    smi = _nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    _say("env", device=repr(kind), torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())
    record["env"] = {"nvidia_smi": smi, "device": kind, "torch": torch.__version__,
                     "cuda": torch.version.cuda}

    # 2. build both libraries, one nvcc each, in parallel
    t0 = time.perf_counter()
    built = dict(zip(("megakernel", "regroup"),
                     build.load_libraries([mk.LIBRARY, rg.LIBRARY])))
    build_s = time.perf_counter() - t0
    ptxas = {k: b.ptxas_usage() for k, b in built.items()}
    attrs = {"megakernel": {str(t): mk.kernel_attributes(t) for t in (False, True)},
             "regroup": rg.kernel_attributes()}
    _say("build", seconds=f"{build_s:.2f}",
         nvcc_seconds=json.dumps({k: round(b.build_seconds, 2) for k, b in built.items()}),
         ptxas=json.dumps(ptxas, sort_keys=True), attributes=json.dumps(attrs))
    record["build"] = {"seconds": build_s,
                       "nvcc_seconds": {k: b.build_seconds for k, b in built.items()},
                       "ptxas": ptxas, "attributes": attrs}
    spills = [u for lib in ptxas.values() for u in lib.values()
              if u.get("spill_stores") or u.get("spill_loads")]
    _check(not spills, ("register spills", spills))

    # 3. megakernel against plain, both on the card
    record["plain"] = {}
    max_abs_err = None
    for name, w, h, frames, spp, bounces in _PLAIN_CASES:
        scene, sky, basis = _case(name, w, h, "cuda")
        inp = mk.kernel_inputs(scene, sky, basis)
        a = _render(mk.launch_megakernel, inp, w, h, frames, spp, bounces)
        b = _render(mk.render_plain_with_inputs, inp, w, h, frames, spp, bounces)
        _check(bool(torch.isfinite(a).all()), f"{name}: non-finite kernel output")
        st = _compare(b, a, w, h)
        _say("plain", case=name, size=f"{w}x{h}", frames=frames, spp=spp,
             bounces=bounces, **{k: f"{v:.3e}" for k, v in st.items()})
        record["plain"][name] = st
        if name == "first_hit":
            max_abs_err = st["max_abs_err"]
            _check(st["pixel_mismatch"] < FIRST_HIT_GATE, st)
        else:
            _check(st["rmse"] < RMSE_GATE and st["mean_rel"] < MEAN_REL_GATE, st)

    # 4. regroup kernels against their twins, then the pipeline
    rg_err = _k0_k1_vs_plain(mk, rg)
    w, h = 96, 64
    t = rg.plan(w, h, 4, 8, _CUTS)[0]
    small = _pack_combine_vs_plain(rg, mk.kernel_inputs(*_case("rtiow", w, h, "cuda")),
                                   t, seed=0)
    rg_err.update(pack=small["pack"], combine=small["combine"])
    _say("regroup_plain", case="kernels", k0_max_abs_err=f"{rg_err['k0']:.3e}",
         k1_max_abs_err=f"{rg_err['k1']:.3e}", pack="bit-exact",
         combine="bit-exact", size=f"{w}x{h}", spp=4, pack_live=json.dumps(small["live"]))
    record["regroup_plain"] = {"kernels": {**rg_err, "pack_live": small["live"]}}
    for name, w, h, frames, spp, bounces in _REGROUP_CASES:
        scene, sky, basis = _case(name, w, h, "cuda")
        inp = mk.kernel_inputs(scene, sky, basis)
        a = _render(rg.launch_regrouped, inp, w, h, frames, spp, bounces, cuts=_CUTS)
        b = _render(rg.regrouped_plain_with_inputs, inp, w, h, frames, spp, bounces,
                    cuts=_CUTS)
        _check(bool(torch.isfinite(a).all()), f"{name}: non-finite regroup output")
        st = _compare(b, a, w, h)
        _say("regroup_plain", case=name, size=f"{w}x{h}", frames=frames, spp=spp,
             bounces=bounces, cuts=_CUTS, **{k: f"{v:.3e}" for k, v in st.items()})
        record["regroup_plain"][name] = st
        _check(st["rmse"] < RMSE_GATE and st["mean_rel"] < MEAN_REL_GATE, st)

    # 5. regroup against the megakernel, both CUDA, one frame
    tm = _TIMING
    w, h = tm["width"], tm["height"]
    scene, sky, basis = _case(tm["scene"], w, h, "cuda")
    inp_t = mk.kernel_inputs(scene, sky, basis)
    record["regroup_vs_megakernel"] = {}
    for spp in (tm["spp"], 1):
        a = _render(rg.launch_regrouped, inp_t, w, h, 1, spp, tm["bounces"], cuts=_CUTS)
        m = _render(mk.launch_megakernel, inp_t, w, h, 1, spp, tm["bounces"])
        st = _compare(m, a, w, h)
        st["pixels_differing"] = int((a != m).any(dim=1).sum())
        _say("regroup_vs_megakernel", shape=f"{tm['scene']} {w}x{h} spp{spp} "
             f"b{tm['bounces']}", cuts=_CUTS, pixels=w * h,
             **{k: (v if isinstance(v, int) else f"{v:.3e}") for k, v in st.items()})
        record["regroup_vs_megakernel"][f"spp{spp}"] = st
        _check(st["pixel_mismatch"] < FIRST_HIT_GATE and st["rmse"] < RMSE_GATE
               and st["mean_rel"] < MEAN_REL_GATE, st)
        # one sample per pixel leaves no sum to contract: the same bits
        _check(spp != 1 or st["pixels_differing"] == 0, st)

    # 6. the main paths, through the entry points a user calls: "auto"
    # (which resolves to regroup), then "pallas" (the megakernel)
    mp = _MAIN
    w, h = mp["width"], mp["height"]
    params = RenderParams(
        camera=SCENES["rtiow"][1](), viewport_size=(w, h),
        sampling=SamplingParams(max_samples_per_pixel=mp["max_spp"],
                                num_samples_per_pixel=mp["spp"],
                                num_bounces=mp["bounces"]))
    band0, band_h = 528, 32  # one full row of tiles
    record["main"] = {}
    launches = {}
    for backend in ("auto", "pallas"):
        renderer = Renderer(SCENES["rtiow"][0](), params, backend=backend, device="cuda")
        expect = "regroup" if backend == "auto" else "pallas"
        _check(renderer.backend == expect, (backend, renderer.backend))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launch_counts(mk, rg)
        stats = renderer.render()
        counts = _launch_counts(mk, rg)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        frames = stats.frames
        _check(frames == mp["max_spp"] // mp["spp"], stats)
        if expect == "regroup":
            want = {"megakernel": 0, "k0": frames, "pack": 3 * frames,
                    "k1": 3 * frames, "combine": 3 * frames}
        else:
            want = {"megakernel": frames, "k0": 0, "pack": 0, "k1": 0, "combine": 0}
        _check(counts == want, (expect, counts, want))
        launches[expect] = counts
        mean = renderer.mean_radiance()
        _check(tuple(mean.shape) == (h, w, 3), tuple(mean.shape))
        _check(bool(torch.isfinite(mean).all()), "non-finite accumulator")
        img = renderer.image()
        frac_black = float((img.max(axis=2) == 0).mean())
        frac_white = float((img.min(axis=2) == 255).mean())
        _check(20 < img.mean() < 235 and frac_black < 0.5 and frac_white < 0.5, (
            img.mean(), frac_black, frac_white))
        # a band of rows of the main path's image against its plain twin
        inp = mk.kernel_inputs(renderer._scene, renderer._sky, renderer._basis)
        ref = torch.zeros((w * band_h, 3), dtype=torch.float32, device="cuda")
        for f in range(frames):
            kw = dict(width=w, height=band_h, spp=mp["spp"], num_bounces=mp["bounces"],
                      row_offset=band0, full_height=h)
            if expect == "regroup":
                rg.render_image_regrouped_plain(ref, f, f == 0, renderer._scene,
                                                renderer._sky, renderer._basis,
                                                cuts=_CUTS, **kw)
            else:
                mk.render_plain_with_inputs(ref, inp, f, f == 0, **kw)
        ref = ref / stats.samples_per_pixel
        band = mean.reshape(-1, 3)[band0 * w:(band0 + band_h) * w]
        band_st = _compare(ref, band, w, band_h)
        _check(band_st["rmse"] < RMSE_GATE and band_st["mean_rel"] < MEAN_REL_GATE,
               band_st)
        warm_frames = frames - 1
        warm_s = (stats.seconds - stats.warmup_seconds) / max(warm_frames, 1)
        # where a frame's time goes: the per-frame host prep (host clock
        # around a synchronized kernel_inputs) and the kernels (CUDA events)
        t0 = time.perf_counter()
        for _ in range(5):
            mk.kernel_inputs(renderer._scene, renderer._sky, renderer._basis)
        torch.cuda.synchronize()
        prep_ms = (time.perf_counter() - t0) * 1e3 / 5
        scratch = torch.zeros_like(renderer._accum)
        fkw = dict(width=w, height=h, spp=mp["spp"], num_bounces=mp["bounces"])
        rec = {"frames": frames, "launches": counts, "warmup_s": stats.warmup_seconds,
               "warm_frame_s": warm_s, "rays_per_s": stats.rays_per_sec,
               "seconds": stats.seconds, "prep_ms": prep_ms, "peak_gb": peak_gb,
               "image_mean": float(img.mean()), "band": band_st}
        if expect == "regroup":
            stages = _stage_ms(lambda mark: rg.launch_regrouped(
                scratch, inp, 0, True, cuts=_CUTS, on_stage=mark, **fkw))
            # live records per phase, in dense rows of 128 (the last row part full)
            _, rows = rg.launch_regrouped(scratch, inp, 0, True, cuts=_CUTS,
                                          debug_counts=True, **fkw)
            rec.update(frame_kernel_ms=sum(stages.values()), stages_ms=stages,
                       rows=rows)
            extra = dict(stages_ms=json.dumps({k: round(v, 3) for k, v in stages.items()}),
                         rows=json.dumps(rows))
            # PACK and COMBINE bit for bit at the main path's size, where the
            # scan runs over 64 block totals a thread and a pixel folds 32 lanes
            big = _pack_combine_vs_plain(
                rg, inp, rg.plan(w, h, mp["spp"], mp["bounces"], _CUTS)[0], seed=1)
            rg_err["pack"] = max(rg_err["pack"], big["pack"])
            rg_err["combine"] = max(rg_err["combine"], big["combine"])
            rec["pack_combine_vs_plain"] = big
            _say("main", case="pack_combine_vs_plain", size=f"{w}x{h}", spp=mp["spp"],
                 pack="bit-exact", combine="bit-exact", pack_live=json.dumps(big["live"]))
        else:
            rec["frame_kernel_ms"] = _time_ms(lambda: mk.launch_megakernel(
                scratch, inp, 0, True, **fkw), 3)
            extra = {}
        record["main"][expect] = rec
        _say("main", backend=renderer.backend, frames=frames,
             launches=json.dumps(counts), spp=stats.samples_per_pixel,
             warmup_s=f"{stats.warmup_seconds:.3f}", warm_frame_s=f"{warm_s:.4f}",
             rays_per_s=f"{stats.rays_per_sec:.4e}",
             frame_kernel_ms=f"{rec['frame_kernel_ms']:.2f}", prep_ms=f"{prep_ms:.2f}",
             peak_gb=f"{peak_gb:.3f}", image_mean=f"{img.mean():.1f}",
             band=json.dumps(band_st), **extra, card=repr(smi))
        if expect == "regroup":
            from weekend_raytracer_tpu_torch.utils.image import save_png

            os.makedirs(os.path.dirname(os.path.abspath(args.png)), exist_ok=True)
            save_png(args.png, img)
        del renderer, scratch
        torch.cuda.empty_cache()

    # 7. kernels against plain time at one shape (CUDA events), and the
    # 1080p frame of each backend, in turns
    kw = dict(width=tm["width"], height=tm["height"], spp=tm["spp"],
              num_bounces=tm["bounces"])
    acc = torch.zeros((tm["width"] * tm["height"], 3), device="cuda")

    def mega():
        mk.launch_megakernel(acc, inp_t, 0, True, **kw)

    def mega_plain():
        mk.render_plain_with_inputs(acc, inp_t, 0, True, **kw)

    def regroup_stages(plain):
        fn = rg.regrouped_plain_with_inputs if plain else rg.launch_regrouped
        return _per_kernel(_stage_ms(lambda mark: fn(acc, inp_t, 0, True, cuts=_CUTS,
                                                     on_stage=mark, **kw)))

    mega()
    mega_plain()
    regroup_stages(False)
    regroup_stages(True)
    times = {"megakernel": [], "megakernel_plain": [], "regroup": [], "regroup_plain": []}
    for label, reps in (("plain", 2), ("kernel", 10), ("kernel", 10), ("plain", 2)):
        if label == "kernel":
            times["megakernel"].append(_time_ms(mega, reps))
            times["regroup"].append(regroup_stages(False))
        else:
            times["megakernel_plain"].append(_time_ms(mega_plain, reps))
            times["regroup_plain"].append(regroup_stages(True))
    ms = {"megakernel": min(times["megakernel"]),
          **{k: min(r[k] for r in times["regroup"]) for k in REGROUP_KERNELS}}
    plain_ms = {"megakernel": min(times["megakernel_plain"]),
                **{k: min(r[k] for r in times["regroup_plain"]) for k in REGROUP_KERNELS}}
    # the 1080p frame, kernels only: regroup, megakernel, megakernel, regroup
    inp = mk.kernel_inputs(*_case("rtiow", mp["width"], mp["height"], "cuda"))
    big = torch.zeros((mp["width"] * mp["height"], 3), device="cuda")
    fkw = dict(width=mp["width"], height=mp["height"], spp=mp["spp"],
               num_bounces=mp["bounces"])
    frame_fns = {
        "regroup": lambda: rg.launch_regrouped(big, inp, 0, True, cuts=_CUTS, **fkw),
        "megakernel": lambda: mk.launch_megakernel(big, inp, 0, True, **fkw)}
    frame_fns["regroup"]()
    frame_ms = {"regroup": [], "megakernel": []}
    for label in ("regroup", "megakernel", "megakernel", "regroup"):
        frame_ms[label].append(_time_ms(frame_fns[label], 3))
    _say("timing", shape=f"{tm['scene']} {tm['width']}x{tm['height']} "
         f"spp{tm['spp']} b{tm['bounces']}",
         kernel_ms=json.dumps({k: round(v, 4) for k, v in ms.items()}),
         plain_ms=json.dumps({k: round(v, 3) for k, v in plain_ms.items()}),
         frame_1080p_ms=json.dumps(frame_ms), card=repr(smi))
    record["timing"] = {"shape": tm, "kernel_ms": ms, "plain_ms": plain_ms,
                        "runs": times, "frame_1080p_ms": frame_ms}

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(record, f, indent=1)
    kernels = [{
        "name": "megakernel", "route": "cuda", "source": mk.KERNEL_SOURCE,
        "replaces": mk.REPLACES, "launches": launches["pallas"]["megakernel"],
        "max_abs_err": max_abs_err, "ms": ms["megakernel"],
        "plain_ms": plain_ms["megakernel"]}]
    for k in REGROUP_KERNELS:
        kernels.append({
            "name": f"regroup_{k}", "route": "cuda", "source": rg.KERNEL_SOURCE,
            "replaces": rg.REPLACES[k], "launches": launches["regroup"][k],
            "max_abs_err": rg_err[k], "ms": ms[k], "plain_ms": plain_ms[k]})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # any failed phase: no ok line, non-zero exit
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc!r}", file=sys.stderr)
        sys.exit(1)
