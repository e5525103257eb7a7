#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA megakernel from the sources in the checkout, holds it
against its plain PyTorch version on the card, renders the RTiOW final scene
at 1920x1080 (32 spp per frame, 96 spp, 8 bounces) through
``Renderer(backend="auto", device="cuda")``, checks that every frame went
through the kernel and that the image is right, and times the kernel against
the plain version. Each phase prints one line; any failure exits non-zero
without the final ``ok`` line. It needs a CUDA device and imports nothing of
JAX. Options: ``--png PATH`` (default: chip_smoke_rtiow.png in the temporary
directory) and ``--out DIR`` (also write every number as JSON there).
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
_MAIN = dict(width=1920, height=1080, spp=32, max_spp=96, bounces=8)
_TIMING = dict(scene="rtiow", width=480, height=270, spp=4, bounces=8)
RMSE_GATE = 5e-3  # tonemapped RMSE (tests/test_pallas.py's gate)
MEAN_REL_GATE = 1e-3  # relative linear mean radiance
FIRST_HIT_GATE = 0.01  # fraction of first-hit pixels allowed to differ


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


def _render(fn, inp, w, h, frames, spp, bounces):
    import torch

    acc = torch.zeros((w * h, 3), dtype=torch.float32, device="cuda")
    for f in range(frames):
        fn(acc, inp, f, f == 0, width=w, height=h, spp=spp, num_bounces=bounces)
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
    from weekend_raytracer_tpu_torch.ops.cuda import megakernel as mk

    _check("jax" not in sys.modules, "the port imported jax")
    smi = _nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    _say("env", device=repr(kind), torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())
    record["env"] = {"nvidia_smi": smi, "device": kind, "torch": torch.__version__,
                     "cuda": torch.version.cuda}

    # 2. build
    t0 = time.perf_counter()
    built = mk._library()
    build_s = time.perf_counter() - t0
    ptxas = built.ptxas_usage()
    attrs = {t: mk.kernel_attributes(t) for t in (False, True)}
    _say("build", seconds=f"{build_s:.2f}", nvcc_seconds=f"{built.build_seconds:.2f}",
         ptxas=json.dumps(ptxas, sort_keys=True), attributes=json.dumps(attrs))
    record["build"] = {"seconds": build_s, "nvcc_seconds": built.build_seconds,
                       "ptxas": ptxas, "attributes": {str(k): v for k, v in attrs.items()}}

    # 3. kernel against plain, both on the card
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

    # 4. the main path, through the entry points a user calls
    mp = _MAIN
    params = RenderParams(
        camera=SCENES["rtiow"][1](), viewport_size=(mp["width"], mp["height"]),
        sampling=SamplingParams(max_samples_per_pixel=mp["max_spp"],
                                num_samples_per_pixel=mp["spp"],
                                num_bounces=mp["bounces"]))
    renderer = Renderer(SCENES["rtiow"][0](), params, backend="auto", device="cuda")
    _check(renderer.backend == "pallas", renderer.backend)
    mk.render_image_megakernel.launches = 0
    stats = renderer.render()
    launches = mk.render_image_megakernel.launches
    _check(stats.frames == mp["max_spp"] // mp["spp"], stats)
    _check(launches == stats.frames, (launches, stats.frames))
    mean = renderer.mean_radiance()
    _check(tuple(mean.shape) == (mp["height"], mp["width"], 3), tuple(mean.shape))
    _check(bool(torch.isfinite(mean).all()), "non-finite accumulator")
    img = renderer.image()
    frac_black = float((img.max(axis=2) == 0).mean())
    frac_white = float((img.min(axis=2) == 255).mean())
    _check(20 < img.mean() < 235 and frac_black < 0.5 and frac_white < 0.5, (
        img.mean(), frac_black, frac_white))
    # a band of rows of the main path's image against the plain version
    band0, band_h = 536, 8
    w, h = mp["width"], mp["height"]
    inp = mk.kernel_inputs(renderer._scene, renderer._sky, renderer._basis)
    ref = torch.zeros((w * band_h, 3), dtype=torch.float32, device="cuda")
    for f in range(stats.frames):
        mk.render_plain_with_inputs(ref, inp, f, f == 0, width=w, height=band_h,
                                    spp=mp["spp"], num_bounces=mp["bounces"],
                                    row_offset=band0, full_height=h)
    ref = ref / stats.samples_per_pixel
    band = mean.reshape(-1, 3)[band0 * w:(band0 + band_h) * w]
    band_st = _compare(ref, band, w, band_h)
    _check(band_st["rmse"] < RMSE_GATE and band_st["mean_rel"] < MEAN_REL_GATE, band_st)
    from weekend_raytracer_tpu_torch.utils.image import save_png

    os.makedirs(os.path.dirname(os.path.abspath(args.png)), exist_ok=True)
    save_png(args.png, img)
    warm_frames = stats.frames - 1
    warm_s = (stats.seconds - stats.warmup_seconds) / max(warm_frames, 1)
    # where a frame's time goes: the per-frame host prep (host clock around
    # a synchronized kernel_inputs) and the kernel alone (CUDA events)
    t0 = time.perf_counter()
    for _ in range(5):
        mk.kernel_inputs(renderer._scene, renderer._sky, renderer._basis)
    torch.cuda.synchronize()
    prep_ms = (time.perf_counter() - t0) * 1e3 / 5
    scratch = torch.zeros_like(renderer._accum)
    frame_kernel_ms = _time_ms(lambda: mk.launch_megakernel(
        scratch, inp, 0, True, width=w, height=h, spp=mp["spp"],
        num_bounces=mp["bounces"]), 3)
    _say("main", backend=renderer.backend, frames=stats.frames, launches=launches,
         spp=stats.samples_per_pixel, warmup_s=f"{stats.warmup_seconds:.3f}",
         warm_frame_s=f"{warm_s:.4f}", rays_per_s=f"{stats.rays_per_sec:.4e}",
         frame_kernel_ms=f"{frame_kernel_ms:.2f}", prep_ms=f"{prep_ms:.2f}",
         image_mean=f"{img.mean():.1f}", band=json.dumps(band_st), png=args.png,
         card=repr(smi))
    record["main"] = {"frames": stats.frames, "launches": launches,
                      "warmup_s": stats.warmup_seconds, "warm_frame_s": warm_s,
                      "rays_per_s": stats.rays_per_sec, "seconds": stats.seconds,
                      "frame_kernel_ms": frame_kernel_ms, "prep_ms": prep_ms,
                      "image_mean": float(img.mean()), "band": band_st}

    # 5. kernel against plain time, one shape, CUDA events
    tm = _TIMING
    scene, sky, basis = _case(tm["scene"], tm["width"], tm["height"], "cuda")
    inp = mk.kernel_inputs(scene, sky, basis)
    acc = torch.zeros((tm["width"] * tm["height"], 3), device="cuda")
    kw = dict(width=tm["width"], height=tm["height"], spp=tm["spp"],
              num_bounces=tm["bounces"])

    def kernel():
        mk.launch_megakernel(acc, inp, 0, True, **kw)

    def plain():
        mk.render_plain_with_inputs(acc, inp, 0, True, **kw)

    kernel()
    plain()
    times = {"kernel": [], "plain": []}
    for order in (("plain", 2), ("kernel", 10), ("kernel", 10), ("plain", 2)):
        times[order[0]].append(_time_ms(kernel if order[0] == "kernel" else plain,
                                        order[1]))
    ms, plain_ms = min(times["kernel"]), min(times["plain"])
    _say("timing", shape=f"{tm['scene']} {tm['width']}x{tm['height']} "
         f"spp{tm['spp']} b{tm['bounces']}", kernel_ms=f"{ms:.3f}",
         plain_ms=f"{plain_ms:.3f}", runs=json.dumps(times), card=repr(smi))
    record["timing"] = {"shape": tm, "kernel_ms": ms, "plain_ms": plain_ms,
                        "runs": times}

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(record, f, indent=1)
    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "megakernel", "route": "cuda", "source": mk.KERNEL_SOURCE,
        "replaces": mk.REPLACES, "launches": launches,
        "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms}]}), flush=True)
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
