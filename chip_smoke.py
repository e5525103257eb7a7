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
times the kernels against their plain versions.

The ``[stats]`` phase holds the two stats kernels (the megakernel's and
K1's kStats instantiations) against their twins at small sizes (a
super-chunk scene among them), then runs the counters' own path at full
size, as benchmarks/kernel_stats.py and benchmarks/profile_regroup.py's
``stats`` run the TPU kernels: the megakernel with ``stats=True`` on RTiOW
1920x1080 and random_spheres(10000) at 3840x2160 (4 spp, 8 bounces), and
K0 -> PACK -> K1(stats) at the first cut of RTiOW 1920x1080 x 32 spp. Each
full-size table is held against the twin on a part of it (the last row of
TPU tiles, the last dense tiles); the phase prints the summaries and times
each stats kernel against its kStats = false twin. ``[trace]`` runs one regroup
1080p frame under ``utils.metrics.profiler_trace`` and prints what the
profiler saw beside the CUDA-event stage times. The ``kernels`` line gives
every kernel its time, its twin's, its bound (the least time the card could
take, from this run's live counts) and a library call's time where one
computes the same function.

Each phase prints one line; any failure exits non-zero without the final
``ok`` line. It needs a CUDA device and imports nothing of JAX. Options:
``--png PATH`` (default: chip_smoke_rtiow.png in the temporary directory)
and ``--out DIR`` (also write every number as JSON there, and the profiler
trace).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

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
# Each counter column's sum against the twin over 8 bounces. The megakernel
# and its twin differ only by nvcc's contraction of a * b + c into FMAs,
# which the twin does not do: built with -fmad=false the kernel equals its
# twin in every bit, image and counters (tools/fma_divergence.py). With it,
# paths that part by an ulp move the sums by under 0.4% on RTiOW and by up
# to 2.7% on the random_spheres scenes, where more of them part.
STATS_SUM_GATE = 0.01
STATS_SUM_GATE_RANDOM = 0.03
_RANDOM_SCENES = ("super", "random10k")
REGROUP_KERNELS = ("k0", "pack", "k1", "combine")
# name, w, h, spp of the stats kernels' cases against their twins: RTiOW, and
# random_spheres(1200) in 75 chunks of 16 and 5 super-chunks, seen through a
# narrow lens so that a tile's rays miss some super-chunks (col 3)
_STATS_PLAIN_CASES = (("rtiow", 96, 64, 4), ("super", 256, 128, 4))
K1_SPAN_TILES = 32  # dense tiles of the 1080p pool held against k1_plain
# the counters' full-size cases: benchmarks/kernel_stats.py:30, 41-45 and
# benchmarks/profile_regroup.py:42, 114-279
_STATS_MK = (("rtiow", 1920, 1080), ("random10k", 3840, 2160))
_STATS_MK_RUN = dict(spp=4, bounces=8, frame=1)
_STATS_K1 = dict(width=1920, height=1080, spp=32, bounces=8, frame=0)
# H100 SXM peaks at 700 W (NVIDIA's published figures)
FP32_PEAK = 67e12  # FP32 operations per second, outside the tensor cores
HBM_RATE = 3.35e12  # bytes per second
SPHERE_TEST_OPS = 21  # FP32 operations of one sphere test (bounce.cuh sweep_sphere)
SLAB_TEST_OPS = 12  # per chunk or super-chunk box: 6 subtractions, 6 products
RECORD_BYTES = 64  # a pool record: 16 f32 components


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


def _stats_inputs(mk, name, w, h, device):
    """Kernel inputs of a _STATS_PLAIN_CASES case."""
    if name != "super":
        return mk.kernel_inputs(*_case(name, w, h, device))
    from weekend_raytracer_tpu_torch import Camera, CameraBasis, SkyParams, to_sky_state
    from weekend_raytracer_tpu_torch.models.scenes import random_spheres

    cam = Camera.look_at((0.0, 6.0, 60.0), (30.0, 0.5, 30.0), vfov_degrees=8.0,
                         aperture=0.02)
    return mk.kernel_inputs(random_spheres(1200).build(device=device),
                            to_sky_state(SkyParams(), device=device),
                            CameraBasis.create(cam, (w, h), device=device), chunk_size=16)


def _render(fn, inp, w, h, frames, spp, bounces, **kw):
    acc = torch.zeros((w * h, 3), dtype=torch.float32, device="cuda")
    for f in range(frames):
        fn(acc, inp, f, f == 0, width=w, height=h, spp=spp, num_bounces=bounces, **kw)
    torch.cuda.synchronize()
    return acc / (frames * spp)


def _time_ms(fn, reps: int) -> float:
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
            **{k: getattr(rg, f"launch_{k}").launches for k in REGROUP_KERNELS},
            "megakernel_stats": mk.render_image_megakernel.stats_launches,
            "k1_stats": rg.launch_k1.stats_launches}


def _zero_launch_counts(mk, rg) -> None:
    mk.render_image_megakernel.launches = 0
    mk.render_image_megakernel.stats_launches = 0
    rg.launch_k1.stats_launches = 0
    for k in REGROUP_KERNELS:
        getattr(rg, f"launch_{k}").launches = 0


def _bitwise_max_err(a, b, what) -> float:
    """Check that a and b are equal in every bit, +0.0 and -0.0 held equal;
    returns max |a - b| (0.0 then)."""
    same = a.shape == b.shape and torch.equal((a + 0.0).view(torch.int32),
                                              (b + 0.0).view(torch.int32))
    _check(same, (what, "not bit for bit"))
    return float((a - b).nan_to_num(0.0).abs().max()) if a.numel() else 0.0


def _k0_k1_vs_plain(mk, rg) -> dict:
    """K0 and K1 against their twins on the first-hit scene (two bounces
    into a constant sky, so every path is decided), cut after bounce 0.
    K0's alive flags and home slots must agree exactly, K1's alive flags on
    99% of the records, and the radiance of both with an error of 0."""
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


def _check_stats(st, max_iters: int, what, chunked: bool = True) -> None:
    """tests/test_pallas.py:252-255's invariants, in every tile of a
    counter table (its live tiles, for K1)."""
    _check(tuple(st.shape[1:]) == (8,) and bool((st[:, 4:] == 0).all()), (what, "shape"))
    _check(bool((st[:, 0] >= 1).all() and (st[:, 0] <= max_iters).all()), (what, "iterations"))
    _check(bool((st[:, 1] > 0).all()), (what, "live lanes"))
    _check(not chunked or bool((st[:, 2] >= st[:, 0]).all()), (what, "chunks < iterations"))


def _sum_rel(st, ref) -> list:
    """Each counter column's sum against the twin's, relative."""
    a, b = st[:, :4].double().sum(0), ref[:, :4].double().sum(0)
    return [float(abs(x - y) / y) if y else float(x != 0) for x, y in zip(a, b)]


def _dense_pool(rg, inp, t, frame, cut):
    """K0 (bounces [0, cut)) and PACK, kernels: the dense pool K1 takes,
    its counts [cap, live] and the live record count."""
    dev = inp.sweep.device
    pool = torch.empty((rg.N_COMP, t.cap), device=dev)
    rg.launch_k0(inp, pool, torch.empty((3, t.cap), device=dev), t, frame, cut)
    dense = torch.empty_like(pool)
    counts = torch.tensor([t.cap, 0], dtype=torch.int32, device=dev)
    rg.launch_pack(pool, dense, torch.empty((t.cap,), dtype=torch.int32, device=dev), counts, 1,
                   torch.empty((t.cap // 1024,), dtype=torch.int32, device=dev))
    del pool
    return dense, counts, int(counts[1])


def _k1_stats(rg, fn, inp, dense, counts, t, frame, b_lo, b_hi):
    """K1 (kernel or twin) with counters on a copy of the dense pool."""
    st = torch.full((t.cap // rg.TILE_RECORDS, 8), -1.0, device=dense.device)
    fn(inp, dense.clone(), torch.empty((3, t.cap), device=dense.device), counts, 1, t, frame,
       b_lo, b_hi, stats=st)
    return st


def _stats_vs_plain(mk, rg) -> dict:
    """Both stats kernels against their twins at small sizes: the
    megakernel on each _STATS_PLAIN_CASES case, K1 on RTiOW 96x64 x 4 spp.
    Equal per tile over one bounce, each column's sum within _sum_gate
    over more (8 for the megakernel, [2, 4) for K1), the invariants in
    every tile, and the kStats image equal in every bit to the kStats =
    false one; in the super-chunk case some tile enters fewer super-chunks
    than there are. Returns the counters' largest error at one bounce and
    the sums'."""
    dev = torch.device("cuda")
    out = {"megakernel_err": 0.0, "k1_err": 0.0, "megakernel_sum_rel": {}}
    for name, w, h, spp in _STATS_PLAIN_CASES:
        inp = _stats_inputs(mk, name, w, h, dev)
        for bounces in (1, 8):
            kw = dict(width=w, height=h, spp=spp, num_bounces=bounces)
            img, st = mk.launch_megakernel(torch.zeros((w * h, 3), device=dev), inp, 1, True,
                                           stats=True, **kw)
            _, ref = mk.render_plain_with_inputs(torch.zeros((w * h, 3), device=dev), inp, 1,
                                                 True, stats=True, **kw)
            img0 = mk.launch_megakernel(torch.zeros((w * h, 3), device=dev), inp, 1, True, **kw)
            torch.cuda.synchronize()
            what = ("megakernel stats", name, bounces)
            _check(torch.equal(img, img0), what + ("image",))
            # a late iteration whose live rays all leave the scene enters no chunk
            _check_stats(st, spp * bounces, what, chunked=name == "rtiow" or bounces == 1)
            if bounces == 1:
                out["megakernel_err"] = max(out["megakernel_err"], float((st - ref).abs().max()))
                _check(torch.equal(st, ref), what + ("at one bounce", st, ref))
                if inp.n_super:
                    _check(bool((st[:, 3] > 0).all() and (st[:, 3] < inp.n_super * spp).any()),
                           what + ("super-chunks", st[:, 3]))
            else:
                out["megakernel_sum_rel"][name] = _sum_rel(st, ref)
                _check(max(out["megakernel_sum_rel"][name]) < _sum_gate(name), out)
    w, h, spp = 96, 64, 4
    inp = _stats_inputs(mk, "rtiow", w, h, dev)
    t, _ = rg.plan(w, h, spp, 8, _CUTS)
    dense, counts, n = _dense_pool(rg, inp, t, 0, _CUTS[0])
    live = -(-n // rg.TILE_RECORDS)
    for b_hi in (_CUTS[0] + 1, _CUTS[1]):
        st, ref = (_k1_stats(rg, fn, inp, dense, counts, t, 0, _CUTS[0], b_hi)
                   for fn in (rg.launch_k1, rg.k1_plain))
        torch.cuda.synchronize()
        _check(bool((st[live:] == 0).all()), "K1 stats past the count")
        _check_stats(st[:live], b_hi - _CUTS[0], ("K1 stats", b_hi))
        if b_hi == _CUTS[0] + 1:
            out["k1_err"] = float((st - ref).abs().max())
            _check(torch.equal(st, ref), ("K1 stats over one bounce", st[:live], ref[:live]))
        else:
            out["k1_sum_rel"] = _sum_rel(st[:live], ref[:live])
            _check(max(out["k1_sum_rel"]) < STATS_SUM_GATE, out)
    return out


def _sum_gate(name: str) -> float:
    return STATS_SUM_GATE_RANDOM if name in _RANDOM_SCENES else STATS_SUM_GATE


def _megakernel_band_vs_plain(mk, name, inp, w, h, run, table) -> dict:
    """The kStats megakernel at full size against its twin on the image's
    last row of TPU tiles (a band of rows at full width through row_offset
    and full_height; its padding rows repeat the image's last row, as the
    full image's do): the kernel's rows of that band equal the twin's per
    tile over one bounce (a full-size launch of its own), and each column's
    sum within _sum_gate(name) over the path's bounces (``table``, the
    path's own)."""
    dev = inp.sweep.device
    top = (h - 1) // mk.TILE_H * mk.TILE_H
    tiles_x = -(-w // mk.TILE_W)
    out = {"rows": [top, h], "tiles": tiles_x}
    one = mk.launch_megakernel(torch.zeros((w * h, 3), device=dev), inp, run["frame"], True,
                               width=w, height=h, spp=run["spp"], num_bounces=1, stats=True)[1]
    for bounces, full in ((1, one), (run["bounces"], table)):
        kw = dict(width=w, spp=run["spp"], num_bounces=bounces, stats=True)
        _, ref = mk.render_plain_with_inputs(torch.zeros((w * (h - top), 3), device=dev), inp,
                                             run["frame"], True, height=h - top, row_offset=top,
                                             full_height=h, **kw)
        st = full[-tiles_x:]
        if bounces == 1:
            out["err_one_bounce"] = float((st - ref).abs().max())
            _check(torch.equal(st, ref), ("megakernel stats band at one bounce", w, h, out))
        else:
            out["sum_rel"] = _sum_rel(st, ref)
            _check(max(out["sum_rel"]) < _sum_gate(name), ("megakernel stats band", w, h, out))
    return out


def _k1_span_vs_plain(rg, inp, dense, counts, n, t, frame, b_lo, b_hi, table) -> dict:
    """K1's kStats kernel on the whole dense pool against k1_plain on its
    last K1_SPAN_TILES dense tiles (the last part full), moved to the front
    of a pool of their own: the kernel's rows equal the twin's per tile over
    [b_lo, b_lo + 1) (a launch of its own) and each column's sum within
    STATS_SUM_GATE over [b_lo, b_hi) (``table``, the path's own)."""
    dev = dense.device
    live = -(-n // rg.TILE_RECORDS)
    t0 = max(0, live - K1_SPAN_TILES)
    start = t0 * rg.TILE_RECORDS
    span = torch.zeros_like(dense)
    span[:, :n - start] = dense[:, start:n]
    span_counts = torch.tensor([t.cap, n - start], dtype=torch.int32, device=dev)
    out = {"tiles": [t0, live]}
    one = _k1_stats(rg, rg.launch_k1, inp, dense, counts, t, frame, b_lo, b_lo + 1)
    for hi, full in ((b_lo + 1, one), (b_hi, table)):
        ref = _k1_stats(rg, rg.k1_plain, inp, span, span_counts, t, frame, b_lo, hi)
        st, ref = full[t0:live], ref[:live - t0]
        if hi == b_lo + 1:
            out["err_one_bounce"] = float((st - ref).abs().max())
            _check(torch.equal(st, ref), ("K1 stats span over one bounce", out))
        else:
            out["sum_rel"] = _sum_rel(st, ref)
            _check(max(out["sum_rel"]) < STATS_SUM_GATE, ("K1 stats span", out))
    return out


def _summary(st, inp, lanes: int = 32 * 128) -> dict:
    """benchmarks/kernel_stats.py's summary (lines 52-66) and
    profile_regroup.py's k1_stats fields (264-277) of one counter table,
    with the scene's own chunk size (kernel_stats.py assumes 32)."""
    st = st.double().cpu()
    iters, live, chunks, supers = st[:, 0], st[:, 1], st[:, 2], st[:, 3]
    q = torch.quantile(iters, torch.tensor([0.1, 0.5, 0.9, 1.0], dtype=torch.float64))
    entry = chunks / (iters * max(inp.n_chunks, 1) + 1e-9)
    return {
        "tiles": int(st.shape[0]), "iters_mean": float(iters.mean()),
        "iters_p10_p50_p90_max": [float(v) for v in q],
        "live_frac_mean": float((live / (iters * lanes + 1e-9)).mean()),
        "chunk_entry_frac": float(entry.mean()),
        "supers_per_tile": float(supers.mean()),
        "tests_per_segment": float((chunks * inp.chunk_size * lanes).sum()
                                   / max(float(live.sum()), 1.0)),
        "spheres": inp.n_spheres, "chunks": inp.n_chunks, "chunk_size": inp.chunk_size,
        "supers": inp.n_super,
    }


def _stats_path(mk, rg) -> dict:
    """The counters' own path at full size, through the entry points:
    render_image_megakernel(stats=True) for each _STATS_MK case, and K0 ->
    PACK -> K1(stats) at the first cut of RTiOW 1080p x 32 spp. Each counter
    table is checked, summarised, and held against a second run in which the
    kStats kernel is timed against its kStats = false twin (CUDA events, in
    turns); the 1080p stats image must equal the stats=False one in every
    bit. Returns the launches of the path, the summaries and the times."""
    dev = torch.device("cuda")
    run = _STATS_MK_RUN
    cases = {}
    for name, w, h in _STATS_MK:
        cases[name] = (w, h, *_case(name, w, h, dev))
    k = _STATS_K1
    t, cuts = rg.plan(k["width"], k["height"], k["spp"], k["bounces"], _CUTS)
    scene, sky, basis = _case("rtiow", k["width"], k["height"], dev)
    inp_k1 = mk.kernel_inputs(scene, sky, basis)
    torch.cuda.synchronize()
    _zero_launch_counts(mk, rg)
    tables, images = {}, {}
    for name, (w, h, sc, sk, ba) in cases.items():
        images[name], tables[name] = mk.render_image_megakernel(
            torch.zeros((w * h, 3), device=dev), run["frame"], True, sc, sk, ba, width=w,
            height=h, spp=run["spp"], num_bounces=run["bounces"], stats=True)
    dense, counts, n = _dense_pool(rg, inp_k1, t, k["frame"], cuts[0])
    st_k1 = torch.empty((t.cap // rg.TILE_RECORDS, 8), device=dev)
    rg.launch_k1(inp_k1, dense.clone(), torch.empty((3, t.cap), device=dev), counts, 1, t,
                 k["frame"], cuts[0], cuts[1], stats=st_k1)
    torch.cuda.synchronize()
    launches = _launch_counts(mk, rg)
    want = {"megakernel": 0, "k0": 1, "pack": 1, "k1": 0, "combine": 0,
            "megakernel_stats": len(_STATS_MK), "k1_stats": 1}
    _check(launches == want, ("stats path launches", launches, want))
    out = {"launches": launches, "summary": {}, "ms": {}, "vs_plain": {}}
    for name, (w, h, sc, sk, ba) in cases.items():
        st = tables[name]
        # a tile of sky enters no chunk, so chunks >= iterations holds only
        # at the small sizes of _stats_vs_plain, where every tile sees spheres
        _check_stats(st, run["spp"] * run["bounces"], name, chunked=False)
        inp = mk.kernel_inputs(sc, sk, ba)
        out["vs_plain"][f"megakernel_{name}"] = _megakernel_band_vs_plain(
            mk, name, inp, w, h, run, st)
        out["summary"][f"megakernel_{name}"] = _summary(st, inp)
        kw = dict(width=w, height=h, spp=run["spp"], num_bounces=run["bounces"])
        scratch = torch.zeros((w * h, 3), device=dev)
        times = {False: [], True: []}
        reps = 2 if name == "rtiow" else 1
        for stats in (False, True, True, False):
            times[stats].append(_time_ms(lambda: mk.launch_megakernel(
                scratch, inp, run["frame"], True, stats=stats, **kw), reps))
        if name == "rtiow":
            _check(torch.equal(scratch, images[name]), "1080p stats image differs")
        out["ms"][f"megakernel_{name}"] = {"stats": times[True], "plain_kernel": times[False]}
    live = -(-n // rg.TILE_RECORDS)
    _check_stats(st_k1[:live], cuts[1] - cuts[0], "k1 stats", chunked=False)
    _check(bool((st_k1[live:] == 0).all()), "K1 stats past the count")
    out["summary"]["k1_rtiow"] = {"cut": cuts[0], "b_hi": cuts[1], "live_records": n,
                                  "of": t.cap, **_summary(st_k1[:live], inp_k1)}
    out["vs_plain"]["k1_rtiow"] = _k1_span_vs_plain(rg, inp_k1, dense, counts, n, t,
                                                    k["frame"], cuts[0], cuts[1], st_k1)
    times = {False: [], True: []}
    for stats in (False, True, True, False):
        times[stats].append(_k1_ms(rg, inp_k1, dense, counts, t, k["frame"], cuts[0], cuts[1],
                                   stats, reps=2))
    out["ms"]["k1_rtiow"] = {"stats": times[True], "plain_kernel": times[False]}
    return out


def _k1_ms(rg, inp, dense, counts, t, frame, b_lo, b_hi, stats: bool, reps: int,
           fn=None) -> float:
    """Mean CUDA-event time of K1 (or ``fn``, its twin) on a fresh copy of
    the dense pool per run; the copies are not timed."""
    fn = fn or rg.launch_k1
    st = torch.empty((t.cap // rg.TILE_RECORDS, 8), device=dense.device) if stats else None
    r8 = torch.empty((3, t.cap), device=dense.device)
    total = 0.0
    for _ in range(reps):
        pool = dense.clone()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(inp, pool, r8, counts, 1, t, frame, b_lo, b_hi, stats=st)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
        del pool
    return total / reps


def _trace_frame(rg, inp, fkw, log_dir) -> dict:
    """One regroup frame under profiler_trace, with CUDA-event stage times
    beside it: each kernel's device time as the profiler's key_averages()
    report it, and how many device events it recorded."""
    import re

    from torch.autograd import DeviceType

    from weekend_raytracer_tpu_torch.utils.metrics import profiler_trace

    scratch = torch.zeros((fkw["width"] * fkw["height"], 3), device="cuda")
    rg.launch_regrouped(scratch, inp, 0, True, cuts=_CUTS, **fkw)  # warm
    torch.cuda.synchronize()
    with profiler_trace(log_dir) as prof:
        stages = _stage_ms(lambda mark: rg.launch_regrouped(
            scratch, inp, 0, True, cuts=_CUTS, on_stage=mark, **fkw))
    device_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us and e.device_type == DeviceType.CUDA:
            m = re.search(r"(\w+)(<[^(]*>)?\(", e.key)
            name = m.group(1) if m else e.key[:40]
            kernels[name] = kernels.get(name, 0.0) + us / 1e3
    return {"device_events": len(device_events), "kernel_ms": kernels,
            "kernel_total_ms": sum(kernels.values()), "stages_ms": stages,
            "stage_total_ms": sum(stages.values())}


def _slot_pixels(t, dev):
    """Pixel column and row of each ray slot of tiling ``t``, unclamped
    (past the image edge for the padding slots)."""
    slot = torch.arange(t.cap, device=dev)
    tile, row, lane = slot >> 12, (slot >> 7) & 31, slot & 127
    return ((tile % t.tiles_x) * t.block_w + (lane >> t.spp_shift),
            (tile // t.tiles_x) * 32 + row)


def _live_per_bounce(rg, inp, t, frame, bounces):
    """Paths alive at the start of each bounce (K0 run to each depth): of
    every slot, and of the slots of real pixels (the megakernel's)."""
    dev = inp.sweep.device
    x, y = _slot_pixels(t, dev)
    real = (x < t.width) & (y < t.height)
    live_all, live_real = [t.cap], [int(real.sum())]
    pool = torch.empty((rg.N_COMP, t.cap), device=dev)
    contrib = torch.empty((3, t.cap), device=dev)
    for b in range(1, bounces):
        rg.launch_k0(inp, pool, contrib, t, frame, b)
        alive = pool[rg._AL] > 0.5
        live_all.append(int(alive.sum()))
        live_real.append(int((alive & real).sum()))
    return live_all, live_real


def _bound(ops: float, nbytes: float) -> dict:
    """The least time the card could take: operations over the FP32 peak or
    bytes over the memory rate, whichever is larger."""
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_RATE
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes}


def _bounds(mk, inp, t, live_all, live_real, mk_stats=None, k1_stats=None) -> dict:
    """Each kernel's bound at the [timing] shape, from this run's live
    counts: a live path segment (a path alive at the start of a bounce)
    tests every prepared sphere; a kStats segment also tests the priors and
    every chunk and super-chunk box. The megakernels trace the real
    pixels' paths (the stats one counts the TPU's padded lanes without
    tracing them); K1 stats traces the segments of its table's col 1
    (``k1_stats``). Each record or value is read once and written once
    (csrc/regroup.cu's layout), and a stats table (``mk_stats``,
    ``k1_stats``) written once. The scatter, camera and sky add under 2%
    to a sweep of 496 spheres and are not counted."""
    n = inp.n_spheres
    sweep = SPHERE_TEST_OPS * n
    counted = sweep + SPHERE_TEST_OPS * mk.N_PRIORS + SLAB_TEST_OPS * (inp.n_tests
                                                                        + inp.n_super)
    pixels = t.width * t.height
    cuts = list(_CUTS)
    n_in = [t.cap] + [live_all[c] for c in cuts[:-1]]  # each PACK's input records
    n_out = [live_all[c] for c in cuts]  # and the live records it keeps
    k1_seg = sum(live_all[cuts[0]:])
    out = {
        "megakernel": _bound(sweep * sum(live_real), pixels * 12),
        "k0": _bound(sweep * (live_all[0] + live_all[1]), t.cap * (RECORD_BYTES + 12)),
        "pack": _bound(0, sum(a * 8 + b * 2 * RECORD_BYTES for a, b in zip(n_in, n_out))),
        "k1": _bound(sweep * k1_seg, sum(b * (2 * RECORD_BYTES + 12) for b in n_out)),
        "combine": _bound(0, sum(a * 4 + b * 24 for a, b in zip(n_in[1:], n_out[1:]))
                          + t.cap * 16 + pixels * 12),
    }
    if mk_stats is not None:
        out["megakernel_stats"] = _bound(counted * sum(live_real),
                                         pixels * 12 + mk_stats.numel() * 4)
    if k1_stats is not None:
        out["k1_stats"] = _bound(counted * float(k1_stats[:, 1].sum()),
                                 n_out[0] * (2 * RECORD_BYTES + 12) + k1_stats.numel() * 4)
    return out


def _library_ms(rg, inp, t, frame, num_bounces, live_all, reps: int = 5) -> dict:
    """One PyTorch call per kernel's function, where one computes it, on
    this frame's own inputs at the [timing] shape (a manual K0 -> PACK ->
    K1 chain of the kernels gives them): PACK as torch.nonzero +
    index_select of the live records (the inverse map left out), COMBINE as
    an index_put_ per level and one index_add_ of every slot's radiance
    into its pixel (the home level's fold); the indices are computed
    outside the timed calls. The sweeps have no such call."""
    dev = inp.sweep.device
    pool = torch.empty((rg.N_COMP, t.cap), device=dev)
    contrib = torch.empty((3, t.cap), device=dev)
    rg.launch_k0(inp, pool, contrib, t, frame, _CUTS[0])
    counts = torch.full((len(_CUTS) + 1,), t.cap, dtype=torch.int32, device=dev)
    pools = [pool, torch.empty_like(pool)]
    invs, r8s = [], []
    block_sums = torch.empty((t.cap // 1024,), dtype=torch.int32, device=dev)
    pack_ms = 0.0
    for k, b_lo in enumerate(_CUTS, 1):
        src, dst = pools[(k - 1) % 2], pools[k % 2]
        n_in = t.cap if k == 1 else live_all[_CUTS[k - 2]]

        def lib_pack(src=src, n_in=n_in):
            idx = torch.nonzero(src[rg._AL, :n_in] > 0.5).squeeze(1)
            return src.index_select(1, idx)

        pack_ms += _time_ms(lib_pack, reps)
        invs.append(torch.empty((t.cap,), dtype=torch.int32, device=dev))
        rg.launch_pack(src, dst, invs[-1], counts, k, block_sums)
        r8s.append(torch.empty((3, t.cap), device=dev))
        b_hi = _CUTS[k] if k < len(_CUTS) else num_bounces
        rg.launch_k1(inp, dst, r8s[-1], counts, k, t, frame, b_lo, b_hi)
    combine_ms = 0.0
    radiance = r8s[-1]
    for k in range(len(_CUTS), 1, -1):
        n_in = live_all[_CUTS[k - 2]]
        j = invs[k - 1][:n_in].long()
        p = torch.nonzero(j >= 0).squeeze(1)
        jp = j[p]
        base = r8s[k - 2]

        def lib_level(base=base, p=p, jp=jp, radiance=radiance):
            base[:, p] = radiance[:, jp]

        combine_ms += _time_ms(lib_level, reps)
        lib_level()
        radiance = base
    j = invs[0].long()
    per_slot = torch.where(j >= 0, radiance[:, j.clamp(min=0)], contrib).T.contiguous()
    x, y = _slot_pixels(t, dev)
    real = torch.nonzero((x < t.width) & (y < t.height)).squeeze(1)
    pix = (y * t.width + x)[real]
    vals = per_slot[real]
    acc = torch.zeros((t.width * t.height, 3), device=dev)
    combine_ms += _time_ms(lambda: acc.index_add_(0, pix, vals), reps)
    return {"pack": pack_ms, "combine": combine_ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--png", default=os.path.join(tempfile.gettempdir(),
                                                  "chip_smoke_rtiow.png"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    record = {}

    # 1. environment
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
    attrs = {"megakernel": {("textured" if t else "plain") + ("_stats" if st else ""):
                            mk.kernel_attributes(t, st) for t in (False, True)
                            for st in (False, True)},
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
        want.update(megakernel_stats=0, k1_stats=0)
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
            # one frame first, as [trace] does, so that the stages time
            # the kernels alone: the first frame after the band check's
            # twin can put host work between the start event and K0
            rg.launch_regrouped(scratch, inp, 0, True, cuts=_CUTS, **fkw)
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

    # 7. the stats kernels against their twins, then the counters' own path
    # at full size, with its launches counted from 0 (after the main paths,
    # so that their numbers are taken as before)
    sv = _stats_vs_plain(mk, rg)
    _say("stats", case="vs_plain",
         shapes=json.dumps([f"{n} {w}x{h} spp{spp}" for n, w, h, spp in _STATS_PLAIN_CASES]),
         bounces="1 and 8", k1_span=f"[{_CUTS[0]}, {_CUTS[0] + 1}) and [{_CUTS[0]}, {_CUTS[1]})",
         megakernel_err_one_bounce=sv["megakernel_err"], k1_err_one_bounce=sv["k1_err"],
         megakernel_sum_rel=json.dumps({k: [round(x, 5) for x in v]
                                        for k, v in sv["megakernel_sum_rel"].items()}),
         k1_sum_rel=json.dumps([round(v, 5) for v in sv["k1_sum_rel"]]))
    sp = _stats_path(mk, rg)
    for name, cmp in sp["vs_plain"].items():
        _say("stats", case=f"{name}_vs_plain_full_size", **{k: json.dumps(v)
                                                            for k, v in cmp.items()})
    for name, summ in sp["summary"].items():
        _say("stats", case=name, **{k: json.dumps(v) for k, v in summ.items()})
    _say("stats", case="stats_vs_plain_kernel_ms", ms=json.dumps(sp["ms"]),
         launches=json.dumps(sp["launches"]), card=repr(smi))
    record["stats"] = {"vs_plain": sv, **sp}
    torch.cuda.empty_cache()

    # 8. kernels against plain time at one shape (CUDA events), and the
    # 1080p frame of each backend, in turns
    kw = dict(width=tm["width"], height=tm["height"], spp=tm["spp"],
              num_bounces=tm["bounces"])
    acc = torch.zeros((tm["width"] * tm["height"], 3), device="cuda")
    t_t = rg.plan(tm["width"], tm["height"], tm["spp"], tm["bounces"], _CUTS)[0]
    dense_t, counts_t, _ = _dense_pool(rg, inp_t, t_t, 0, _CUTS[0])

    def mega(stats=False):
        return mk.launch_megakernel(acc, inp_t, 0, True, stats=stats, **kw)

    def mega_plain(stats=False):
        return mk.render_plain_with_inputs(acc, inp_t, 0, True, stats=stats, **kw)

    def regroup_stages(plain):
        fn = rg.regrouped_plain_with_inputs if plain else rg.launch_regrouped
        return _per_kernel(_stage_ms(lambda mark: fn(acc, inp_t, 0, True, cuts=_CUTS,
                                                     on_stage=mark, **kw)))

    def k1_stats(plain, reps):
        return _k1_ms(rg, inp_t, dense_t, counts_t, t_t, 0, _CUTS[0], _CUTS[1], True, reps,
                      fn=rg.k1_plain if plain else None)

    mega()
    mega_plain()
    mega(True)
    mega_plain(True)
    regroup_stages(False)
    regroup_stages(True)
    k1_stats(False, 1)
    k1_stats(True, 1)
    times = {k: [] for k in ("megakernel", "megakernel_plain", "regroup", "regroup_plain",
                             "megakernel_stats", "megakernel_stats_plain", "k1_stats",
                             "k1_stats_plain")}
    for label, reps in (("plain", 2), ("kernel", 10), ("kernel", 10), ("plain", 2)):
        if label == "kernel":
            times["megakernel"].append(_time_ms(mega, reps))
            times["regroup"].append(regroup_stages(False))
            times["megakernel_stats"].append(_time_ms(lambda: mega(True), reps))
            times["k1_stats"].append(k1_stats(False, reps))
        else:
            times["megakernel_plain"].append(_time_ms(mega_plain, reps))
            times["regroup_plain"].append(regroup_stages(True))
            times["megakernel_stats_plain"].append(_time_ms(lambda: mega_plain(True), reps))
            times["k1_stats_plain"].append(k1_stats(True, reps))
    ms = {"megakernel": min(times["megakernel"]),
          **{k: min(r[k] for r in times["regroup"]) for k in REGROUP_KERNELS},
          "megakernel_stats": min(times["megakernel_stats"]),
          "k1_stats": min(times["k1_stats"])}
    plain_ms = {"megakernel": min(times["megakernel_plain"]),
                **{k: min(r[k] for r in times["regroup_plain"]) for k in REGROUP_KERNELS},
                "megakernel_stats": min(times["megakernel_stats_plain"]),
                "k1_stats": min(times["k1_stats_plain"])}
    # bounds from this shape's live counts, and the library calls
    live_all, live_real = _live_per_bounce(rg, inp_t, t_t, 0, tm["bounces"])
    mk_table = mega(True)[1]
    k1_table = _k1_stats(rg, rg.launch_k1, inp_t, dense_t, counts_t, t_t, 0, _CUTS[0],
                         _CUTS[1])
    bounds = _bounds(mk, inp_t, t_t, live_all, live_real, mk_table, k1_table)
    library_ms = _library_ms(rg, inp_t, t_t, 0, tm["bounces"], live_all)
    del dense_t
    _say("bounds", shape=f"{tm['scene']} {tm['width']}x{tm['height']} spp{tm['spp']} "
         f"b{tm['bounces']}", live_per_bounce=json.dumps(live_all),
         live_real_per_bounce=json.dumps(live_real),
         bounds=json.dumps({k: [round(v["bound_ms"], 5), v["bound_by"]]
                            for k, v in bounds.items()}),
         library_ms=json.dumps({k: round(v, 4) for k, v in library_ms.items()}),
         card=repr(smi))
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
                        "runs": times, "frame_1080p_ms": frame_ms, "bounds": bounds,
                        "library_ms": library_ms, "live_per_bounce": live_all,
                        "live_real_per_bounce": live_real}

    # 9. one regroup 1080p frame under the port's profiler_trace, and the
    # bounds of the 1080p frames' kernels beside their times
    trace_dir = (os.path.join(args.out, "trace") if args.out
                 else tempfile.mkdtemp(prefix="chip_smoke_trace_"))
    tr = _trace_frame(rg, inp, fkw, trace_dir)
    _say("trace", device_events=tr["device_events"],
         kernel_ms=json.dumps({k: round(v, 3) for k, v in tr["kernel_ms"].items()}),
         kernel_total_ms=f"{tr['kernel_total_ms']:.3f}",
         stages_ms=json.dumps({k: round(v, 3) for k, v in tr["stages_ms"].items()}),
         stage_total_ms=f"{tr['stage_total_ms']:.3f}", card=repr(smi))
    record["trace"] = tr
    t_big = rg.plan(mp["width"], mp["height"], mp["spp"], mp["bounces"], _CUTS)[0]
    live_big = _live_per_bounce(rg, inp, t_big, 0, mp["bounces"])
    bounds_big = _bounds(mk, inp, t_big, *live_big)
    stage_big = {**_per_kernel(tr["stages_ms"]), "megakernel": min(frame_ms["megakernel"])}
    _say("bounds", shape=f"rtiow {mp['width']}x{mp['height']} spp{mp['spp']} "
         f"b{mp['bounces']}", live_per_bounce=json.dumps(live_big[0]),
         live_real_per_bounce=json.dumps(live_big[1]),
         ms_bound_share=json.dumps({k: [round(stage_big[k], 3),
                                        round(bounds_big[k]["bound_ms"], 3),
                                        bounds_big[k]["bound_by"],
                                        round(bounds_big[k]["bound_ms"] / stage_big[k], 4)]
                                    for k in stage_big}), card=repr(smi))
    record["bounds_1080p"] = {"live": live_big, "bounds": bounds_big, "ms": stage_big}

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(record, f, indent=1)
    def entry(name, key, source, replaces, n, err):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n, "max_abs_err": err, "ms": ms[key], "plain_ms": plain_ms[key],
                "bound_ms": bounds[key]["bound_ms"], "bound_by": bounds[key]["bound_by"],
                "library_ms": library_ms.get(key)}

    kernels = [entry("megakernel", "megakernel", mk.KERNEL_SOURCE, mk.REPLACES,
                     launches["pallas"]["megakernel"], max_abs_err)]
    kernels += [entry(f"regroup_{k}", k, rg.KERNEL_SOURCE, rg.REPLACES[k],
                      launches["regroup"][k], rg_err[k]) for k in REGROUP_KERNELS]
    kernels += [
        entry("megakernel_stats", "megakernel_stats", mk.KERNEL_SOURCE, mk.STATS_REPLACES,
              sp["launches"]["megakernel_stats"], sv["megakernel_err"]),
        entry("regroup_k1_stats", "k1_stats", rg.KERNEL_SOURCE, rg.REPLACES["k1_stats"],
              sp["launches"]["k1_stats"], sv["k1_err"])]
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
