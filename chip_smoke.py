#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA libraries from the sources in the checkout (the
megakernel, the regroup pipeline, the row-compacted wavefront, the record
reorder kernels, the sweep probe kernels and the indexed-access probe
kernels, one nvcc each, in parallel),
holds every kernel against its plain PyTorch version on the card, holds
the regroup pipeline against the megakernel, and renders
the RTiOW final scene at 1920x1080 (32 spp per frame, 96 spp, 8 bounces)
three times: through ``Renderer(backend="auto", device="cuda")``, which
resolves to the regroup pipeline (K0, PACK, K1, COMBINE), through
``Renderer(backend="pallas")``, the megakernel, and through
``Renderer(backend="wavefront")``, which runs the wavefront as the JAX
Renderer does, one K0 per frame. For each it checks that every frame went
through the kernels and that the image is right, and it times the kernels
against their plain versions. ``Renderer(backend="auto")`` at 24 spp a
frame, which the JAX rule gives to the megakernel, must launch it once a
frame and regroup never, and equal the stats megakernel's full sweep in
every bit.

The ``[megakernel]`` phase holds the megakernel, which culls its sweep per
warp and refills each lane's samples, in every bit against the stats
megakernel (the full sweep from a staged table, its samples refilled per
lane too) on RTiOW 1920x1080 x
32 spp, random_spheres(10000) at 3840x2160 x 4 spp, random_spheres(60000)
at 1920x1080 x 1 spp (boxes in global memory), the first-hit scene and the
textured scene; holds a 1080p band of the textured scene against its twin
at the image gates; and counts the 1080p frame's sphere and box tests per
live segment with ``cull.megakernel_census``, the warp's lanes in step and
refilled, for its bounds.

The ``[wavefront]`` phase drives COMPACT and K1 through
``render_image_wavefront(..., phase_cuts=...)`` at 1080p x 32 spp and holds
the wavefront, whose K0 and K1 cull their sweep per warp (K0's lanes
refilled, K1's live lanes regrouped per block), in every bit against
regroup (two frames), against the megakernel at one sample per pixel, and
against itself under four cut schedules; COMPACT against its twin bit for
bit and K1 against its twin on the whole dense pool at the first cut.

The ``[stats]`` phase holds the two stats kernels (the megakernel's and
K1's) against their twins at small sizes (a
super-chunk scene among them), then runs the counters' own path at full
size, as benchmarks/kernel_stats.py and benchmarks/profile_regroup.py's
``stats`` run the TPU kernels: the megakernel with ``stats=True`` on RTiOW
1920x1080 and random_spheres(10000) at 3840x2160 (4 spp, 8 bounces), and
K0 -> PACK -> K1(stats) at the first cut of RTiOW 1920x1080 x 32 spp. Each
full-size table is held against the twin on a part of it (the last row of
TPU tiles, the last dense tiles); the phase prints the summaries and times
each stats kernel against the culled kernel it is the reference of.
``[cull]`` holds regroup and the wavefront, whose K0 and K1 cull their sweep per warp,
against the full-sweep wavefront (K0's and K1's kCull = false
instantiations) in every bit, the wavefront at four cut schedules (RTiOW
1920x1080 x 32 spp over two frames, random_spheres(10000) at 3840x2160 x 4
spp, and random_spheres(60000), whose boxes K0 and K1 read from global
memory, at 1920x1080 x 1 spp), and both against the stats megakernel's
full sweep at one sample per pixel; it prints the sphere and box tests
per live segment that each lane's own decisions need and that the warp
vote runs (regroup's warps, and the wavefront's refilled and regrouped
ones), and times random_spheres(60000)'s culled kernels with CUDA events,
its census taken in a child process. ``[trace]`` runs one regroup
1080p frame under ``utils.metrics.profiler_trace`` and prints what the
profiler saw beside the CUDA-event stage times. The ``kernels`` line gives
every kernel its time, its twin's, its bound (the least time the card could
take, from this run's live counts) and a library call's time where one
computes the same function.

``[reorder]`` runs probes/dma.py's record-DMA probes (benchmarks/probe_dma.py
and probe_mosaic.py:143) at the TPU probes' shapes, each kernel against its
twin bit for bit, and times dma_rate over the probe's (64800, 11, 128) pool
beside its byte bound and index_select + sum; the gather and the scatter
at further widths, both scatter routes (a permutation of dst's records,
inverted and gathered through; a shorter list, stored where it points);
and, in a child process (``--child tiny``, where the profiler keeps every
event), the tiny probes' and index_select_bw's event, device and host ms
beside index_select's or index_copy_'s, and lane_scan's beside cumsum's at
its probe shape (row 10g). ``[binned]`` drives
probes/binned.py (benchmarks/probe_binned.py's path): K0 and PACK to cut 3,
then for every bin scheme a stable sort, the permutation (record_gather), K1
timed on it, the scatter back (record_scatter) held in every bit to the
home-order K1, and K1-stats held against its twin on the last dense tiles;
RTiOW 1920x1080 x 4 spp with all eight schemes, random_spheres(10000) at
3840x2160 with the quick five.

``[sweep]`` runs probes/mxu_sweep.py (benchmarks/probe_mxu_sweep.py's nine
kernels, each probe with its launches counted from 0 and held to exact
counts): the closest-hit sweep as bounce.cuh's FMA sweep against the same
sweep with its products on the tensor cores (TF32 and 3xTF32 mma.sync), at
the probe's shapes (every ray as the twin's), past the first
shared-memory window of sweep_mma (every ray) and at a card-filling shape
(2,097,152 rays against RTiOW's 496 spheres; at most 1e-5 of the rays may
part), the dot's precision (FP32 bit for bit with the probe's reference)
at p3's shape and at a card-filling B[8, 2^20], each mode beside
torch.matmul by CUDA events, the host clock and the profiler, and the
layout kernels, each against its twin and its bound.

``[access]`` runs probes/place.py, probes/mosaic.py and probes/gather_cost.py
(benchmarks/probe_place.py's, probe_mosaic.py's and probe_gather_cost.py's
fifteen pallas_calls on csrc/access.cu's five kernels, each probe with its
launches counted from 0 and held to exact counts): every route of
table_gather, lane_gather, smem_rw, row_sort and lane_scan against its twin
bit for bit (row_sort also on p3's edge keys: NaN payloads, both zeros,
infinities, denormals and runs, each row a permutation), at the probes'
shapes (with the profiler's device time beside the event time) and at
card-filling shapes (2^24 values; the texture
pools of textured_spheres at the LUT's budget and at full size), each
beside its bound and a library call; smem_rw's three routes ("direct"
among them) also with each call's host time, and at the fill with the
library call's device and host time, each case's calls rotating over copies
of its scratches until a round of them outgrows the L2 (``warm_l2`` lists
the cases too small for that), and a call's host side by piece
(``case=smem_rw_host_parts_ms``).

``[xla]`` drives the ``"xla"`` backend, the JAX package's XLA tracer in
plain PyTorch, through ``Renderer(backend="xla", device="cuda")``: RTiOW at
1920x1080, three frames of 4 spp (an eager 4-spp frame took 5.5 s on an
NVIDIA H100 80GB HBM3 at 700 W, PERF.md section 5, so 32 would take eight
times that), 8 bounces, with every launch count of the six libraries set to 0
before and required 0 after; its image against regroup's on the same
params at the statistical gates; one pixel batch of one sample under the
profiler (PyTorch's launches, their device time, the idle share); the
textured scene at 1920x1080, regroup at texture budgets 512, 8192 and the
largest texture's texels against the full-resolution xla frame, whose
tonemapped RMSE must not rise with the budget; and a regroup checkpoint
saved after two 1080p frames, resumed in a fresh renderer, equal in every
bit.

``[parallel]`` runs the mesh (parallel/sharding.py) at RTiOW 1920x1080 x
32 spp x 8 bounces: the per-shard body ``render_shard`` shard after shard
on the card, each shard's launches counted from 0 (regroup: K0 once, PACK
and K1 three times, COMBINE once; the megakernel once). A (4, 1) layout,
regroup and the megakernel, equals the unsharded frames in every bit over
two frames (the second accumulated as base + contrib), the megakernel's
bands also against the stats megakernel's full sweep; 7 tiles, whose last
band runs 5 rows past the image, equal them on the real rows, the padding
finite; (2, 2) at 16 spp a shard passes the image gates against the
unsharded frames after 48 frames of each; and ``Renderer(mesh=
global_mesh())`` in a one-process NCCL world that ``multihost.initialize``
starts equals the unsharded Renderer in every bit, with its launches
counted and one frame's shard and all_reduce times. ``[front]`` runs the
CLI as a user does (``python -m weekend_raytracer_tpu_torch``, RTiOW
1080p, 64 spp in frames of 32) and under ``torchrun --nproc-per-node 1``
(a (1, 1) mesh), each with a timeout, and requires the JAX CLI's JSON
keys, ``"regroup"`` and a ``--hdr`` equal to an in-process Renderer's mean
radiance in every bit; then drives ``TerminalViewer`` headless along 30
key and mouse events, one frame after each, on RTiOW 1080p and
random_spheres(10000) at 3840x2160 (4 spp), and prints the time to the
first frame, the event-to-frame latency p50 and p95, the
``set_render_params`` and half-block draw host times.

Each phase prints one line (some several); any failure exits non-zero
without the final ``ok`` line. It needs a CUDA device and imports nothing of JAX. Options:
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

from weekend_raytracer_tpu_torch.probes import (FP32_PEAK, HBM_RATE, SLAB_TEST_OPS,
                                                SPHERE_TEST_OPS, TRACE_PAD_S, stats_bound)

# name, w, h, frames, spp, bounces of the kernel-against-plain cases
_PLAIN_CASES = (("first_hit", 64, 48, 1, 1, 1),
                ("rtiow", 96, 64, 4, 4, 8),
                ("textured", 96, 64, 4, 4, 8))
_REGROUP_CASES = (("rtiow", 96, 64, 4, 4, 8), ("textured", 96, 64, 4, 4, 8))
_CUTS = (2, 4, 6)  # default_cuts(8, 486), the main path's schedule
_MAIN = dict(width=1920, height=1080, spp=32, max_spp=96, bounces=8)
_TIMING = dict(scene="rtiow", width=480, height=270, spp=4, bounces=8)
# the xla backend's 1080p frames take 4 spp each: an eager 4-spp frame took
# 5.5 s on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 5)
_XLA = dict(width=1920, height=1080, spp=4, frames=3, bounces=8)
_XLA_BUDGETS = (512, 8192)  # and the largest texture's texels
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
# the kernels that cull per warp ("wavefront_k0_nocut": the Renderer's K0,
# all bounces in one launch)
CULLED_KERNELS = ("k0", "k1", "megakernel", "wavefront_k0", "wavefront_k0_nocut", "wavefront_k1")
WAVEFRONT_KERNELS = ("k0", "compact", "k1")
REORDER_KERNELS = ("record_gather", "record_scatter", "dma_rate")
SWEEP_KERNELS = ("sweep_fma", "sweep_mma_tf32", "sweep_mma_3xtf32", "dot_mma", "layout")
ACCESS_KERNELS = ("table_gather", "lane_gather", "smem_rw", "row_sort", "lane_scan")
# (n_rays, n_spheres, iters) at which [build] holds sweep_fma's launch plan
# to its mirror: the [sweep] shapes (p5, p8, window, fill), a few rays, and
# a table of more than one window
FMA_PLAN_SHAPES = {"p5": (4096, 32, 64), "p8": (4096, 320, 16), "window": (4096, 1024, 1),
                   "fill": (2_097_152, 496, 1), "few_rays": (100, 5, 3),
                   "windows": (50_000, 3000, 2)}
# (n_spheres, n_chunks, n_tests, n_super, chunk_size) at which [build] holds
# the stats kernels' windows (csrc/bounce.cuh stats_plan) to their mirror:
# RTiOW, random10k, random60k (boxes in global memory), the super-chunk
# case, tables without chunks, and chunks too large for one window's share
STATS_PLAN_SHAPES = {"rtiow": (496, 31, 31, 0, 16), "random10k": (10016, 313, 320, 20, 32),
                     "random60k": (60000, 1875, 1888, 118, 32), "super": (1200, 75, 80, 5, 16),
                     "no_chunks": (10016, 0, 0, 0, 16), "one_sphere": (1, 0, 0, 0, 16),
                     "opt_in": (8192, 4, 4, 0, 2048)}
# the wavefront's cut schedules held equal in every bit: none (the
# Renderer's), the main path's first cut, its cuts, and a cut at every bounce
_WF_SCHEDULES = ((), (2,), _CUTS, (1, 2, 3, 4, 5, 6, 7))
BINNED_CUT = 3  # probe_binned.py's default cut (4 spp, 8 bounces)
ALIVE_GATE = 0.99  # share of a K1's lanes whose alive flag must match the twin's
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
# the [cull] phase: scene, width, height, spp, frames of regroup and the
# wavefront (K0 and K1 culled per warp) against the full-sweep wavefront;
# and the rows of the frame whose rays rg.cull_census counts (None: all,
# with cull.wavefront_census too; else the middle row of tiles, since the
# twins' sweep of 10,016 spheres over 33M rays would take minutes).
# random_spheres(60000)'s 48,144 bytes of boxes pass what a block
# stages, so K0 and K1 read them from global memory. Each census (up to
# some 10^5 small launches of the twins) runs in a child process
# (``--child NAME``, NAME a case or "timing", the [timing] shape), so that
# none adds its launches to this process: with random60k's census in it,
# later profiler traces of the [access] phase lost all their device events
# (three runs of three on an H100).
_CULL_CASES = (("rtiow", 1920, 1080, 32, 2, None), ("random10k", 3840, 2160, 4, 1, 32),
               ("random60k", 1920, 1080, 1, 1, 32))
# the [megakernel] phase: scene, width, height, spp, bounces of the
# megakernel against the stats megakernel's full sweep in every
# bit (random_spheres(60000): boxes in global memory; first_hit: one
# sphere, no chunks, one bounce; textured: no chunks, image textures)
_MK_CASES = (("rtiow", 1920, 1080, 32, 8), ("random10k", 3840, 2160, 4, 8),
             ("random60k", 1920, 1080, 1, 8), ("first_hit", 64, 48, 1, 1),
             ("textured", 1920, 1080, 4, 8))
TEX_BAND = (528, 32)  # first row and rows of the textured 1080p band against its twin
# Renderer(backend="auto") at a spp that is not a power of two: the megakernel
_AUTO_MK = dict(spp=24, max_spp=72)
RECORD_BYTES = 64  # a pool record: 16 f32 components
WF_COMPONENTS = 15  # a wavefront row holds 15 components of 128 f32 lanes
ROW_PLANE_BYTES = 128 * 4  # one component of one wavefront row


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

    if name == "random60k":
        from weekend_raytracer_tpu_torch.models.scenes import random_spheres, random_spheres_camera

        desc, cam = random_spheres(60000), random_spheres_camera()
        sky = to_sky_state(SkyParams(), device=device)
    elif name == "first_hit":
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


def _per_kernel(stages: dict, kernels=REGROUP_KERNELS) -> dict:
    """Stage times summed per kernel: {"k0": ms, "pack": ms, ...}."""
    out = dict.fromkeys(kernels, 0.0)
    for name, ms in stages.items():
        out[next(k for k in kernels if name.startswith(k))] += ms
    return out


def _launch_counts(mk, rg, wf, ro, sw) -> dict:
    return {"megakernel": mk.render_image_megakernel.launches,
            **{k: getattr(rg, f"launch_{k}").launches for k in REGROUP_KERNELS},
            "megakernel_stats": mk.render_image_megakernel.stats_launches,
            "k1_stats": rg.launch_k1.stats_launches,
            **{f"wavefront_{k}": getattr(wf, f"launch_{k}").launches
               for k in WAVEFRONT_KERNELS},
            **{k: getattr(ro, k).launches for k in REORDER_KERNELS},
            **sw.launch_counts(), **_access().launch_counts()}


def _zero_launch_counts(mk, rg, wf, ro, sw) -> None:
    mk.render_image_megakernel.launches = 0
    mk.render_image_megakernel.stats_launches = 0
    rg.launch_k1.stats_launches = 0
    for k in REGROUP_KERNELS:
        getattr(rg, f"launch_{k}").launches = 0
    for k in WAVEFRONT_KERNELS:
        getattr(wf, f"launch_{k}").launches = 0
    for k in REORDER_KERNELS:
        getattr(ro, k).launches = 0
    sw.zero_launch_counts()
    _access().zero_launch_counts()


def _access():
    from weekend_raytracer_tpu_torch.ops.cuda import access

    return access


# launches of no wavefront, reorder, sweep or access kernel, for the other
# paths' counts
_NO_WAVEFRONT = {**{f"wavefront_{k}": 0 for k in WAVEFRONT_KERNELS},
                 **{k: 0 for k in REORDER_KERNELS}, **{k: 0 for k in SWEEP_KERNELS},
                 **{k: 0 for k in ACCESS_KERNELS}}


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


def _pack_vs_plain(rg, pool, n_in: int, what) -> tuple:
    """PACK (one launch) against pack_plain on the first ``n_in`` records
    of ``pool``, both writing over poisoned buffers: the live count, the
    dense pool up to its padded last row (+-0 equal) and the inverse map
    must agree in every bit. Returns (max error, live count, inverse map,
    the kernel's dense pool)."""
    dev = pool.device
    cap = pool.shape[1]
    res = []
    for pack in (rg.launch_pack, rg.pack_plain):
        counts = torch.tensor([n_in, 0], dtype=torch.int32, device=dev)
        dst = torch.full((rg.N_COMP, cap), 7.0, device=dev)
        inv = torch.full((cap,), -7, dtype=torch.int32, device=dev)
        pack(pool, dst, inv, counts, 1, rg.pack_scratch(cap, dev))
        res.append((counts, dst, inv))
    torch.cuda.synchronize()
    n = int(res[1][0][1])
    _check(int(res[0][0][1]) == n, (what, "pack count", int(res[0][0][1]), n))
    end = -(-n // 128) * 128
    err = _bitwise_max_err(res[0][1][:, :end], res[1][1][:, :end], (what, "dense pool"))
    _check(torch.equal(res[0][2], res[1][2]), (what, "inverse map"))
    return err, n, res[0][2], res[0][1]


def _combine_vs_plain(rg, t, inv, r8, contrib, gen, what) -> float:
    """COMBINE (one launch) against combine_chain_plain on one chain of
    inverse maps, onto a random accumulator and with clear: the
    accumulators must agree in every bit, and the inputs stay as they
    were."""
    dev = contrib.device
    kept = [x.clone() for x in (inv, r8, contrib)]
    err = 0.0
    for clear in (False, True):
        accum = torch.rand((t.width * t.height, 3), device=dev, generator=gen)
        out = [accum.clone(), accum.clone()]
        rg.launch_combine(inv, r8, contrib, out[0], t, clear)
        rg.combine_chain_plain(inv, r8, contrib, out[1], t, clear)
        torch.cuda.synchronize()
        err = max(err, _bitwise_max_err(out[0], out[1], (what, "combine", clear)))
    _check(all(_same_bits(a, b) for a, b in zip(kept, (inv, r8, contrib))),
           (what, "COMBINE changed its inputs"))
    return err


def _pack_combine_vs_plain(rg, inp, t, seed: int) -> dict:
    """PACK and COMBINE against their twins, bit for bit, at tiling ``t``:
    a frame's chain (K0, then PACK and K1 at each of _CUTS, so that PACK 2
    and 3 take a live count that is no multiple of the tile, then COMBINE
    over the frame's inverse maps and radiance), and PACK of K0's pool with
    a random, a ragged (the random mask over an input count that is no
    multiple of the tile nor of 4), an all-live and an all-dead mask, each
    followed by a one-phase COMBINE through its inverse map."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    pools = [torch.empty((rg.N_COMP, t.cap), device=dev) for _ in range(2)]
    contrib = torch.empty((3, t.cap), device=dev)
    rg.launch_k0(inp, pools[0], contrib, t, 0, _CUTS[0])
    inv = torch.empty((len(_CUTS), t.cap), dtype=torch.int32, device=dev)
    r8 = torch.empty((len(_CUTS), 3, t.cap), device=dev)
    pack_err, combine_err, live = 0.0, 0.0, {}
    n_in = t.cap
    for k, b_lo in enumerate(_CUTS, 1):
        err, n, inv_k, dense = _pack_vs_plain(rg, pools[(k - 1) % 2], n_in, f"cut{k}")
        pack_err = max(pack_err, err)
        live[f"cut{k}"] = [n_in, n]
        pools[k % 2].copy_(dense)
        inv[k - 1] = inv_k
        del dense, inv_k
        counts = torch.tensor([n_in, n], dtype=torch.int32, device=dev)
        b_hi = _CUTS[k] if k < len(_CUTS) else 8
        rg.launch_k1(inp, pools[k % 2], r8[k - 1], counts, 1, t, 0, b_lo, b_hi)
        n_in = n
    combine_err = _combine_vs_plain(rg, t, inv, r8, contrib, gen, "frame")
    rg.launch_k0(inp, pools[0], contrib, t, 0, _CUTS[0])
    del pools[1], inv, r8
    pool = pools[0]
    ragged = t.cap * 3 // 4 - 1237  # odd: no multiple of the tile nor of 4
    masks = {"random": (torch.rand(t.cap, device=dev, generator=gen) < 0.3).float(),
             "all_live": torch.ones(t.cap, device=dev),
             "all_dead": torch.zeros(t.cap, device=dev)}
    for label, mask, count in (("random", masks["random"], t.cap),
                               ("ragged", masks["random"], ragged),
                               ("all_live", masks["all_live"], t.cap),
                               ("all_dead", masks["all_dead"], t.cap)):
        pool[rg._AL] = mask
        err, n, inv_k, dense = _pack_vs_plain(rg, pool, count, label)
        pack_err = max(pack_err, err)
        live[label] = [count, n]
        del dense
        if count < t.cap:  # COMBINE reads every home slot's entry
            inv_k[count:] = rg.DEAD
        one = torch.rand((1, 3, t.cap), device=dev, generator=gen)
        base = torch.rand((3, t.cap), device=dev, generator=gen)
        combine_err = max(combine_err, _combine_vs_plain(rg, t, inv_k[None], one, base, gen,
                                                         label))
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
                   rg.pack_scratch(t.cap, dev))
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
    every tile, and the stats kernel's image equal in every bit to the
    culled one; in the super-chunk case some tile enters fewer super-chunks
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
    """The stats megakernel at full size against its twin on the image's
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
    """K1's stats kernel on the whole dense pool against k1_plain on its
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


def _stats_path(mk, rg, wf, ro, sw) -> dict:
    """The counters' own path at full size, through the entry points:
    render_image_megakernel(stats=True) for each _STATS_MK case, and K0 ->
    PACK -> K1(stats) at the first cut of RTiOW 1080p x 32 spp. Each counter
    table is checked, summarised, and held against a second run in which the
    stats kernel is timed against the culled kernel (CUDA events, in
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
    _zero_launch_counts(mk, rg, wf, ro, sw)
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
    launches = _launch_counts(mk, rg, wf, ro, sw)
    want = {"megakernel": 0, "k0": 1, "pack": 1, "k1": 0, "combine": 0,
            "megakernel_stats": len(_STATS_MK), "k1_stats": 1, **_NO_WAVEFRONT}
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


def _frame_kernels(kind: str) -> dict:
    """The CUDA kernels of the port that one frame with cuts _CUTS launches,
    by name: a COMPACT is three kernels (count, scan, scatter), a PACK one,
    and COMBINE one a frame."""
    n = len(_CUTS)
    if kind == "regroup":
        return {"regroup_k0": 1, "regroup_pack": n, "regroup_k1": n, "regroup_combine": 1}
    return {"wavefront_k0": 1, "compact_count": n, "compact_scan": n, "compact_scatter": n,
            "wavefront_k1": n}


def _kernel_name(key: str) -> str:
    """A kernel's function name in a profiler event's demangled name."""
    import re

    m = re.search(r"(\w+)(<[^(]*>)?\(", key)
    return m.group(1) if m else key[:40]


def _trace_frame(run, log_dir, expect: dict) -> dict:
    """One frame, ``run(on_stage)``, under profiler_trace, with CUDA-event
    stage times beside it (the frame padded on both sides by
    probes.TRACE_PAD_S of idle host time, as the probes' traces are): each
    kernel's device time as the profiler's key_averages() report it, and
    how many device events it recorded. The port's kernels among those
    events are held against ``expect`` (the frame's launches, by kernel
    name): the profiler can drop device events, so the idle share
    (1 - kernel ms / stage ms) is given only when none of the frame's
    kernels is missing, and ``missing_events`` says how many are."""
    from torch.autograd import DeviceType

    from weekend_raytracer_tpu_torch.utils.metrics import profiler_trace

    run(None)  # warm
    torch.cuda.synchronize()
    with profiler_trace(log_dir) as prof:
        time.sleep(TRACE_PAD_S)
        stages = _stage_ms(run)
        time.sleep(TRACE_PAD_S)
    device_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    seen = {}
    for e in device_events:
        name = _kernel_name(e.name)
        if name in expect:
            seen[name] = seen.get(name, 0) + 1
    missing = sum(max(0, n - seen.get(name, 0)) for name, n in expect.items())
    kernels = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us and e.device_type == DeviceType.CUDA:
            name = _kernel_name(e.key)
            kernels[name] = kernels.get(name, 0.0) + us / 1e3
    kernel_total, stage_total = sum(kernels.values()), sum(stages.values())
    return {"device_events": len(device_events), "frame_kernels": sum(expect.values()),
            "recorded_frame_kernels": seen, "missing_events": missing, "kernel_ms": kernels,
            "kernel_total_ms": kernel_total, "stages_ms": stages,
            "stage_total_ms": stage_total,
            "idle_share": None if missing else 1.0 - kernel_total / stage_total}


def _trace_fields(tr: dict) -> dict:
    """The [trace] line's account of the events: the idle share where every
    kernel of the frame was recorded, else how many events are missing."""
    out = {"device_events": tr["device_events"], "frame_kernels": tr["frame_kernels"]}
    if tr["missing_events"]:
        out["missing_events"] = tr["missing_events"]
        out["idle_share"] = "not given: the profiler dropped events"
    else:
        out["idle_share"] = f"{tr['idle_share']:.4f}"
    return out


def _census_lines(census) -> dict:
    """Per kernel of the frame and per bounce: live segments; the sphere
    tests (the priors' apart) and box tests per live segment that each
    lane's own cull decisions need; and the same two under the warp vote."""
    out = {}
    for (b_lo, b_hi), counts in census:
        key = "k0" if b_lo == 0 else f"k1[{b_lo},{b_hi})"
        out[key] = {str(b): [c.live] + [round(v / max(c.live, 1), 2) for v in (
            c.own_sphere_tests, c.prior_tests, c.own_box_tests, c.sphere_tests, c.box_tests)]
                    for b, c in zip(range(b_lo, b_hi), counts)}
    return out


def _wf_spans(spans) -> list:
    """A wavefront census's spans (cull.CensusSpan) as rg.cull_census
    gives its own: [((b_lo, b_hi), [CullCount of each step])]."""
    return [(sp.span, [st.count for st in sp.steps]) for sp in spans]


def _census_line(res: dict) -> dict:
    """The fields of a [cull] census line (JSON): regroup's sphere tests
    (the priors' included) per live segment for each lane's own decisions
    and under the warp vote, K0 and K1 apart; the wavefront's K0 at _CUTS,
    its K1s, and its K0 with no cuts, each summed over its warps' steps
    (_census_totals); regroup's per bounce (_census_lines)."""
    c = res["census"]

    def totals(spans):
        return _census_totals([st for sp in spans for st in sp.steps])

    out = {"rows": res["census_rows"],
           "k0_tests_per_segment": round(_per_segment(c[:1]), 2),
           "k1_tests_per_segment": round(_per_segment(c[1:]), 2),
           "k0_vote_tests_per_segment": round(_per_segment(c[:1], own=False), 2),
           "k1_vote_tests_per_segment": round(_per_segment(c[1:], own=False), 2),
           "live_own_spheres_priors_boxes_vote_spheres_boxes_per_bounce": _census_lines(c),
           "seconds": round(res["census_s"], 1)}
    if "wf_census" in res:
        out["wavefront"] = {"k0": totals(res["wf_census"][:1]),
                            "k1": totals(res["wf_census"][1:]),
                            "k0_nocut": totals(res["wf_census_nocut"]),
                            "rows": [sp.rows for sp in res["wf_census"]]}
    return out


def _per_segment(spans, own: bool = True) -> float:
    """Sphere tests per live segment (the priors' included) over spans of
    a census: those each lane's own decisions need, or (own=False) those
    the lanes run under the warp vote."""
    live = sum(c.live for _, counts in spans for c in counts)
    tests = sum((c.own_sphere_tests if own else c.sphere_tests) + c.prior_tests
                for _, counts in spans for c in counts)
    return tests / max(live, 1)


def _cull_censuses(inp, w, h, spp, band) -> dict:
    """The censuses of a [cull] case on the twins' rays of frame 0, on the
    rows ``band`` asks for (None: all; else the middle row of tiles, ``band``
    rows): rg.cull_census of regroup's K0 and K1 at _CUTS, and, of the whole
    frame, cull.wavefront_census of the wavefront's at _CUTS and with no
    cuts (the Renderer's one K0). The wavefront's refilled warps take a
    step a bounce of a lane's slot, some hundreds of steps a frame, each
    through the twin of the vote over every chunk: random_spheres(60000)'s
    1,875 took 440 s on a row of tiles, so the banded cases count
    regroup's warps alone. Each lane's own counts of the two censuses at
    _CUTS must agree: the same rays, grouped otherwise."""
    from weekend_raytracer_tpu_torch.ops.cuda import cull
    from weekend_raytracer_tpu_torch.ops.cuda import regroup as rg

    rows = (0, h) if band is None else ((h // 2) // 32 * 32, (h // 2) // 32 * 32 + band)
    t = rg.plan(w, rows[1] - rows[0], spp, 8, _CUTS, row_offset=rows[0], full_height=h)[0]
    t0 = time.perf_counter()
    census = rg.cull_census(inp, t, 0, _CUTS, 8)
    if band is not None:
        return {"census_rows": list(rows), "census_s": time.perf_counter() - t0,
                "census": census}
    wf_census = cull.wavefront_census(inp, t, 0, _CUTS, 8)
    wf_nocut = cull.wavefront_census(inp, t, 0, (), 8)
    own = [[(c.live, c.prior_tests, c.own_sphere_tests, c.own_box_tests) for c in counts]
           for _, counts in census]
    for spans in (wf_census, wf_nocut):
        _check(sum(sum(sp.live) for sp in spans) == sum(c.live for _, counts in census
                                                          for c in counts),
               ("the wavefront census's live segments are not regroup's", rows))
    wf_own = []
    for sp in wf_census:
        total = cull.CullCount(0, 0, 0, 0, 0, 0)
        for st in sp.steps:
            total = total.plus(st.count)
        wf_own.append(total)
    _check([(c.live, c.prior_tests, c.own_sphere_tests, c.own_box_tests) for c in wf_own]
           == [tuple(map(sum, zip(*k))) for k in own],
           ("the wavefront census's own counts are not regroup's", rows))
    return {"census_rows": list(rows), "census_s": time.perf_counter() - t0, "census": census,
            "wf_census": wf_census, "wf_census_nocut": wf_nocut}


def _child_census(name: str) -> int:
    """``--child NAME``: _cull_censuses of [cull]'s case NAME, or of the
    [timing] shape (NAME "timing"), in this process, printed as one JSON
    line: the census line's fields (_census_line), regroup's census, and
    each wavefront span's counts summed over its steps."""
    from weekend_raytracer_tpu_torch.ops.cuda import megakernel as mk

    if name == "timing":
        scene, w, h, spp, band = (_TIMING["scene"], _TIMING["width"], _TIMING["height"],
                                  _TIMING["spp"], None)
    else:
        (case,) = [c for c in _CULL_CASES if c[0] == name]
        scene, w, h, spp, _, band = case
    res = _cull_censuses(mk.kernel_inputs(*_case(scene, w, h, "cuda")), w, h, spp, band)

    def span_sum(sp):
        total = (0,) * 6
        for st in sp.steps:
            total = tuple(a + b for a, b in zip(total, st.count))
        return {"span": sp.span, "count": total, "warps": sum(st.warps for st in sp.steps),
                "live": sp.live, "rows": sp.rows}

    out = {"line": _census_line(res),
           "census": [[span, [list(c) for c in counts]] for span, counts in res["census"]]}
    if "wf_census" in res:
        out["wf"] = {key: [span_sum(sp) for sp in res[key]]
                     for key in ("wf_census", "wf_census_nocut")}
    print(json.dumps(out), flush=True)
    return 0


def _census_in_child(name: str) -> dict:
    """_child_census in a child process (with a time limit, killed past
    it): its census line, regroup's census as rg.cull_census gives it, and
    the wavefront's spans (cull.CensusSpan) with one step each, their
    counts summed (what _wf_bounds reads)."""
    from weekend_raytracer_tpu_torch.ops.cuda import cull

    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", name],
                         capture_output=True, text=True, timeout=900)
    _check(out.returncode == 0, (f"the {name} census child failed", out.stderr[-3000:]))
    got = json.loads(out.stdout.strip().splitlines()[-1])
    res = {"census_line": {**got["line"], "child_s": round(time.perf_counter() - t0, 1)},
           "census": [(tuple(span), [cull.CullCount(*c) for c in counts])
                      for span, counts in got["census"]]}
    for key, spans in got.get("wf", {}).items():
        res[key] = [cull.CensusSpan(tuple(sp["span"]),
                                    [cull.CensusStep(cull.CullCount(*sp["count"]), sp["warps"])],
                                    sp["live"], sp["rows"], None) for sp in spans]
    return res


def _wf_schedules_vs_full(mk, rg, wf, ro, sw, inp, kw, frames, ref) -> dict:
    """The culled wavefront at every _WF_SCHEDULES, over ``frames`` frames
    (the later ones accumulated), against ``ref``, the full sweep's
    accumulator, in every bit; the launches counted from 0: one K0 a
    frame, one COMPACT and K1 a cut."""
    acc = torch.zeros_like(ref)
    torch.cuda.synchronize()
    _zero_launch_counts(mk, rg, wf, ro, sw)
    for cuts in _WF_SCHEDULES:
        for f in range(frames):
            wf.launch_wavefront(acc, inp, f, f == 0, phase_cuts=cuts, **kw)
        torch.cuda.synchronize()
        _check(torch.equal(acc, ref), ("the culled wavefront is not the full sweep", cuts,
                                       _compare(ref, acc, kw["width"], kw["height"])))
    launches = _launch_counts(mk, rg, wf, ro, sw)
    n = frames * sum(len(c) for c in _WF_SCHEDULES)
    want = {**dict.fromkeys(launches, 0), "wavefront_k0": frames * len(_WF_SCHEDULES),
            "wavefront_compact": n, "wavefront_k1": n}
    _check(launches == want, ("culled wavefront launches", launches, want))
    return launches


def _cull_times(rg, wf, inp, kw) -> dict:
    """CUDA-event stage times (least of two frames after a warm one) of
    one frame: regroup at _CUTS per kernel, the wavefront with no cuts (the
    Renderer's one K0) and at _CUTS per kernel."""
    acc = torch.zeros((kw["width"] * kw["height"], 3), device="cuda")
    runs = {
        "regroup": (lambda mark: rg.launch_regrouped(acc, inp, 0, True, cuts=_CUTS,
                                                     on_stage=mark, **kw), REGROUP_KERNELS),
        "wavefront_nocut": (lambda mark: wf.launch_wavefront(acc, inp, 0, True, on_stage=mark,
                                                             **kw), ("k0", "fold")),
        "wavefront_cuts": (lambda mark: wf.launch_wavefront(acc, inp, 0, True, phase_cuts=_CUTS,
                                                            on_stage=mark, **kw),
                           WAVEFRONT_KERNELS + ("fold",))}
    out = {}
    for name, (run, kernels) in runs.items():
        run(lambda stage: None)
        times = [_per_kernel(_stage_ms(run), kernels) for _ in range(2)]
        out[name] = {k: min(t[k] for t in times) for k in kernels}
    return out


def _cull_paths(mk, rg, wf, ro, sw) -> dict:
    """The per-warp cull of K0 and K1 at full size (_CULL_CASES): the
    full-sweep wavefront (K0's and K1's kCull = false instantiations, no
    cuts) over the case's frames, the second accumulated, is the
    reference; the regroup accumulator, through launch_regrouped with its
    launches counted from 0, and the culled wavefront's at every
    _WF_SCHEDULES equal it in every bit. At one sample per pixel regroup
    and the wavefront (no cuts and _CUTS) equal the stats megakernel's
    full sweep. Then each case's kernels are timed with CUDA events, and
    the censuses (_cull_censuses, each in a child process) are left to the
    caller."""
    out = {}
    for name, w, h, spp, frames, band in _CULL_CASES:
        inp = mk.kernel_inputs(*_case(name, w, h, "cuda"))
        kw = dict(width=w, height=h, spp=spp, num_bounces=8)
        ref = torch.zeros((w * h, 3), device="cuda")
        for f in range(frames):
            wf._launch_wavefront_full_sweep(ref, inp, f, f == 0, **kw)
        acc = torch.zeros_like(ref)
        torch.cuda.synchronize()
        _zero_launch_counts(mk, rg, wf, ro, sw)
        for f in range(frames):
            rg.launch_regrouped(acc, inp, f, f == 0, cuts=_CUTS, **kw)
        torch.cuda.synchronize()
        launches = _launch_counts(mk, rg, wf, ro, sw)
        n = len(_CUTS) * frames
        want = {**dict.fromkeys(launches, 0), "k0": frames, "pack": n, "k1": n,
                "combine": frames}
        _check(launches == want, ("cull launches", name, launches, want))
        _check(torch.equal(acc, ref), ("culled regroup is not the full sweep", name,
                                       _compare(ref, acc, w, h)))
        del acc
        wf_launches = _wf_schedules_vs_full(mk, rg, wf, ro, sw, inp, kw, frames, ref)
        del ref
        one = dict(kw, spp=1)
        m = torch.zeros((w * h, 3), device="cuda")
        mk.launch_megakernel(m, inp, 0, True, stats=True, **one)
        one_spp = {}
        for key, run in (("regroup", lambda a: rg.launch_regrouped(a, inp, 0, True, cuts=_CUTS,
                                                                   **one)),
                         ("wavefront_nocut", lambda a: wf.launch_wavefront(a, inp, 0, True,
                                                                           **one)),
                         ("wavefront_cuts", lambda a: wf.launch_wavefront(
                             a, inp, 0, True, phase_cuts=_CUTS, **one))):
            a = torch.zeros_like(m)
            run(a)
            torch.cuda.synchronize()
            one_spp[key] = int((a != m).any(dim=1).sum())
        _check(not any(one_spp.values()), ("culled paths against the stats megakernel at 1 spp",
                                           name, one_spp))
        del m, a
        torch.cuda.empty_cache()
        out[name] = {"shape": f"{name} {w}x{h} spp{spp} b8", "frames": frames,
                     "launches": launches, "wavefront_launches": _launch_summary(wf_launches),
                     "vs_full_sweep": "bit-exact", "one_spp_vs_stats_megakernel": one_spp,
                     "ms": _cull_times(rg, wf, inp, kw),
                     "spheres": inp.n_spheres, "chunks": inp.n_chunks, "supers": inp.n_super,
                     "placement": {"regroup": rg.cull_placement(inp),
                                   "wavefront": wf.cull_placement(inp)}}
        torch.cuda.empty_cache()
    return out


def _census_totals(census) -> dict:
    """A megakernel census (cull.megakernel_census) summed over its steps:
    live segments, steps, warp steps and the share of their lanes that are
    live, and the sphere tests (the priors' included) and box tests per
    live segment that each lane's own decisions need and that the warp
    vote runs."""
    steps = [c.count for c in census]
    live = sum(c.live for c in steps)
    warps = sum(c.warps for c in census)
    per = lambda v: round(v / max(live, 1), 2)  # noqa: E731
    return {"segments": live, "steps": len(steps), "warp_steps": warps,
            "live_lane_share": round(live / max(32 * warps, 1), 4),
            "own_tests_per_segment": per(sum(c.own_sphere_tests + c.prior_tests
                                             for c in steps)),
            "own_boxes_per_segment": per(sum(c.own_box_tests for c in steps)),
            "vote_tests_per_segment": per(sum(c.sphere_tests + c.prior_tests for c in steps)),
            "vote_boxes_per_segment": per(sum(c.box_tests for c in steps))}


def _megakernel_census(inp, w, h, spp, bounces, frame=0) -> dict:
    """The megakernel's frame counted by cull.megakernel_census on the
    twin's rays, its warps' lanes in step (one sample and bounce at a
    time) and refilled
    per lane (the kernel's); each lane's own counts are the same in both."""
    from weekend_raytracer_tpu_torch.ops.cuda import cull

    t0 = time.perf_counter()
    out = {grouping: cull.megakernel_census(inp, w, h, spp, bounces, frame,
                                            refill=grouping == "refill")
           for grouping in ("lockstep", "refill")}
    own = [cull.CullCount(*map(sum, zip(*(c.count for c in steps))))
           for steps in out.values()]
    own = [(c.live, c.prior_tests, c.own_sphere_tests, c.own_box_tests) for c in own]
    _check(own[0] == own[1], ("the megakernel census's own counts depend on the grouping",
                              own))
    out["seconds"] = time.perf_counter() - t0
    return out


def _megakernel_paths(mk, rg, wf, ro, sw) -> dict:
    """``[megakernel]``: the megakernel (per-warp cull, samples
    refilled per lane) equals the stats megakernel, which sweeps every
    sphere from a staged table, in every bit (_MK_CASES), with one
    launch each, counted from 0; with each case's times (CUDA events), the
    cull placement and the kernel's registers. Then a 1080p band of the
    textured scene against its twin at the image gates, and the census of
    RTiOW 1080p x 32 spp in both groupings."""
    out = {}
    for name, w, h, spp, bounces in _MK_CASES:
        case = _case(name, w, h, "cuda")
        inp = mk.kernel_inputs(*case)
        kw = dict(width=w, height=h, spp=spp, num_bounces=bounces)
        acc = torch.zeros((w * h, 3), device="cuda")
        ref = torch.zeros_like(acc)
        torch.cuda.synchronize()
        _zero_launch_counts(mk, rg, wf, ro, sw)
        mk.render_image_megakernel(acc, 0, True, *case, **kw)
        torch.cuda.synchronize()
        launches = _launch_counts(mk, rg, wf, ro, sw)
        want = {**dict.fromkeys(launches, 0), "megakernel": 1}
        _check(launches == want, ("megakernel launches", name, launches, want))
        mk.launch_megakernel(ref, inp, 0, True, stats=True, **kw)
        torch.cuda.synchronize()
        differ = int((acc != ref).any(dim=1).sum())
        _check(differ == 0, ("the megakernel is not the full sweep", name, differ,
                             _compare(ref, acc, w, h)))
        _check(bool(torch.isfinite(acc).all()), (name, "non-finite"))
        reps = 1 if w * h * spp > 1e7 else 5
        out[name] = {"shape": f"{name} {w}x{h} spp{spp} b{bounces}", "vs_full_sweep": "bit-exact",
                     "launches": _launch_summary(launches),
                     "ms": _time_ms(lambda: mk.launch_megakernel(acc, inp, 0, True, **kw), reps),
                     "stats_ms": _time_ms(lambda: mk.launch_megakernel(
                         ref, inp, 0, True, stats=True, **kw), reps),
                     "spheres": inp.n_spheres, "chunks": inp.n_chunks,
                     "placement": rg.cull_placement(inp)}
        del acc, ref
        torch.cuda.empty_cache()
    # the textured scene's 1080p band against its twin (Queue 3's item)
    w, h = _MAIN["width"], _MAIN["height"]
    inp = mk.kernel_inputs(*_case("textured", w, h, "cuda"))
    kw = dict(width=w, height=TEX_BAND[1], spp=_MAIN["spp"], num_bounces=_MAIN["bounces"],
              row_offset=TEX_BAND[0], full_height=h)
    band = torch.zeros((w * TEX_BAND[1], 3), device="cuda")
    plain = torch.zeros_like(band)
    mk.launch_megakernel(band, inp, 0, True, **kw)
    mk.render_plain_with_inputs(plain, inp, 0, True, **kw)
    torch.cuda.synchronize()
    st = _compare(plain / _MAIN["spp"], band / _MAIN["spp"], w, TEX_BAND[1])
    _check(st["rmse"] < RMSE_GATE and st["mean_rel"] < MEAN_REL_GATE, ("textured band", st))
    out["textured_band"] = {"rows": [TEX_BAND[0], sum(TEX_BAND)], "spp": _MAIN["spp"],
                            "texture_pool_rows": int(inp.tex_pool.numel() // 128), **st}
    out["census_1080p"] = _megakernel_census(
        mk.kernel_inputs(*_case("rtiow", w, h, "cuda")), w, h, _MAIN["spp"], _MAIN["bounces"])
    torch.cuda.empty_cache()
    return out


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


def _real_root_pairs(rg, inp, t, frame, b_lo: int, b_hi: int, real_only: bool = False) -> int:
    """The pairs with a real root (b^2 - cq > 0, the pairs whose root a
    stats kernel takes) of the rays alive at the start of each bounce of
    [b_lo, b_hi) (K0 run to each depth: the same paths as every kernel's),
    each against every sphere and, in a scene with chunks, the priors; of
    the real pixels' slots only with ``real_only`` (the megakernel's)."""
    from weekend_raytracer_tpu_torch.probes.mxu_sweep import real_root_pairs

    dev = inp.sweep.device
    table = inp.sweep
    if inp.n_chunks:
        table = torch.cat([table, table[inp.prior_idx.long()]])
    x, y = _slot_pixels(t, dev)
    real = (x < t.width) & (y < t.height)
    pool = torch.empty((rg.N_COMP, t.cap), device=dev)
    contrib = torch.empty((3, t.cap), device=dev)
    kept = 0
    for b in range(b_lo, b_hi):
        rg.launch_k0(inp, pool, contrib, t, frame, b)
        alive = pool[rg._AL] > 0.5
        if real_only:
            alive &= real
        idx = torch.nonzero(alive).squeeze(1)
        for r0 in range(0, idx.numel(), 1 << 21):
            kept += real_root_pairs(table, pool[:6, idx[r0:r0 + (1 << 21)]])
    return kept


def _culled_ops(spans, own: bool = True) -> float:
    """FP32 operations of the culled sweep, counted by rg.cull_census over
    some of its kernels' bounces: each sphere test (the priors' included)
    and each box test that each live lane's own decisions need, the work
    the function needs; or (own=False) those the lanes run under the warp
    vote, the design's work."""
    return float(sum(
        SPHERE_TEST_OPS * ((c.own_sphere_tests if own else c.sphere_tests) + c.prior_tests)
        + SLAB_TEST_OPS * (c.own_box_tests if own else c.box_tests)
        for _, counts in spans for c in counts))


def _culled_bounds(census, k0_bytes: float, k1_bytes: float, full: dict) -> dict:
    """K0's and K1's bounds from a census of their frame (K0 its first
    span, K1 the rest): ``bound_ms`` from the work each lane's own cull
    decisions need, ``vote_bound_ms`` the same bound on what the warp vote
    makes the lanes do (the gap is what the vote costs), and
    ``bound_full_ms`` the full sweep's, from ``full``."""
    out = {}
    for key, spans, nbytes in (("k0", census[:1], k0_bytes), ("k1", census[1:], k1_bytes)):
        out[key] = {**_bound(_culled_ops(spans), nbytes),
                    "vote_bound_ms": _bound(_culled_ops(spans, own=False), nbytes)["bound_ms"],
                    "bound_full_ms": full[key]["bound_ms"]}
    return out


def _megakernel_bound(mk_census, pixels: int, full: dict) -> dict:
    """The megakernel's bound from its census (_megakernel_census): each
    real pixel's own sphere, prior and box tests (``bound_ms``); the same
    bound on what the warp vote runs with the lanes refilled
    (``vote_bound_ms``, the kernel's grouping) and in step
    (``lockstep_vote_bound_ms``, one sample and bounce at a time); the
    full sweep's (``bound_full_ms``, from ``full``). A pixel writes 12
    bytes."""
    refill, lockstep = ([(None, [c.count for c in mk_census[g]])]
                        for g in ("refill", "lockstep"))
    return {**_bound(_culled_ops(refill), pixels * 12),
            "vote_bound_ms": _bound(_culled_ops(refill, own=False), pixels * 12)["bound_ms"],
            "lockstep_vote_bound_ms": _bound(_culled_ops(lockstep, own=False),
                                             pixels * 12)["bound_ms"],
            "bound_full_ms": full["bound_ms"]}


def _bounds(mk, inp, t, live_all, live_real, mk_stats=None, k1_stats=None,
            census=None, mk_census=None, stats_kept=(0, 0)) -> dict:
    """Each kernel's bound at the [timing] shape, from this run's live
    counts: a live path segment (a path alive at the start of a bounce)
    tests every prepared sphere; a stats kernel's segment is
    probes.stats_bound's (each pair, the priors' too, each box, and the
    root of each pair with a real root: ``stats_kept``, the megakernel's
    and K1's, _real_root_pairs). K0 and K1 cull per warp: with
    ``census`` (rg.cull_census of this frame) their bound counts the work
    each lane's own cull decisions need (``_culled_bounds``: beside it the
    warp vote's work and the full sweep's); so does the megakernel with
    ``mk_census`` (_megakernel_bound). The megakernels trace the real
    pixels' paths (the stats one counts the TPU's padded lanes without
    tracing them, so its segments are its table's col 1 less the padded
    lanes' weight); K1 stats traces the segments of its table's col 1
    (``k1_stats``). Each record or value is read once and written once
    (csrc/regroup.cu's layout), and a stats table (``mk_stats``,
    ``k1_stats``) written once. The scatter, camera and sky add under 2%
    to a sweep of 496 spheres and are not counted."""
    n = inp.n_spheres
    sweep = SPHERE_TEST_OPS * n
    pixels = t.width * t.height
    cuts = list(_CUTS)
    n_in = [t.cap] + [live_all[c] for c in cuts[:-1]]  # each PACK's input records
    n_out = [live_all[c] for c in cuts]  # and the live records it keeps
    k1_seg = sum(live_all[cuts[0]:])
    k0_bytes = t.cap * (RECORD_BYTES + 12)
    k1_bytes = sum(b * (2 * RECORD_BYTES + 12) for b in n_out)
    full = {"k0": _bound(sweep * sum(live_all[:cuts[0]]), k0_bytes),
            "k1": _bound(sweep * k1_seg, k1_bytes)}
    if census is not None:
        full = _culled_bounds(census, k0_bytes, k1_bytes, full)
    out = {
        "megakernel": _bound(sweep * sum(live_real), pixels * 12),
        "k0": full["k0"],
        "pack": _bound(0, sum(a * 8 + b * 2 * RECORD_BYTES for a, b in zip(n_in, n_out))),
        "k1": full["k1"],
        # COMBINE, on the slots of real pixels only (it skips the padding
        # lanes): each slot's first inverse-map entry, one more entry per
        # record that lived into a later phase, one radiance triple a slot,
        # the accumulator read and written
        "combine": _bound(0, live_real[0] * 16 + sum(live_real[c] for c in cuts[:-1]) * 4
                          + pixels * 24),
    }
    if mk_census is not None:
        out["megakernel"] = _megakernel_bound(mk_census, pixels, out["megakernel"])
    scene = (inp.n_spheres, inp.n_tests, inp.n_super, mk.N_PRIORS if inp.n_chunks else 0)
    if mk_stats is not None:
        out["megakernel_stats"] = stats_bound(sum(live_real), stats_kept[0],
                                              pixels * 12 + mk_stats.numel() * 4, *scene)
    if k1_stats is not None:
        out["k1_stats"] = stats_bound(float(k1_stats[:, 1].sum()), stats_kept[1],
                                      n_out[0] * (2 * RECORD_BYTES + 12)
                                      + k1_stats.numel() * 4, *scene)
    return out


def _library_ms(rg, inp, t, frame, num_bounces, live_all, reps: int = 5) -> dict:
    """One PyTorch call per kernel's function, where one computes it, on
    this frame's own inputs at tiling ``t`` (a manual K0 -> PACK -> K1
    chain of the kernels gives them): PACK as torch.nonzero +
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
    status = rg.pack_scratch(t.cap, dev)
    pack_ms = 0.0
    for k, b_lo in enumerate(_CUTS, 1):
        src, dst = pools[(k - 1) % 2], pools[k % 2]
        n_in = t.cap if k == 1 else live_all[_CUTS[k - 2]]

        def lib_pack(src=src, n_in=n_in):
            idx = torch.nonzero(src[rg._AL, :n_in] > 0.5).squeeze(1)
            return src.index_select(1, idx)

        pack_ms += _time_ms(lib_pack, reps)
        invs.append(torch.empty((t.cap,), dtype=torch.int32, device=dev))
        rg.launch_pack(src, dst, invs[-1], counts, k, status)
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


def _wf_buffers(t, comps, dev="cuda"):
    """An empty [tiles, comps, 32, 128] f32 buffer of tiling ``t``."""
    return torch.empty((t.cap // 4096, comps, 32, 128), device=dev)


def _row_plane(pool, comp: int, n: int):
    """Component ``comp`` of rows [0, n) of a wavefront pool, [n, 128]."""
    return pool[:, comp].reshape(-1, 128)[:n]


def _rows_bit_equal(a, b, n: int) -> bool:
    """Whether rows [0, n) of two wavefront pools agree in every bit."""
    full, part = divmod(n, 32)
    ai, bi = a.view(torch.int32), b.view(torch.int32)
    return (torch.equal(ai[:full], bi[:full])
            and torch.equal(ai[full:full + 1, :, :part], bi[full:full + 1, :, :part]))


def _row_contribs(pool, n: int):
    """tr * cr of every lane of rows [0, n): the contributions K1 writes
    to their home rows, [n, 3, 128]."""
    return torch.stack([_row_plane(pool, c, n) * _row_plane(pool, c + 3, n)
                        for c in range(6, 9)], dim=1)


def _compact_both(wf, pool, n_in: int):
    """COMPACT, kernel and twin, on the first n_in rows of ``pool``: the
    dense pools and their row counts, the twin's after the kernel's."""
    dev = pool.device
    out = []
    for fn in (wf.launch_compact, wf.compact_plain):
        counts = torch.tensor([n_in, -1], dtype=torch.int32, device=dev)
        dense = torch.full_like(pool, 7.0)
        fn(pool, dense, counts, 1, torch.empty((pool.shape[0],), dtype=torch.int32, device=dev))
        out.append((dense, counts))
    torch.cuda.synchronize()
    return out


def _wf_first_hit_vs_plain(mk, wf) -> dict:
    """K0, COMPACT and K1 against their twins on the first-hit scene (two
    bounces into a constant sky, so every path is decided), cut after
    bounce 0: K0's alive flags and home rows equal and its contributions
    with an error of 0; COMPACT bit for bit; K1's alive flags equal on
    ALIVE_GATE of the live rows' lanes and their contributions with an
    error of 0 where they do."""
    dev = torch.device("cuda")
    w, h = 64, 48
    inp = mk.kernel_inputs(*_case("first_hit", w, h, dev))
    t = wf.plan(w, h, 1)
    pools = [_wf_buffers(t, wf.N_COMP) for _ in range(2)]
    contribs = [_wf_buffers(t, 3) for _ in range(2)]
    wf.launch_k0(inp, pools[0], contribs[0], t, 0, 1)
    wf.k0_plain(inp, pools[1], contribs[1], t, 0, 1)
    torch.cuda.synchronize()
    _check(torch.equal(pools[0][:, wf._AL], pools[1][:, wf._AL]), "wavefront K0 alive")
    _check(torch.equal(pools[0][:, wf._HOME], pools[1][:, wf._HOME]), "wavefront K0 home rows")
    out = {"k0": float((contribs[0] - contribs[1]).abs().max())}
    _check(out["k0"] == 0.0, ("wavefront K0 contributions", out["k0"]))
    (dk, ck), (dp, cp) = _compact_both(wf, pools[0], t.cap // 128)
    n = int(cp[1])
    _check(int(ck[1]) == n and n > 0, ("first hit: COMPACT rows", int(ck[1]), n))
    _check(_rows_bit_equal(dk, dp, n), "first hit: COMPACT rows differ from the twin's")
    out["compact"] = 0.0
    base = [contribs[0].clone(), contribs[0].clone()]
    pk, pp = dk.clone(), dk.clone()
    wf.launch_k1(inp, pk, base[0], cp, 1, 1, 2)
    wf.k1_plain(inp, pp, base[1], cp, 1, 1, 2)
    torch.cuda.synchronize()
    same = _row_plane(pk, wf._AL, n) == _row_plane(pp, wf._AL, n)
    _check(float(same.float().mean()) >= ALIVE_GATE, ("wavefront K1 alive agreement",
                                                       float(same.float().mean())))
    diff = (_row_contribs(pk, n) - _row_contribs(pp, n)).abs().amax(dim=1)
    out["k1"] = float(diff[same].max())
    _check(out["k1"] == 0.0, ("wavefront K1 base radiance", out["k1"]))
    return out


def _wf_compact_k1_full(mk, wf, inp, t, frame, fkw) -> dict:
    """COMPACT and K1 against their twins at full size, at the main path's
    first cut. COMPACT, on K0's pool, equals its twin bit for bit (count
    and every dense row). K1 runs, kernel and twin, on that dense pool
    over [_CUTS[0], _CUTS[1]); its rows past the count are NaN before the
    kernel runs, which must read none of them. Home rows must be unchanged
    and equal, alive flags equal on ALIVE_GATE of the lanes, and the
    contributions, folded onto K0's, meet RMSE_GATE and MEAN_REL_GATE.
    COMPACT then runs again on K1's output with the live row count as its
    input count (the second cut's limit), bit for bit with its twin."""
    dev = inp.sweep.device
    b_lo, b_hi = _CUTS[0], _CUTS[1]
    pool = _wf_buffers(t, wf.N_COMP)
    contrib = _wf_buffers(t, 3)
    wf.launch_k0(inp, pool, contrib, t, frame, b_lo)
    (dk, ck), (dp, cp) = _compact_both(wf, pool, t.cap // 128)
    del pool
    n = int(cp[1])
    _check(int(ck[1]) == n, ("COMPACT count", int(ck[1]), n))
    _check(_rows_bit_equal(dk, dp, n), "COMPACT rows differ from the twin's at full size")
    out = {"rows_in": t.cap // 128, "rows": n}
    del dp
    pk, pp = dk, dk.clone()
    full, part = divmod(n, 32)
    pk[full:full + 1, :, part:] = float("nan")
    pk[full + 1:] = float("nan")
    home = _row_plane(pp, wf._HOME, n).clone()
    base = [contrib, contrib.clone()]
    wf.launch_k1(inp, pk, base[0], cp, 1, b_lo, b_hi)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wf.k1_plain(inp, pp, base[1], cp, 1, b_lo, b_hi)
    torch.cuda.synchronize()
    out["k1_plain_s"] = time.perf_counter() - t0
    _check(bool(torch.isfinite(base[0]).all()), "K1 read a row past the count")
    _check(bool(torch.isnan(pk[full + 1:]).all() and torch.isnan(pk[full:full + 1, :, part:]).all()),
           "K1 wrote a row past the count")
    _check(torch.equal(_row_plane(pk, wf._HOME, n), home)
           and torch.equal(_row_plane(pp, wf._HOME, n), home), "K1 home rows")
    same = _row_plane(pk, wf._AL, n) == _row_plane(pp, wf._AL, n)
    out["alive_agreement"] = float(same.float().mean())
    _check(out["alive_agreement"] >= ALIVE_GATE, ("K1 alive agreement", out))
    out["contrib_max_abs_err"] = float((base[0] - base[1]).abs().max())
    w, h, spp = fkw["width"], fkw["height"], fkw["spp"]
    img = []
    for c in base:
        acc = torch.zeros((w * h, 3), device=dev)
        wf._fold(c, acc, t, True)
        img.append(acc / spp)
    out["image"] = _compare(img[1], img[0], w, h)
    _check(out["image"]["rmse"] < RMSE_GATE and out["image"]["mean_rel"] < MEAN_REL_GATE,
           ("K1 at full size", out))
    del base, img, pp
    (dk2, ck2), (dp2, cp2) = _compact_both(wf, pk, n)
    n2 = int(cp2[1])
    _check(int(ck2[1]) == n2 <= n < t.cap // 128, ("second COMPACT count", int(ck2[1]), n2, n))
    _check(_rows_bit_equal(dk2, dp2, n2), "second COMPACT rows differ from the twin's")
    out["rows_second"] = n2
    return out


def _wf_bounds(inp, t, live_all, rows, census=None, census_nocut=None) -> dict:
    """The wavefront kernels' bounds over _CUTS, from this frame's live
    counts (``live_all``, paths alive entering each bounce, as for regroup:
    the same slots trace the same paths) and row counts (``rows``: the home
    pool's rows, then the live rows after each cut, from debug_counts):
    K0 at _CUTS[0], K0 with no cuts ("wavefront_k0_nocut", the Renderer's),
    COMPACT and K1. The full sweep tests every prepared sphere per live
    path segment of the bounces a kernel runs. K0 writes each slot's 15
    components and 3 contributions. K1 reads the alive component of every
    lane of its dense rows; a dead lane also reads its tr, cr and home and
    writes its 3 contributions; a live lane (``live_all`` at the cut) reads
    its 10 other loaded components and its home and writes 14 components
    and 3 contributions (csrc/wavefront.cu k1_regrouped). COMPACT reads
    each input row's alive component and reads and writes each live row.
    With ``census`` and ``census_nocut`` (cull.wavefront_census of this
    frame at _CUTS and with no cuts) K0's and K1's bound counts the work
    each lane's own cull decisions need, beside the warp vote's work
    (``vote_bound_ms``, the lanes grouped as the kernels group them) and
    the full sweep's (``bound_full_ms``)."""
    sweep = SPHERE_TEST_OPS * inp.n_spheres
    c1 = _CUTS[0]
    k0_bytes = t.cap * (WF_COMPONENTS * 4 + 12)
    k1_bytes = sum(b * ROW_PLANE_BYTES + 4 * (10 * (b * 128 - n) + 28 * n)
                   for b, n in zip(rows[1:], (live_all[c] for c in _CUTS)))
    out = {
        "wavefront_k0": _bound(sweep * sum(live_all[:c1]), k0_bytes),
        "wavefront_k0_nocut": _bound(sweep * sum(live_all), k0_bytes),
        "wavefront_compact": _bound(0, sum(a * ROW_PLANE_BYTES
                                           + b * 2 * WF_COMPONENTS * ROW_PLANE_BYTES
                                           for a, b in zip(rows[:-1], rows[1:]))),
        "wavefront_k1": _bound(sweep * sum(live_all[c1:]), k1_bytes),
    }
    if census is None:
        return out
    for key, spans, nbytes in (("wavefront_k0", census[:1], k0_bytes),
                               ("wavefront_k1", census[1:], k1_bytes),
                               ("wavefront_k0_nocut", census_nocut, k0_bytes)):
        spans = _wf_spans(spans)
        out[key] = {**_bound(_culled_ops(spans), nbytes),
                    "vote_bound_ms": _bound(_culled_ops(spans, own=False), nbytes)["bound_ms"],
                    "bound_full_ms": out[key]["bound_ms"]}
    return out


def _wf_library_ms(wf, inp, t, frame, num_bounces, reps: int = 5) -> float:
    """COMPACT's function in PyTorch calls, summed over _CUTS on this
    frame's own pools (a K0 -> COMPACT -> K1 chain of the kernels gives
    them): torch.nonzero of the row flags and an index of the live rows;
    the flags are computed outside the timed call, as PACK's are."""
    dev = inp.sweep.device
    pools = [_wf_buffers(t, wf.N_COMP) for _ in range(2)]
    contrib = _wf_buffers(t, 3)
    wf.launch_k0(inp, pools[0], contrib, t, frame, _CUTS[0])
    counts = torch.full((len(_CUTS) + 1,), t.cap // 128, dtype=torch.int32, device=dev)
    tile_sums = torch.empty((t.cap // 4096,), dtype=torch.int32, device=dev)
    total = 0.0
    for k, b_lo in enumerate(_CUTS, 1):
        src, dst = pools[(k - 1) % 2], pools[k % 2]
        flags = (src[:, wf._AL] > 0.0).any(dim=-1)
        flags.view(-1)[int(counts[k - 1]):] = False

        def lib(src=src, flags=flags):
            idx = torch.nonzero(flags)
            return src[idx[:, 0], :, idx[:, 1]]

        total += _time_ms(lib, reps)
        wf.launch_compact(src, dst, counts, k, tile_sums)
        b_hi = _CUTS[k] if k < len(_CUTS) else num_bounces
        wf.launch_k1(inp, dst, contrib, counts, k, b_lo, b_hi)
    torch.cuda.synchronize()
    return total


def _wavefront_device_ms(kernel_ms: dict) -> dict:
    """The profiler's kernel device times of a wavefront frame, per
    wavefront kernel, and the fold's (PyTorch's elementwise kernels)."""
    names = {"wavefront_k0": "wavefront_k0", "compact_count": "wavefront_compact",
             "compact_scan": "wavefront_compact", "compact_scatter": "wavefront_compact",
             "wavefront_k1": "wavefront_k1"}
    out = dict.fromkeys(("wavefront_k0", "wavefront_compact", "wavefront_k1", "fold"), 0.0)
    for name, ms in kernel_ms.items():
        out[names.get(name, "fold")] += ms
    return out


def _same_bits(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _reorder_probes(ro, dma) -> dict:
    """probes/dma.py's probes on the card, with their launches counted from
    0: the four gathers and the scatter at the TPU probes' shapes (each
    kernel against the probe's expectation and its twin, bit for bit) and
    dma_rate over the probe's full (64800, 11, 128) pool, against its twin
    in every bit and timed beside its bound and index_select + sum. Then,
    outside the count, dma_rate on uniform data and the gather and scatter
    at further record widths and SoA plane counts, each against its twin
    bit for bit and the scatter's route checked, and the library
    yardsticks."""
    torch.cuda.synchronize()
    for k in REORDER_KERNELS:
        getattr(ro, k).launches = 0
    out = {"probes": {}}
    for name, fn in dma.PROBES[:6]:
        out["probes"][name] = fn("cuda")
    torch.cuda.synchronize()
    launches = {k: getattr(ro, k).launches for k in REORDER_KERNELS}
    want = {"record_gather": 4, "record_scatter": 1,
            "dma_rate": 2 + dma.RATE_PROBE["reps"]}
    _check(launches == want, ("reorder probe launches", launches, want))
    out["launches"] = launches
    # each small probe's kernel at its own shape, where a launch is all it
    # costs: beside its twin, its byte bound and index_select / index_copy_
    at_shape = {}
    for name in dma.RECORD_PROBES:
        src, idx, held = dma.probe_inputs(name, "cuda")
        idx_long = idx.long()
        if held is None:
            dst = torch.empty((idx.numel(), *src.shape[1:]), device="cuda")
            fns = (lambda: ro.record_gather(src, idx, dst),
                   lambda: ro.gather_plain(src, idx, dst),
                   lambda: src.index_select(0, idx_long))
        else:
            dst = held
            fns = (lambda: ro.record_scatter(src, idx, dst),
                   lambda: ro.scatter_plain(src, idx, dst),
                   lambda: dst.index_copy_(0, idx_long, src))
        moved = idx.numel() * (src.numel() // src.shape[0])
        at_shape[name] = {**dict(zip(("ms", "plain_ms", "library_ms"),
                                     (_time_ms(fn, 100) for fn in fns))),
                          **_bound(0, 2 * moved * 4 + idx.numel() * 4)}
    out["at_shape"] = at_shape
    # the fixed sum order, where it matters: uniform values in [0, 1)
    gen = torch.Generator(device="cuda").manual_seed(5)
    pool = torch.rand((dma.RATE_PROBE["records"], dma.RATE_PROBE["comps"], dma.RATE_PROBE["width"]),
                      generator=gen, device="cuda")
    perm = torch.randperm(pool.shape[0], generator=gen, device="cuda").to(torch.int32)
    _check(_same_bits(ro.dma_rate(pool, perm), ro.dma_rate_plain(pool, perm)),
           "dma_rate against its twin on uniform data")
    out["dma_rate_plain_ms"] = _time_ms(lambda: ro.dma_rate_plain(pool, perm), 2)
    del pool
    # records along dim 0 (rows of several widths) and along dim 1 (columns
    # of 16 planes, as the binned pool's, and of 5): a short list and a
    # permutation each. The scatter's route is read from its launches: a
    # short list must keep what dst held elsewhere, so it stores where it
    # points (scatter_cols, reorder_rows: one launch); a permutation of
    # records whose contiguous bytes are fewer than a 32-byte sector's is
    # inverted and gathered through (invert + gather_cols: two launches).
    widths = {}
    for shape, dim in (((4099, 3), 0), ((2048, 128), 0), ((1024, 11, 128), 0),
                       ((777, 5, 16), 0), ((16, 4099), 1), ((5, 1031), 1)):
        records = shape[dim]
        # the bytes of a record that lie together: a row, or a value a plane
        record_bytes = 4 * torch.Size(shape).numel() // records if dim == 0 else 4
        src = torch.randn(shape, generator=gen, device="cuda")
        perm = torch.randperm(records, generator=gen, device="cuda").to(torch.int32)
        for cover, idx in (("short", perm[:records - 3]), ("permutation", perm)):
            got = ro.record_gather(src, idx, dim=dim)
            _check(_same_bits(got, ro.gather_plain(src, idx, torch.empty_like(got), dim)),
                   ("record_gather against its twin", shape, dim, cover))
            dst = torch.randn(shape, generator=gen, device="cuda")
            ref = dst.clone()
            before = ro.record_scatter.launches
            ro.record_scatter(got, idx, dst, dim)
            route = {1: "direct", 2: "inverse"}.get(ro.record_scatter.launches - before)
            ro.scatter_plain(got, idx, ref, dim)
            _check(_same_bits(dst, ref), ("record_scatter against its twin", shape, dim, cover))
            want = "inverse" if cover == "permutation" and record_bytes < 32 else "direct"
            _check(route == want, ("record_scatter route", shape, dim, cover, route, want))
            widths[f"{shape} dim {dim} {cover}"] = f"bit-exact ({route})"
    out["widths"] = widths
    out["index_select_bw"] = dma.probe_index_select_bw("cuda")
    out["sort_cost"] = dma.probe_sort_cost("cuda")
    return out


def _binned_run(mk, rg, wf, ro, sw, binned, scene: str, quick: bool) -> dict:
    """probes/binned.py's path through binned.run, with the launches
    counted from 0: K0 and PACK to the cut, one K1, sort and gather to warm
    up, then per scheme the sort, the
    permutation (record_gather), K1 timed on it, the scatter back
    (record_scatter, held to the home-order K1 in every bit inside run) and
    K1-stats. On RTiOW each scheme's counters are also held against the
    twin on the last dense tiles (equal per tile over one bounce, column
    sums within STATS_SUM_GATE over [cut, 8)); the launches those
    comparisons make are not counted."""
    extra, vs_plain = {}, {}

    def on_scheme(name, pool, counts, n, t, inp, st):
        if scene != "rtiow":
            return
        torch.cuda.synchronize()
        before = _launch_counts(mk, rg, wf, ro, sw)
        vs_plain[name] = _k1_span_vs_plain(rg, inp, pool, counts, n, t, 0, BINNED_CUT,
                                           binned.BOUNCES, st)
        torch.cuda.synchronize()
        for k, v in _launch_counts(mk, rg, wf, ro, sw).items():
            extra[k] = extra.get(k, 0) + v - before[k]

    torch.cuda.synchronize()
    _zero_launch_counts(mk, rg, wf, ro, sw)
    head = []
    rows = binned.run(BINNED_CUT, scene, quick, on_scheme=on_scheme, emit=head.append)
    torch.cuda.synchronize()
    launches = {k: v - extra.get(k, 0) for k, v in _launch_counts(mk, rg, wf, ro, sw).items()}
    n_s, reps = len(rows), (3 if quick else 5)
    # each scheme but home scatters back twice (records, radiance), each a
    # permutation of all its pool's records, one value a plane: the inverse
    # route, two launches (invert, gather_cols) a scatter
    want = {**dict.fromkeys(launches, 0), "k0": 1, "pack": 1, "k1": 1 + n_s * reps,
            "k1_stats": n_s, "record_gather": n_s, "record_scatter": 2 * (n_s - 1) * 2}
    _check(launches == want, ("binned launches", scene, launches, want))
    _check(all(r["in_sum_rel_err"] < 1e-9 for r in rows), ("binned live sums", rows))
    return {"pool": head[0], "live_records": head[1]["n"], "rows": rows,
            "launches": launches, "vs_plain": vs_plain}


def _binned_kernels(mk, rg, ro, binned) -> dict:
    """Every kernel of the binned path at its own shape, RTiOW 1080p x 4
    spp at cut 3: K0 and PACK to the cut, K1 and K1-stats over [3, 8) on the
    dense pool, and the chunkxoct permutation (record_gather) and its
    undoing (record_scatter), those two against their twins bit for bit
    (the scatter gives back the dense pool). Each is timed (CUDA events)
    beside its twin, its bound from this run's live counts (K0 and K1: the
    work each lane's own cull decisions need, rg.cull_census of this frame,
    with the warp vote's and the full sweep's beside it; a stats segment
    tests every sphere, the priors and the chunk boxes, probes.stats_bound;
    every value moved once)
    and, where one computes the same function, one PyTorch call (PACK:
    nonzero + index_select; the gather: index_select; the scatter:
    index_copy_)."""
    w, h = binned.SHAPES["rtiow"]
    cut, bounces = BINNED_CUT, binned.BOUNCES
    inp, _ = binned.scene_inputs("rtiow", w, h, "cuda")
    t, _ = rg.plan(w, h, binned.SPP, bounces, (cut,))
    live_all, _ = _live_per_bounce(rg, inp, t, 0, cut + 1)
    pool = torch.empty((rg.N_COMP, t.cap), device="cuda")
    contrib = torch.empty((3, t.cap), device="cuda")
    dense = torch.empty_like(pool)
    inv = torch.empty((t.cap,), dtype=torch.int32, device="cuda")
    status = rg.pack_scratch(t.cap, "cuda")
    counts = torch.tensor([t.cap, 0], dtype=torch.int32, device="cuda")
    plain_ms, ms, library_ms = {}, {}, {}
    # the twins first, so that the kernels' outputs are the ones kept
    plain_ms["k0"] = _time_ms(lambda: rg.k0_plain(inp, pool, contrib, t, 0, cut), 1)
    ms["k0"] = min(_time_ms(lambda: rg.launch_k0(inp, pool, contrib, t, 0, cut), 3)
                   for _ in range(2))
    plain_ms["pack"] = _time_ms(lambda: rg.pack_plain(pool, dense, inv, counts, 1), 1)
    ms["pack"] = min(_time_ms(lambda: rg.launch_pack(pool, dense, inv, counts, 1, status), 3)
                     for _ in range(2))
    library_ms["pack"] = _time_ms(lambda: pool.index_select(
        1, torch.nonzero(pool[rg._AL] > 0.5).squeeze(1)), 3)
    n = int(counts[1])
    _check(n == live_all[cut], ("binned pool", n, live_all[cut]))
    table = _k1_stats(rg, rg.launch_k1, inp, dense, counts, t, 0, cut, bounces)
    segments = float(table[:, 1].sum())
    for key, stats in (("k1", False), ("k1_stats", True)):
        plain_ms[key] = _k1_ms(rg, inp, dense, counts, t, 0, cut, bounces, stats, 1,
                               fn=rg.k1_plain)
        ms[key] = min(_k1_ms(rg, inp, dense, counts, t, 0, cut, bounces, stats, 3)
                      for _ in range(2))
    library_ms.update(k0=None, k1=None, k1_stats=None)

    order = binned.stable_order(binned.bin_keys(dense, n, inp, ("chunkxoct",))["chunkxoct"])
    end = -(-n // 128) * 128
    index = binned.with_tail(order, n, end)
    order_long, index_long = order.long(), index.long()
    perm, plain = torch.empty_like(dense), torch.empty_like(dense)
    ro.record_gather(dense, index, perm, dim=1)
    ro.gather_plain(dense, index, plain, dim=1)
    torch.cuda.synchronize()
    _check(_same_bits(perm[:, :end], plain[:, :end]), "record_gather against its twin, 1080p")
    src = perm[:, :n].contiguous()
    back, back_plain = torch.empty_like(src), torch.empty_like(src)
    ro.record_scatter(src, order, back, dim=1)
    ro.scatter_plain(src, order, back_plain, dim=1)
    torch.cuda.synchronize()
    _check(_same_bits(back, back_plain) and _same_bits(back, dense[:, :n]),
           "record_scatter against its twin and the dense pool, 1080p")
    reps = 10
    ms["record_gather"] = min(_time_ms(lambda: ro.record_gather(dense, index, perm, dim=1),
                                       reps) for _ in range(2))
    ms["record_scatter"] = min(_time_ms(lambda: ro.record_scatter(src, order, back, dim=1),
                                        reps) for _ in range(2))
    plain_ms["record_gather"] = _time_ms(lambda: ro.gather_plain(dense, index, plain, dim=1),
                                         reps)
    plain_ms["record_scatter"] = _time_ms(
        lambda: ro.scatter_plain(src, order, back_plain, dim=1), reps)
    library_ms["record_gather"] = _time_ms(lambda: torch.index_select(dense, 1, index_long),
                                           reps)
    library_ms["record_scatter"] = _time_ms(
        lambda: back_plain.index_copy_(1, order_long, src), reps)

    sweep = SPHERE_TEST_OPS * inp.n_spheres
    k0_bytes, k1_bytes = t.cap * (RECORD_BYTES + 12), n * (2 * RECORD_BYTES + 12)
    value = rg.N_COMP * 4
    census = rg.cull_census(inp, t, 0, (cut,), bounces)
    bounds = {
        **_culled_bounds(census, k0_bytes, k1_bytes,
                         {"k0": _bound(sweep * sum(live_all[:cut]), k0_bytes),
                          "k1": _bound(sweep * segments, k1_bytes)}),
        "pack": _bound(0, t.cap * 8 + n * 2 * RECORD_BYTES),
        "k1_stats": stats_bound(segments, _real_root_pairs(rg, inp, t, 0, cut, bounces),
                                k1_bytes + table.numel() * 4, inp.n_spheres, inp.n_tests,
                                inp.n_super, mk.N_PRIORS),
        "record_gather": _bound(0, end * (2 * value + 4)),
        "record_scatter": _bound(0, n * (2 * value + 4)),
    }
    return {"records": n, "slots": t.cap, "live_per_bounce": live_all, "segments": segments,
            "census_segments": [sum(c.live for c in counts) for _, counts in census],
            "tests_per_segment": [round(_per_segment(census[:1]), 2),
                                  round(_per_segment(census[1:]), 2)],
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bounds": bounds,
            "share": {k: bounds[k]["bound_ms"] / ms[k] for k in ms},
            "share_full": {k: bounds[k]["bound_full_ms"] / ms[k] for k in ("k0", "k1")}}


def _sweep_launches(mxu, name: str) -> dict:
    """The launches each probe of probes/mxu_sweep.py makes: a kernel held
    against its twin once, then timed (time_mean: a warm call and ``reps``),
    or timed in turns (twice); the sweep probes at the probe's shape and at
    the card-filling one."""
    def timed(reps):
        return 1 + reps

    def case(reps):
        return 1 + timed(reps)

    def turns(reps):
        return 1 + 2 * timed(reps)

    r, p8, fl = 20, mxu.P8["reps"], mxu.FILL["reps"]
    probe = case(mxu.PROBE["reps"])
    prec = "sweep_mma_" + ("tf32" if name.endswith("bf16") else "3xtf32")
    want = dict.fromkeys(SWEEP_KERNELS, 0)
    if name in ("p1", "p2"):
        want["layout"] = 2 * case(r)
    elif name == "p3":  # the probe's shape and the card-filling B[8, 2^20]
        want["dot_mma"] = mxu.dot_launches(r)
    elif name == "p4":
        want["layout"] = (len(mxu.CHAIN_SHAPES) + 1) * 2 * case(r)
    elif name.startswith("p5"):
        want["sweep_fma"] = want[prec] = probe + case(fl)
    elif name.startswith("p7"):
        want[prec] = probe + case(fl)
    elif name.startswith("p8"):
        want["sweep_fma"] = want[prec] = case(p8) + case(fl)
    elif name == "fill":  # and the census launch beside sweep_mma's, at each precision
        want.update(sweep_fma=2 * turns(fl), sweep_mma_tf32=turns(fl) + 2,
                    sweep_mma_3xtf32=turns(fl) + 2)
    elif name == "window":
        want.update(sweep_mma_tf32=1, sweep_mma_3xtf32=1)
    return want


def _sweep_probes(mk, rg, wf, ro, sw, mxu) -> dict:
    """probes/mxu_sweep.py's probes (benchmarks/probe_mxu_sweep.py's nine
    pallas_calls, p6's yardstick, the card-filling ``fill`` and ``window``)
    through their entry points, each with every launch counted from 0: each
    kernel held against its twin inside its probe (layout remap and dot_mma
    FP32 bit for bit, the chain and the TF32 products within their bounds,
    the sweeps on every ray at the probe's shapes and at FILL_WRONG_SHARE at
    the card-filling one) and timed beside its bound. Each probe must make
    exactly the launches _sweep_launches counts, and no kernel of another
    path launches."""
    mxu.warm_up()
    out, total = {}, dict.fromkeys(SWEEP_KERNELS, 0)
    for name, fn in mxu.PROBES:
        torch.cuda.synchronize()
        _zero_launch_counts(mk, rg, wf, ro, sw)
        out[name] = fn("cuda")
        torch.cuda.synchronize()
        launches = _launch_counts(mk, rg, wf, ro, sw)
        want = {**dict.fromkeys(launches, 0), **_sweep_launches(mxu, name)}
        _check(launches == want, ("sweep probe launches", name, launches, want))
        for k in SWEEP_KERNELS:
            total[k] += launches[k]
    _check(all(total.values()), ("a sweep kernel never launched", total))
    out["launches"] = total
    return out


def _access_probes(mk, rg, wf, ro, sw, modules) -> dict:
    """The probes of probes/place.py, probes/mosaic.py and
    probes/gather_cost.py (the indexed-access probes' fifteen pallas_calls)
    through their entry points, each with every launch counted from 0: each
    route of each kernel held against its twin bit for bit inside its probe
    and timed beside its bound. Each probe must make exactly the launches
    its module's ``launches`` counts, and no kernel of another path
    launches."""
    out, total = {}, dict.fromkeys(ACCESS_KERNELS, 0)
    for mod in modules:
        for name, fn in mod.PROBES:
            torch.cuda.synchronize()
            _zero_launch_counts(mk, rg, wf, ro, sw)
            out[name] = fn("cuda")
            torch.cuda.synchronize()
            launches = _launch_counts(mk, rg, wf, ro, sw)
            want = {**dict.fromkeys(launches, 0), **mod.launches(name)}
            _check(launches == want, ("access probe launches", name, launches, want))
            out[name]["launches"] = {k: launches[k] for k in ACCESS_KERNELS}
            for k in ACCESS_KERNELS:
                total[k] += launches[k]
    _check(all(total.values()), ("an access kernel never launched", total))
    out["launches"] = total
    return out


def _child_tiny(event_reps: int = 100, device_reps: int = 20, host_reps: int = 200) -> int:
    """``--child tiny``: rows 9a-9d and 10f at the TPU probes' tiny shapes,
    record_gather at index_select_bw's three shapes, and lane_scan at its
    probe shape (row 10g), in this process, where the profiler keeps every
    event (PERF.md §7): each kernel's and its library call's (index_select,
    index_copy_, cumsum) CUDA-event ms (probes.time_mean), device ms
    (probes.device_times; the library call's from traces that kept every
    event) and host ms (probes.host_ms), printed as one JSON line."""
    import numpy as np

    from weekend_raytracer_tpu_torch.ops.cuda import access as ac
    from weekend_raytracer_tpu_torch.ops.cuda import reorder as ro
    from weekend_raytracer_tpu_torch.probes import device_times, dma, host_ms, time_mean

    pairs = {}
    for name in dma.RECORD_PROBES:
        src, idx, held = dma.probe_inputs(name, "cuda")
        idx_long = idx.long()
        if held is None:
            dst = torch.empty((idx.numel(), *src.shape[1:]), device="cuda")
            pairs[name] = (lambda src=src, idx=idx, dst=dst: ro.record_gather(src, idx, dst),
                           lambda src=src, i=idx_long: src.index_select(0, i))
        else:
            pairs[name] = (lambda src=src, idx=idx, held=held: ro.record_scatter(src, idx, held),
                           lambda src=src, i=idx_long, held=held: held.index_copy_(0, i, src))
    for rows, width in dma.INDEX_SELECT_BW:
        src, idx = dma.index_select_bw_inputs(rows, width, "cuda")
        dst, idx_long = torch.empty_like(src), idx.long()
        pairs[f"{rows}x{width}"] = (
            lambda src=src, idx=idx, dst=dst: ro.record_gather(src, idx, dst),
            lambda src=src, i=idx_long: src.index_select(0, i))
    x = torch.from_numpy((np.random.default_rng(0).random((32, 128)) < 0.5)
                         .astype(np.float32)).cuda()  # mosaic.cumsum_lanes's probe input
    pairs["lane_scan"] = (lambda: ac.lane_scan(x), lambda: torch.cumsum(x, 1))
    fns = {**{k: f for k, (f, _) in pairs.items()},
           **{f"{k}.library": g for k, (_, g) in pairs.items()}}
    dev = device_times(fns, device_reps, "cuda",
                       several=tuple(k for k in fns if k.endswith(".library")))
    out = {}
    for k in pairs:
        case = {}
        for prefix, label in (("", k), ("library_", f"{k}.library")):
            case[f"{prefix}event_ms"] = time_mean(fns[label], event_reps, "cuda")
            case[f"{prefix}device_ms"] = dev[label]["device_ms"]
            case[f"{prefix}device_ms_by"] = dev[label]["device_ms_by"]
            case[f"{prefix}host_ms"] = host_ms(fns[label], host_reps, "cuda")
        out[k] = case
    print(json.dumps(out), flush=True)
    return 0


def _tiny_in_child() -> dict:
    """_child_tiny's cases from a child process (with a time limit)."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", "tiny"],
                         capture_output=True, text=True, timeout=300)
    _check(out.returncode == 0, ("the tiny-shapes child failed", out.stderr[-3000:]))
    return {"cases": json.loads(out.stdout.strip().splitlines()[-1]),
            "child_s": round(time.perf_counter() - t0, 1)}


def _tiny_line(case: dict) -> list:
    """[event, device, host, library event, library device, library host]
    ms of a _child_tiny case."""
    return [_sig(case[k]) for k in ("event_ms", "device_ms", "host_ms", "library_event_ms",
                                    "library_device_ms", "library_host_ms")]


def _sig(x, digits: int = 4):
    """x to ``digits`` significant digits (None stays None)."""
    return None if x is None else float(f"{x:.{digits}g}")


def _access_summary(res: dict) -> dict:
    """{"case.route": [ms, device ms, host ms, bound ms, share, library ms,
    library device ms, library host ms]} of a probe's result (None where a
    number was not taken; host ms: probes.host_ms, a call's host side)."""
    out = {}

    def walk(key, v):
        if isinstance(v, dict) and "bound_ms" in v and "ms" in v:
            out[key] = [_sig(v[k]) if k in ("ms", "bound_ms") else _sig(v.get(k))
                        for k in ("ms", "device_ms", "host_ms", "bound_ms", "share",
                                  "library_ms", "library_device_ms", "library_host_ms")]
        elif isinstance(v, dict):
            for k, vv in v.items():
                walk(f"{key}.{k}" if key else k, vv)

    walk("", {k: v for k, v in res.items() if k not in ("launches", "smem_rate")})
    return out


def _warm_l2(res: dict) -> list:
    """The scratch cases of a probe's result whose calls fit in the L2
    (probes/place.py ``rotation``), so that their byte bound, at the HBM
    rate, is no bound."""
    out = []

    def walk(key, v):
        if isinstance(v, dict) and "warm_l2" in v:
            if v["warm_l2"]:
                out.append(key)
        elif isinstance(v, dict):
            for k, vv in v.items():
                walk(f"{key}.{k}" if key else k, vv)

    walk("", res)
    return out


def _by_events(res: dict) -> list:
    """The cases of a probe's result whose device ms are CUDA-event times,
    because their profiler trace recorded no device event."""
    out = []

    def walk(key, v):
        if isinstance(v, dict) and v.get("device_ms_by") == "cuda_events":
            out.append(key)
        elif isinstance(v, dict):
            for k, vv in v.items():
                walk(f"{key}.{k}" if key else k, vv)

    walk("", res)
    return out


def _xla_renderer(name, backend, spp, frames, budget_texels=None):
    """A 1080p Renderer of the ``[xla]`` phase on the card."""
    from weekend_raytracer_tpu_torch import SCENES, RenderParams, Renderer, SamplingParams

    x = _XLA
    params = RenderParams(
        camera=SCENES[name][1](), viewport_size=(x["width"], x["height"]),
        sampling=SamplingParams(max_samples_per_pixel=spp * frames,
                                num_samples_per_pixel=spp, num_bounces=x["bounces"]))
    return Renderer(SCENES[name][0](), params, backend=backend, device="cuda",
                    budget_texels=budget_texels)


def _xla_eager(r, log_dir) -> dict:
    """One pixel batch of one sample of the xla frame, as the Renderer runs
    it (render_pixels), under the profiler: how many kernels PyTorch
    launches for it, their device time, and the host-clock time of the
    same batch run alone; idle share = 1 - device ms / wall ms."""
    from torch.autograd import DeviceType

    from weekend_raytracer_tpu_torch.ops.tracer import render_pixels
    from weekend_raytracer_tpu_torch.renderer import _default_pixel_batch
    from weekend_raytracer_tpu_torch.utils.metrics import profiler_trace

    x = _XLA
    w, h = x["width"], x["height"]
    batch = _default_pixel_batch(w * h)
    idx = torch.arange(batch, device="cuda")

    def run():
        render_pixels(idx, 0, r._scene, r._sky, r._basis, w, h, 1, x["bounces"])
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profiler_trace(log_dir) as prof:
        run()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA) / 1e3
    return {"pixels": batch, "spp": 1, "bounces": x["bounces"], "kernels": len(events),
            "kernels_per_bounce": len(events) / x["bounces"], "device_ms": device_ms,
            "wall_ms": wall_ms, "idle_share": 1.0 - device_ms / wall_ms,
            "batches_per_sample": -(-w * h // batch)}


def _xla_paths(mk, rg, wf, ro, sw, log_dir) -> dict:
    """The ``"xla"`` backend on the card (plain PyTorch, no kernel of the
    port): RTiOW at 1920x1080 through Renderer(backend="xla") with every
    launch count of the six libraries set to 0 before and required 0 after,
    its image against regroup's on the same params at RMSE_GATE and
    MEAN_REL_GATE; the textured scene's ladder, regroup at three texture
    budgets against the full-resolution xla frame, whose tonemapped RMSE
    must not rise with the budget; and a regroup checkpoint saved after two
    1080p frames, resumed in a fresh renderer, equal in every bit."""
    x = _XLA
    w, h, spp, frames = x["width"], x["height"], x["spp"], x["frames"]
    t_phase = time.perf_counter()
    out = {}
    r = _xla_renderer("rtiow", "xla", spp, frames)
    _check(r.backend == "xla", r.backend)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts(mk, rg, wf, ro, sw)
    stats = r.render()
    counts = _launch_counts(mk, rg, wf, ro, sw)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _check(stats.frames == frames and not any(counts.values()),
           ("the xla frames launched a kernel of the port", stats.frames, counts))
    xla_mean = r.mean_radiance().reshape(-1, 3)
    img = r.image()
    _check(bool(torch.isfinite(xla_mean).all()) and 20 < img.mean() < 235, img.mean())
    out["rtiow"] = {"frames": frames, "spp_per_frame": spp, "launches": counts,
                    "warmup_s": stats.warmup_seconds,
                    "warm_frame_s": (stats.seconds - stats.warmup_seconds) / (frames - 1),
                    "rays_per_s": stats.rays_per_sec, "peak_gb": peak_gb,
                    "image_mean": float(img.mean()), "eager": _xla_eager(r, log_dir)}
    del r
    torch.cuda.empty_cache()
    # regroup on the same params: the same draws, statistically the same image
    g = _xla_renderer("rtiow", "auto", spp, frames)
    _check(g.backend == "regroup", g.backend)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gstats = g.render()
    st = _compare(g.mean_radiance().reshape(-1, 3), xla_mean, w, h)
    _check(st["rmse"] < RMSE_GATE and st["mean_rel"] < MEAN_REL_GATE,
           ("xla against regroup", st))
    out["rtiow"]["vs_regroup"] = st
    out["rtiow"]["regroup"] = {
        "warm_frame_s": (gstats.seconds - gstats.warmup_seconds) / (frames - 1),
        "rays_per_s": gstats.rays_per_sec,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del g, xla_mean
    torch.cuda.empty_cache()
    # the textured ladder: one frame, the full-resolution xla reference
    # against regroup's mipped, quantized LUT at three budgets
    r = _xla_renderer("textured", "xla", spp, 1)
    r.render()
    ref = r.mean_radiance().reshape(-1, 3)
    meta = r._scene.materials.tex_meta
    whole = max(d[0] * d[1] for pair in meta for d in pair)
    ladder = {}
    for budget in _XLA_BUDGETS + (whole,):
        g = _xla_renderer("textured", "regroup", spp, 1, budget_texels=budget)
        g.render()
        ladder[budget] = _compare(g.mean_radiance().reshape(-1, 3), ref, w, h)["rmse"]
    rmse = list(ladder.values())
    _check(all(b <= a for a, b in zip(rmse, rmse[1:])),
           ("the textured RMSE rose with the budget", ladder))
    out["textured_ladder"] = {"largest_texture_texels": whole, "tonemapped_rmse": ladder}
    del r, g, ref
    torch.cuda.empty_cache()
    # a checkpoint of the main path, saved after two frames on the card
    ck = dict(spp=_MAIN["spp"], frames=4)
    a = _xla_renderer("rtiow", "regroup", **ck)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        path = os.path.join(tmp, "ckpt.npz")
        a.render_frame()
        a.render_frame()
        a.save_checkpoint(path)
        while a.render_frame():
            pass
        b = _xla_renderer("rtiow", "regroup", **ck)
        b.load_checkpoint(path)
        _check(b.accumulated_samples() == 2 * ck["spp"], b.accumulated_samples())
        while b.render_frame():
            pass
    _check(torch.equal(a._accum, b._accum), "the resumed regroup render is not bit-equal")
    out["checkpoint"] = {"backend": "regroup", "spp_per_frame": ck["spp"],
                         "frames": ck["frames"], "saved_after": 2, "resumed": "bit-exact"}
    del a, b
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


# [parallel]: RTiOW at the main path's size through the per-shard body
_PAR = dict(width=1920, height=1080, spp=32, bounces=8)
PAD_TILES = 7  # does not divide 1080: bands of 155 rows, 5 padding rows
# (2, 2) against the unsharded Renderer's frames: the two draw different
# samples, so they are held at the image gates once each holds
# SPP_FRAMES x 32 samples (at 32, one frame, the two part by some 0.02 in
# tonemapped RMSE on the CPU at 160x90; the RMSE falls as 1/sqrt(spp))
SPP_FRAMES = 48
# the JAX CLI's JSON keys, in order (weekend_raytracer_tpu/cli.py:171-182)
CLI_KEYS = ("scene", "backend", "size", "spp", "seconds", "warmup_seconds", "rays_per_sec",
            "devices", "sky", "output")
_VIEWER_CASES = (("rtiow", 1920, 1080), ("random10k", 3840, 2160))
_VIEWER_SPP = 4
SUBPROCESS_TIMEOUT_S = 420


def _shard_want(backend: str, counts: dict) -> dict:
    """One shard's launches: a regroup shard runs K0, PACK and K1 at each of
    the three cuts, and COMBINE; a megakernel shard one launch."""
    want = dict.fromkeys(counts, 0)
    if backend == "regroup":
        want.update(k0=1, pack=3, k1=3, combine=1)
    else:
        want.update(megakernel=1)
    return want


def _shards(mods, case, backend, n_tiles, n_spp, frame):
    """Every shard of a (n_tiles, n_spp) layout through render_shard, one
    after another on the card; each tile's spp shards summed in spp order
    (two shards sum alike in either order, as their all_reduce would).
    Returns the frame's contribution [padded H * W, 3], each shard's
    CUDA-event ms (its call: host prep and kernels) and each shard's
    launches, counted from 0."""
    from weekend_raytracer_tpu_torch.parallel.sharding import render_shard

    p = _PAR
    h = p["height"]
    hp = -(-h // n_tiles) * n_tiles
    bands, ms, counts = [], [], []
    for t in range(n_tiles):
        tot = None
        for s in range(n_spp):
            torch.cuda.synchronize()
            _zero_launch_counts(*mods)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            c = render_shard(frame, *case, tile_idx=t, spp_idx=s, n_tiles=n_tiles,
                             n_spp=n_spp, width=p["width"], height=hp, spp=p["spp"],
                             num_bounces=p["bounces"], backend=backend, aim_height=h)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
            n = _launch_counts(*mods)
            _check(n == _shard_want(backend, n), ("shard launches", backend, t, s, n))
            counts.append(n)
            tot = c if tot is None else tot + c
        bands.append(tot)
    return torch.cat(bands), ms, counts


def _unsharded(mods, case, backend, acc, frame, clear):
    mk, rg = mods[0], mods[1]
    p = _PAR
    kw = dict(width=p["width"], height=p["height"], spp=p["spp"], num_bounces=p["bounces"])
    if backend == "regroup":
        n_spheres = int(case[0].spheres.centers.shape[0])
        rg.render_image_regrouped(acc, frame, clear, *case,
                                  cuts=rg.default_cuts(p["bounces"], n_spheres), **kw)
    else:
        mk.render_image_megakernel(acc, frame, clear, *case, **kw)


def _launch_summary(counts) -> dict:
    return {k: v for k, v in counts.items() if v}


def _parallel_path(mods) -> dict:
    """``[parallel]``: the mesh's per-shard body on the card at 1920x1080 x
    32 spp x 8 bounces. (4, 1) for regroup and the megakernel over two
    frames, the second accumulated as base + contrib, equal to the
    unsharded frames in every bit (the megakernel's bands each frame also
    to the stats megakernel's full sweep); PAD_TILES tiles (padding rows
    past the image) bit-equal on the real rows, finite on the padding; (2, 2) at 16
    spp a shard against the unsharded frames at the image gates; then
    Renderer(mesh=global_mesh()) in a one-process NCCL world started by
    initialize, equal to the unsharded Renderer in every bit."""
    p = _PAR
    w, h = p["width"], p["height"]
    case = _case("rtiow", w, h, "cuda")
    out = {}
    for backend in ("regroup", "pallas"):
        ref = torch.zeros((w * h, 3), device="cuda")
        acc = torch.zeros((w * h, 3), device="cuda")
        res = {"shard_ms": [], "unsharded_ms": []}
        for frame in range(2):
            contrib, ms, counts = _shards(mods, case, backend, 4, 1, frame)
            if frame == 0:
                acc.zero_()
            if backend == "pallas":  # the bands against the full sweep
                full = torch.zeros_like(contrib)
                mods[0].launch_megakernel(full, mods[0].kernel_inputs(*case), frame, True,
                                          stats=True, width=w, height=h, spp=p["spp"],
                                          num_bounces=p["bounces"])
                _bitwise_max_err(contrib, full, (backend, "(4, 1) frame", frame,
                                                 "against the full sweep"))
                del full
            acc += contrib
            res["unsharded_ms"].append(_time_ms(
                lambda: _unsharded(mods, case, backend, ref, frame, frame == 0), 1))
            _bitwise_max_err(acc, ref, (backend, "(4, 1) frame", frame))
            res["shard_ms"].append(ms)
        res["launches_per_shard"] = _launch_summary(counts[0])
        # a tile count that does not divide the height: the last band's
        # rows past 1080 are the padding
        contrib, ms, counts = _shards(mods, case, backend, PAD_TILES, 1, 0)
        _unsharded(mods, case, backend, ref, 0, True)
        _bitwise_max_err(contrib[:w * h], ref, (backend, "padded real rows"))
        pad = contrib[w * h:]
        _check(pad.shape[0] == w * (-(-h // PAD_TILES) * PAD_TILES - h)
               and bool(torch.isfinite(pad).all()), (backend, "padding rows"))
        res.update(padded={"tiles": PAD_TILES, "band_rows": -(-h // PAD_TILES),
                           "padding_rows": pad.shape[0] // w, "shard_ms": ms,
                           "padding_mean": float(pad.mean())})
        out[backend] = res
        del ref, acc, contrib, pad
        torch.cuda.empty_cache()
    # (2, 2): 16 spp a shard, against the unsharded 32-spp frames
    sh = torch.zeros((w * h, 3), device="cuda")
    un = torch.zeros((w * h, 3), device="cuda")
    for frame in range(SPP_FRAMES):
        contrib, ms, counts = _shards(mods, case, "regroup", 2, 2, frame)
        if frame == 0:
            sh.zero_()
            spp_ms = ms
        sh += contrib
        _unsharded(mods, case, "regroup", un, frame, frame == 0)
        if frame == 0:
            first = _compare(sh / p["spp"], un / p["spp"], w, h)
    n = SPP_FRAMES * p["spp"]
    st = _compare(sh / n, un / n, w, h)
    _check(st["rmse"] < RMSE_GATE and st["mean_rel"] < MEAN_REL_GATE, ("(2, 2) gates", st))
    out["spp_2x2"] = {"frames": SPP_FRAMES, "spp": n, "shard_ms": spp_ms,
                      "launches_per_shard": _launch_summary(counts[0]),
                      "vs_unsharded": st, "one_frame_vs_unsharded": first}
    del sh, un, contrib
    torch.cuda.empty_cache()
    out["nccl_world"] = _nccl_world(mods)
    return out


def _nccl_world(mods) -> dict:
    """Renderer(mesh=global_mesh()) in a one-process NCCL world that
    multihost.initialize starts from torchrun's variables (a free local
    port): launches counted from 0 over its three frames, its image and
    mean radiance against the unsharded Renderer's in every bit, and one
    frame's shard and all_reduce times (CUDA events) and the gather."""
    import socket
    from datetime import timedelta

    import torch.distributed as dist

    from weekend_raytracer_tpu_torch import SCENES, RenderParams, Renderer, SamplingParams
    from weekend_raytracer_tpu_torch.parallel import multihost
    from weekend_raytracer_tpu_torch.parallel.sharding import render_image_sharded

    p = _PAR
    w, h = p["width"], p["height"]
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "WORLD_SIZE": "1",
           "RANK": "0", "LOCAL_RANK": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        multihost.initialize(backend="nccl", timeout=timedelta(seconds=120))
        _check(dist.is_initialized() and dist.get_backend() == "nccl", "no NCCL world")
        mesh = multihost.global_mesh()
        params = RenderParams(
            camera=SCENES["rtiow"][1](), viewport_size=(w, h),
            sampling=SamplingParams(max_samples_per_pixel=3 * p["spp"],
                                    num_samples_per_pixel=p["spp"], num_bounces=p["bounces"]))
        r = Renderer(SCENES["rtiow"][0](), params, device="cuda", mesh=mesh)
        _check(r.device == torch.device("cuda", 0) and r.backend == "regroup",
               (r.device, r.backend))
        torch.cuda.synchronize()
        _zero_launch_counts(*mods)
        stats = r.render()
        counts = _launch_counts(*mods)
        want = {**dict.fromkeys(counts, 0), "k0": 3, "pack": 9, "k1": 9, "combine": 3}
        _check(counts == want, ("mesh Renderer launches", counts, want))
        gather_ms = []
        for _ in range(3):  # the first also sets up the group's communicator
            t0 = time.perf_counter()
            mean = r.mean_radiance()
            torch.cuda.synchronize()
            gather_ms.append((time.perf_counter() - t0) * 1e3)
        ref = Renderer(SCENES["rtiow"][0](), params, device="cuda")
        ref_stats = ref.render()
        _bitwise_max_err(mean, ref.mean_radiance(), "NCCL mesh Renderer vs unsharded")
        _check(bool((r.image() == ref.image()).all()), "NCCL mesh image")
        scratch = torch.zeros_like(r._accum)
        fkw = dict(width=w, height=h, spp=p["spp"], num_bounces=p["bounces"], mesh=mesh,
                   backend=r.backend)
        render_image_sharded(scratch, 0, True, r._scene, r._sky, r._basis, **fkw)
        stages = [_stage_ms(lambda mark: render_image_sharded(
            scratch, 0, True, r._scene, r._sky, r._basis, on_stage=mark, **fkw))
            for _ in range(3)]
        return {"mesh": mesh.shape, "backend": dist.get_backend(), "launches":
                _launch_summary(counts), "frames": stats.frames,
                "warm_frame_s": (stats.seconds - stats.warmup_seconds) / (stats.frames - 1),
                "unsharded_warm_frame_s": (ref_stats.seconds - ref_stats.warmup_seconds)
                / (ref_stats.frames - 1),
                "shard_ms": [st["shard"] for st in stages],
                "all_reduce_ms": [st["all_reduce"] for st in stages],
                "gather_ms": gather_ms}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _run_bounded(cmd, timeout: float) -> str:
    """Run ``cmd`` from the checkout's root in a session of its own; on
    timeout kill the whole session (torchrun's workers too) and fail.
    Returns its standard output; a non-zero exit fails."""
    import signal

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise RuntimeError(f"{cmd[:6]} timed out after {timeout} s")
    _check(proc.returncode == 0, (cmd[:6], proc.returncode, err[-3000:]))
    return out


def _front_cli() -> dict:
    """The CLI as a user runs it, then under torchrun (one rank, a (1, 1)
    mesh): RTiOW 1920x1080, 64 spp in frames of 32, 8 bounces; the JAX
    CLI's keys, "regroup", and --hdr equal to an in-process Renderer's mean
    radiance in every bit."""
    import numpy as np

    from weekend_raytracer_tpu_torch import SCENES, RenderParams, Renderer, SamplingParams

    p = _PAR
    params = RenderParams(
        camera=SCENES["rtiow"][1](), viewport_size=(p["width"], p["height"]),
        sampling=SamplingParams(max_samples_per_pixel=2 * p["spp"],
                                num_samples_per_pixel=p["spp"], num_bounces=p["bounces"]))
    r = Renderer(SCENES["rtiow"][0](), params, device="cuda")
    r.render()
    want = r.mean_radiance().cpu().numpy()
    del r
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_front_")
    args = ["--scene", "rtiow", "--size", f"{p['width']}x{p['height']}", "--spp",
            str(2 * p["spp"]), "--spp-per-frame", str(p["spp"]), "--bounces", str(p["bounces"]),
            "--stats-json"]
    launchers = {
        "cli": [sys.executable, "-m", "weekend_raytracer_tpu_torch"],
        "torchrun": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                     "--nproc-per-node", "1", "-m", "weekend_raytracer_tpu_torch"]}
    out = {}
    for label, launcher in launchers.items():
        hdr = os.path.join(tmp, f"{label}.npz")
        extra = ["--tile-shards", "1"] if label == "torchrun" else []
        t0 = time.perf_counter()
        stdout = _run_bounded(launcher + args + ["--hdr", hdr, "-o",
                                                 os.path.join(tmp, f"{label}.png")] + extra,
                              SUBPROCESS_TIMEOUT_S)
        wall = time.perf_counter() - t0
        lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
        _check(len(lines) == 1, (label, stdout[-2000:]))
        line = json.loads(lines[0])
        _check(tuple(line) == CLI_KEYS and line["backend"] == "regroup"
               and line["spp"] == 2 * p["spp"] and line["devices"] == 1, (label, line))
        with np.load(hdr) as data:
            got = data["mean_radiance"]
        _check(got.shape == want.shape and np.array_equal((got + 0.0).view(np.int32),
                                                          (want + 0.0).view(np.int32)),
               (label, "--hdr is not the in-process Renderer's mean radiance"))
        out[label] = {"wall_s": wall, **{k: line[k] for k in ("seconds", "warmup_seconds",
                                                              "rays_per_sec", "devices")}}
    return out


def _viewer_events(w: int, h: int) -> list:
    """The scripted fly-camera path: 24 keys (moves, looks, lens and sky
    edits, a reset) and a drag of 6 mouse events, in terminal cells (a row
    is two pixels)."""
    keys = ["w", "w", "a", "d", "s", "q", "e", "j", "l", "i", "k", "f", "F", "g", "G", "v",
            "V", "t", "T", "z", "Z", "x", "X", "r"]
    cols, rows = w, h // 2
    drag = [(cols // 2, rows // 2, True), (cols // 2 + cols // 40, rows // 2, True),
            (cols // 2 + cols // 20, rows // 2 + rows // 30, True),
            (cols // 2 + cols // 20, rows // 2 + rows // 15, True),
            (cols // 2 + cols // 20, rows // 2 + rows // 15, False), (cols // 3, rows // 3, False)]
    return [("key", k) for k in keys] + [("mouse", *m) for m in drag]


def _viewer_run(mods, name: str, w: int, h: int) -> dict:
    """TerminalViewer driven headless on the card along _viewer_events, one
    frame after each event (an event that edits the camera, the sky or the
    sampling resets accumulation, so its frame is a first frame): time to the first frame (the viewer made, its scene on
    the card, one frame read back; the libraries already loaded), each
    event's latency on the host clock to the frame read back after a
    synchronize, the host time of the set_render_params each event ends in,
    and the half-block draw's host time (the native library's route when it
    loads, else the Python one). Launches counted from 0 over the events."""
    import numpy as np

    from weekend_raytracer_tpu_torch import SCENES, SamplingParams
    from weekend_raytracer_tpu_torch.interactive.fly_camera import FlyCameraController
    from weekend_raytracer_tpu_torch.interactive.viewer import TerminalViewer, _halfblock_frame
    from weekend_raytracer_tpu_torch.utils import native

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v = TerminalViewer(SCENES[name][0](), FlyCameraController(), viewport=(w, h),
                       sampling=SamplingParams(max_samples_per_pixel=1 << 16,
                                               num_samples_per_pixel=_VIEWER_SPP,
                                               num_bounces=8),
                       backend="auto", device="cuda")
    _check(v.renderer.render_frame() and v.renderer.backend == "regroup", v.renderer.backend)
    img = v.renderer.image()
    first_s = time.perf_counter() - t0
    set_ms = []
    set_params = v.renderer.set_render_params

    def timed(params):
        t = time.perf_counter()
        changed = set_params(params)
        set_ms.append((time.perf_counter() - t) * 1e3)
        return changed

    v.renderer.set_render_params = timed
    events = _viewer_events(w, h)
    latency = []
    _zero_launch_counts(*mods)
    for kind, *args in events:
        t = time.perf_counter()
        if kind == "key":
            _check(v.handle_key(args[0]), ("viewer quit on", args))
        else:
            v.handle_mouse(*args)
        _check(v.renderer.render_frame(), "the viewer's frame did not render")
        img = v.renderer.image()
        torch.cuda.synchronize()
        latency.append((time.perf_counter() - t) * 1e3)
        _check(img.shape == (h, w, 3), img.shape)
    counts = _launch_counts(*mods)
    n = len(events)
    want = {**dict.fromkeys(counts, 0), "k0": n, "pack": 3 * n, "k1": 3 * n, "combine": n}
    _check(counts == want, ("viewer launches", counts, want))
    # an event that changes no parameter (a release where the drag ended)
    # keeps accumulating
    _check(v.renderer.accumulated_samples() % _VIEWER_SPP == 0 and img.mean() > 1.0,
           (v.renderer.accumulated_samples(), float(img.mean())))
    route = "native" if native.available() else "python"
    draw = native.halfblock_render if route == "native" else _halfblock_frame
    draw_ms = []
    for _ in range(2):
        t = time.perf_counter()
        frame = draw(img)
        draw_ms.append((time.perf_counter() - t) * 1e3)
        _check(len(frame) > w * (h // 2), len(frame))
    del v
    torch.cuda.empty_cache()
    return {"scene": name, "size": f"{w}x{h}", "spp": _VIEWER_SPP, "events": n,
            "first_frame_s": first_s, "latency_ms_p50": float(np.percentile(latency, 50)),
            "latency_ms_p95": float(np.percentile(latency, 95)),
            "latency_ms_max": max(latency),
            "set_render_params_ms_p50": float(np.percentile(set_ms, 50)),
            "set_render_params_ms_max": max(set_ms), "draw_route": route,
            "draw_ms": draw_ms, "launches": _launch_summary(counts)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--png", default=os.path.join(tempfile.gettempdir(),
                                                  "chip_smoke_rtiow.png"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    record = {}

    # 1. environment
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if args.child == "tiny":  # the tiny shapes' device times, in a process of their own
        return _child_tiny()
    if args.child:  # [cull]'s census of one case, in a process of its own
        return _child_census(args.child)
    from weekend_raytracer_tpu_torch import (SCENES, RenderParams, Renderer,
                                             SamplingParams)
    from weekend_raytracer_tpu_torch.ops.cuda import build
    from weekend_raytracer_tpu_torch.ops.cuda import access as ac
    from weekend_raytracer_tpu_torch.ops.cuda import megakernel as mk
    from weekend_raytracer_tpu_torch.ops.cuda import regroup as rg
    from weekend_raytracer_tpu_torch.ops.cuda import reorder as ro
    from weekend_raytracer_tpu_torch.ops.cuda import sweep as sw
    from weekend_raytracer_tpu_torch.ops.cuda import wavefront as wf
    from weekend_raytracer_tpu_torch.probes import (binned, dma, gather_cost, mosaic,
                                                    mxu_sweep, place)

    _check("jax" not in sys.modules, "the port imported jax")
    smi = _nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    _say("env", device=repr(kind), torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())
    record["env"] = {"nvidia_smi": smi, "device": kind, "torch": torch.__version__,
                     "cuda": torch.version.cuda}

    # 2. build the libraries, one nvcc each, in parallel
    t0 = time.perf_counter()
    _check(sw.KERNELS == SWEEP_KERNELS, ("sweep kernels", sw.KERNELS))
    _check(ac.KERNELS == ACCESS_KERNELS, ("access kernels", ac.KERNELS))
    built = dict(zip(("megakernel", "regroup", "wavefront", "reorder", "sweep", "access"),
                     build.load_libraries([mk.LIBRARY, rg.LIBRARY, wf.LIBRARY, ro.LIBRARY,
                                           sw.LIBRARY, ac.LIBRARY])))
    build_s = time.perf_counter() - t0
    ptxas = {k: b.ptxas_usage() for k, b in built.items()}
    attrs = {"megakernel": {("textured" if t else "plain") + suffix:
                            mk.kernel_attributes(t, st, staged, windowed) for t in (False, True)
                            for suffix, st, staged, windowed in (
                                ("", False, True, False), ("_global", False, False, False),
                                ("_stats", True, True, False),
                                ("_stats_global", True, False, False),
                                ("_stats_windowed", True, True, True),
                                ("_stats_global_windowed", True, False, True))},
             "regroup": rg.kernel_attributes(), "wavefront": wf.kernel_attributes(),
             "reorder": ro.kernel_attributes(), "sweep": sw.kernel_attributes(),
             "access": ac.kernel_attributes()}
    _say("build", seconds=f"{build_s:.2f}",
         nvcc_seconds=json.dumps({k: round(b.build_seconds, 2) for k, b in built.items()}),
         ptxas=json.dumps(ptxas, sort_keys=True), attributes=json.dumps(attrs),
         wavefront_registers=json.dumps({k: v["registers"] for k, v in attrs["wavefront"].items()}))
    record["build"] = {"seconds": build_s,
                       "nvcc_seconds": {k: b.build_seconds for k, b in built.items()},
                       "ptxas": ptxas, "attributes": attrs}
    spills = [u for lib in ptxas.values() for u in lib.values()
              if u.get("spill_stores") or u.get("spill_loads")]
    _check(not spills, ("register spills", spills))
    # K0 and K1: the chosen launch bounds, registers, spills, static shared
    # memory and the cull tables each block stages (RTiOW; random10k's in
    # [cull]), in both placements of the boxes
    k01 = ("k0", "k0_textured", "k1", "k1_textured", "k0_global", "k0_global_textured",
           "k1_global", "k1_global_textured")
    _say("build", case="regroup_k0_k1", launch_bounds=json.dumps(rg.launch_bounds()),
         attributes=json.dumps({k: attrs["regroup"][k] for k in k01}),
         ptxas=json.dumps({k: v for k, v in ptxas["regroup"].items()
                           if "regroup_k0" in k or "regroup_k1" in k}),
         rtiow_cull=json.dumps(rg.cull_placement(
             mk.kernel_inputs(*_case("rtiow", 96, 64, "cuda")))))
    record["build"]["regroup_k0_k1"] = {"launch_bounds": rg.launch_bounds()}
    # the megakernel's and its stats kernel's launch bounds, registers and
    # spills (both placements of the boxes); the stats kernels' windows as
    # the library derives them, held to their mirror (mk.stats_plan), and
    # K1's stats kernel's registers
    stats_plans = {k: mk.stats_plan(*shape) for k, shape in STATS_PLAN_SHAPES.items()}
    built_stats_plans = {k: mk.stats_plan_built(*shape) for k, shape in STATS_PLAN_SHAPES.items()}
    _check(stats_plans == built_stats_plans, ("the stats kernels' plan against its mirror",
                                              stats_plans, built_stats_plans))
    _say("build", case="megakernel", launch_bounds=json.dumps(mk.launch_bounds()),
         attributes=json.dumps(attrs["megakernel"]),
         ptxas=json.dumps({k: v for k, v in ptxas["megakernel"].items() if "megakernel" in k}),
         k1_stats_attributes=json.dumps({k: v for k, v in attrs["regroup"].items()
                                         if k.startswith("k1_stats")}),
         stats_plans=json.dumps(stats_plans))
    record["build"]["megakernel"] = {"launch_bounds": mk.launch_bounds(),
                                     "stats_plans": stats_plans}
    # the wavefront's K0 and K1: culled (boxes staged and in global memory)
    # and full-sweep, textured and not; the culled ones' launch bounds, the
    # most slices a K0 warp walks and K1's rows a block (wavefront.cu's
    # constants, which the census mirrors), and the tables a block stages
    _say("build", case="wavefront_k0_k1", launch_bounds=json.dumps(wf.launch_bounds()),
         k0_max_slices=wf.K0_MAX_SLICES, k1_rows=wf.K1_ROWS,
         attributes=json.dumps({k: v for k, v in attrs["wavefront"].items()
                                if k.startswith(("k0", "k1"))}),
         ptxas=json.dumps({k[k.index("wavefront_k"):][:25]: v
                           for k, v in ptxas["wavefront"].items() if "wavefront_k" in k}),
         rtiow_cull=json.dumps(wf.cull_placement(
             mk.kernel_inputs(*_case("rtiow", 96, 64, "cuda")))))
    record["build"]["wavefront_k0_k1"] = {"launch_bounds": wf.launch_bounds()}
    # sweep_mma's chosen launch bounds (one budget for its four, one and
    # census instantiations at each precision), registers and spills
    _say("build", case="sweep_mma", launch_bounds=json.dumps(sw.launch_bounds()),
         attributes=json.dumps({k: v for k, v in attrs["sweep"].items()
                                if k.startswith("sweep_mma")}),
         ptxas=json.dumps({k: v for k, v in ptxas["sweep"].items() if "sweep_mma" in k}))
    record["build"]["sweep_mma"] = {"launch_bounds": sw.launch_bounds()}
    # sweep_fma (kFmaRays rays a thread, and one) and row_sort: registers
    # and spills (none allowed, above); sweep_fma's launch plan as the
    # library derives it, held to its mirror (sw.fma_plan) on this card
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fma_plans = {k: sw.fma_plan(*shape, sms) for k, shape in FMA_PLAN_SHAPES.items()}
    built_plans = {k: sw.fma_plan_built(*shape, sms) for k, shape in FMA_PLAN_SHAPES.items()}
    _check(fma_plans == built_plans, ("sweep_fma's plan against its mirror", fma_plans,
                                      built_plans))
    fma_sort_attrs = {**{k: attrs["sweep"][k] for k in ("sweep_fma", "sweep_fma_narrow")},
                      "row_sort": attrs["access"]["row_sort"]}
    _say("build", case="sweep_fma_row_sort", attributes=json.dumps(fma_sort_attrs),
         ptxas=json.dumps({k: v for lib in ("sweep", "access") for k, v in ptxas[lib].items()
                           if "sweep_fma" in k or "row_sort" in k}),
         fma_plans=json.dumps(fma_plans), sms=sms)
    record["build"]["sweep_fma_row_sort"] = {"attributes": fma_sort_attrs,
                                             "fma_plans": fma_plans}

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
    w, h, spp = _TIMING["width"], _TIMING["height"], _TIMING["spp"]
    t = rg.plan(w, h, spp, _TIMING["bounces"], _CUTS)[0]
    small = _pack_combine_vs_plain(rg, mk.kernel_inputs(*_case(_TIMING["scene"], w, h, "cuda")),
                                   t, seed=0)
    rg_err.update(pack=small["pack"], combine=small["combine"])
    # COMBINE's other staging layouts (spp 1: no padding; spp 2: stride 3;
    # spp 128: 16 tiles a block, stride 129) on a ragged image
    ragged = {}
    for r_spp in (1, 2, 128):
        r_t = rg.plan(100, 70, r_spp, _TIMING["bounces"], _CUTS)[0]
        r = _pack_combine_vs_plain(rg, mk.kernel_inputs(*_case(_TIMING["scene"], 100, 70,
                                                               "cuda")), r_t, seed=r_spp)
        rg_err.update(pack=max(rg_err["pack"], r["pack"]),
                      combine=max(rg_err["combine"], r["combine"]))
        ragged[f"100x70_spp{r_spp}"] = r["live"]
    _say("regroup_plain", case="kernels", k0_max_abs_err=f"{rg_err['k0']:.3e}",
         k1_max_abs_err=f"{rg_err['k1']:.3e}", pack="bit-exact",
         combine="bit-exact", size=f"{w}x{h}", spp=spp,
         pack_in_live=json.dumps(small["live"]), ragged_pack_in_live=json.dumps(ragged))
    record["regroup_plain"] = {"kernels": {**rg_err, "pack_live": small["live"],
                                           "ragged_pack_live": ragged}}
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

    # 4b. the wavefront's kernels against their twins, then the frame at
    # three cut schedules
    wf_err = _wf_first_hit_vs_plain(mk, wf)
    _say("wavefront_plain", case="first_hit", size="64x48", spp=1, cut=1,
         k0_max_abs_err=f"{wf_err['k0']:.3e}", compact="bit-exact",
         k1_max_abs_err=f"{wf_err['k1']:.3e}")
    record["wavefront_plain"] = {"first_hit": wf_err}
    for name, w, h, frames, spp, bounces in _REGROUP_CASES:
        inp = mk.kernel_inputs(*_case(name, w, h, "cuda"))
        for cuts in _WF_SCHEDULES[:3]:
            a = _render(wf.launch_wavefront, inp, w, h, frames, spp, bounces, phase_cuts=cuts)
            b = _render(wf.wavefront_plain_with_inputs, inp, w, h, frames, spp, bounces,
                        phase_cuts=cuts)
            _check(bool(torch.isfinite(a).all()), f"{name}: non-finite wavefront output")
            st = _compare(b, a, w, h)
            _say("wavefront_plain", case=name, size=f"{w}x{h}", frames=frames, spp=spp,
                 bounces=bounces, phase_cuts=cuts, **{k: f"{v:.3e}" for k, v in st.items()})
            record["wavefront_plain"][f"{name}_{cuts}"] = st
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
    launches, accums = {}, {}
    for backend in ("auto", "pallas"):
        renderer = Renderer(SCENES["rtiow"][0](), params, backend=backend, device="cuda")
        expect = "regroup" if backend == "auto" else "pallas"
        _check(renderer.backend == expect, (backend, renderer.backend))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launch_counts(mk, rg, wf, ro, sw)
        stats = renderer.render()
        counts = _launch_counts(mk, rg, wf, ro, sw)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        frames = stats.frames
        _check(frames == mp["max_spp"] // mp["spp"], stats)
        if expect == "regroup":
            want = {"megakernel": 0, "k0": frames, "pack": 3 * frames,
                    "k1": 3 * frames, "combine": frames}
        else:
            want = {"megakernel": frames, "k0": 0, "pack": 0, "k1": 0, "combine": 0}
        want.update(megakernel_stats=0, k1_stats=0, **_NO_WAVEFRONT)
        _check(counts == want, (expect, counts, want))
        launches[expect] = counts
        accums[expect] = renderer._accum.clone()
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
            # look-back runs over 16,320 tiles and a pixel folds 32 lanes
            big = _pack_combine_vs_plain(
                rg, inp, rg.plan(w, h, mp["spp"], mp["bounces"], _CUTS)[0], seed=1)
            rg_err["pack"] = max(rg_err["pack"], big["pack"])
            rg_err["combine"] = max(rg_err["combine"], big["combine"])
            rec["pack_combine_vs_plain"] = big
            _say("main", case="pack_combine_vs_plain", size=f"{w}x{h}", spp=mp["spp"],
                 pack="bit-exact", combine="bit-exact", pack_in_live=json.dumps(big["live"]))
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

    # 6a. Renderer(backend="auto") at 24 spp a frame, not a power of two,
    # as the JAX rule gives it to the megakernel: one launch a frame, none
    # of regroup's; its accumulator equals the stats megakernel's full
    # sweep, frame by frame, in every bit
    ap = RenderParams(camera=SCENES["rtiow"][1](), viewport_size=(w, h),
                      sampling=SamplingParams(max_samples_per_pixel=_AUTO_MK["max_spp"],
                                              num_samples_per_pixel=_AUTO_MK["spp"],
                                              num_bounces=mp["bounces"]))
    renderer = Renderer(SCENES["rtiow"][0](), ap, backend="auto", device="cuda")
    _check(renderer.backend == "pallas", ("auto at 24 spp", renderer.backend))
    torch.cuda.synchronize()
    _zero_launch_counts(mk, rg, wf, ro, sw)
    stats = renderer.render()
    counts = _launch_counts(mk, rg, wf, ro, sw)
    frames = stats.frames
    want = {**dict.fromkeys(counts, 0), "megakernel": frames}
    _check(frames == _AUTO_MK["max_spp"] // _AUTO_MK["spp"] and counts == want,
           ("auto at 24 spp", frames, counts, want))
    inp = mk.kernel_inputs(renderer._scene, renderer._sky, renderer._basis)
    full = torch.zeros_like(renderer._accum)
    for f in range(frames):
        mk.launch_megakernel(full, inp, f, f == 0, stats=True, width=w, height=h,
                             spp=_AUTO_MK["spp"], num_bounces=mp["bounces"])
    torch.cuda.synchronize()
    _check(torch.equal(renderer._accum, full),
           ("auto at 24 spp is not the full sweep", _compare(full, renderer._accum, w, h)))
    img = renderer.image()
    _check(20 < img.mean() < 235, img.mean())
    warm_s = (stats.seconds - stats.warmup_seconds) / max(frames - 1, 1)
    launches["auto_spp24"] = counts
    record["main"]["auto_spp24"] = {
        "frames": frames, "launches": counts, "warmup_s": stats.warmup_seconds,
        "warm_frame_s": warm_s, "rays_per_s": stats.rays_per_sec, "seconds": stats.seconds,
        "image_mean": float(img.mean()), "vs_full_sweep": "bit-exact"}
    _say("main", backend="auto", resolved=renderer.backend, spp=_AUTO_MK["spp"], frames=frames,
         launches=json.dumps(_launch_summary(counts)), warmup_s=f"{stats.warmup_seconds:.3f}",
         warm_frame_s=f"{warm_s:.4f}", rays_per_s=f"{stats.rays_per_sec:.4e}",
         image_mean=f"{img.mean():.1f}", vs_full_sweep="bit-exact (stats megakernel)",
         card=repr(smi))
    del renderer, full
    torch.cuda.empty_cache()

    # 6b. the wavefront through Renderer(backend="wavefront"), as the JAX
    # Renderer runs it: no cuts, so one K0 per frame. After the same frames
    # its accumulator must be regroup's in every bit.
    fkw = dict(width=w, height=h, spp=mp["spp"], num_bounces=mp["bounces"])
    renderer = Renderer(SCENES["rtiow"][0](), params, backend="wavefront", device="cuda")
    _check(renderer.backend == "wavefront", renderer.backend)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts(mk, rg, wf, ro, sw)
    stats = renderer.render()
    counts = _launch_counts(mk, rg, wf, ro, sw)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    frames = stats.frames
    want = {**dict.fromkeys(counts, 0), "wavefront_k0": frames}
    _check(frames == mp["max_spp"] // mp["spp"] and counts == want, ("wavefront", counts, want))
    launches["wavefront"] = counts
    _check(torch.equal(renderer._accum, accums["regroup"]),
           ("the wavefront Renderer's accumulator is not regroup's",
            _compare(accums["regroup"], renderer._accum, w, h)))
    img = renderer.image()
    _check(bool(torch.isfinite(renderer._accum).all()) and 20 < img.mean() < 235, img.mean())
    warm_s = (stats.seconds - stats.warmup_seconds) / max(frames - 1, 1)
    inp = mk.kernel_inputs(renderer._scene, renderer._sky, renderer._basis)
    scratch = torch.zeros_like(renderer._accum)
    wf.launch_wavefront(scratch, inp, 0, True, **fkw)
    stages = _stage_ms(lambda mark: wf.launch_wavefront(scratch, inp, 0, True, on_stage=mark,
                                                        **fkw))
    record["main"]["wavefront"] = {
        "frames": frames, "launches": counts, "warmup_s": stats.warmup_seconds,
        "warm_frame_s": warm_s, "rays_per_s": stats.rays_per_sec, "seconds": stats.seconds,
        "peak_gb": peak_gb, "image_mean": float(img.mean()),
        "frame_kernel_ms": sum(stages.values()), "stages_ms": stages}
    _say("main", backend=renderer.backend, frames=frames, launches=json.dumps(counts),
         spp=stats.samples_per_pixel, warmup_s=f"{stats.warmup_seconds:.3f}",
         warm_frame_s=f"{warm_s:.4f}", rays_per_s=f"{stats.rays_per_sec:.4e}",
         frame_kernel_ms=f"{sum(stages.values()):.2f}",
         stages_ms=json.dumps({k: round(v, 3) for k, v in stages.items()}),
         peak_gb=f"{peak_gb:.3f}", image_mean=f"{img.mean():.1f}",
         accumulator="regroup's, bit for bit", card=repr(smi))
    del renderer, scratch, accums
    torch.cuda.empty_cache()

    # 6c. COMPACT and K1 at 1080p x 32 spp, through render_image_wavefront
    # (the entry point tests/test_wavefront.py calls), with the launches
    # counted from 0: the image equals regroup's in every pixel over two
    # frames, the second accumulated onto the first; every cut schedule
    # gives the same bits; one sample per pixel gives the megakernel's
    case = _case("rtiow", w, h, "cuda")
    inp = mk.kernel_inputs(*case)
    ref, acc = [], torch.zeros((w * h, 3), device="cuda")
    for f in range(2):
        rg.launch_regrouped(acc, inp, f, f == 0, cuts=_CUTS, **fkw)
        ref.append(acc.clone())
    torch.cuda.synchronize()
    _zero_launch_counts(mk, rg, wf, ro, sw)
    wf_rows, wf_peak = {}, {}
    for cuts in _WF_SCHEDULES[1:3]:
        acc = torch.zeros((w * h, 3), device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for f in range(2):
            _, rows = wf.render_image_wavefront(acc, f, f == 0, *case, phase_cuts=cuts,
                                                debug_counts=True, **fkw)
            if f == 0:
                wf_peak[str(cuts)] = torch.cuda.max_memory_allocated() / 1e9
                wf_rows[cuts] = [int(r) for r in rows]
            _check(torch.equal(acc, ref[f]), ("wavefront is not regroup", cuts, f,
                                              _compare(ref[f], acc, w, h)))
    counts = _launch_counts(mk, rg, wf, ro, sw)
    n_cuts = len(_WF_SCHEDULES[1]) + len(_CUTS)
    want = {**dict.fromkeys(counts, 0), "wavefront_k0": 4, "wavefront_compact": 2 * n_cuts,
            "wavefront_k1": 2 * n_cuts}
    _check(counts == want, ("wavefront cuts", counts, want))
    launches["wavefront_cuts"] = counts
    for cuts in (_WF_SCHEDULES[0], _WF_SCHEDULES[3]):
        acc = torch.zeros((w * h, 3), device="cuda")
        wf.launch_wavefront(acc, inp, 0, True, phase_cuts=cuts, **fkw)
        _check(torch.equal(acc, ref[0]), ("wavefront cut schedules differ", cuts,
                                          _compare(ref[0], acc, w, h)))
    one = dict(fkw, spp=1)
    a, m = torch.zeros((w * h, 3), device="cuda"), torch.zeros((w * h, 3), device="cuda")
    wf.launch_wavefront(a, inp, 0, True, phase_cuts=_WF_SCHEDULES[1], **one)
    mk.launch_megakernel(m, inp, 0, True, **one)
    one_spp_differing = int((a != m).any(dim=1).sum())
    _check(one_spp_differing == 0, ("wavefront against the megakernel at 1 spp",
                                    one_spp_differing))
    del ref, acc, a, m
    full = _wf_compact_k1_full(mk, wf, inp, wf.plan(w, h, mp["spp"]), 0, fkw)
    record["wavefront"] = {
        "launches": counts, "equal_to_regroup": "2 frames, phase_cuts (2,) and (2, 4, 6)",
        "schedules_equal": [list(c) for c in _WF_SCHEDULES], "one_spp_pixels_differing": 0,
        "rows": {str(k): v for k, v in wf_rows.items()},
        "regroup_rows": record["main"]["regroup"]["rows"], "peak_gb": wf_peak,
        "vs_plain_full_size": full}
    _say("wavefront", shape=f"rtiow {w}x{h} spp{mp['spp']} b{mp['bounces']}",
         vs_regroup="bit-exact (2 frames, phase_cuts (2,) and (2, 4, 6))",
         schedules=json.dumps([list(c) for c in _WF_SCHEDULES]), schedules_equal=True,
         one_spp_pixels_differing=one_spp_differing, launches=json.dumps(counts))
    _say("wavefront", case="live_rows", rows=json.dumps({str(k): v for k, v in wf_rows.items()}),
         regroup_dense_rows=json.dumps(record["main"]["regroup"]["rows"]),
         peak_gb=json.dumps({k: round(v, 3) for k, v in wf_peak.items()}),
         renderer_peak_gb=f"{record['main']['wavefront']['peak_gb']:.3f}", card=repr(smi))
    _say("wavefront", case="compact_k1_vs_plain_full_size", compact="bit-exact (two cuts)",
         **{k: json.dumps(v) for k, v in full.items()})
    torch.cuda.empty_cache()

    # 6d. the per-warp cull of K0 and K1 at full size: regroup and the
    # wavefront (four cut schedules) against the full-sweep wavefront, and
    # at 1 spp the stats megakernel, in every bit; each case's kernel times;
    # and the tests each lane needs and those of the warp votes, beside the
    # full sweep's (random60k's census in a child process)
    cull = _cull_paths(mk, rg, wf, ro, sw)
    for name, res in cull.items():
        _say("cull", shape=res["shape"], frames=res["frames"],
             vs_full_sweep="bit-exact (regroup; the wavefront at "
             f"{[list(c) for c in _WF_SCHEDULES]})",
             one_spp_vs_stats_megakernel_pixels_differing=json.dumps(
                 res["one_spp_vs_stats_megakernel"]),
             launches=json.dumps(res["launches"]),
             wavefront_launches=json.dumps(res["wavefront_launches"]),
             ms=json.dumps({k: {kk: round(vv, 3) for kk, vv in v.items()}
                            for k, v in res["ms"].items()}),
             spheres=res["spheres"], chunks=res["chunks"], supers=res["supers"],
             placement=json.dumps(res["placement"]), card=repr(smi))
    for name, res in cull.items():
        res.update(_census_in_child(name))
        _say("cull", case=f"{name}_census", full_sweep_tests_per_segment=res["spheres"],
             **{k: json.dumps(v) for k, v in res["census_line"].items()}, card=repr(smi))
    record["cull"] = {k: {kk: vv for kk, vv in v.items()
                          if kk not in ("census", "wf_census", "wf_census_nocut")}
                      for k, v in cull.items()}

    # 6d'. the megakernel against the full sweep in every bit,
    # the textured 1080p band against its twin, and the census of its
    # warps at 1080p in both groupings
    mkp = _megakernel_paths(mk, rg, wf, ro, sw)
    for name, *_ in _MK_CASES:
        res = mkp[name]
        _say("megakernel", shape=res["shape"], vs_full_sweep="bit-exact (stats megakernel)",
             launches=json.dumps(res["launches"]), ms=f"{res['ms']:.4f}",
             stats_ms=f"{res['stats_ms']:.4f}", spheres=res["spheres"], chunks=res["chunks"],
             placement=json.dumps(res["placement"]), card=repr(smi))
    _say("megakernel", case="textured_band_vs_plain",
         **{k: (f"{v:.3e}" if isinstance(v, float) else json.dumps(v))
            for k, v in mkp["textured_band"].items()})
    mk_census = mkp["census_1080p"]
    _say("megakernel", case="rtiow_census", shape=f"rtiow {w}x{h} spp{mp['spp']} "
         f"b{mp['bounces']}", full_sweep_tests_per_segment=mkp["rtiow"]["spheres"],
         **{g: json.dumps(_census_totals(mk_census[g])) for g in ("lockstep", "refill")},
         seconds=f"{mk_census['seconds']:.1f}", card=repr(smi))
    record["megakernel"] = {**{k: v for k, v in mkp.items() if k != "census_1080p"},
                            "census_1080p": {g: _census_totals(mk_census[g])
                                             for g in ("lockstep", "refill")}}

    # 6e. the xla backend on the card: no kernel of the port launches; its
    # image against regroup's; the textured ladder; a checkpoint resumed
    xla = _xla_paths(mk, rg, wf, ro, sw, os.path.join(
        args.out or tempfile.mkdtemp(prefix="chip_smoke_trace_"), "trace_xla_batch"))
    xr, eager = xla["rtiow"], xla["rtiow"]["eager"]
    _say("xla", shape=f"rtiow {_XLA['width']}x{_XLA['height']} spp{_XLA['spp']}x"
         f"{_XLA['frames']} b{_XLA['bounces']}", launches=json.dumps(xr["launches"]),
         warmup_s=f"{xr['warmup_s']:.3f}", warm_frame_s=f"{xr['warm_frame_s']:.4f}",
         rays_per_s=f"{xr['rays_per_s']:.4e}", peak_gb=f"{xr['peak_gb']:.3f}",
         vs_regroup=json.dumps({k: float(f"{v:.4g}") for k, v in xr["vs_regroup"].items()}),
         regroup_same_params=json.dumps({k: float(f"{v:.4g}") for k, v in xr["regroup"].items()}),
         image_mean=f"{xr['image_mean']:.1f}", card=repr(smi))
    _say("xla", case="eager_batch", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                                       for k, v in eager.items()})
    _say("xla", case="textured_ladder", size=f"{_XLA['width']}x{_XLA['height']}",
         spp=_XLA["spp"], largest_texture_texels=xla["textured_ladder"]["largest_texture_texels"],
         tonemapped_rmse_by_budget=json.dumps(
             {k: float(f"{v:.5g}") for k, v in xla["textured_ladder"]["tonemapped_rmse"].items()}),
         never_rises=True)
    _say("xla", case="checkpoint", **xla["checkpoint"], seconds=f"{xla['seconds']:.1f}")
    record["xla"] = xla

    # 6f. the mesh: its per-shard body at full size, then a real
    # one-process NCCL world through Renderer(mesh=global_mesh())
    mods = (mk, rg, wf, ro, sw)
    t0 = time.perf_counter()
    par = _parallel_path(mods)
    par_s = time.perf_counter() - t0
    _say("parallel", shape=f"rtiow {_PAR['width']}x{_PAR['height']} spp{_PAR['spp']} "
         f"b{_PAR['bounces']}",
         tiles_4x1="bit-exact over 2 frames (regroup, pallas; pallas also to the full sweep)",
         padded=f"{PAD_TILES} tiles bit-exact on the real rows, padding finite",
         **{f"{k}": json.dumps(v) for k, v in par.items()}, seconds=f"{par_s:.1f}",
         card=repr(smi))
    record["parallel"] = par

    # 6g. the front ends: the CLI, the CLI under torchrun, the viewer
    t0 = time.perf_counter()
    front = {"cli": _front_cli()}
    for name, vw, vh in _VIEWER_CASES:
        front[f"viewer_{name}"] = _viewer_run(mods, name, vw, vh)
    front_s = time.perf_counter() - t0
    _say("front", hdr="bit-exact (cli and torchrun against the in-process Renderer)",
         **{k: json.dumps(v) for k, v in front.items()}, seconds=f"{front_s:.1f}",
         card=repr(smi))
    record["front"] = front

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
    sp = _stats_path(mk, rg, wf, ro, sw)
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

    def wavefront_stages(plain):
        fn = wf.wavefront_plain_with_inputs if plain else wf.launch_wavefront
        return _per_kernel(_stage_ms(lambda mark: fn(acc, inp_t, 0, True, phase_cuts=_CUTS,
                                                     on_stage=mark, **kw)),
                           WAVEFRONT_KERNELS + ("fold",))

    mega()
    mega_plain()
    mega(True)
    mega_plain(True)
    regroup_stages(False)
    regroup_stages(True)
    k1_stats(False, 1)
    k1_stats(True, 1)
    wavefront_stages(False)
    wavefront_stages(True)
    times = {k: [] for k in ("megakernel", "megakernel_plain", "regroup", "regroup_plain",
                             "megakernel_stats", "megakernel_stats_plain", "k1_stats",
                             "k1_stats_plain", "wavefront", "wavefront_plain")}
    for label, reps in (("plain", 2), ("kernel", 10), ("kernel", 10), ("plain", 2)):
        if label == "kernel":
            times["megakernel"].append(_time_ms(mega, reps))
            times["regroup"].append(regroup_stages(False))
            times["megakernel_stats"].append(_time_ms(lambda: mega(True), reps))
            times["k1_stats"].append(k1_stats(False, reps))
            times["wavefront"].append(wavefront_stages(False))
        else:
            times["megakernel_plain"].append(_time_ms(mega_plain, reps))
            times["regroup_plain"].append(regroup_stages(True))
            times["megakernel_stats_plain"].append(_time_ms(lambda: mega_plain(True), reps))
            times["k1_stats_plain"].append(k1_stats(True, reps))
            times["wavefront_plain"].append(wavefront_stages(True))
    ms = {"megakernel": min(times["megakernel"]),
          **{k: min(r[k] for r in times["regroup"]) for k in REGROUP_KERNELS},
          "megakernel_stats": min(times["megakernel_stats"]),
          "k1_stats": min(times["k1_stats"]),
          **{f"wavefront_{k}": min(r[k] for r in times["wavefront"]) for k in WAVEFRONT_KERNELS}}
    plain_ms = {"megakernel": min(times["megakernel_plain"]),
                **{k: min(r[k] for r in times["regroup_plain"]) for k in REGROUP_KERNELS},
                "megakernel_stats": min(times["megakernel_stats_plain"]),
                "k1_stats": min(times["k1_stats_plain"]),
                **{f"wavefront_{k}": min(r[k] for r in times["wavefront_plain"])
                   for k in WAVEFRONT_KERNELS}}
    # bounds from this shape's live counts, and the library calls
    live_all, live_real = _live_per_bounce(rg, inp_t, t_t, 0, tm["bounces"])
    mk_table = mega(True)[1]
    k1_table = _k1_stats(rg, rg.launch_k1, inp_t, dense_t, counts_t, t_t, 0, _CUTS[0],
                         _CUTS[1])
    child_t = _census_in_child("timing")  # regroup's and the wavefront's censuses
    census_t = child_t["census"]
    mk_census_t = _megakernel_census(inp_t, tm["width"], tm["height"], tm["spp"],
                                     tm["bounces"])
    stats_kept = (_real_root_pairs(rg, inp_t, t_t, 0, 0, tm["bounces"], real_only=True),
                  _real_root_pairs(rg, inp_t, t_t, 0, _CUTS[0], _CUTS[1]))
    bounds = _bounds(mk, inp_t, t_t, live_all, live_real, mk_table, k1_table, census_t,
                     mk_census_t, stats_kept)
    library_ms = _library_ms(rg, inp_t, t_t, 0, tm["bounces"], live_all)
    del dense_t
    # the wavefront's: its rows per cut at this shape, and the profiler's
    # device times of its kernels beside the stage events (at about 1 ms a
    # stage's events also time host work)
    wf_t = wf.plan(tm["width"], tm["height"], tm["spp"])
    _, rows_t = wf.launch_wavefront(acc, inp_t, 0, True, phase_cuts=_CUTS, debug_counts=True,
                                    **kw)
    rows_t = [int(r) for r in rows_t]
    bounds.update(_wf_bounds(inp_t, wf_t, live_all, rows_t, child_t["wf_census"],
                             child_t["wf_census_nocut"]))
    library_ms["wavefront_compact"] = _wf_library_ms(wf, inp_t, wf_t, 0, tm["bounces"])
    trace_root = args.out or tempfile.mkdtemp(prefix="chip_smoke_trace_")
    wf_device_t = _wavefront_device_ms(_trace_frame(
        lambda mark: wf.launch_wavefront(acc, inp_t, 0, True, phase_cuts=_CUTS,
                                         on_stage=mark, **kw),
        os.path.join(trace_root, "trace_wavefront_timing"),
        _frame_kernels("wavefront"))["kernel_ms"])
    _say("bounds", shape=f"{tm['scene']} {tm['width']}x{tm['height']} spp{tm['spp']} "
         f"b{tm['bounces']}", live_per_bounce=json.dumps(live_all),
         live_real_per_bounce=json.dumps(live_real),
         bounds=json.dumps({k: [round(v["bound_ms"], 5), v["bound_by"]]
                            for k, v in bounds.items()}),
         culled_bound_full_ms=json.dumps({k: round(bounds[k]["bound_full_ms"], 5)
                                          for k in CULLED_KERNELS}),
         culled_vote_bound_ms=json.dumps({k: round(bounds[k]["vote_bound_ms"], 5)
                                          for k in CULLED_KERNELS}),
         megakernel_lockstep_vote_bound_ms=round(
             bounds["megakernel"]["lockstep_vote_bound_ms"], 5),
         k0_k1_tests_per_segment=json.dumps([round(_per_segment(census_t[:1]), 2),
                                             round(_per_segment(census_t[1:]), 2)]),
         megakernel_census=json.dumps({g: _census_totals(mk_census_t[g])
                                       for g in ("lockstep", "refill")}),
         wavefront_census=json.dumps(child_t["census_line"]["wavefront"]),
         library_ms=json.dumps({k: round(v, 4) for k, v in library_ms.items()}),
         wavefront_rows=json.dumps(rows_t), card=repr(smi))
    # the 1080p frame, kernels only: regroup, megakernel, megakernel, regroup
    inp = mk.kernel_inputs(*_case("rtiow", mp["width"], mp["height"], "cuda"))
    big = torch.zeros((mp["width"] * mp["height"], 3), device="cuda")
    fkw = dict(width=mp["width"], height=mp["height"], spp=mp["spp"],
               num_bounces=mp["bounces"])
    frame_fns = {
        "regroup": lambda: rg.launch_regrouped(big, inp, 0, True, cuts=_CUTS, **fkw),
        "megakernel": lambda: mk.launch_megakernel(big, inp, 0, True, **fkw),
        "wavefront": lambda: wf.launch_wavefront(big, inp, 0, True, **fkw),
        "wavefront_cuts": lambda: wf.launch_wavefront(big, inp, 0, True, phase_cuts=_CUTS,
                                                      **fkw)}
    for label in ("regroup", "wavefront", "wavefront_cuts"):
        frame_fns[label]()
    frame_ms = {k: [] for k in frame_fns}
    for label in ("regroup", "megakernel", "wavefront", "wavefront_cuts", "wavefront_cuts",
                  "wavefront", "megakernel", "regroup"):
        frame_ms[label].append(_time_ms(frame_fns[label], 3))
    _say("timing", shape=f"{tm['scene']} {tm['width']}x{tm['height']} "
         f"spp{tm['spp']} b{tm['bounces']}",
         kernel_ms=json.dumps({k: round(v, 4) for k, v in ms.items()}),
         plain_ms=json.dumps({k: round(v, 3) for k, v in plain_ms.items()}),
         wavefront_device_ms=json.dumps({k: round(v, 4) for k, v in wf_device_t.items()}),
         frame_1080p_ms=json.dumps(frame_ms), card=repr(smi))
    record["timing"] = {"shape": tm, "kernel_ms": ms, "plain_ms": plain_ms,
                        "runs": times, "frame_1080p_ms": frame_ms, "bounds": bounds,
                        "library_ms": library_ms, "live_per_bounce": live_all,
                        "live_real_per_bounce": live_real, "wavefront_rows": rows_t,
                        "wavefront_device_ms": wf_device_t}

    # 9. one regroup and one wavefront 1080p frame under the port's
    # profiler_trace, and the bounds of the 1080p frames' kernels beside
    # their times
    tr = _trace_frame(lambda mark: rg.launch_regrouped(big, inp, 0, True, cuts=_CUTS,
                                                       on_stage=mark, **fkw),
                      os.path.join(trace_root, "trace"), _frame_kernels("regroup"))
    _say("trace", frame="regroup", **_trace_fields(tr),
         kernel_ms=json.dumps({k: round(v, 3) for k, v in tr["kernel_ms"].items()}),
         kernel_total_ms=f"{tr['kernel_total_ms']:.3f}",
         stages_ms=json.dumps({k: round(v, 3) for k, v in tr["stages_ms"].items()}),
         stage_total_ms=f"{tr['stage_total_ms']:.3f}", card=repr(smi))
    record["trace"] = tr
    tr_wf = _trace_frame(lambda mark: wf.launch_wavefront(big, inp, 0, True, phase_cuts=_CUTS,
                                                          on_stage=mark, **fkw),
                         os.path.join(trace_root, "trace_wavefront"),
                         _frame_kernels("wavefront"))
    wf_device = _wavefront_device_ms(tr_wf["kernel_ms"])
    _say("trace", frame="wavefront", phase_cuts=_CUTS, **_trace_fields(tr_wf),
         kernel_ms=json.dumps({k: round(v, 3) for k, v in wf_device.items()}),
         kernel_total_ms=f"{tr_wf['kernel_total_ms']:.3f}",
         stages_ms=json.dumps({k: round(v, 3) for k, v in tr_wf["stages_ms"].items()}),
         stage_total_ms=f"{tr_wf['stage_total_ms']:.3f}", card=repr(smi))
    record["trace_wavefront"] = {**tr_wf, "per_kernel_ms": wf_device}
    t_big = rg.plan(mp["width"], mp["height"], mp["spp"], mp["bounces"], _CUTS)[0]
    live_big = _live_per_bounce(rg, inp, t_big, 0, mp["bounces"])
    bounds_big = _bounds(mk, inp, t_big, *live_big, census=cull["rtiow"]["census"],
                         mk_census=mk_census)
    bounds_big.update(_wf_bounds(inp, t_big, live_big[0], wf_rows[_CUTS],
                                 cull["rtiow"]["wf_census"], cull["rtiow"]["wf_census_nocut"]))
    library_big = _library_ms(rg, inp, t_big, 0, mp["bounces"], live_big[0], reps=3)
    stage_big = {**_per_kernel(tr["stages_ms"]), "megakernel": min(frame_ms["megakernel"]),
                 **{f"wavefront_{k}": v for k, v in _per_kernel(
                     tr_wf["stages_ms"], WAVEFRONT_KERNELS + ("fold",)).items() if k != "fold"},
                 "wavefront_k0_nocut": record["main"]["wavefront"]["stages_ms"]["k0"]}
    _say("bounds", shape=f"rtiow {mp['width']}x{mp['height']} spp{mp['spp']} "
         f"b{mp['bounces']}", live_per_bounce=json.dumps(live_big[0]),
         live_real_per_bounce=json.dumps(live_big[1]),
         ms_bound_share=json.dumps({k: [round(stage_big[k], 3),
                                        round(bounds_big[k]["bound_ms"], 3),
                                        bounds_big[k]["bound_by"],
                                        round(bounds_big[k]["bound_ms"] / stage_big[k], 4)]
                                    for k in stage_big}),
         culled_bound_full_ms_share=json.dumps({
             k: [round(bounds_big[k]["bound_full_ms"], 3),
                 round(bounds_big[k]["bound_full_ms"] / stage_big[k], 4)]
             for k in CULLED_KERNELS}),
         culled_vote_bound_ms_share=json.dumps({
             k: [round(bounds_big[k]["vote_bound_ms"], 3),
                 round(bounds_big[k]["vote_bound_ms"] / stage_big[k], 4)]
             for k in CULLED_KERNELS}),
         megakernel_lockstep_vote_bound_ms_share=json.dumps([
             round(bounds_big["megakernel"]["lockstep_vote_bound_ms"], 3),
             round(bounds_big["megakernel"]["lockstep_vote_bound_ms"]
                   / stage_big["megakernel"], 4)]),
         library_ms=json.dumps({k: round(v, 4) for k, v in library_big.items()}),
         wavefront_rows=json.dumps(wf_rows[_CUTS]), card=repr(smi))
    record["bounds_1080p"] = {"live": live_big, "bounds": bounds_big, "ms": stage_big,
                              "library_ms": library_big, "wavefront_device_ms": wf_device}
    torch.cuda.empty_cache()

    # 10. the record-DMA probes (probes/dma.py) on the reorder kernels, with
    # their launches counted from 0
    rp = _reorder_probes(ro, dma)
    for name, res in rp["probes"].items():
        _say("reorder", probe=name, **{k: json.dumps(v) for k, v in res.items()})
    rate = rp["probes"]["dma_rate"]
    _say("reorder", case="dma_rate", ms=f"{rate['ms']:.4f}", bound_ms=f"{rate['bound_ms']:.4f}",
         share=f"{rate['bound_ms'] / rate['ms']:.4f}",
         records_per_s=f"{rate['records_per_s']:.4e}",
         read_gb_per_s=f"{rate['read_gb_per_s']:.1f}", library_ms=f"{rate['library_ms']:.4f}",
         plain_ms=f"{rp['dma_rate_plain_ms']:.4f}", launches=json.dumps(rp["launches"]),
         card=repr(smi))
    _say("reorder", case="probe_shapes", at_shape=json.dumps(rp["at_shape"]), card=repr(smi))
    _say("reorder", case="widths_and_yardsticks", widths=json.dumps(rp["widths"]),
         index_select_bw=json.dumps(rp["index_select_bw"]),
         sort_ms=json.dumps(rp["sort_cost"]["ms"]), card=repr(smi))
    # rows 9a-9d, 10f, index_select_bw's shapes and row 10g by device time,
    # in a child process whose profiler traces keep their events
    tiny = _tiny_in_child()
    rp["tiny_shapes"] = tiny
    _say("reorder", case="tiny_shapes_ms", ev_dev_host_library_ev_dev_host=json.dumps(
        {k: _tiny_line(v) for k, v in tiny["cases"].items() if k != "lane_scan"}),
         device_ms_by_cuda_events=json.dumps(
             [f"{k}{p}" for k, v in tiny["cases"].items() for p in ("", ".library")
              if v[f"{'library_' if p else ''}device_ms_by"] == "cuda_events"]),
         child_s=tiny["child_s"], card=repr(smi))
    _say("reorder", case="lane_scan_probe_shape", row="10g",
         ev_dev_host_cumsum_ev_dev_host=json.dumps(_tiny_line(tiny["cases"]["lane_scan"])),
         card=repr(smi))
    record["reorder"] = rp
    torch.cuda.empty_cache()

    # 11. probe_binned.py's path on the port (probes/binned.py): K0 -> PACK
    # to cut 3, then per bin scheme the sort, the permutation, K1 timed, the
    # scatter back held to home-order K1 in every bit, and K1-stats; RTiOW
    # 1080p x 4 spp with every scheme, random10k 4K with the quick set
    bn = {}
    for scene, quick in (("rtiow", False), ("random10k", True)):
        res = _binned_run(mk, rg, wf, ro, sw, binned, scene, quick)
        _say("binned", scene=scene, case="pool", pool=json.dumps(res["pool"]),
             live_records=res["live_records"], launches=json.dumps(res["launches"]))
        for row in res["rows"]:
            _say("binned", scene=scene, scheme=row["scheme"], row=json.dumps(row))
        if res["vs_plain"]:
            _say("binned", scene=scene, case="k1_stats_vs_plain",
                 **{k: json.dumps(v) for k, v in res["vs_plain"].items()})
        bn[scene] = res
        torch.cuda.empty_cache()
    shape = _binned_kernels(mk, rg, ro, binned)
    _say("binned", case="kernels", shape=f"rtiow {binned.SHAPES['rtiow']} spp{binned.SPP} "
         f"cut {BINNED_CUT} b{binned.BOUNCES}",
         **{k: json.dumps(v) for k, v in shape.items()}, card=repr(smi))
    record["binned"] = {**bn, "kernels": shape}
    for key in ("record_gather", "record_scatter"):
        ms[key], plain_ms[key] = shape["ms"][key], shape["plain_ms"][key]
        bounds[key], library_ms[key] = shape["bounds"][key], shape["library_ms"][key]
    ms["dma_rate"], plain_ms["dma_rate"] = rate["ms"], rp["dma_rate_plain_ms"]
    bounds["dma_rate"] = {"bound_ms": rate["bound_ms"], "bound_by": "bytes"}
    library_ms["dma_rate"] = rate["library_ms"]

    # 12. probe_mxu_sweep.py's probes on the sweep kernels (probes/mxu_sweep.py),
    # each with its launches counted from 0: the FMA sweep against the TF32
    # and 3xTF32 tensor-core sweep, the dot's precision, the layouts
    sp7 = _sweep_probes(mk, rg, wf, ro, sw, mxu_sweep)
    for name, _ in mxu_sweep.PROBES:
        _say("sweep", probe=name, message=repr(sp7[name]["message"]))
    fill = sp7["fill"]
    forms = {k: v for k, v in fill.items() if isinstance(v, dict) and "ms" in v}
    _say("sweep", case="fill", rays=fill["rays"], spheres=fill["spheres"],
         ms_bound_share=json.dumps({k: [round(v["ms"], 4), round(v["bound_ms"], 4), v["bound_by"],
                                        round(v["share"], 4)] for k, v in forms.items()}),
         agree=json.dumps({k: {g: round(v[g], 7) for g in ("mask_agree", "idx_agree", "t_agree",
                                                            "parted")}
                           for k, v in forms.items()}),
         wrong_share_gate=fill["wrong_share"], control=f"{fill['control']:.3g}",
         launches=json.dumps(sp7["launches"]), card=repr(smi))
    # sweep_mma's survivors at the fill: the pairs whose pre-test kept them
    # for a root, and the root rounds a warp took per (tile, 8-ray tile)
    _say("sweep", case="fill_census", census=json.dumps(
        {p: {**{k: c[k] for k in ("pairs", "kept", "rounds", "steps")},
             **{k: _sig(c[k]) for k in ("kept_share", "rounds_per_step")}}
         for p, c in fill["census"].items()}),
         card=repr(smi))
    record["sweep"] = sp7
    dot = {"p3": sp7["p3"], "p3_fill": sp7["p3"]["fill"]}
    for shape, res in dot.items():
        _say("sweep", case=f"dot_mma_{shape}", shape=json.dumps(res.get("shape", [64, 8, 4096])),
             ms_device_host_bound_share=json.dumps(
                 {p: [_sig(res[p].get(k)) for k in ("ms", "device_ms", "host_ms", "bound_ms",
                                                     "share")] for p in sw.PRECISIONS}),
             library_ms_device_host=json.dumps(
                 {p: [_sig(res[f"library{k}"].get(p)) for k in ("_ms", "_device_ms", "_host_ms")]
                  for p in ("fp32", "tf32")}),
             device_ms_by_cuda_events=json.dumps(
                 _by_events({k: v for k, v in res.items() if k != "fill"})), card=repr(smi))
    for key, case in (("sweep_fma", fill["fma"]), ("sweep_mma_tf32", fill["mma_tf32"]),
                      ("sweep_mma_3xtf32", fill["mma_3xtf32"]),
                      ("dot_mma", dot["p3_fill"]["fp32"]), ("layout", sp7["p1"]["big"])):
        ms[key], plain_ms[key] = case["ms"], case["plain_ms"]
        bounds[key] = {"bound_ms": case["bound_ms"], "bound_by": case["bound_by"]}
    library_ms["dot_mma"] = dot["p3_fill"]["library_ms"]["fp32"]
    library_ms["layout"] = sp7["p1"]["big"]["library_ms"]
    _say("sweep", case="kernels", ms_bound_share=json.dumps(
        {k: [round(ms[k], 4), round(bounds[k]["bound_ms"], 4), bounds[k]["bound_by"],
             round(bounds[k]["bound_ms"] / ms[k], 4)] for k in SWEEP_KERNELS}),
         plain_ms=json.dumps({k: round(plain_ms[k], 3) for k in SWEEP_KERNELS}),
         library_ms=json.dumps({k: library_ms.get(k) for k in SWEEP_KERNELS}),
         dot_tf32_library_ms=f"{dot['p3_fill']['library_ms']['tf32']:.4f}", card=repr(smi))
    torch.cuda.empty_cache()

    # 13. the indexed-access probes (probes/place.py, mosaic.py,
    # gather_cost.py) on csrc/access.cu's kernels, each with its launches
    # counted from 0
    t0 = time.perf_counter()
    access = _access_probes(mk, rg, wf, ro, sw, (place, mosaic, gather_cost))
    for mod in (place, mosaic, gather_cost):
        for name, _ in mod.PROBES:
            _say("access", probe=name, row=mod.ROWS[name],
                 launches=json.dumps({k: v for k, v in access[name]["launches"].items() if v}),
                 ms_device_host_bound_share_library_device_host=json.dumps(
                     _access_summary(access[name])),
                 device_ms_by_cuda_events=json.dumps(_by_events(access[name])),
                 warm_l2=json.dumps(_warm_l2(access[name])))
    _say("access", case="smem_rw_host_parts_ms", parts=json.dumps(
        {k: _sig(v) for k, v in access["p2"]["host_parts"].items()}), card=repr(smi))
    # profiler traces that recorded no device event, timed by CUDA events
    by_events = sum(len(_by_events(access[name])) for mod in (place, mosaic, gather_cost)
                    for name, _ in mod.PROBES)
    rate = access["gather_cost"]["smem_rate"]
    access_s = time.perf_counter() - t0
    picks = {"table_gather": access["fill"]["span16"]["global"],
             "lane_gather": access["take_along_lane_32"]["fill"]["shfl"],
             "smem_rw": access["p2"]["fill"]["rotate"]["smem"],
             "row_sort": access["p3"]["fill"]["shfl"],
             "lane_scan": access["cumsum_lanes"]["fill"]["shfl"]}
    for key, case in picks.items():
        ms[key], plain_ms[key], library_ms[key] = case["ms"], case["plain_ms"], case["library_ms"]
        bounds[key] = {"bound_ms": case["bound_ms"], "bound_by": case["bound_by"]}
    _say("access", case="kernels", ms_bound_share=json.dumps(
        {k: [round(ms[k], 5), round(bounds[k]["bound_ms"], 5), bounds[k]["bound_by"],
             round(bounds[k]["bound_ms"] / ms[k], 4)] for k in ACCESS_KERNELS}),
         plain_ms=json.dumps({k: round(plain_ms[k], 3) for k in ACCESS_KERNELS}),
         library_ms=json.dumps({k: library_ms.get(k) for k in ACCESS_KERNELS}),
         launches=json.dumps(access["launches"]), sms=rate["sms"], max_sm_mhz=rate["max_sm_mhz"],
         smem_bytes_per_s=f"{rate['bytes_per_s']:.4e}", seconds=f"{access_s:.1f}",
         traces_by_cuda_events=by_events, card=repr(smi))
    record["access"] = {**access, "seconds": access_s,
                        "traces_by_cuda_events": by_events}
    torch.cuda.empty_cache()

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
    # K0, K1 and the megakernel cull per warp: their bound counts the work
    # each lane's own cull decisions need (rg.cull_census,
    # cull.megakernel_census), vote_bound_ms what the warp vote makes the
    # lanes do, bound_full_ms the full sweep's
    for e in kernels:
        if e["name"] in ("regroup_k0", "regroup_k1", "megakernel"):
            b = bounds[e["name"].replace("regroup_", "")]
            e.update(vote_bound_ms=b["vote_bound_ms"], bound_full_ms=b["bound_full_ms"])
    kernels += [
        entry("megakernel_stats", "megakernel_stats", mk.KERNEL_SOURCE, mk.STATS_REPLACES,
              sp["launches"]["megakernel_stats"], sv["megakernel_err"]),
        entry("regroup_k1_stats", "k1_stats", rg.KERNEL_SOURCE, rg.REPLACES["k1_stats"],
              sp["launches"]["k1_stats"], sv["k1_err"])]
    # K0's launches are the Renderer's (one per frame, no cuts); COMPACT's
    # and K1's those of render_image_wavefront with cuts
    kernels += [entry(f"wavefront_{k}", f"wavefront_{k}", wf.KERNEL_SOURCE, wf.REPLACES[k],
                      launches["wavefront" if k == "k0" else "wavefront_cuts"][f"wavefront_{k}"],
                      wf_err[k]) for k in WAVEFRONT_KERNELS]
    # the wavefront's K0 and K1 cull per warp too (cull.wavefront_census);
    # their ms and bounds are the [timing] shape's at _CUTS
    for e in kernels:
        if e["name"] in ("wavefront_k0", "wavefront_k1"):
            b = bounds[e["name"]]
            e.update(vote_bound_ms=b["vote_bound_ms"], bound_full_ms=b["bound_full_ms"])
    # the gather's and the scatter's launches are the binned path's (RTiOW,
    # every scheme), dma_rate's the probe's; all three equal their twins
    # in every bit
    kernels += [entry(k, k, ro.KERNEL_SOURCE, ro.REPLACES[k],
                      (rp if k == "dma_rate" else bn["rtiow"])["launches"][k], 0.0)
                for k in REORDER_KERNELS]
    # the sweeps' numbers are the card-filling shape's (fill), dot_mma's its
    # FP32 mode at p3's card-filling B[8, 2^20], layout's the remap of 2^24
    # values (p1)
    sweep_err = {"sweep_fma": fill["fma"]["max_abs_err"],
                 "sweep_mma_tf32": fill["mma_tf32"]["max_abs_err"],
                 "sweep_mma_3xtf32": fill["mma_3xtf32"]["max_abs_err"],
                 "dot_mma": sp7["p3"]["fp32"]["max_abs_err"], "layout": 0.0}
    kernels += [entry(k, k, sw.KERNEL_SOURCE, sw.REPLACES[k], sp7["launches"][k], sweep_err[k])
                for k in SWEEP_KERNELS]
    # the access kernels' numbers are a card-filling case of each (table_gather
    # at 4,096 tiles, span 16, "global"; lane_gather 10c's lanes, smem_rw
    # p2's rotated reads, "smem"); all equal their twins in every bit
    kernels += [entry(k, k, ac.KERNEL_SOURCE, ac.REPLACES[k], access["launches"][k], 0.0)
                for k in ACCESS_KERNELS]
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
