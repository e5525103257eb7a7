#!/usr/bin/env python3
"""Renderer(mesh=...) across the cards of one host, one process a card.

    torchrun --standalone --nproc-per-node 4 tools/mesh_cards.py
    torchrun --standalone --nproc-per-node 4 tools/mesh_cards.py \
        --device cpu --size 64x36 --spp 4 --frames 2   # gloo, on the host

For each layout (default 4x1, 2x2, 1x4 over four ranks): RTiOW through
``Renderer(backend="auto", mesh=...)``, each rank on its own card (NCCL) or
CPU process (gloo), at 1920x1080, 32 spp a frame, 3 frames, 8 bounces by
default. Every rank's warm frames are timed on the host clock after a
barrier and the slowest rank's time kept. Rank 0 then renders the same
frames on its own device: through the unsharded Renderer, which a
tiles-only layout must equal in every bit, and through ``render_shard`` for
every cell of the layout in turn (the emulated mesh), which the mesh must
equal in every bit with two spp shards (a sum of two is the same in either
order) and at the image gates with more (the all_reduce's order is the
library's: tonemapped RMSE < 5e-3, mean within 1e-3). Rank 0 prints the
card's name and power limit, then one JSON line per layout.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from datetime import timedelta

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

RMSE_GATE = 5e-3
MEAN_REL_GATE = 1e-3


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def _gates(a: torch.Tensor, b: torch.Tensor, w: int, h: int) -> dict:
    from weekend_raytracer_tpu_torch.ops import tonemap

    ta, tb = (tonemap.to_srgb_u8(x.reshape(h, w, 3)).float() / 255 for x in (a, b))
    ma, mb = float(a.mean()), float(b.mean())
    return {"rmse": float(((ta - tb) ** 2).mean().sqrt()),
            "mean_rel": abs(ma - mb) / max(mb, 1e-6),
            "max_abs_err": float((a - b).abs().max()),
            "pixels_differing": int((a != b).any(dim=-1).sum())}


def _emulated(renderer, n_tiles: int, n_spp: int, frames: int, spp: int, bounces: int):
    """The layout's frames, every cell's render_shard in turn on this
    rank's device, as the mesh accumulates them; [H * W, 3] mean radiance."""
    from weekend_raytracer_tpu_torch.parallel.sharding import render_shard

    w, h = renderer.params.viewport_size
    hp = -(-h // n_tiles) * n_tiles
    acc = torch.zeros((w * hp, 3), device=renderer.device)
    for frame in range(frames):
        bands = []
        for t in range(n_tiles):
            tot = None
            for s in range(n_spp):
                c = render_shard(frame, renderer._scene, renderer._sky, renderer._basis,
                                 tile_idx=t, spp_idx=s, n_tiles=n_tiles, n_spp=n_spp,
                                 width=w, height=hp, spp=spp, num_bounces=bounces,
                                 backend=renderer.backend, aim_height=h)
                tot = c if tot is None else tot + c
            bands.append(tot)
        acc += torch.cat(bands)
    return (acc[:w * h] / (frames * spp)).reshape(h, w, 3)


def _timed_render(r) -> tuple:
    """(first frame s, warm s a frame) of ``r.render()``, the slowest rank's."""
    dist.barrier()
    stats = r.render()
    t = torch.tensor([stats.warmup_seconds, (stats.seconds - stats.warmup_seconds)
                      / max(stats.frames - 1, 1)], dtype=torch.float64, device=r._accum.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t[0]), float(t[1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layouts", default="4x1,2x2,1x4")
    ap.add_argument("--size", default="1920x1080")
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--bounces", type=int, default=8)
    args = ap.parse_args(argv)

    from weekend_raytracer_tpu_torch import SCENES, RenderParams, Renderer, SamplingParams
    from weekend_raytracer_tpu_torch.parallel import multihost
    from weekend_raytracer_tpu_torch.parallel.sharding import make_mesh

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("mesh_cards: no CUDA device", file=sys.stderr)
        return 2
    multihost.initialize(backend="nccl" if cuda else "gloo", timeout=timedelta(seconds=300))
    if not dist.is_initialized():
        print("mesh_cards: run under torchrun (no torch.distributed world)", file=sys.stderr)
        return 2
    try:
        rank, world = dist.get_rank(), dist.get_world_size()
        w, h = (int(v) for v in args.size.split("x"))
        params = RenderParams(camera=SCENES["rtiow"][1](), viewport_size=(w, h),
                              sampling=SamplingParams(
                                  max_samples_per_pixel=args.frames * args.spp,
                                  num_samples_per_pixel=args.spp, num_bounces=args.bounces))
        if rank == 0:
            print(_card() if cuda else f"cpu, {world} gloo processes", flush=True)
        for layout in args.layouts.split(","):
            n_tiles, n_spp = (int(v) for v in layout.split("x"))
            mesh = make_mesh(tile_shards=n_tiles, spp_shards=n_spp)
            r = Renderer(SCENES["rtiow"][0](), params, device=args.device, mesh=mesh)
            first_s, warm_s = _timed_render(r)
            mean = r.mean_radiance()
            dist.barrier()
            if rank == 0:
                one = Renderer(SCENES["rtiow"][0](), params, device=args.device)
                stats = one.render()
                one_warm = (stats.seconds - stats.warmup_seconds) / max(stats.frames - 1, 1)
                emu = _emulated(one, n_tiles, n_spp, args.frames, args.spp, args.bounces)
                vs_emu = _gates(mean, emu, w, h)
                vs_one = _gates(mean, one.mean_radiance(), w, h)
                if n_spp == 1:
                    ok = vs_one["pixels_differing"] == 0 and vs_emu["pixels_differing"] == 0
                elif n_spp == 2:
                    ok = vs_emu["pixels_differing"] == 0
                else:
                    ok = vs_emu["rmse"] < RMSE_GATE and vs_emu["mean_rel"] < MEAN_REL_GATE
                print(json.dumps({
                    "layout": mesh.shape, "backend": r.backend, "device": str(r.device),
                    "size": [w, h], "spp": args.spp, "frames": args.frames,
                    "bounces": args.bounces, "first_frame_s": first_s, "warm_frame_s": warm_s,
                    "one_device_warm_frame_s": one_warm, "speedup": one_warm / warm_s,
                    "vs_emulated": vs_emu, "vs_one_device": vs_one, "ok": ok}), flush=True)
                del one
            else:
                ok = True
            flag = torch.tensor([int(ok)], device=r._accum.device)
            dist.broadcast(flag, 0)
            if not int(flag):
                raise RuntimeError(f"layout {layout}: the mesh's image is off")
            del r, mean
            if cuda:
                torch.cuda.empty_cache()
        return 0
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
