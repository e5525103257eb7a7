"""Headless renderer CLI of the PyTorch/CUDA port.

Counterpart of weekend_raytracer_tpu/cli.py, with the same flags and the
same JSON keys, plus ``--device`` (default ``cuda``; the tests pass
``cpu``):

    python -m weekend_raytracer_tpu_torch --scene rtiow --size 1920x1080 \
        --spp 128 --spp-per-frame 32 --bounces 8 -o out.png

On more than one card, one process a card under torchrun, each rendering a
band of rows (``--tile-shards``) and/or a share of each frame's samples
(``--spp-shards``):

    torchrun --standalone --nproc-per-node 4 -m weekend_raytracer_tpu_torch \
        --scene rtiow --size 1920x1080 --spp 128 --spp-per-frame 32 \
        --tile-shards 2 --spp-shards 2 -o out.png

Rank 0 alone writes the PNG, ``--hdr`` and ``--checkpoint``, and prints.

Scenes: demo | single | three | rtiow | textured | random10k.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

def parse_size(s: str):
    w, h = s.lower().split("x")
    return int(w), int(h)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scene", default="demo", help="scene name or 'list'")
    p.add_argument("--size", type=parse_size, default=(800, 600),
                   help="WIDTHxHEIGHT (default 800x600, the reference window)")
    p.add_argument("--spp", type=int, default=128, help="total samples/pixel")
    p.add_argument("--spp-per-frame", type=int, default=None,
                   help="samples per progressive frame (default: the largest "
                        "of 4, 2, 1 that divides --spp)")
    p.add_argument("--bounces", type=int, default=8)
    p.add_argument("--backend", default="auto",
                   choices=["auto", "xla", "pallas", "regroup"])
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda; under a mesh "
                        "each rank's own card); 'cpu' runs the kernels' plain "
                        "twins")
    p.add_argument("--assets", default=None, help="dir with earthmap/moon images")
    p.add_argument("-o", "--output", default="render.png")
    p.add_argument("--hdr", default=None, metavar="PATH.npz",
                   help="also dump linear mean radiance (pre-tonemap) as .npz")
    p.add_argument("--checkpoint", default=None, metavar="PATH.npz",
                   help="resume from / save to a progressive render checkpoint")
    p.add_argument("--tile-shards", type=int, default=None, metavar="N",
                   help="shard image rows over N ranks (default: no mesh; "
                        "0 = all ranks after --spp-shards); run under torchrun")
    p.add_argument("--spp-shards", type=int, default=1, metavar="N",
                   help="shard each frame's samples over N ranks, merged "
                        "with one all_reduce (run under torchrun)")
    p.add_argument("--texture-budget", type=int, default=None, metavar="N",
                   help="texels per image texture in the fused kernels' "
                        "LUT (default 8192; textures are mipped to fit — "
                        "larger is sharper but slower; the xla backend "
                        "always samples full resolution)")
    p.add_argument("--hw-dataset", default=None, metavar="PATH",
                   help="path to the published Hosek-Wilkie 2012 RGB "
                        "dataset (ArHosekSkyModelData_RGB.h or .npz): "
                        "cook sky coefficients exactly like the "
                        "reference's hw_skymodel crate instead of the "
                        "built-in Preetham fit (also: WRT_HW_DATASET)")
    p.add_argument("--validate-hw-dataset", action="store_true",
                   help="load --hw-dataset (or WRT_HW_DATASET), render "
                        "the scene with the exact Hosek-Wilkie sky AND "
                        "the built-in Preetham fit, and print one JSON "
                        "line with the image RMSE between them")
    p.add_argument("--mxu-sweep", action="store_true",
                   help="run the closest-hit chunk sweeps on the MXU "
                        "(per-chunk matmuls) instead of the VPU FMA "
                        "chain — statistically equivalent, not "
                        "bit-identical (also: WRT_MXU_SWEEP=1). On the "
                        "card: 3xTF32 tensor-core products, 4-7.5x slower "
                        "than the FMA sweep at RTiOW 1920x1080 x 32 spp on "
                        "an H100 80GB HBM3 at 700 W (PERF.md)")
    p.add_argument("--stats-json", action="store_true",
                   help="print render stats as one JSON line")
    args = p.parse_args(argv)

    from .models import scenes as scene_lib

    if args.scene == "list":
        print("\n".join(scene_lib.SCENES))
        return 0
    if args.scene not in scene_lib.SCENES:
        print(f"unknown scene {args.scene!r}; use --scene list", file=sys.stderr)
        return 2

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"--device {args.device}: no CUDA device (torch.cuda.is_available() "
              "is False); pass --device cpu to run the plain twins on the host",
              file=sys.stderr)
        return 2

    from . import RenderParams, SamplingParams

    build, cam_fn = scene_lib.SCENES[args.scene]
    try:
        desc = build(assets_dir=args.assets)
    except TypeError:
        desc = build()

    # default spp/frame: the largest of {4, 2, 1} that divides total spp
    # (max_samples_per_pixel must be a multiple of samples-per-frame)
    spp_frame = args.spp_per_frame or next(
        d for d in (4, 2, 1) if args.spp % d == 0
    )
    params = RenderParams(
        camera=cam_fn(),
        viewport_size=args.size,
        sampling=SamplingParams(
            max_samples_per_pixel=args.spp,
            num_samples_per_pixel=spp_frame,
            num_bounces=args.bounces,
        ),
    )

    if args.validate_hw_dataset:
        return _validate_hw_dataset(args, desc, params, device)

    if args.tile_shards is None and args.spp_shards == 1:
        return _render(args, desc, params, device, None)
    import torch.distributed as dist

    from .parallel.multihost import initialize
    from .parallel.sharding import make_mesh

    initialize(backend="nccl" if device.type == "cuda" else "gloo")
    try:
        mesh = make_mesh(tile_shards=args.tile_shards or None,
                         spp_shards=args.spp_shards)
        return _render(args, desc, params, device, mesh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _render(args, desc, params, device, mesh) -> int:
    import numpy as np
    import torch.distributed as dist

    from . import Renderer
    from .utils.image import save_png

    renderer = Renderer(desc, params, backend=args.backend, device=device, mesh=mesh,
                        budget_texels=args.texture_budget, hw_dataset=args.hw_dataset,
                        mxu_sweep=True if args.mxu_sweep else None)
    lead = mesh is None or not mesh.distributed or dist.get_rank() == 0
    if args.checkpoint and os.path.exists(args.checkpoint):
        renderer.load_checkpoint(args.checkpoint)
    stats = renderer.render()
    # readback and checkpoints gather the bands: every rank takes part
    img = renderer.image()
    mean = renderer.mean_radiance().cpu().numpy() if args.hdr else None
    if args.checkpoint:
        renderer.save_checkpoint(args.checkpoint)
    if not lead:
        return 0
    save_png(args.output, img)
    if args.hdr:
        np.savez_compressed(args.hdr, mean_radiance=mean,
                            samples=renderer.accumulated_samples())

    line = {
        "scene": args.scene,
        "backend": renderer.backend,
        "size": list(args.size),
        "spp": stats.samples_per_pixel,
        "seconds": round(stats.seconds, 3),
        "warmup_seconds": round(stats.warmup_seconds, 3),
        "rays_per_sec": round(stats.rays_per_sec, 1),
        "devices": mesh.ranks.size if mesh is not None else 1,
        "sky": renderer.sky_model(),
        "output": args.output,
    }
    if args.stats_json:
        print(json.dumps(line))
    else:
        print(
            f"{args.scene} [{renderer.backend}] {args.size[0]}x{args.size[1]} "
            f"{stats.samples_per_pixel}spp in {stats.seconds:.2f}s "
            f"(warm {stats.rays_per_sec / 1e6:.1f}M rays/s; first frame "
            f"incl. kernel build {stats.warmup_seconds:.2f}s) -> {args.output}"
        )
    return 0


def _validate_hw_dataset(args, desc, params, device) -> int:
    import numpy as np

    from . import Renderer
    from .models.hw_dataset import load_dataset
    from .ops import tonemap

    path = args.hw_dataset or os.environ.get("WRT_HW_DATASET")
    if not path:
        print("--validate-hw-dataset needs --hw-dataset PATH (or "
              "WRT_HW_DATASET)", file=sys.stderr)
        return 2
    # parse + cook up front so format errors surface as themselves, not as
    # a renderer fallback to the builtin fit
    load_dataset(path)
    imgs = {}
    for tag, ds in (("hw2012", path), ("builtin", None)):
        r = Renderer(desc, params, backend=args.backend, device=device,
                     hw_dataset=ds, budget_texels=args.texture_budget)
        r.render()
        if tag == "hw2012" and r.sky_model() != "hosek-wilkie-2012-exact":
            print(f"dataset at {path} did not activate the exact sky "
                  f"(got {r.sky_model()!r})", file=sys.stderr)
            return 1
        mean = r.mean_radiance()
        imgs[tag] = (mean.cpu().numpy(),
                     tonemap.to_srgb_u8(mean).cpu().numpy().astype(np.float64))
    lin_h, tm_h = imgs["hw2012"]
    lin_b, tm_b = imgs["builtin"]
    print(json.dumps({
        "dataset": path,
        "scene": args.scene,
        "size": list(args.size),
        "spp": args.spp,
        "tonemapped_rmse_u8": round(float(np.sqrt(np.mean((tm_h - tm_b) ** 2))), 4),
        "linear_mean_hw": [round(float(v), 6) for v in lin_h.reshape(-1, 3).mean(0)],
        "linear_mean_builtin": [round(float(v), 6)
                                for v in lin_b.reshape(-1, 3).mean(0)],
        "sky_hw": "hosek-wilkie-2012-exact",
        "sky_builtin": "preetham-fit-builtin",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
