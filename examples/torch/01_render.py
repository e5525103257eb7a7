"""Headless render of a built-in scene to a PNG, with stats (the port's
counterpart of examples/01_render.py).

    python examples/torch/01_render.py --scene rtiow --size 1920x1080 --spp 64
    python examples/torch/01_render.py --device cpu --scene three --size 64x36
"""

from _common import parse_args


def main():
    args = parse_args(
        "render a built-in scene headless",
        **{
            "--scene": dict(default="demo", help="one of SCENES (see --scene list)"),
            "--size": dict(default="400x300"),
            "--spp": dict(type=int, default=16),
            "--out": dict(default="example_render.png"),
        },
    )
    from weekend_raytracer_tpu_torch import (RenderParams, Renderer, SamplingParams,
                                             SCENES)
    from weekend_raytracer_tpu_torch.utils.image import save_png

    if args.scene == "list":
        print(" ".join(SCENES))
        return
    build, camera = SCENES[args.scene]
    w, h = (int(v) for v in args.size.split("x"))
    params = RenderParams(
        camera=camera(),
        viewport_size=(w, h),
        sampling=SamplingParams(max_samples_per_pixel=args.spp,
                                num_samples_per_pixel=2),
    )
    r = Renderer(build(), params, device=args.device)  # "auto" -> regroup or the megakernel
    stats = r.render()             # progressive frames to convergence
    save_png(args.out, r.image())  # tonemapped sRGB uint8 [H, W, 3]
    print(f"{args.scene} {w}x{h} spp={r.accumulated_samples()} "
          f"backend={r.backend} sky={r.sky_model()} device={r.device}")
    print(f"{stats.rays_per_sec/1e6:.1f} Mrays/s warm, "
          f"{stats.seconds:.2f} s total -> {args.out}")


if __name__ == "__main__":
    main()
