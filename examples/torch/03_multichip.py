"""Shard one progressive render over a (tiles x spp) grid of ranks, one
process a card, under torchrun (the port's counterpart of
examples/03_multichip.py).

Pixels are embarrassingly parallel: each rank owns a horizontal band of the
accumulator for the whole render; an optional spp axis renders
decorrelated sample batches that merge with one all_reduce a frame
(weekend_raytracer_tpu_torch/parallel/sharding.py).

    torchrun --standalone --nproc-per-node 4 examples/torch/03_multichip.py \
        --spp-shards 2
    torchrun --standalone --nproc-per-node 2 examples/torch/03_multichip.py \
        --device cpu          # gloo between two CPU processes
"""

from _common import parse_args


def main():
    args = parse_args(
        "sharded render over a grid of ranks",
        **{
            "--tile-shards": dict(type=int, default=None,
                                  help="ranks on the tile axis "
                                       "(default: all // spp_shards)"),
            "--spp-shards": dict(type=int, default=2),
        },
    )
    import torch.distributed as dist

    from weekend_raytracer_tpu_torch import (RenderParams, Renderer, SamplingParams,
                                             SCENES)
    from weekend_raytracer_tpu_torch.parallel.multihost import initialize
    from weekend_raytracer_tpu_torch.parallel.sharding import make_mesh

    initialize(backend="gloo" if args.device == "cpu" else "nccl")
    n = dist.get_world_size() if dist.is_initialized() else 1
    spp_shards = args.spp_shards if n % args.spp_shards == 0 else 1
    mesh = make_mesh(tile_shards=args.tile_shards, spp_shards=spp_shards)
    lead = not dist.is_initialized() or dist.get_rank() == 0

    build, camera = SCENES["three"]
    params = RenderParams(
        camera=camera(),
        viewport_size=(320, 180),
        sampling=SamplingParams(max_samples_per_pixel=16,
                                num_samples_per_pixel=4),
    )
    # Same API as single-device; heights not divisible by the tile axis
    # are padded internally, images stay bit-identical band-for-band.
    r = Renderer(build(), params, device=args.device, mesh=mesh)
    stats = r.render()
    img = r.image()  # the bands gathered on every rank: uint8 [H, W, 3]
    if lead:
        print(f"mesh: {mesh.shape} over {n} rank(s) on {r.device.type}")
        print(f"backend={r.backend} frames={stats.frames} "
              f"image={img.shape[1]}x{img.shape[0]} "
              f"band rows per rank={r._accum.shape[0] // params.viewport_size[0]}")
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
