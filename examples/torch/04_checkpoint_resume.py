"""Interrupt a render, checkpoint it, resume in a fresh Renderer, and
verify the result is bit-identical to an uninterrupted run (the port's
counterpart of examples/04_checkpoint_resume.py).

The checkpoint (.npz) carries the accumulator, the sample count, and a
fingerprint of everything that shaped it (scene, camera, sky, estimator,
texture budget, package); loading into a mismatched renderer is refused.

    python examples/torch/04_checkpoint_resume.py [--device cpu]
"""

import numpy as np

from _common import parse_args


def main():
    args = parse_args("checkpoint/resume demo",
                      **{"--ckpt": dict(default="example_ckpt.npz")})
    from weekend_raytracer_tpu_torch import (RenderParams, Renderer, SamplingParams,
                                             SCENES)

    build, camera = SCENES["demo"]
    params = RenderParams(
        camera=camera(),
        viewport_size=(320, 240),
        sampling=SamplingParams(max_samples_per_pixel=16,
                                num_samples_per_pixel=4),
    )

    # Straight-through run (the control).
    control = Renderer(build(), params, device=args.device)
    control.render()

    # Interrupted run: stop halfway, checkpoint, resume elsewhere.
    first = Renderer(build(), params, device=args.device)
    while first.accumulated_samples() < 8:
        first.render_frame()
    first.sync()
    first.save_checkpoint(args.ckpt)
    print(f"checkpointed at {first.accumulated_samples()} spp")

    resumed = Renderer(build(), params, device=args.device)
    resumed.load_checkpoint(args.ckpt)
    resumed.render()
    print(f"resumed to {resumed.accumulated_samples()} spp")

    same = np.array_equal(control.image(), resumed.image())
    print("bit-identical to the uninterrupted render:", same)
    if not same:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
