#!/usr/bin/env python3
"""Write the JAX package's own images of a few small cases to
``tests/data/jax_images.npz``, the fixture that the port's kernels are held
against on the card (chip_smoke.py ``[reference]``) without JAX there.

Run from the repository root on the CPU:

    JAX_PLATFORMS=cpu python3 tools/jax_images.py [--out PATH]

It imports jax and the JAX package, which the port and chip_smoke.py never
do, and configures JAX as tests/conftest.py does. The images are those
that the port's CPU tests already compute from the JAX package in Pallas
interpret mode, at the same parameters:

- ``render_image_pallas`` (the fused megakernel) at
  tests/test_torch_megakernel.py's ``_CASES`` for ``first_hit`` (64x48,
  1 spp, 1 bounce, a constant sky), ``rtiow`` (48x32, 8 frames of 4 spp,
  8 bounces) and ``textured`` (40x24, 8 x 4, 6 bounces);
- ``render_image_regrouped`` at tests/test_torch_regroup.py's ``_SLICE``
  for ``rtiow`` (64x32, 8 x 4, 8 bounces, cuts (2, 4)) and ``textured``
  (64x32, 8 x 4, 6 bounces, cuts (2,));
- the same with ``mxu_sweep=True`` (the MXU chunk sweep), as
  ``<kernel>_mxu_<case>``: ``megakernel_mxu_rtiow``,
  ``megakernel_mxu_textured``, ``regroup_mxu_rtiow``,
  ``regroup_mxu_textured``, and ``render_image_wavefront`` on ``rtiow``
  at regroup's parameters with ``phase_cuts`` (2, 4) (``wavefront_mxu_rtiow``,
  its cuts as ``wavefront_mxu_rtiow_cuts``), so that its K1 runs too. The
  textured scene has no chunks, so there the knob changes nothing.

Each image is the mean radiance, [H*W, 3] float32 (the accumulator over
frames x spp), stored as ``<kernel>_<case>``, with its parameters as
``<kernel>_<case>_params`` (width, height, frames, spp, bounces),
regroup's cuts as ``regroup_<case>_cuts``, and the jax and jaxlib
versions as ``jax_version`` and ``jaxlib_version``. The tests
tests/test_torch_megakernel.py and tests/test_torch_regroup.py hold the
fixture to their own JAX images.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "tests", "data", "jax_images.npz")
# name -> (w, h, frames, spp, bounces): test_torch_megakernel.py _CASES
MEGAKERNEL_CASES = {"first_hit": (64, 48, 1, 1, 1), "rtiow": (48, 32, 8, 4, 8),
                    "textured": (40, 24, 8, 4, 6)}
# name -> (w, h, frames, spp, bounces, cuts): test_torch_regroup.py _SLICE
REGROUP_CASES = {"rtiow": (64, 32, 8, 4, 8, (2, 4)), "textured": (64, 32, 8, 4, 6, (2,))}


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_threefry_partitionable", True)
    return jax


def _setup(name, w, h):
    """The JAX scene, sky and camera basis of a case, as the tests build
    them."""
    import numpy as onp

    from weekend_raytracer_tpu.models import scenes as jscenes
    from weekend_raytracer_tpu.models.camera import Camera, CameraBasis
    from weekend_raytracer_tpu.models.materials import Material
    from weekend_raytracer_tpu.models.scenes import SceneDesc
    from weekend_raytracer_tpu.models.sky import SkyParams, SkyState, to_sky_state
    from weekend_raytracer_tpu.models.spheres import Sphere

    if name == "first_hit":
        desc = SceneDesc(materials=[Material.lambertian((0.3, 0.4, 0.5))],
                         spheres=[Sphere((0.0, 0.0, -3.0), 1.0, 0)])
        cam = Camera.look_at((0, 0, 1), (0, 0, -3), vfov_degrees=40.0, aperture=0.0)
        params = onp.zeros((3, 9), onp.float32)
        params[:, 2] = 1.0
        sky = SkyState.from_raw(params, onp.full(3, 1.0), onp.array([0.0, 1.0, 0.0]))
    else:
        desc, cam = jscenes.SCENES[name][0](), jscenes.SCENES[name][1]()
        sky = to_sky_state(SkyParams())
    return desc.build(), sky, CameraBasis.create(cam, (w, h))


def megakernel_image(name, mxu_sweep: bool = False) -> np.ndarray:
    import jax.numpy as jnp

    from weekend_raytracer_tpu.ops.pallas import megakernel as jmk

    w, h, frames, spp, bounces = MEGAKERNEL_CASES[name]
    scene, sky, basis = _setup(name, w, h)
    acc = jnp.zeros((w * h, 3), jnp.float32)
    for f in range(frames):
        acc = jmk.render_image_pallas(acc, jnp.uint32(f), jnp.bool_(f == 0), scene, sky,
                                      basis, width=w, height=h, spp=spp, num_bounces=bounces,
                                      mxu_sweep=mxu_sweep)
    return np.asarray(acc) / (frames * spp)


def regroup_image(name, mxu_sweep: bool = False) -> np.ndarray:
    import jax.numpy as jnp

    from weekend_raytracer_tpu.ops.pallas import regroup as jrg

    w, h, frames, spp, bounces, cuts = REGROUP_CASES[name]
    scene, sky, basis = _setup(name, w, h)
    acc = jnp.zeros((w * h, 3), jnp.float32)
    for f in range(frames):
        acc = jrg.render_image_regrouped(acc, jnp.uint32(f), jnp.bool_(f == 0), scene, sky,
                                         basis, width=w, height=h, spp=spp,
                                         num_bounces=bounces, cuts=cuts, mxu_sweep=mxu_sweep)
    return np.asarray(acc) / (frames * spp)


def wavefront_image(name, mxu_sweep: bool = False) -> np.ndarray:
    """render_image_wavefront at regroup's parameters, its cuts as phase
    cuts."""
    import jax.numpy as jnp

    from weekend_raytracer_tpu.ops.pallas import wavefront as jwf

    w, h, frames, spp, bounces, cuts = REGROUP_CASES[name]
    scene, sky, basis = _setup(name, w, h)
    acc = jnp.zeros((w * h, 3), jnp.float32)
    for f in range(frames):
        acc = jwf.render_image_wavefront(acc, jnp.uint32(f), jnp.bool_(f == 0), scene, sky,
                                         basis, width=w, height=h, spp=spp,
                                         num_bounces=bounces, phase_cuts=cuts,
                                         mxu_sweep=mxu_sweep)
    return np.asarray(acc) / (frames * spp)


# the MXU chunk sweep's images: (kernel, case) of each
MXU_IMAGES = (("megakernel", "rtiow"), ("megakernel", "textured"), ("regroup", "rtiow"),
              ("regroup", "textured"), ("wavefront", "rtiow"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    jax = _jax()
    import jaxlib

    arrays = {"jax_version": np.array(jax.__version__),
              "jaxlib_version": np.array(jaxlib.__version__)}
    for name, case in MEGAKERNEL_CASES.items():
        t0 = time.perf_counter()
        arrays[f"megakernel_{name}"] = megakernel_image(name).astype(np.float32)
        arrays[f"megakernel_{name}_params"] = np.array(case, np.int32)
        print(f"megakernel {name} {case}: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, case in REGROUP_CASES.items():
        t0 = time.perf_counter()
        arrays[f"regroup_{name}"] = regroup_image(name).astype(np.float32)
        arrays[f"regroup_{name}_params"] = np.array(case[:5], np.int32)
        arrays[f"regroup_{name}_cuts"] = np.array(case[5], np.int32)
        print(f"regroup {name} {case}: {time.perf_counter() - t0:.1f} s", flush=True)
    images = {"megakernel": megakernel_image, "regroup": regroup_image,
              "wavefront": wavefront_image}
    for kernel, name in MXU_IMAGES:
        t0 = time.perf_counter()
        key = f"{kernel}_mxu_{name}"
        case = MEGAKERNEL_CASES[name] if kernel == "megakernel" else REGROUP_CASES[name]
        arrays[key] = images[kernel](name, mxu_sweep=True).astype(np.float32)
        arrays[f"{key}_params"] = np.array(case[:5], np.int32)
        if kernel != "megakernel":
            arrays[f"{key}_cuts"] = np.array(case[5], np.int32)
        print(f"{key} {case}: {time.perf_counter() - t0:.1f} s", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
