"""Progressive renderer: accumulation state machine + per-frame kernel launch.

Counterpart of weekend_raytracer_tpu/renderer.py (reference ``Raytracer``,
src/raytracer/mod.rs:20-394, and ``RenderProgress``, mod.rs:615-679):

 - per-frame progressive sample accumulation into a persistent f32 tensor
   on the renderer's device, updated in place by the kernel;
 - the three-state progress machine: first-frame clear / accumulating /
   done, driving how many samples each frame contributes;
 - validated parameter updates with change detection: a changed bundle
   re-derives the camera basis + sky state and resets accumulation;
 - progress = accumulated / max samples.

Every renderer names its device. Checkpoints, mesh sharding, the CLI and
the viewer are not ported yet (ROADMAP Queue 1).

Backends: ``"pallas"`` is the fused CUDA megakernel (one launch per frame),
``"regroup"`` the lane-regrouped wavefront (K0, then PACK and K1 per cut,
then COMBINE); ``"auto"`` picks between them by the JAX package's rule.
``"wavefront"`` is the row-compacted wavefront, run as the JAX Renderer
runs it: with no cuts, so each frame is one K0 launch; it is never picked
by ``"auto"``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .models.camera import CameraBasis
from .models.params import RenderParams, RenderParamsValidationError
from .models.scenes import SceneDesc
from .models.sky import resolve_sky_state
from .ops import tonemap
from .ops.cuda.megakernel import render_image_megakernel
from .ops.cuda.regroup import default_cuts, render_image_regrouped
from .ops.cuda.wavefront import render_image_wavefront
from .ops.tracer import Scene

# Backends of the JAX package that this package does not have yet, and the
# ROADMAP Queue 1 item that brings each. None is replaced by another.
_NOT_PORTED = {
    "xla": "ROADMAP Queue 1, item 2 (XLA tracer as the 'xla' backend)",
}


@dataclasses.dataclass
class GpuSamplingParams:
    """Per-frame sampling state handed to the kernel (reference
    GpuSamplingParams, mod.rs:898-906)."""

    num_samples_per_pixel: int
    num_bounces: int
    accumulated_samples_per_pixel: int
    clear_accumulated_samples: bool


class RenderProgress:
    """The 3-state accumulation machine (reference mod.rs:615-679)."""

    def __init__(self):
        self._accumulated = 0

    def next_frame(self, sampling) -> GpuSamplingParams:
        current = self._accumulated
        nxt = current + sampling.num_samples_per_pixel
        if current == 0:
            self._accumulated = nxt
            return GpuSamplingParams(
                sampling.num_samples_per_pixel, sampling.num_bounces, nxt, True
            )
        if nxt <= sampling.max_samples_per_pixel:
            self._accumulated = nxt
            return GpuSamplingParams(
                sampling.num_samples_per_pixel, sampling.num_bounces, nxt, False
            )
        return GpuSamplingParams(0, sampling.num_bounces, current, False)

    def reset(self) -> None:
        self._accumulated = 0

    def restore(self, accumulated: int) -> None:
        """Set the accumulated-sample count."""
        self._accumulated = int(accumulated)

    def accumulated_samples(self) -> int:
        return self._accumulated


def resolve_backend(requested: str, params: RenderParams) -> str:
    """The JAX package's backend rule, with its validation, for the
    backends this package has (weekend_raytracer_tpu/renderer.py:184-192):
    ``"auto"`` is ``"regroup"`` for power-of-two spp <= 128 and at least 2
    bounces, else ``"pallas"`` (the CUDA megakernel). ``"wavefront"`` is
    taken as it is: its spp is checked when a frame renders, as in the JAX
    package. Backends not ported yet raise NotImplementedError; none is
    replaced by another."""
    spp = params.sampling.num_samples_per_pixel
    bounces = params.sampling.num_bounces
    pow2 = spp >= 1 and spp & (spp - 1) == 0
    regroup_ok = pow2 and spp <= 128 and bounces >= 2
    if requested == "auto":
        return "regroup" if regroup_ok else "pallas"
    if requested in ("pallas", "wavefront"):
        return requested
    if requested == "regroup":
        if not regroup_ok:
            raise RenderParamsValidationError(
                "backend='regroup' requires power-of-two (per-shard) "
                "spp <= 128 and num_bounces >= 2; got spp="
                f"{spp}, bounces={bounces} — use backend='pallas' or 'auto'"
            )
        return "regroup"
    if requested in _NOT_PORTED:
        raise NotImplementedError(
            f"backend={requested!r} is not ported yet: {_NOT_PORTED[requested]}")
    raise ValueError(f"unknown backend {requested!r}")


class Renderer:
    """Owns the scene tensors on one device and renders progressive frames.

    Parameters
    ----------
    scene : SceneDesc or a prebuilt ops.tracer.Scene (moved to ``device``)
    params : RenderParams (validated on construction and on update)
    backend : "auto" | "pallas" (the CUDA megakernel) | "regroup" (the
        lane-regrouped wavefront) | "wavefront" (the row-compacted
        wavefront, with no cuts). "auto" follows the JAX package's rule.
        "xla" raises NotImplementedError until it is ported.
    device : the torch device every tensor of this renderer lives on, e.g.
        "cuda" or "cpu". On a CUDA device each frame launches the backend's
        CUDA kernels; on the CPU it runs their plain PyTorch twins.
    budget_texels : texels per image texture in the kernel's LUT (default
        8192); textures are mipped down to fit.
    hw_dataset : optional path to the published Hosek-Wilkie 2012 RGB
        dataset; otherwise the built-in Preetham fit supplies the sky.
    """

    def __init__(self, scene, params: RenderParams, backend: str = "auto", *,
                 device, budget_texels: Optional[int] = None,
                 hw_dataset: Optional[str] = None):
        params.validate()
        self.device = torch.device(device)
        if isinstance(scene, SceneDesc):
            self._scene: Scene = scene.build(device=self.device)
        else:
            self._scene = _scene_to(scene, self.device)
        self._backend_request = backend
        self.budget_texels = budget_texels
        self.hw_dataset = hw_dataset
        self.backend = resolve_backend(backend, params)
        self._params = params
        self._progress = RenderProgress()
        self._frame_number = 0
        self._derive_device_state()
        self._alloc_accumulator()

    # -- state derivation ---------------------------------------------------

    def _derive_device_state(self) -> None:
        self._basis = CameraBasis.create(self._params.camera,
                                         self._params.viewport_size,
                                         device=self.device)
        self._sky, self._sky_model = resolve_sky_state(
            self._params.sky, hw_dataset_path=self.hw_dataset,
            device=self.device)

    def sky_model(self) -> str:
        """Which sky model this renderer's frames actually use."""
        return self._sky_model

    def _alloc_accumulator(self) -> None:
        w, h = self._params.viewport_size
        self._accum = torch.zeros((w * h, 3), dtype=torch.float32,
                                  device=self.device)

    # -- parameter updates (reference mod.rs:353-388) ------------------------

    @property
    def params(self) -> RenderParams:
        return self._params

    def set_render_params(self, params: RenderParams) -> bool:
        """Validate + apply; any change resets accumulation. Returns True
        if the params actually changed (reference early-outs on equality)."""
        if params == self._params:
            return False
        params.validate()
        backend = resolve_backend(self._backend_request, params)
        resize = params.viewport_size != self._params.viewport_size
        self.backend = backend
        self._params = params
        self._derive_device_state()
        if resize:
            self._alloc_accumulator()
        self._progress.reset()
        return True

    # -- progressive rendering ----------------------------------------------

    def render_frame(self) -> bool:
        """Render one progressive frame; returns False when converged
        (the reference's 0-spp 'done' state skips device work)."""
        gpu = self._progress.next_frame(self._params.sampling)
        if gpu.num_samples_per_pixel == 0:
            return False
        w, h = self._params.viewport_size
        bt = ({} if self.budget_texels is None
              else {"budget_texels": self.budget_texels})
        if self.backend == "regroup":
            n_spheres = int(self._scene.spheres.centers.shape[0])
            fn = render_image_regrouped
            bt["cuts"] = default_cuts(gpu.num_bounces, n_spheres)
        elif self.backend == "wavefront":
            fn = render_image_wavefront
        else:
            fn = render_image_megakernel
        fn(self._accum, self._frame_number, gpu.clear_accumulated_samples,
           self._scene, self._sky, self._basis, width=w, height=h,
           spp=gpu.num_samples_per_pixel, num_bounces=gpu.num_bounces, **bt)
        self._frame_number += 1
        return True

    def reset_accumulation(self) -> None:
        """Restart progressive accumulation without changing parameters
        (the next frame renders with the clear flag set)."""
        self._progress.reset()

    def sync(self) -> None:
        """Wait for the renderer's queued device work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def render(self, block: bool = True) -> "RenderStats":
        """Render until converged (max spp reached); returns timing stats.

        ``rays_per_sec`` is computed over warm frames only: the first frame
        is synced and timed separately (``warmup_seconds``) because it pays
        the kernel build and load; ``seconds`` is total wall time.
        """
        t0 = time.perf_counter()
        frames = 0
        warmup = 0.0
        warm_t0 = t0
        warm_spp0 = self._progress.accumulated_samples()
        while self.render_frame():
            frames += 1
            if frames == 1:
                self.sync()
                now = time.perf_counter()
                warmup = now - t0
                warm_t0 = now
                warm_spp0 = self._progress.accumulated_samples()
        if block:
            self.sync()
        end = time.perf_counter()
        dt = end - t0
        dt_warm = end - warm_t0
        w, h = self._params.viewport_size
        s = self._params.sampling
        total_spp = self._progress.accumulated_samples()
        rays = w * h * total_spp * s.num_bounces
        warm_rays = w * h * (total_spp - warm_spp0) * s.num_bounces
        if warm_rays > 0 and dt_warm > 0:
            rps = warm_rays / dt_warm
        else:  # single-frame render: no warm frames to measure
            rps = rays / dt if dt > 0 else 0.0
        return RenderStats(
            frames=frames,
            seconds=dt,
            samples_per_pixel=total_spp,
            rays=rays,
            rays_per_sec=rps,
            warmup_seconds=warmup,
        )

    def progress(self) -> float:
        """Fraction of max spp accumulated (reference mod.rs:390-394)."""
        return (
            self._progress.accumulated_samples()
            / self._params.sampling.max_samples_per_pixel
        )

    def accumulated_samples(self) -> int:
        return self._progress.accumulated_samples()

    # -- readback ------------------------------------------------------------

    def mean_radiance(self) -> torch.Tensor:
        """Accumulator / sample count as [H, W, 3] (pre-tonemap), on the
        renderer's device."""
        w, h = self._params.viewport_size
        n = max(1, self._progress.accumulated_samples())
        return (self._accum / n).reshape(h, w, 3)

    def image(self) -> np.ndarray:
        """Tonemapped sRGB uint8 frame [H, W, 3] on the host."""
        return tonemap.to_srgb_u8(self.mean_radiance()).cpu().numpy()


def _scene_to(scene: Scene, device: torch.device) -> Scene:
    """A prebuilt Scene with every tensor on ``device``."""
    def move(obj):
        return dataclasses.replace(obj, **{
            f.name: getattr(obj, f.name).to(device)
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)})

    return Scene(spheres=move(scene.spheres), materials=move(scene.materials))


@dataclasses.dataclass(frozen=True)
class RenderStats:
    frames: int
    seconds: float  # total wall time, including the first frame
    samples_per_pixel: int
    rays: int
    rays_per_sec: float  # warm-frame throughput (first frame excluded)
    warmup_seconds: float = 0.0  # first frame incl. kernel build and load
