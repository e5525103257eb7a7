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

Every renderer names its device. The render state (the accumulator and
the sample count) is saved and resumed by ``save_checkpoint`` and
``load_checkpoint``, which refuse a checkpoint of another estimator. With
``mesh=`` (parallel/sharding.py) each torch.distributed rank keeps one band
of the accumulator and renders it, its tile's sample shards merged by one
all_reduce a frame.

Backends: ``"pallas"`` is the fused CUDA megakernel (one launch per frame),
``"regroup"`` the lane-regrouped wavefront (K0, then PACK and K1 per cut,
then COMBINE); ``"auto"`` picks between them by the JAX package's rule.
``"wavefront"`` is the row-compacted wavefront, run as the JAX Renderer
runs it: with no cuts, so each frame is one K0 launch. ``"xla"`` is the JAX
package's XLA tracer in plain PyTorch (ops/tracer.py), which launches none
of the port's kernels and samples textures at full resolution. ``"auto"``
picks neither of the last two.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .models.camera import CameraBasis
from .models.params import RenderParams, RenderParamsValidationError
from .models.scenes import SceneDesc
from .models.sky import resolve_sky_state
from .ops import tonemap
from .ops.cuda.megakernel import (DEFAULT_TEXTURE_BUDGET, resolve_mxu_sweep,
                                  render_image_megakernel)
from .ops.cuda.regroup import default_cuts, render_image_regrouped
from .ops.cuda.wavefront import render_image_wavefront
from .ops.tracer import Scene, render_image
from .parallel.multihost import local_rank
from .parallel.sharding import (SPP_AXIS, TILE_AXIS, gather_accumulator,
                                render_image_sharded, sharded_accumulator,
                                validate_mesh_config)

# Hashed into every checkpoint's estimator family: the two packages' draws
# agree only statistically (FMA contraction, math libraries), so a
# checkpoint of the JAX package is refused here, and one of this package
# there.
PACKAGE_TAG = "torch"


class CheckpointMismatchError(ValueError):
    """A checkpoint's scene/params fingerprint doesn't match the renderer.

    Raised by Renderer.load_checkpoint instead of silently blending samples
    rendered under different scene data, camera, sky, viewport, bounce
    depth, estimator or package into the accumulator."""


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


def _default_pixel_batch(n_pixels: int) -> Optional[int]:
    """The ``"xla"`` backend's pixel batch, bounding the [lanes x
    sphere_chunk] intersection intermediates (the JAX package's rule)."""
    if n_pixels <= (1 << 17):
        return None
    return 1 << 16


def resolve_backend(requested: str, params: RenderParams, mesh=None) -> str:
    """The JAX package's backend rule, with its validation
    (weekend_raytracer_tpu/renderer.py:163-204): ``"auto"`` is
    ``"regroup"`` for power-of-two spp <= 128 and at least 2 bounces, else
    ``"pallas"`` (the CUDA megakernel); it never picks ``"xla"`` or
    ``"wavefront"``. ``"wavefront"`` is taken as it is: its spp is checked
    when a frame renders, as in the JAX package. Under a ``mesh`` the
    params are validated against it, the rule reads the spp of one shard,
    and ``"wavefront"`` is refused."""
    spp = params.sampling.num_samples_per_pixel
    bounces = params.sampling.num_bounces
    if mesh is not None:
        validate_mesh_config(mesh, params.viewport_size, spp)
        spp //= mesh.shape[SPP_AXIS]
    pow2 = spp >= 1 and spp & (spp - 1) == 0
    regroup_ok = pow2 and spp <= 128 and bounces >= 2
    if requested == "auto":
        backend = "regroup" if regroup_ok else "pallas"
    elif requested in ("pallas", "wavefront", "xla"):
        backend = requested
    elif requested == "regroup":
        if not regroup_ok:
            raise RenderParamsValidationError(
                "backend='regroup' requires power-of-two (per-shard) "
                "spp <= 128 and num_bounces >= 2; got spp="
                f"{spp}, bounces={bounces} — use backend='pallas' or 'auto'"
            )
        backend = "regroup"
    else:
        raise ValueError(f"unknown backend {requested!r}")
    if backend == "wavefront" and mesh is not None:
        raise RenderParamsValidationError(
            "backend='wavefront' does not support mesh sharding yet; "
            "use backend='regroup', 'pallas', or 'auto' with a mesh"
        )
    return backend


def rank_device(device, mesh=None) -> torch.device:
    """The renderer's device: ``device``, except that under a mesh a bare
    "cuda" is the rank's own card, ``cuda:LOCAL_RANK``."""
    device = torch.device(device)
    if mesh is not None and device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_rank())
    return device


class Renderer:
    """Owns the scene tensors on one device and renders progressive frames.

    Parameters
    ----------
    scene : SceneDesc or a prebuilt ops.tracer.Scene (moved to ``device``)
    params : RenderParams (validated on construction and on update)
    backend : "auto" | "pallas" (the CUDA megakernel) | "regroup" (the
        lane-regrouped wavefront) | "wavefront" (the row-compacted
        wavefront, with no cuts) | "xla" (the XLA tracer in plain PyTorch;
        the full-resolution texture reference). "auto" follows the JAX
        package's rule.
    device : the torch device every tensor of this renderer lives on, e.g.
        "cuda" or "cpu". On a CUDA device each frame launches the backend's
        CUDA kernels (``"xla"``: PyTorch's own); on the CPU it runs their
        plain PyTorch twins. Under a mesh, "cuda" is the rank's own card
        (``cuda:LOCAL_RANK``).
    mesh : optional parallel.sharding.Mesh (tiles x spp ranks, see
        make_mesh). When given, this rank keeps its band of the
        accumulator, every frame renders through render_image_sharded (the
        band's sample shards merged with one all_reduce), and heights the
        tile axis does not divide are padded. Readback (``mean_radiance``,
        ``image``) and checkpoints gather the bands: every rank calls them.
    budget_texels : texels per image texture in the fused kernels' LUT
        (default 8192); textures are mipped down to fit. The ``"xla"``
        backend samples full resolution and ignores it.
    hw_dataset : optional path to the published Hosek-Wilkie 2012 RGB
        dataset; otherwise the built-in Preetham fit supplies the sky.
    mxu_sweep : run the fused kernels' culled chunk sweeps with their
        products on the tensor cores (3xTF32 ``mma.sync``; on the CPU the
        twins' f32 product) instead of the FMA chain. Statistically
        equivalent, not bit-identical; None defers to WRT_MXU_SWEEP
        (default off). Ignored by the ``"xla"`` backend and by scenes
        without chunks.
    """

    def __init__(self, scene, params: RenderParams, backend: str = "auto", *,
                 device, mesh=None, budget_texels: Optional[int] = None,
                 hw_dataset: Optional[str] = None, mxu_sweep: Optional[bool] = None):
        params.validate()
        self.device = rank_device(device, mesh)
        if isinstance(scene, SceneDesc):
            self._scene: Scene = scene.build(device=self.device)
        else:
            self._scene = _scene_to(scene, self.device)
        self._backend_request = backend
        self.mesh = mesh
        self.budget_texels = budget_texels
        self.hw_dataset = hw_dataset
        self.mxu_sweep = mxu_sweep
        self.backend = resolve_backend(backend, params, mesh)
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

    def resolved_mxu_sweep(self) -> bool:
        """Whether this renderer's fused kernels run the MXU chunk sweep
        (explicit knob > WRT_MXU_SWEEP > scene-size default, the JAX
        package's order). Part of the checkpoint fingerprint: the MXU
        estimator is not bit-identical to the FMA one."""
        return resolve_mxu_sweep(self.mxu_sweep, self._scene)

    def _padded_height(self) -> int:
        """Image height padded so the tile axis divides the rows evenly
        (single-device: no padding). Padding rows render off-frame content
        and are dropped on readback."""
        h = self._params.viewport_size[1]
        if self.mesh is None:
            return h
        n_tiles = self.mesh.shape[TILE_AXIS]
        return -(-h // n_tiles) * n_tiles

    def _alloc_accumulator(self) -> None:
        w, h = self._params.viewport_size
        if self.mesh is None:
            self._accum = torch.zeros((w * h, 3), dtype=torch.float32,
                                      device=self.device)
        else:
            self._accum = sharded_accumulator(w, self._padded_height(), self.mesh,
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
        backend = resolve_backend(self._backend_request, params, self.mesh)
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
        mxu = self.resolved_mxu_sweep()
        if self.mesh is not None:
            render_image_sharded(
                self._accum, self._frame_number, gpu.clear_accumulated_samples,
                self._scene, self._sky, self._basis, width=w,
                height=self._padded_height(), aim_height=h,
                spp=gpu.num_samples_per_pixel, num_bounces=gpu.num_bounces,
                mesh=self.mesh, backend=self.backend, budget_texels=self.budget_texels,
                mxu_sweep=mxu)
            self._frame_number += 1
            return True
        bt = ({} if self.budget_texels is None
              else {"budget_texels": self.budget_texels})
        bt["mxu_sweep"] = mxu
        if self.backend == "xla":  # full-resolution textures, no MXU sweep
            fn, bt = render_image, {"pixel_batch": _default_pixel_batch(w * h)}
        elif self.backend == "regroup":
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

    # -- checkpoint / resume: the accumulator and the sample count are the
    # render's whole persistent state -----------------------------------------

    def _fingerprint(self) -> str:
        """Stable hash binding a checkpoint to what produced its samples:
        scene tensors, camera, sky, viewport, bounce depth and estimator
        family, in the JAX package's order, plus this package's tag.

        Sampling counts are left out: changing them only re-paces or
        extends the render, and resuming with a larger max spp is
        supported. The fused backends (pallas, wavefront, regroup) draw the
        same per-sample radiances, so they share one family; the xla
        backend samples textures at full resolution, not from the fused
        kernels' mipped LUT, so it is a family of its own. The fused family
        hashes ``mxu={resolved_mxu_sweep()}`` (the MXU chunk sweep is
        another estimator: a checkpoint of one setting is refused by the
        other) and, for a textured scene, the LUT's budget.
        """
        h = hashlib.sha256()
        sp, mt = self._scene.spheres, self._scene.materials
        for leaf in (sp.centers, sp.radii, sp.material_idx, mt.ids, mt.tex1, mt.tex2,
                     mt.x, mt.pool, mt.albedo1, mt.albedo2):
            a = leaf.cpu().numpy()
            h.update(str(a.shape).encode())
            h.update(str(a.dtype).encode())
            h.update(a.tobytes())
        p = self._params
        h.update(repr(p.camera).encode())
        h.update(repr(p.sky).encode())
        # the cooked sky coefficients too: the same SkyParams cook to
        # another estimator under the exact HW dataset
        h.update(self._sky.params.cpu().numpy().tobytes())
        h.update(self._sky.radiances.cpu().numpy().tobytes())
        h.update(repr(tuple(p.viewport_size)).encode())
        h.update(str(p.sampling.num_bounces).encode())
        family = "xla" if self.backend == "xla" else "fused"
        h.update(family.encode())
        h.update(PACKAGE_TAG.encode())
        if family == "fused":
            h.update(f"mxu={self.resolved_mxu_sweep()}".encode())
            if not mt.all_solid:
                bt = (DEFAULT_TEXTURE_BUDGET if self.budget_texels is None
                      else self.budget_texels)
                h.update(str(bt).encode())
        return h.hexdigest()

    def _whole_accumulator(self) -> torch.Tensor:
        """The (padded) accumulator of the whole image: under a mesh the
        bands gathered from every rank (a collective), else ``_accum``."""
        if self.mesh is None:
            return self._accum
        return gather_accumulator(self._accum, self.mesh)

    def save_checkpoint(self, path: str) -> None:
        """Persist the progressive render state to an .npz file (the JAX
        package's keys). Under a mesh every rank calls it and rank 0 writes
        the gathered accumulator, padding rows included."""
        accum = self._whole_accumulator().cpu().numpy()
        if self.mesh is not None and self.mesh.distributed and dist.get_rank() != 0:
            return
        np.savez_compressed(
            path,
            accum=accum,
            accumulated_spp=np.int64(self._progress.accumulated_samples()),
            frame_number=np.int64(self._frame_number),
            viewport=np.asarray(self._params.viewport_size, dtype=np.int64),
            fingerprint=np.asarray(self._fingerprint()),
        )

    def load_checkpoint(self, path: str) -> None:
        """Resume a progressive render saved by save_checkpoint.

        Raises CheckpointMismatchError unless the checkpoint's viewport and
        fingerprint match this renderer; a checkpoint without a fingerprint
        cannot be checked and is refused too. Parameter changes after the
        resume behave like live changes (reset on change). Rows past the
        image (a mesh's padding) are grown or trimmed to this renderer's
        padded height, so a checkpoint moves between a mesh and a single
        device; under a mesh every rank reads the file and keeps its band.
        """
        with np.load(path) as data:
            vp = tuple(int(v) for v in data["viewport"])
            if vp != tuple(self._params.viewport_size):
                raise CheckpointMismatchError(
                    f"checkpoint viewport {vp} != current {self._params.viewport_size}")
            saved = str(data["fingerprint"]) if "fingerprint" in data else None
            if saved != self._fingerprint():
                raise CheckpointMismatchError(
                    f"checkpoint {path!r} was saved with different scene/camera/sky/"
                    "bounces/estimator/package state than this renderer; refusing "
                    "to blend incompatible samples")
            accum = np.asarray(data["accum"], dtype=np.float32)
            w, h = self._params.viewport_size
            if accum.ndim != 2 or accum.shape[1] != 3 or accum.shape[0] % w or \
                    accum.shape[0] < w * h:
                raise CheckpointMismatchError(
                    f"checkpoint accumulator shape {tuple(accum.shape)} holds no "
                    f"whole {w}x{h} image")
            accumulated = int(data["accumulated_spp"])
            frame_number = int(data["frame_number"])
        # grow or trim the padding rows, which carry no image data
        whole = np.zeros((w * self._padded_height(), 3), dtype=np.float32)
        n = min(whole.shape[0], accum.shape[0])
        whole[:n] = accum[:n]
        if self.mesh is not None:
            tile_idx, _ = self.mesh.coords()
            block = self._accum.shape[0]
            whole = whole[tile_idx * block:(tile_idx + 1) * block]
        self._accum = torch.from_numpy(whole).to(self.device)
        self._progress.restore(accumulated)
        self._frame_number = frame_number

    # -- readback ------------------------------------------------------------

    def mean_radiance(self) -> torch.Tensor:
        """Accumulator / sample count as [H, W, 3] (pre-tonemap), on the
        renderer's device. Under a mesh the bands are gathered (every rank
        calls it) and the padding rows dropped."""
        w, h = self._params.viewport_size
        n = max(1, self._progress.accumulated_samples())
        acc = self._whole_accumulator()[: w * h]
        return (acc / n).reshape(h, w, 3)

    def image(self) -> np.ndarray:
        """Tonemapped sRGB uint8 frame [H, W, 3] on the host (under a mesh,
        gathered on every rank)."""
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
