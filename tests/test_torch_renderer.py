"""The port's Renderer: end to end on the CPU against the JAX Renderer,
backend resolution, the progress machine, and the import boundary.

On the CPU every frame runs the kernel's plain PyTorch version (the
wrapper takes it only for CPU tensors), so this is the whole progressive
path short of the CUDA launch.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import weekend_raytracer_tpu as jwrt  # noqa: E402
from weekend_raytracer_tpu.models import scenes as jscenes  # noqa: E402
from weekend_raytracer_tpu.ops.tonemap import to_srgb_u8  # noqa: E402
import weekend_raytracer_tpu_torch as twrt  # noqa: E402
from weekend_raytracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from weekend_raytracer_tpu_torch.models.sky import SkyParams  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import megakernel as mk  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _params(pkg, scenes, max_spp=8, spp=2, bounces=4, size=(32, 18), name="three"):
    return pkg.RenderParams(
        camera=scenes.SCENES[name][1](), viewport_size=size,
        sampling=pkg.SamplingParams(max_samples_per_pixel=max_spp,
                                    num_samples_per_pixel=spp,
                                    num_bounces=bounces))


def _renderer(backend="auto", name="three", **kw):
    return twrt.Renderer(tscenes.SCENES[name][0](),
                         _params(twrt, tscenes, name=name, **kw),
                         backend=backend, device="cpu")


@pytest.mark.parametrize("name", ["three", "single"])
def test_renderer_matches_jax_renderer(name):
    """32x18, 16 spp in 8 frames of 2: the port's Renderer on the CPU
    against the JAX Renderer's fused megakernel, at tests/test_pallas.py's
    statistical gates."""
    kw = dict(max_spp=16, spp=2, bounces=8, name=name)
    jr = jwrt.Renderer(jscenes.SCENES[name][0](), _params(jwrt, jscenes, **kw),
                       backend="pallas")
    jstats = jr.render()
    tr = _renderer(**kw)
    tstats = tr.render()
    assert tr.backend == "pallas"
    assert (tstats.frames, tstats.samples_per_pixel, tstats.rays) == (
        jstats.frames, jstats.samples_per_pixel, jstats.rays)
    a = np.asarray(jr.mean_radiance())
    b = tr.mean_radiance().numpy()
    assert b.shape == (18, 32, 3) and np.isfinite(b).all()
    ta = np.asarray(to_srgb_u8(a)).astype(np.float32) / 255
    tb = tr.image().astype(np.float32) / 255
    rmse = float(np.sqrt(((ta - tb) ** 2).mean()))
    assert rmse < 5e-3, rmse
    assert abs(a.mean() - b.mean()) / a.mean() < 1e-3


@pytest.mark.parametrize("spp,bounces", [(2, 4), (3, 4), (4, 1)])
def test_auto_resolves_to_pallas(spp, bounces):
    """'auto' is the megakernel for every spp and depth until regroup is
    ported (the JAX rule would pick regroup for power-of-two spp)."""
    r = _renderer(max_spp=12, spp=spp, bounces=bounces)
    assert r.backend == "pallas"


@pytest.mark.parametrize("backend", ["regroup", "xla", "wavefront"])
def test_unported_backends_raise(backend):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _renderer(backend=backend)


def test_regroup_keeps_the_jax_validation():
    with pytest.raises(twrt.RenderParamsValidationError):
        _renderer(backend="regroup", max_spp=9, spp=3)
    with pytest.raises(ValueError, match="unknown backend"):
        _renderer(backend="vulkan")


def test_set_render_params_reresolves_and_raises_unported():
    r = _renderer(backend="auto")
    r.render()
    assert r.progress() == 1.0
    new = dataclasses.replace(r.params, sky=SkyParams(turbidity=7.0))
    assert r.set_render_params(new)
    assert r.progress() == 0.0
    assert not r.set_render_params(new)  # unchanged: no-op
    bad = dataclasses.replace(new, sampling=twrt.SamplingParams(
        max_samples_per_pixel=7, num_samples_per_pixel=2))
    with pytest.raises(twrt.RenderParamsValidationError):
        r.set_render_params(bad)


def test_render_to_convergence_and_readback():
    r = _renderer(max_spp=8, spp=2, size=(40, 24))
    before = mk.render_image_megakernel.launches
    stats = r.render()
    assert stats.frames == 4 and stats.samples_per_pixel == 8
    assert r.progress() == pytest.approx(1.0)
    assert not r.render_frame()  # converged: no more work
    assert mk.render_image_megakernel.launches == before  # no CUDA launch on CPU
    img = r.image()
    assert img.shape == (24, 40, 3) and img.dtype == np.uint8
    assert r.mean_radiance().device.type == "cpu"
    assert r.sky_model() == "preetham-fit-builtin"


def test_reset_and_resize():
    r = _renderer(size=(32, 18))
    r.render()
    r.reset_accumulation()
    assert r.accumulated_samples() == 0
    assert r.render_frame()
    r.set_render_params(dataclasses.replace(r.params, viewport_size=(16, 10)))
    r.render_frame()
    assert r.image().shape == (10, 16, 3)


def test_prebuilt_scene_is_moved_to_the_device():
    scene = tscenes.three_spheres().build(device="cpu")
    r = twrt.Renderer(scene, _params(twrt, tscenes, max_spp=2, spp=2), device="cpu")
    assert r.render().frames == 1


def test_import_leaves_jax_out():
    code = ("import sys, weekend_raytracer_tpu_torch as w; "
            "import weekend_raytracer_tpu_torch.ops.cuda.megakernel; "
            "import weekend_raytracer_tpu_torch.renderer; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m); "
            "assert 'weekend_raytracer_tpu' not in sys.modules")
    env = dict(os.environ, PYTHONPATH=_REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=_REPO, env=env,
                   timeout=120)


def test_package_exports_the_jax_names_it_has():
    ported = set(twrt.__all__)
    assert ported <= set(jwrt.__all__) | {"GpuSamplingParams"}
    for name in ("Renderer", "RenderProgress", "RenderStats", "Scene", "SceneDesc",
                 "SCENES", "CameraBasis", "SkyState", "to_sky_state"):
        assert name in ported
