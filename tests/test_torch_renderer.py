"""The port's Renderer: end to end on the CPU against the JAX Renderer,
backend resolution, the progress machine, and the import boundary.

On the CPU every frame runs the backend's plain PyTorch twins (the
megakernel's, or the regroup pipeline's for "auto" at a power-of-two spp;
the wrappers take them only for CPU tensors), so this is the whole
progressive path short of the CUDA launches.
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
from weekend_raytracer_tpu_torch.ops.cuda import regroup as rg  # noqa: E402

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


def _matches_jax_renderer(name, backend, expect):
    """32x18, 16 spp in 8 frames of 2: the port's Renderer on the CPU
    against the JAX Renderer on the same backend, at tests/test_pallas.py's
    statistical gates."""
    kw = dict(max_spp=16, spp=2, bounces=8, name=name)
    jr = jwrt.Renderer(jscenes.SCENES[name][0](), _params(jwrt, jscenes, **kw),
                       backend=backend)
    jstats = jr.render()
    tr = _renderer(backend=backend, **kw)
    tstats = tr.render()
    assert jr.backend == tr.backend == expect
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


@pytest.mark.parametrize("name", ["three", "single"])
def test_renderer_matches_jax_renderer(name):
    """The megakernel backend, pinned on both sides."""
    _matches_jax_renderer(name, "pallas", "pallas")


@pytest.mark.parametrize("name", ["three", "single"])
def test_auto_renderer_matches_jax_regroup(name):
    """'auto' at spp 2 and 8 bounces: regroup on both sides."""
    _matches_jax_renderer(name, "auto", "regroup")


@pytest.mark.parametrize("spp,bounces", [(2, 4), (3, 4), (4, 1)])
def test_auto_resolves_to_pallas(spp, bounces):
    """'auto' follows the JAX package's rule: regroup for power-of-two spp
    <= 128 and at least 2 bounces (2, 4), the megakernel otherwise (3, 4)
    and (4, 1)."""
    kw = dict(max_spp=12, spp=spp, bounces=bounces)
    r = _renderer(**kw)
    jr = jwrt.Renderer(jscenes.SCENES["three"][0](), _params(jwrt, jscenes, **kw))
    assert r.backend == jr.backend == ("regroup" if (spp, bounces) == (2, 4) else "pallas")


def test_regroup_backend_matches_wavefront_through_renderer():
    """The counterpart of tests/test_renderer.py's test of the same name:
    'auto' (regroup, with its default cuts) gives the image of the
    uncompacted wavefront (one K0 per frame) bit for bit."""
    params = twrt.RenderParams(
        camera=tscenes.reference_demo_camera(), viewport_size=(64, 36),
        sampling=twrt.SamplingParams(max_samples_per_pixel=8,
                                     num_samples_per_pixel=4, num_bounces=5))
    ra = twrt.Renderer(tscenes.reference_demo(), params, backend="auto", device="cpu")
    assert ra.backend == "regroup"
    ra.render()
    rw = twrt.Renderer(tscenes.reference_demo(), params, backend="wavefront", device="cpu")
    assert rw.backend == "wavefront"
    rw.render()
    np.testing.assert_array_equal(ra.image(), rw.image())


@pytest.mark.parametrize("spp,bounces", [(4, 5), (3, 4), (4, 1), (1, 2)])
def test_auto_never_picks_wavefront(spp, bounces, monkeypatch):
    """'auto' resolves to regroup or the megakernel, never to the wavefront
    (an explicit choice, as in the JAX package), and a frame of it runs no
    wavefront function."""
    def _no_wavefront(*a, **k):
        raise AssertionError("'auto' ran the wavefront")

    monkeypatch.setattr(twrt.renderer, "render_image_wavefront", _no_wavefront)
    r = _renderer(max_spp=spp, spp=spp, bounces=bounces, size=(8, 4))
    assert r.backend == ("regroup" if spp in (1, 4) and bounces >= 2 else "pallas")
    assert r.render_frame()


def test_wavefront_backend_checks_spp_per_frame():
    """As in the JAX package, 'wavefront' is taken at construction and its
    spp checked when a frame renders; it runs with no cuts, so a frame is
    the K0 twin and the fold alone on the CPU."""
    r = _renderer(backend="wavefront", max_spp=6, spp=3)
    assert r.backend == "wavefront"
    with pytest.raises(ValueError, match="power of two"):
        r.render_frame()


def test_regroup_keeps_the_jax_validation():
    with pytest.raises(twrt.RenderParamsValidationError):
        _renderer(backend="regroup", max_spp=9, spp=3)
    with pytest.raises(twrt.RenderParamsValidationError):
        _renderer(backend="regroup", bounces=1)
    assert _renderer(backend="regroup", spp=4, max_spp=8).backend == "regroup"
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


def _regroup_launches():
    return [getattr(rg, f"launch_{k}").launches for k in ("k0", "pack", "k1", "combine")]


def test_render_to_convergence_and_readback():
    r = _renderer(max_spp=8, spp=2, size=(40, 24))
    assert r.backend == "regroup"
    before = mk.render_image_megakernel.launches, _regroup_launches()
    stats = r.render()
    assert stats.frames == 4 and stats.samples_per_pixel == 8
    assert r.progress() == pytest.approx(1.0)
    assert not r.render_frame()  # converged: no more work
    # no CUDA launch on the CPU
    assert (mk.render_image_megakernel.launches, _regroup_launches()) == before
    img = r.image()
    assert img.shape == (24, 40, 3) and img.dtype == np.uint8
    assert r.mean_radiance().device.type == "cpu"
    assert r.sky_model() == "preetham-fit-builtin"


def test_cpu_auto_render_runs_the_regroup_twins(monkeypatch):
    """On the CPU, 'auto' at a power-of-two spp runs the regroup pipeline's
    plain twins, with the scene's default cuts (three spheres: one cut, 3)."""
    calls = []
    for name in ("k0_plain", "pack_plain", "k1_plain", "combine_chain_plain"):
        real = getattr(rg, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(rg, name, spy)
    r = _renderer(max_spp=4, spp=2, bounces=6)
    assert r.render().frames == 2
    assert calls == ["k0_plain", "pack_plain", "k1_plain", "combine_chain_plain"] * 2
    assert np.isfinite(r.mean_radiance().numpy()).all()


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
            "import weekend_raytracer_tpu_torch.ops.cuda.regroup; "
            "import weekend_raytracer_tpu_torch.ops.cuda.wavefront; "
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
