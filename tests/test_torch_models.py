"""The port's scene and parameter model against the JAX package's.

Every scene function gives the same arrays; the camera basis and the sky
state agree within 1e-6 absolute (both packages compute them in float64
numpy on the host and round once to f32, so they are in fact equal);
scenes carried across with ``Scene.from_numpy`` equal the port's own build;
the progress state machine matches frame for frame.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import weekend_raytracer_tpu as jwrt  # noqa: E402
from weekend_raytracer_tpu.models import hw_dataset as jhw  # noqa: E402
from weekend_raytracer_tpu.models import scenes as jscenes  # noqa: E402
from weekend_raytracer_tpu.models import sky as jsky  # noqa: E402
from weekend_raytracer_tpu.ops import tonemap as jtonemap  # noqa: E402
from weekend_raytracer_tpu.utils import image as jimage  # noqa: E402
import weekend_raytracer_tpu_torch as twrt  # noqa: E402
from weekend_raytracer_tpu_torch.models import hw_dataset as thw  # noqa: E402
from weekend_raytracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from weekend_raytracer_tpu_torch.models import sky as tsky  # noqa: E402
from weekend_raytracer_tpu_torch.ops import tonemap as ttonemap  # noqa: E402
from weekend_raytracer_tpu_torch.ops.tracer import Scene  # noqa: E402
from weekend_raytracer_tpu_torch.utils import image as timage  # noqa: E402

_SPHERE_FIELDS = ("centers", "radii", "material_idx")
_MATERIAL_FIELDS = ("ids", "tex1", "tex2", "x", "pool", "albedo1", "albedo2")
_BASIS_FIELDS = ("eye", "horizontal", "vertical", "u", "v", "lens_radius",
                 "lower_left_corner")


def _assert_equal(ref, got, what):
    ref = np.asarray(ref)
    got = got.cpu().numpy()
    assert ref.shape == got.shape and ref.dtype == got.dtype, (what, ref.shape, got.shape)
    np.testing.assert_array_equal(got, ref, err_msg=what)


@pytest.mark.parametrize("name", sorted(jscenes.SCENES))
def test_scene_builders_give_equal_arrays(name):
    kw = dict(n=300) if name == "random10k" else {}
    jscene = jscenes.SCENES[name][0](**kw).build()
    tscene = tscenes.SCENES[name][0](**kw).build(device="cpu")
    for f in _SPHERE_FIELDS:
        _assert_equal(getattr(jscene.spheres, f), getattr(tscene.spheres, f), f)
    for f in _MATERIAL_FIELDS:
        _assert_equal(getattr(jscene.materials, f), getattr(tscene.materials, f), f)
    assert tscene.materials.tex_meta == jscene.materials.tex_meta
    assert tscene.materials.all_solid == jscene.materials.all_solid
    assert (dataclasses.asdict(jscenes.SCENES[name][1]())
            == dataclasses.asdict(tscenes.SCENES[name][1]()))


def test_scene_seeds_are_kept():
    """rtiow_final(seed=42) and random_spheres(seed=7) are the defaults,
    and another seed gives another scene in both packages alike."""
    for seed in (42, 3):
        j = jscenes.rtiow_final(seed=seed).build()
        t = tscenes.rtiow_final(seed=seed).build(device="cpu")
        _assert_equal(j.spheres.centers, t.spheres.centers, f"rtiow seed {seed}")
    j = jscenes.random_spheres(n=64, seed=8).build()
    t = tscenes.random_spheres(n=64, seed=8).build(device="cpu")
    _assert_equal(j.spheres.radii, t.spheres.radii, "random seed 8")
    np.testing.assert_array_equal(tscenes.procedural_earth().data,
                                  jscenes.procedural_earth().data)
    np.testing.assert_array_equal(tscenes.procedural_moon().data,
                                  jscenes.procedural_moon().data)


@pytest.mark.parametrize("name,viewport", [("rtiow", (1920, 1080)),
                                           ("demo", (800, 600)),
                                           ("textured", (37, 19))])
def test_camera_basis_matches(name, viewport):
    """Both packages derive the basis in float64 numpy and store f32."""
    cam = jscenes.SCENES[name][1]()
    ref = jwrt.CameraBasis.create(cam, viewport)
    got = twrt.CameraBasis.create(tscenes.SCENES[name][1](), viewport, device="cpu")
    for f in _BASIS_FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=0, atol=1e-6, err_msg=f)
        assert getattr(got, f).dtype == torch.float32


@pytest.mark.parametrize("params", [
    dict(), dict(azimuth_degrees=120.0, zenith_degrees=40.0, turbidity=2.5),
    dict(zenith_degrees=0.0, turbidity=7.0, albedo=(0.2, 0.4, 0.6))])
def test_sky_state_matches(params):
    """The Preetham fit is numpy/scipy in float64 in both packages; only
    the final state is rounded to f32 (jnp on one side, torch on the
    other)."""
    ref = jsky.to_sky_state(jsky.SkyParams(**params))
    got = tsky.to_sky_state(tsky.SkyParams(**params), device="cpu")
    for f in ("params", "radiances", "sun_direction"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=0, atol=1e-6, err_msg=f)
    _, model = tsky.resolve_sky_state(tsky.SkyParams(**params), device="cpu")
    assert model == jsky.SKY_MODEL_FIT == tsky.SKY_MODEL_FIT


def test_hw_dataset_cooking_matches(tmp_path):
    """A synthetic dataset file cooks to the same exact-HW sky state."""
    rs = np.random.RandomState(4)
    path = str(tmp_path / "hw.npz")
    np.savez(path, config=rs.rand(3, 2, 10, 6, 9), radiance=rs.rand(3, 2, 10, 6))
    sp = dict(zenith_degrees=35.0, turbidity=3.3, albedo=(0.1, 0.5, 0.9))
    ref, jmodel = jsky.resolve_sky_state(jsky.SkyParams(**sp), hw_dataset_path=path)
    got, tmodel = tsky.resolve_sky_state(tsky.SkyParams(**sp), hw_dataset_path=path,
                                         device="cpu")
    assert jmodel == tmodel == tsky.SKY_MODEL_EXACT
    for f in ("params", "radiances", "sun_direction"):
        _assert_equal(getattr(ref, f), getattr(got, f), f)
    p_ref = jhw.cook(*jhw.load_dataset(path), 4.5, np.array([0.3, 0.3, 0.3]), 0.7)
    p_got = thw.cook(*thw.load_dataset(path), 4.5, np.array([0.3, 0.3, 0.3]), 0.7)
    for a, b in zip(p_ref, p_got):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["three", "textured"])
def test_scene_from_numpy_equals_build(name):
    jscene = jscenes.SCENES[name][0]().build()
    carried = Scene.from_numpy(
        {k: np.asarray(getattr(jscene.spheres, k)) for k in _SPHERE_FIELDS},
        {k: np.asarray(getattr(jscene.materials, k)) for k in _MATERIAL_FIELDS},
        "cpu")
    own = tscenes.SCENES[name][0]().build(device="cpu")
    for f in _SPHERE_FIELDS:
        _assert_equal(getattr(own.spheres, f), getattr(carried.spheres, f), f)
    for f in _MATERIAL_FIELDS:
        _assert_equal(getattr(own.materials, f), getattr(carried.materials, f), f)
    assert carried.materials.tex_meta == own.materials.tex_meta
    assert carried.materials.all_solid == own.materials.all_solid


def test_sky_and_basis_from_numpy_equal_own():
    sky_j = jsky.to_sky_state(jsky.SkyParams())
    sky_t = tsky.SkyState.from_numpy(*(np.asarray(getattr(sky_j, f)) for f in
                                       ("params", "radiances", "sun_direction")),
                                     device="cpu")
    own = tsky.to_sky_state(tsky.SkyParams(), device="cpu")
    for f in ("params", "radiances", "sun_direction"):
        torch.testing.assert_close(getattr(sky_t, f), getattr(own, f), rtol=0, atol=0)
    cam = jscenes.three_spheres_camera()
    b_j = jwrt.CameraBasis.create(cam, (64, 48))
    b_t = twrt.CameraBasis.from_numpy(*(np.asarray(getattr(b_j, f)) for f in _BASIS_FIELDS),
                                      device="cpu")
    own_b = twrt.CameraBasis.create(cam, (64, 48), device="cpu")
    for f in _BASIS_FIELDS:
        torch.testing.assert_close(getattr(b_t, f), getattr(own_b, f), rtol=0, atol=0)


def test_render_progress_matches_frame_for_frame():
    """A scripted sequence of next_frame / reset / restore calls, with
    sampling changes, gives the same GpuSamplingParams in both packages."""
    jp, tp = jwrt.RenderProgress(), twrt.RenderProgress()
    s1 = jwrt.SamplingParams(max_samples_per_pixel=8, num_samples_per_pixel=2)
    s2 = jwrt.SamplingParams(max_samples_per_pixel=12, num_samples_per_pixel=3,
                             num_bounces=5)
    script = ["f1"] * 6 + ["reset", "f2", "f2", "restore9", "f2", "f2", "f1",
                           "reset", "reset", "f1"]
    for step in script:
        if step == "reset":
            jp.reset()
            tp.reset()
        elif step.startswith("restore"):
            jp.restore(int(step[7:]))
            tp.restore(int(step[7:]))
        else:
            s = s1 if step == "f1" else s2
            ts = twrt.SamplingParams(**dataclasses.asdict(s))
            assert dataclasses.asdict(tp.next_frame(ts)) == dataclasses.asdict(jp.next_frame(s))
        assert tp.accumulated_samples() == jp.accumulated_samples()


def test_params_validation_matches():
    cam = tscenes.three_spheres_camera()
    for bad in (dict(sampling=twrt.SamplingParams(max_samples_per_pixel=7,
                                                  num_samples_per_pixel=2)),
                dict(viewport_size=(0, 10)),
                dict(sky=twrt.SkyParams(turbidity=11.0))):
        with pytest.raises(twrt.RenderParamsValidationError):
            twrt.RenderParams(camera=cam, **bad).validate()
    twrt.RenderParams(camera=cam).validate()


def test_tonemap_matches():
    rs = np.random.RandomState(2)
    x = (rs.rand(64, 48, 3) * rs.choice([0.1, 1.0, 20.0], (64, 48, 1))).astype(np.float32)
    ref = np.asarray(jtonemap.to_srgb_u8(jnp.asarray(x))).astype(np.int32)
    got = ttonemap.to_srgb_u8(torch.from_numpy(x)).numpy().astype(np.int32)
    assert np.abs(ref - got).max() <= 1  # last-ulp pow differences may round
    assert (ref != got).mean() < 1e-3
    np.testing.assert_allclose(ttonemap.uncharted2(torch.from_numpy(x)).numpy(),
                               np.asarray(jtonemap.uncharted2(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


def test_image_writers_match(tmp_path):
    rs = np.random.RandomState(1)
    img = rs.randint(0, 256, (9, 13, 3)).astype(np.uint8)
    for writer, ext in (("save_png", "png"), ("save_ppm", "ppm")):
        getattr(jimage, writer)(str(tmp_path / f"j.{ext}"), img)
        getattr(timage, writer)(str(tmp_path / f"t.{ext}"), img)
        assert (tmp_path / f"j.{ext}").read_bytes() == (tmp_path / f"t.{ext}").read_bytes()
