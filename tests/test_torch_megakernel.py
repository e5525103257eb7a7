"""The port's megakernel against the JAX package's fused megakernel.

The plain PyTorch version runs on the CPU against the JAX
``render_image_pallas``, which runs in Pallas interpret mode on the CPU, as
tests/test_pallas.py runs it. The gates are the ones test_pallas.py holds
the JAX fused path to: tonemapped RMSE < 5e-3 and linear mean radiance
within a relative 1e-3 on converged images, and < 1% mismatched pixels on
the deterministic first-hit image. Monte-Carlo paths diverge chaotically
under last-ulp differences (torch and XLA round transcendental functions
differently), so images are compared statistically; every input (scene,
sky, camera basis) is carried across bit for bit with ``from_numpy``.

The wrapper's dispatch is tested here with a stub kernel library; the CUDA
kernel itself is held to the plain version by tests/test_torch_cuda.py,
whose tests need a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from weekend_raytracer_tpu.models import scenes as jscenes  # noqa: E402
from weekend_raytracer_tpu.models.camera import Camera as JCamera  # noqa: E402
from weekend_raytracer_tpu.models.camera import CameraBasis as JBasis  # noqa: E402
from weekend_raytracer_tpu.models.materials import Material as JMaterial  # noqa: E402
from weekend_raytracer_tpu.models.scenes import SceneDesc as JSceneDesc  # noqa: E402
from weekend_raytracer_tpu.models.sky import SkyParams as JSkyParams  # noqa: E402
from weekend_raytracer_tpu.models.sky import SkyState as JSkyState  # noqa: E402
from weekend_raytracer_tpu.models.sky import to_sky_state as j_to_sky_state  # noqa: E402
from weekend_raytracer_tpu.models.spheres import Sphere as JSphere  # noqa: E402
from weekend_raytracer_tpu.ops.pallas import megakernel as jmk  # noqa: E402
from weekend_raytracer_tpu.ops.tonemap import to_srgb_u8  # noqa: E402
from weekend_raytracer_tpu_torch.models.camera import CameraBasis  # noqa: E402
from weekend_raytracer_tpu_torch.models.sky import SkyState  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import megakernel as mk  # noqa: E402
from weekend_raytracer_tpu_torch.ops.tracer import Scene  # noqa: E402

_SPHERE_FIELDS = ("centers", "radii", "material_idx")
_MATERIAL_FIELDS = ("ids", "tex1", "tex2", "x", "pool", "albedo1", "albedo2")
_BASIS_FIELDS = ("eye", "horizontal", "vertical", "u", "v", "lens_radius",
                 "lower_left_corner")


def _port(jscene, jsky, jbasis, device="cpu"):
    """The JAX scene, sky and basis leaves, carried into the port."""
    scene = Scene.from_numpy(
        {k: np.asarray(getattr(jscene.spheres, k)) for k in _SPHERE_FIELDS},
        {k: np.asarray(getattr(jscene.materials, k)) for k in _MATERIAL_FIELDS},
        device)
    sky = SkyState.from_numpy(np.asarray(jsky.params), np.asarray(jsky.radiances),
                              np.asarray(jsky.sun_direction), device=device)
    basis = CameraBasis.from_numpy(
        *[np.asarray(getattr(jbasis, f)) for f in _BASIS_FIELDS], device=device)
    return scene, sky, basis


def _constant_sky(level):
    params = np.zeros((3, 9), np.float32)
    params[:, 2] = 1.0
    return JSkyState.from_raw(params, np.full(3, level), np.array([0.0, 1.0, 0.0]))


def _first_hit_case():
    desc = JSceneDesc(materials=[JMaterial.lambertian((0.3, 0.4, 0.5))],
                      spheres=[JSphere((0.0, 0.0, -3.0), 1.0, 0)])
    cam = JCamera.look_at((0, 0, 1), (0, 0, -3), vfov_degrees=40.0, aperture=0.0)
    return desc, cam, _constant_sky(1.0)


def _emissive_case():
    desc = JSceneDesc(
        materials=[JMaterial.lambertian((0.7, 0.7, 0.7)),
                   JMaterial.emissive((1.0, 0.8, 0.5), intensity=8.0)],
        spheres=[JSphere((0.0, -100.5, 0.0), 100.0, 0),
                 JSphere((0.0, 2.5, 0.0), 1.0, 1)])
    cam = JCamera.look_at((0, 1.5, 5.0), (0, 1.0, 0.0), vfov_degrees=45.0)
    return desc, cam, _constant_sky(0.0)


# name -> (w, h, frames, spp, bounces)
_CASES = {
    "three": (48, 32, 8, 4, 8),
    "rtiow": (48, 32, 8, 4, 8),
    "textured": (40, 24, 8, 4, 6),
    "emissive": (40, 24, 8, 4, 6),
    "first_hit": (64, 48, 1, 1, 1),
}


def _setup(name):
    if name == "first_hit":
        desc, cam, sky = _first_hit_case()
    elif name == "emissive":
        desc, cam, sky = _emissive_case()
    else:
        desc = jscenes.SCENES[name][0]()
        cam = jscenes.SCENES[name][1]()
        sky = j_to_sky_state(JSkyParams())
    w, h = _CASES[name][:2]
    return desc.build(), sky, JBasis.create(cam, (w, h))


def _run_jax(jscene, jsky, jbasis, w, h, frames, spp, bounces):
    acc = jnp.zeros((w * h, 3), jnp.float32)
    for f in range(frames):
        acc = jmk.render_image_pallas(
            acc, jnp.uint32(f), jnp.bool_(f == 0), jscene, jsky, jbasis,
            width=w, height=h, spp=spp, num_bounces=bounces)
    return np.asarray(acc) / (frames * spp)


def _run_port(fn, scene, sky, basis, w, h, frames, spp, bounces, device="cpu"):
    acc = torch.zeros((w * h, 3), dtype=torch.float32, device=device)
    for f in range(frames):
        fn(acc, f, f == 0, scene, sky, basis, width=w, height=h, spp=spp,
           num_bounces=bounces)
    return acc.cpu().numpy() / (frames * spp)


@pytest.fixture(scope="module")
def jax_reference():
    """Each case's JAX image, computed once per module (interpret mode)."""
    cache = {}

    def get(name):
        if name not in cache:
            jscene, jsky, jbasis = _setup(name)
            cache[name] = (_run_jax(jscene, jsky, jbasis, *_CASES[name]),
                           _port(jscene, jsky, jbasis))
        return cache[name]

    return get


def _tonemapped(img, w, h):
    return np.asarray(to_srgb_u8(img.reshape(h, w, 3))).astype(np.float32) / 255


def _assert_statistically_equal(a, b, w, h):
    rmse = float(np.sqrt(((_tonemapped(a, w, h) - _tonemapped(b, w, h)) ** 2).mean()))
    assert rmse < 5e-3, rmse
    assert abs(a.mean() - b.mean()) / max(a.mean(), 1e-6) < 1e-3


@pytest.mark.parametrize("name", ["three", "rtiow", "textured", "emissive"])
def test_statistical_equivalence(name, jax_reference):
    ref, (scene, sky, basis) = jax_reference(name)
    w, h = _CASES[name][:2]
    got = _run_port(mk.render_image_megakernel, scene, sky, basis, *_CASES[name])
    assert np.isfinite(got).all()
    assert got.mean() > 0.01
    _assert_statistically_equal(ref, got, w, h)


def test_first_hit_geometry_identical(jax_reference):
    """1 bounce, constant sky, no lens: each pixel is a binary hit/miss;
    only sub-ulp silhouette pixels may differ."""
    ref, (scene, sky, basis) = jax_reference("first_hit")
    got = _run_port(mk.render_image_megakernel, scene, sky, basis,
                    *_CASES["first_hit"])
    mismatch = (np.abs(ref - got) > 1e-6).any(axis=-1).mean()
    assert mismatch < 0.01, mismatch


def _three(w, h):
    jscene, jsky, jbasis = (jscenes.three_spheres().build(),
                            j_to_sky_state(JSkyParams()),
                            JBasis.create(jscenes.three_spheres_camera(), (w, h)))
    return _port(jscene, jsky, jbasis)


def test_accumulation_and_clear_semantics():
    w, h = 32, 16
    scene, sky, basis = _three(w, h)
    acc = torch.full((w * h, 3), 7.0)  # stale data
    kw = dict(width=w, height=h, spp=1, num_bounces=2)
    out1 = mk.render_image_megakernel(acc, 0, True, scene, sky, basis, **kw)
    assert out1 is acc  # accumulates in place
    first = acc.clone()
    assert float(first.min()) < 1.0  # clear=True discarded the stale 7.0
    mk.render_image_megakernel(acc, 1, False, scene, sky, basis, **kw)
    assert float(acc.mean()) > float(first.mean())  # additive
    again = torch.zeros_like(acc)
    mk.render_image_megakernel(again, 1, True, scene, sky, basis, **kw)
    torch.testing.assert_close(acc - first, again, rtol=0, atol=1e-6)


def test_non_tile_multiple_size(jax_reference):
    """30 x 17 (510 pixels, no multiple of any block) against the JAX kernel
    at the same size."""
    w, h = 30, 17
    jscene = jscenes.single_sphere().build()
    jsky = j_to_sky_state(JSkyParams())
    jbasis = JBasis.create(jscenes.single_sphere_camera(), (w, h))
    ref = _run_jax(jscene, jsky, jbasis, w, h, 2, 4, 4)
    got = _run_port(mk.render_image_megakernel, *_port(jscene, jsky, jbasis),
                    w, h, 2, 4, 4)
    assert got.shape == (w * h, 3)
    assert np.isfinite(got).all()
    _assert_statistically_equal(ref, got, w, h)


def test_row_band_reproduces_full_image():
    """A band rendered at a global row offset seeds and aims in full-image
    coordinates, so it equals the same rows of the full render."""
    w, h = 24, 16
    scene, sky, basis = _three(w, h)
    kw = dict(width=w, spp=2, num_bounces=4)
    full = torch.zeros((w * h, 3))
    mk.render_image_megakernel(full, 3, True, scene, sky, basis, height=h, **kw)
    band = torch.zeros((w * 6, 3))
    mk.render_image_megakernel(band, 3, True, scene, sky, basis, height=6,
                               row_offset=5, full_height=h, **kw)
    torch.testing.assert_close(band, full[5 * w:11 * w], rtol=0, atol=0)


@pytest.mark.parametrize("knob,value", [
    ("tsub", 16), ("block_w", 32), ("subcull", 8),
    ("listed", True), ("mxu_sweep", True)])
def test_tpu_only_knobs_raise(knob, value):
    w, h = 8, 8
    scene, sky, basis = _three(w, h)
    acc = torch.zeros((w * h, 3))
    with pytest.raises(NotImplementedError, match=knob):
        mk.render_image_megakernel(acc, 0, True, scene, sky, basis, width=w,
                                   height=h, spp=1, num_bounces=1,
                                   **{knob: value})


def test_bad_accumulator_raises():
    w, h = 8, 8
    scene, sky, basis = _three(w, h)
    kw = dict(width=w, height=h, spp=1, num_bounces=1)
    with pytest.raises(ValueError):
        mk.render_image_megakernel(torch.zeros((w * h, 4)), 0, True, scene,
                                   sky, basis, **kw)
    with pytest.raises(ValueError):
        mk.render_image_megakernel(torch.zeros((w * h, 3), dtype=torch.float64),
                                   0, True, scene, sky, basis, **kw)


def test_approx_trig_matches_jax():
    """The polynomial acos/atan2 agree with the JAX kernel's to one f32
    ulp at pi (torch and XLA may round a sqrt argument differently)."""
    ulp_pi = float(np.spacing(np.float32(np.pi)))
    x = np.linspace(-1.0, 1.0, 4001, dtype=np.float32)
    got = mk.acos_approx(torch.from_numpy(x)).numpy()
    ref = np.asarray(jmk.acos_approx(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ulp_pi)
    rs = np.random.RandomState(3)
    y, xx = (rs.randn(2, 4096) * 3).astype(np.float32)
    got = mk.atan2_approx(torch.from_numpy(y), torch.from_numpy(xx)).numpy()
    ref = np.asarray(jmk.atan2_approx(jnp.asarray(y), jnp.asarray(xx)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ulp_pi)


class _StubLaunch:
    """Stands in for the built library's C launch function."""

    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


def _stubbed_wrapper(monkeypatch, rc=0):
    """Make the wrapper treat CPU tensors as CUDA ones and launch a stub;
    the plain version must then never run."""
    launch = _StubLaunch(rc)

    class _Lib:
        wrt_megakernel_launch = launch

    class _Built:
        lib = _Lib()

    monkeypatch.setattr(mk, "_device_type", lambda t: "cuda")
    monkeypatch.setattr(mk, "_library", lambda: _Built())
    monkeypatch.setattr(mk, "_stream_handle", lambda device: 1234)

    def _no_plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(mk, "render_image_megakernel_plain", _no_plain)
    return launch


def test_wrapper_launches_kernel_for_cuda_tensor(monkeypatch):
    w, h = 20, 12
    scene, sky, basis = _three(w, h)
    launch = _stubbed_wrapper(monkeypatch)
    acc = torch.zeros((w * h, 3))
    before = mk.render_image_megakernel.launches
    out = mk.render_image_megakernel(acc, 5, True, scene, sky, basis, width=w,
                                     height=h, spp=3, num_bounces=7)
    assert out is acc
    assert mk.render_image_megakernel.launches == before + 1
    assert len(launch.calls) == 1
    args = launch.calls[0]
    assert args[5] == acc.data_ptr()
    assert args[6] == 5  # spheres of the three-sphere scene, unpadded
    assert args[7:9] == (w, h)
    assert args[9] == pytest.approx(1.0 / w) and args[10] == pytest.approx(1.0 / h)
    assert args[11:] == (5, 0, 1, 3, 7, 1234)
    assert args[4] is None  # no image textures


def test_wrapper_raises_on_launch_error(monkeypatch):
    w, h = 8, 8
    scene, sky, basis = _three(w, h)
    _stubbed_wrapper(monkeypatch, rc=700)
    before = mk.render_image_megakernel.launches
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        mk.render_image_megakernel(torch.zeros((w * h, 3)), 0, True, scene,
                                   sky, basis, width=w, height=h, spp=1,
                                   num_bounces=1)
    assert mk.render_image_megakernel.launches == before
