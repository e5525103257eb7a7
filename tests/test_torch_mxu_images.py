"""The MXU chunk sweep's twins against the JAX package's ``mxu_sweep=True``
frames, on the CPU: regroup (K0 and K1) and the megakernel.

The JAX kernels run in Pallas interpret mode, as tests/test_regroup.py runs
them (its ``test_mxu_sweep_statistical_equivalence`` takes 46 s at 96x40 x
4 spp, so the images here are 48x24, 4 frames of 2 spp, 6 bounces: at one
frame of 2 spp the port's FMA twin is as far from the JAX FMA frame,
6.5-7e-3 RMSE, as its MXU twin from the JAX MXU one); the port runs its
plain twins, whose sweep is ``megakernel._closest_hit_mxu``. Both products
are f32-accurate but sum in their own order, so the images are held at the
port's statistical gates (tonemapped RMSE < 5e-3, mean within a relative
1e-3), and the port's MXU image to its own FMA image as the JAX test holds
the JAX ones: mean within 2e-3 relative, more than half of the values
equal. The wavefront's are tests/test_torch_mxu_wavefront.py's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from weekend_raytracer_tpu.models import scenes as jscenes  # noqa: E402
from weekend_raytracer_tpu.models.camera import CameraBasis as JBasis  # noqa: E402
from weekend_raytracer_tpu.models.sky import SkyParams as JSkyParams  # noqa: E402
from weekend_raytracer_tpu.models.sky import to_sky_state as j_to_sky_state  # noqa: E402
from weekend_raytracer_tpu.ops.pallas import megakernel as jmk  # noqa: E402
from weekend_raytracer_tpu.ops.pallas import regroup as jrg  # noqa: E402
from weekend_raytracer_tpu.ops.tonemap import to_srgb_u8  # noqa: E402
from weekend_raytracer_tpu_torch.models.camera import CameraBasis  # noqa: E402
from weekend_raytracer_tpu_torch.models.sky import SkyState  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import megakernel as mk  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import regroup as rg  # noqa: E402
from weekend_raytracer_tpu_torch.ops.tracer import Scene  # noqa: E402

W, H, FRAMES, SPP, BOUNCES, CUTS = 48, 24, 4, 2, 6, (2,)
_BASIS_FIELDS = ("eye", "horizontal", "vertical", "u", "v", "lens_radius",
                 "lower_left_corner")
# backend -> (JAX function, port function, their extra keywords)
_BACKENDS = {
    "regroup": (jrg.render_image_regrouped, rg.render_image_regrouped, {"cuts": CUTS}),
    "pallas": (jmk.render_image_pallas, mk.render_image_megakernel, {}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(jscene, jsky, jbasis):
    """The JAX scene, sky and basis leaves, carried into the port."""
    scene = Scene.from_numpy(
        {k: np.asarray(getattr(jscene.spheres, k))
         for k in ("centers", "radii", "material_idx")},
        {k: np.asarray(getattr(jscene.materials, k))
         for k in ("ids", "tex1", "tex2", "x", "pool", "albedo1", "albedo2")},
        "cpu")
    sky = SkyState.from_numpy(np.asarray(jsky.params), np.asarray(jsky.radiances),
                              np.asarray(jsky.sun_direction), device="cpu")
    basis = CameraBasis.from_numpy(
        *[np.asarray(getattr(jbasis, f)) for f in _BASIS_FIELDS], device="cpu")
    return scene, sky, basis


@pytest.fixture(scope="module")
def frames():
    """Per backend: the JAX MXU image, and the port's MXU and FMA images,
    [H*W, 3] mean radiance of RTiOW over FRAMES frames."""
    jscene = jscenes.SCENES["rtiow"][0]().build()
    jsky = j_to_sky_state(JSkyParams())
    jbasis = JBasis.create(jscenes.SCENES["rtiow"][1](), (W, H))
    case = _port(jscene, jsky, jbasis)
    kw = dict(width=W, height=H, spp=SPP, num_bounces=BOUNCES)
    out = {}
    for backend, (jfn, tfn, extra) in _BACKENDS.items():
        jacc = jnp.zeros((W * H, 3), jnp.float32)
        for f in range(FRAMES):
            jacc = jfn(jacc, jnp.uint32(f), jnp.bool_(f == 0), jscene, jsky, jbasis,
                       mxu_sweep=True, **kw, **extra)
        imgs = {"jax": np.asarray(jacc) / (FRAMES * SPP)}
        for name, mxu in (("mxu", True), ("fma", False)):
            acc = torch.zeros((W * H, 3))
            for f in range(FRAMES):
                tfn(acc, f, f == 0, *case, mxu_sweep=mxu, **kw, **extra)
            imgs[name] = acc.numpy() / (FRAMES * SPP)
        out[backend] = imgs
    return out


def _tonemapped(img):
    return np.asarray(to_srgb_u8(jnp.asarray(img.reshape(H, W, 3)))).astype(np.float32) / 255


@pytest.mark.parametrize("backend", list(_BACKENDS))
def test_mxu_twin_meets_the_gates_against_jax(backend, frames):
    got, ref = frames[backend]["mxu"], frames[backend]["jax"]
    assert np.isfinite(got).all() and got.mean() > 0.01
    rmse = float(np.sqrt(((_tonemapped(got) - _tonemapped(ref)) ** 2).mean()))
    assert rmse < 5e-3, rmse
    assert abs(got.mean() - ref.mean()) / ref.mean() < 1e-3


@pytest.mark.parametrize("backend", list(_BACKENDS))
def test_mxu_twin_keeps_the_fma_estimator(backend, frames):
    """The JAX test's own assertions, on the port's two frames: the MXU
    estimator's mean within 2e-3 of the FMA one's, and most values equal
    (the paths an ulp does not move)."""
    mxu, fma = frames[backend]["mxu"], frames[backend]["fma"]
    assert not np.array_equal(mxu, fma)
    assert abs(mxu.mean() - fma.mean()) / fma.mean() < 2e-3
    assert (mxu == fma).mean() > 0.5


def test_backends_share_the_mxu_estimator(frames):
    """Regroup and the megakernel run the same per-ray body on the same
    samples with the knob on too (the JAX test holds the same of its own)."""
    a, b = frames["regroup"]["mxu"], frames["pallas"]["mxu"]
    assert abs(a.mean() - b.mean()) / b.mean() < 2e-3
    assert (np.abs(a - b) > 1e-6).any(axis=1).mean() < 0.01
