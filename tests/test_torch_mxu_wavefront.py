"""The MXU chunk sweep's wavefront twins against the JAX package's
``render_image_wavefront(..., mxu_sweep=True)``, on the CPU.

As tests/test_torch_mxu_images.py for regroup and the megakernel: the JAX
kernels in Pallas interpret mode, RTiOW 48x24, 4 frames of 2 spp, 6
bounces, one cut at 2 (so that K1 runs too), the port's twins on
``megakernel._closest_hit_mxu``; the images at the port's statistical
gates, and the port's MXU image against its FMA one as the JAX test holds
the JAX ones. On the CPU the wavefront's twins trace regroup's batches, so
with the knob on too the two give the same bits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from weekend_raytracer_tpu.models import scenes as jscenes  # noqa: E402
from weekend_raytracer_tpu.models.camera import CameraBasis as JBasis  # noqa: E402
from weekend_raytracer_tpu.models.sky import SkyParams as JSkyParams  # noqa: E402
from weekend_raytracer_tpu.models.sky import to_sky_state as j_to_sky_state  # noqa: E402
from weekend_raytracer_tpu.ops.pallas import wavefront as jwf  # noqa: E402
from weekend_raytracer_tpu.ops.tonemap import to_srgb_u8  # noqa: E402
from weekend_raytracer_tpu_torch.models.camera import CameraBasis  # noqa: E402
from weekend_raytracer_tpu_torch.models.sky import SkyState  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import regroup as rg  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import wavefront as wf  # noqa: E402
from weekend_raytracer_tpu_torch.ops.tracer import Scene  # noqa: E402

W, H, FRAMES, SPP, BOUNCES, CUTS = 48, 24, 4, 2, 6, (2,)
_BASIS_FIELDS = ("eye", "horizontal", "vertical", "u", "v", "lens_radius",
                 "lower_left_corner")


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
def images():
    """The JAX MXU image, and the port's wavefront MXU and FMA images and
    its regroup MXU image, [H*W, 3] mean radiance of RTiOW."""
    jscene = jscenes.SCENES["rtiow"][0]().build()
    jsky = j_to_sky_state(JSkyParams())
    jbasis = JBasis.create(jscenes.SCENES["rtiow"][1](), (W, H))
    case = _port(jscene, jsky, jbasis)
    kw = dict(width=W, height=H, spp=SPP, num_bounces=BOUNCES)
    jacc = jnp.zeros((W * H, 3), jnp.float32)
    for f in range(FRAMES):
        jacc = jwf.render_image_wavefront(jacc, jnp.uint32(f), jnp.bool_(f == 0), jscene, jsky,
                                          jbasis, phase_cuts=CUTS, mxu_sweep=True, **kw)
    out = {"jax": np.asarray(jacc) / (FRAMES * SPP)}
    runs = (("mxu", wf.render_image_wavefront, {"phase_cuts": CUTS, "mxu_sweep": True}),
            ("fma", wf.render_image_wavefront, {"phase_cuts": CUTS, "mxu_sweep": False}),
            ("regroup", rg.render_image_regrouped, {"cuts": CUTS, "mxu_sweep": True}))
    for name, fn, extra in runs:
        acc = torch.zeros((W * H, 3))
        for f in range(FRAMES):
            fn(acc, f, f == 0, *case, **kw, **extra)
        out[name] = acc.numpy() / (FRAMES * SPP)
    return out


def _tonemapped(img):
    return np.asarray(to_srgb_u8(jnp.asarray(img.reshape(H, W, 3)))).astype(np.float32) / 255


def test_mxu_twins_meet_the_gates_against_jax(images):
    got, ref = images["mxu"], images["jax"]
    assert np.isfinite(got).all() and got.mean() > 0.01
    rmse = float(np.sqrt(((_tonemapped(got) - _tonemapped(ref)) ** 2).mean()))
    assert rmse < 5e-3, rmse
    assert abs(got.mean() - ref.mean()) / ref.mean() < 1e-3


def test_mxu_twins_keep_the_fma_estimator(images):
    mxu, fma = images["mxu"], images["fma"]
    assert not np.array_equal(mxu, fma)
    assert abs(mxu.mean() - fma.mean()) / fma.mean() < 2e-3
    assert (mxu == fma).mean() > 0.5


def test_mxu_twins_are_regroups(images):
    """The wavefront's twins trace regroup's batches, on the MXU sweep too."""
    assert np.array_equal(images["mxu"], images["regroup"])
