"""The port's ``"xla"`` backend against the JAX package's XLA tracer.

Module by module (intersect, hit_record, texture_lookup, scatter,
sky_radiance, make_rays) on the same arrays, made with numpy from a seed;
then the frame (``render_image``) on three scenes, the batching
invariances, the port's NumPy oracle against the JAX package's oracle in
every bit, the xla backend against the port's oracle, and the Renderer
against the JAX Renderer. Images are held at tests/test_tracer.py's gate:
Monte-Carlo paths fork at silhouettes under last-ulp differences between
XLA:CPU and PyTorch, so most pixels must agree to float precision and the
rest are only bounded.
"""
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import weekend_raytracer_tpu as jwrt  # noqa: E402
from weekend_raytracer_tpu.models import scenes as jscenes  # noqa: E402
from weekend_raytracer_tpu.models.camera import CameraBasis as JBasis  # noqa: E402
from weekend_raytracer_tpu.models.camera import make_rays as j_make_rays  # noqa: E402
from weekend_raytracer_tpu.models.materials import Material as JMaterial  # noqa: E402
from weekend_raytracer_tpu.models.materials import MaterialTable as JTable  # noqa: E402
from weekend_raytracer_tpu.models.sky import SkyParams as JSkyParams  # noqa: E402
from weekend_raytracer_tpu.models.sky import to_sky_state as j_to_sky_state  # noqa: E402
from weekend_raytracer_tpu.models.spheres import SphereSoA as JSoA  # noqa: E402
from weekend_raytracer_tpu.ops import intersect as jint  # noqa: E402
from weekend_raytracer_tpu.ops import scatter as jsc  # noqa: E402
from weekend_raytracer_tpu.ops.sky_radiance import sky_radiance as j_sky_radiance  # noqa: E402
from weekend_raytracer_tpu.ops.tonemap import to_srgb_u8  # noqa: E402
from weekend_raytracer_tpu.ops.tracer import render_image as j_render_image  # noqa: E402
from weekend_raytracer_tpu.reference import OracleTracer as JOracle  # noqa: E402
import weekend_raytracer_tpu_torch as twrt  # noqa: E402
from weekend_raytracer_tpu_torch import renderer as trenderer  # noqa: E402
from weekend_raytracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from weekend_raytracer_tpu_torch.models.camera import CameraBasis, make_rays  # noqa: E402
from weekend_raytracer_tpu_torch.models.materials import MaterialTable  # noqa: E402
from weekend_raytracer_tpu_torch.models.sky import SkyState  # noqa: E402
from weekend_raytracer_tpu_torch.models.spheres import SphereSoA  # noqa: E402
from weekend_raytracer_tpu_torch.ops import intersect as tint  # noqa: E402
from weekend_raytracer_tpu_torch.ops import scatter as tsc  # noqa: E402
from weekend_raytracer_tpu_torch.ops.sky_radiance import sky_radiance  # noqa: E402
from weekend_raytracer_tpu_torch.ops.tracer import Scene, render_image  # noqa: E402
from weekend_raytracer_tpu_torch.reference import OracleTracer  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_MATERIAL_FIELDS = ("ids", "tex1", "tex2", "x", "pool", "albedo1", "albedo2")
_BASIS_FIELDS = ("eye", "horizontal", "vertical", "u", "v", "lens_radius",
                 "lower_left_corner")
# the frame: tests/test_pallas.py's statistical-equivalence shape, two frames
_FRAME = dict(w=48, h=32, spp=4, bounces=8, frames=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors gain nothing from intra-op threads, and beside the
    other test workers those threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a, dtype=dtype))


def _table(jtable):
    return MaterialTable.from_numpy(
        *[np.asarray(getattr(jtable, f)) for f in _MATERIAL_FIELDS], device="cpu")


def _port(jscene, jsky, jbasis):
    """The JAX scene, sky and basis leaves, carried into the port."""
    sp = jscene.spheres
    scene = Scene(spheres=SphereSoA.from_numpy(np.asarray(sp.centers), np.asarray(sp.radii),
                                               np.asarray(sp.material_idx), device="cpu"),
                  materials=_table(jscene.materials))
    sky = SkyState.from_numpy(np.asarray(jsky.params), np.asarray(jsky.radiances),
                              np.asarray(jsky.sun_direction), device="cpu")
    basis = CameraBasis.from_numpy(*[np.asarray(getattr(jbasis, f)) for f in _BASIS_FIELDS],
                                   device="cpu")
    return scene, sky, basis


def _unit(rs, n):
    d = rs.randn(n, 3).astype(np.float32)
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


# --- intersect and hit_record ---------------------------------------------

def _intersect_case(name):
    """(centers, radii, o, d, chunk) of tests/test_ops.py's cases, plus
    ties: a sphere repeated inside one chunk and across chunks."""
    z = np.zeros((1, 3), np.float32)
    fwd = np.array([[0.0, 0.0, -1.0]], np.float32)
    if name == "head_on":
        return [[0, 0, -5]], [1.0], z, fwd, 512
    if name == "many":
        return [[0, 0, -10], [0, 0, -3], [0, 0, -20]], [1.0, 0.5, 3.0], z, fwd, 512
    if name == "miss":
        return [[0, 10, -5]], [1.0], z, fwd, 512
    if name == "inside":
        return [[0, 0, 0]], [2.0], z, fwd, 512
    rs = np.random.RandomState(0)
    centers = rs.randn(100, 3) * 5
    radii = rs.rand(100) + 0.2
    o = (rs.randn(256, 3) * 3).astype(np.float32)
    d = _unit(rs, 256)
    if name.startswith("ties"):
        # sphere 3 repeated at 7 (same chunk of 16) and at 40 (a later chunk)
        centers[7] = centers[40] = centers[3]
        radii[7] = radii[40] = radii[3]
        o[:64] = o[0]
        d[:64] = ((centers[3] - o[0]) / np.linalg.norm(centers[3] - o[0])).astype(np.float32)
    chunk = 16 if name.endswith("16") else 512
    return centers, radii, o, d, chunk


@pytest.mark.parametrize("name", ["head_on", "many", "miss", "inside", "chunked512",
                                  "chunked16", "ties512", "ties16"])
def test_intersect_matches_jax(name):
    centers, radii, o, d, chunk = _intersect_case(name)
    centers = np.asarray(centers, np.float32)
    radii = np.asarray(radii, np.float32)
    mats = np.zeros(len(radii), np.int32)
    jt, ji, jh = jint.intersect(jnp.asarray(o), jnp.asarray(d),
                                JSoA(jnp.asarray(centers), jnp.asarray(radii),
                                     jnp.asarray(mats)), chunk_size=chunk)
    soa = SphereSoA.from_numpy(centers, radii, mats, device="cpu")
    tt, ti, th = tint.intersect(_t(o), _t(d), soa, chunk_size=chunk)
    assert ti.dtype == torch.int32 and th.dtype == torch.bool
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if name == "miss":
        assert not th[0] and float(tt[0]) == tint.MAX_T and int(ti[0]) == 0
    if name.startswith("ties"):
        assert (ti[:64] == 3).all()  # the first of equal spheres wins
    if name in ("head_on", "inside"):
        assert float(tt[0]) == pytest.approx(4.0 if name == "head_on" else 2.0, rel=1e-5)


def test_hit_record_matches_jax():
    """p and n within a relative 1e-6, u and v (acos and atan2 of the
    normal) within 1e-6, on a hundred spheres, every seventh with a
    negative radius, for hits and misses alike."""
    centers, radii, o, d, _ = _intersect_case("chunked512")
    centers = centers.astype(np.float32)
    radii = radii.astype(np.float32)
    radii[::7] *= -1
    mats = np.zeros(len(radii), np.int32)
    jsoa = JSoA(jnp.asarray(centers), jnp.asarray(radii), jnp.asarray(mats))
    jt, ji, jh = jint.intersect(jnp.asarray(o), jnp.asarray(d), jsoa)
    assert 0.2 < float(np.asarray(jh).mean()) < 0.8
    want = [np.asarray(a) for a in jint.hit_record(jnp.asarray(o), jnp.asarray(d), jt, ji,
                                                   jsoa)]
    soa = SphereSoA.from_numpy(centers, radii, mats, device="cpu")
    got = [a.numpy() for a in tint.hit_record(_t(o), _t(d), _t(np.asarray(jt)),
                                              _t(np.asarray(ji)), soa)]
    for g, w, tol in zip(got, want, (dict(rtol=1e-6, atol=0), dict(rtol=1e-6, atol=0),
                                     dict(rtol=0, atol=1e-6), dict(rtol=0, atol=1e-6))):
        np.testing.assert_allclose(g, w, **tol)


# --- texture_lookup, scatter ------------------------------------------------

def test_texture_lookup_bit_for_bit():
    """Full-resolution nearest-texel lookups into the textured scene's pool
    (the procedural 512x256 earth and moon), at random and edge UVs."""
    jtable = JTable.build(jscenes.textured_spheres().materials)
    table = _table(jtable)
    rs = np.random.RandomState(3)
    n = 4096
    desc = np.asarray(jtable.tex1)[rs.randint(0, len(jtable.ids), n)]
    u = rs.rand(n).astype(np.float32)
    v = rs.rand(n).astype(np.float32)
    u[:8] = [0.0, 1.0, -0.1, 1.1, 0.5, 0.999999, 1e-7, 0.25]
    v[:8] = [1.0, 0.0, 1.1, -0.1, 0.999999, 0.5, 0.75, 1e-7]
    want = np.asarray(jsc.texture_lookup(jnp.asarray(desc), jnp.asarray(u), jnp.asarray(v),
                                         jnp.asarray(jtable.pool)))
    got = tsc.texture_lookup(_t(desc), _t(u), _t(v), table.pool).numpy()
    np.testing.assert_array_equal(got, want)


_S2 = 1 / math.sqrt(2)
# tests/test_ops.py's scatter cases: material, d, n, p, draws
_SCATTER_CASES = {
    "lambertian": (JMaterial.lambertian((0.5, 0.25, 0.125)), (0, 0, -1), (0, 0, 1),
                   (0, 0, 0), (0.1, 0.2, 0.3, 0.9)),
    "metal_mirror": (JMaterial.metal((0.9, 0.9, 0.9), fuzz=0.0), (_S2, -_S2, 0), (0, 1, 0),
                     (0, 0, 0), (0.1, 0.2, 0.3, 0.9)),
    "metal_fuzz": (JMaterial.metal((0.8, 0.6, 0.2), fuzz=0.3), (_S2, -_S2, 0), (0, 1, 0),
                   (0, 0, 0), (0.1, 0.2, 0.3, 0.9)),
    "dielectric_refract": (JMaterial.dielectric(1.5), (_S2, -_S2, 0), (0, 1, 0), (0, 0, 0),
                           (0.1, 0.2, 0.3, 0.999)),
    "dielectric_tir": (JMaterial.dielectric(1.5),
                       (math.sin(math.radians(80.0)), math.cos(math.radians(80.0)), 0.0),
                       (0, 1, 0), (0, 0, 0), (0.1, 0.2, 0.3, 0.999)),
    "dielectric_schlick": (JMaterial.dielectric(1.5), (_S2, -_S2, 0), (0, 1, 0), (0, 0, 0),
                           (0.1, 0.2, 0.3, 0.0)),
    "checker_odd": (JMaterial.checkerboard((1.0, 0.0, 0.0), (0.0, 1.0, 0.0)), (0, -1, 0),
                    (0, 1, 0), (0.9, 0.9, 0.9), (0.1, 0.2, 0.3, 0.9)),
    "checker_even": (JMaterial.checkerboard((1.0, 0.0, 0.0), (0.0, 1.0, 0.0)), (0, -1, 0),
                     (0, 1, 0), (0.3, 0.3, 0.3), (0.1, 0.2, 0.3, 0.9)),
    "emissive": (JMaterial.emissive((1.0, 0.5, 0.25), intensity=6.0), (0, 0, -1), (0, 0, 1),
                 (0, 0, 0), (0.1, 0.2, 0.3, 0.4)),
    "unknown_pink": (None, (0, 0, -1), (0, 0, 1), (0, 0, 0), (0.1, 0.2, 0.3, 0.4)),
}


def _scatter_both(jtable, d, n, p, u, v, mat, rands):
    jout = jsc.scatter(jnp.asarray(d), jnp.asarray(n), jnp.asarray(p), jnp.asarray(u),
                       jnp.asarray(v), jnp.asarray(mat), jtable,
                       tuple(jnp.asarray(r) for r in rands))
    tout = tsc.scatter(_t(d), _t(n), _t(p), _t(u), _t(v), _t(mat), _table(jtable),
                       tuple(_t(r) for r in rands))
    return jout, tout


def _assert_scatter_close(jout, tout):
    np.testing.assert_allclose(tout.direction.numpy(), np.asarray(jout.direction),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(tout.albedo.numpy(), np.asarray(jout.albedo),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tout.emission.numpy(), np.asarray(jout.emission),
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tout.terminate.numpy(), np.asarray(jout.terminate))


@pytest.mark.parametrize("name", list(_SCATTER_CASES))
def test_scatter_matches_jax_per_material(name):
    """One lane per case with fixed draws: direction within 2e-6, albedo
    within a relative 1e-6, emission too, terminate equal."""
    mat, d, n, p, rands = _SCATTER_CASES[name]
    jtable = JTable.build([mat or JMaterial.lambertian((1, 1, 1))])
    if mat is None:  # an unknown material id renders pink
        jtable = jtable.tree_unflatten(jtable.tree_flatten()[1], (
            jnp.array([7], dtype=jnp.int32), jtable.tex1, jtable.tex2, jtable.x,
            jtable.pool, jtable.albedo1, jtable.albedo2))
    arr = lambda x: np.asarray([x], np.float32)  # noqa: E731
    jout, tout = _scatter_both(jtable, arr(d), arr(n), arr(p), arr(0.5), arr(0.5),
                               np.zeros(1, np.int32), [arr(r) for r in rands])
    _assert_scatter_close(jout, tout)
    if name == "unknown_pink":
        np.testing.assert_allclose(tout.albedo[0].numpy(), [0.9921, 0.24705, 0.57254],
                                   rtol=1e-6)


def test_scatter_matches_jax_on_random_lanes():
    """4096 lanes over a table that holds every material (image textures
    among them), random normals, directions, points, UVs and draws."""
    desc = jscenes.textured_spheres()
    mats = list(desc.materials) + [
        JMaterial.metal((0.8, 0.6, 0.2), fuzz=0.3), JMaterial.dielectric(1.5),
        JMaterial.checkerboard((0.2, 0.3, 0.1), (0.9, 0.9, 0.9)),
        JMaterial.emissive((1.0, 0.8, 0.5), intensity=4.0)]
    jtable = JTable.build(mats)
    rs = np.random.RandomState(5)
    n = 4096
    nrm = _unit(rs, n)
    d = _unit(rs, n)
    p = (rs.randn(n, 3) * 2).astype(np.float32)
    u, v = rs.rand(n).astype(np.float32), rs.rand(n).astype(np.float32)
    mat = rs.randint(0, len(mats), n).astype(np.int32)
    rands = [rs.rand(n).astype(np.float32) for _ in range(4)]
    jout, tout = _scatter_both(jtable, d, nrm, p, u, v, mat, rands)
    _assert_scatter_close(jout, tout)
    assert tout.terminate.any() and not tout.terminate.all()


# --- sky_radiance, make_rays ------------------------------------------------

@pytest.mark.parametrize("sky", [JSkyParams(), JSkyParams(azimuth_degrees=120.0,
                                                          zenith_degrees=45.0,
                                                          turbidity=7.0)])
def test_sky_radiance_matches_jax(sky):
    jsky = j_to_sky_state(sky)
    tsky = SkyState.from_numpy(np.asarray(jsky.params), np.asarray(jsky.radiances),
                               np.asarray(jsky.sun_direction), device="cpu")
    d = _unit(np.random.RandomState(7), 8192)
    want = np.asarray(j_sky_radiance(jnp.asarray(d), jsky))
    got = sky_radiance(_t(d), tsky).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("name", ["rtiow", "three"])
def test_make_rays_matches_jax(name):
    """Thin-lens rays (RTiOW's camera has an aperture) within 1e-6."""
    jbasis = JBasis.create(jscenes.SCENES[name][1](), (64, 36))
    basis = CameraBasis.from_numpy(*[np.asarray(getattr(jbasis, f)) for f in _BASIS_FIELDS],
                                   device="cpu")
    rs = np.random.RandomState(11)
    su, sv, dr, da = (rs.rand(4096).astype(np.float32) for _ in range(4))
    jo, jd = j_make_rays(jbasis, *(jnp.asarray(a) for a in (su, sv, dr, da)))
    o, d = make_rays(basis, *(_t(a) for a in (su, sv, dr, da)))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)


# --- the frame ----------------------------------------------------------------

def _rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)))


def _assert_oracle_match(got, want, close_frac=0.98):
    """tests/test_tracer.py's gate: the overwhelming majority of pixels
    agree to float precision; the forked rest are bounded."""
    close = np.isclose(got, want, rtol=1e-2, atol=1e-3).all(axis=-1)
    assert close.mean() > close_frac, close.mean()
    assert _rmse(got[close], want[close]) < 1e-4


def _jax_case(name, w, h):
    return (jscenes.SCENES[name][0]().build(), j_to_sky_state(JSkyParams()),
            JBasis.create(jscenes.SCENES[name][1](), (w, h)))


@pytest.fixture(scope="module")
def jax_frames():
    """Per scene, two frames of _FRAME, computed once: the JAX render_image,
    and the JAX package's NumPy oracle on the same frames."""
    f = _FRAME
    out = {}
    for name in ("three", "rtiow", "textured"):
        scene, sky, basis = _jax_case(name, f["w"], f["h"])
        acc = jnp.zeros((f["w"] * f["h"], 3), jnp.float32)
        for fr in range(f["frames"]):
            acc = j_render_image(acc, jnp.uint32(fr), jnp.bool_(fr == 0), scene, sky, basis,
                                 f["w"], f["h"], f["spp"], f["bounces"])
        oracle = JOracle(jscenes.SCENES[name][0](), jscenes.SCENES[name][1](), f["w"], f["h"])
        orc = sum(oracle.render(f["spp"], f["bounces"], frame=fr) for fr in range(f["frames"]))
        n = f["frames"] * f["spp"]
        out[name] = np.asarray(acc) / n, orc.reshape(-1, 3) / n
    return out


def _port_frames(name, pixel_batch=None, sphere_chunk=512, frames=None, spp=None):
    f = _FRAME
    scene, sky, basis = _port(*_jax_case(name, f["w"], f["h"]))
    frames = frames or f["frames"]
    spp = spp or f["spp"]
    acc = torch.full((f["w"] * f["h"], 3), 7.0)  # clear must drop this
    for fr in range(frames):
        out = render_image(acc, fr, fr == 0, scene, sky, basis, f["w"], f["h"], spp,
                           f["bounces"], pixel_batch=pixel_batch, sphere_chunk=sphere_chunk)
        assert out is acc
    return acc.numpy() / (frames * spp)


def _close_rmse(got, want):
    close = np.isclose(got, want, rtol=1e-2, atol=1e-3).all(axis=-1)
    return close.mean(), _rmse(got[close], want[close])


@pytest.mark.parametrize("name", ["three", "rtiow", "textured"])
def test_render_image_matches_jax(name, jax_frames):
    """Two frames against the JAX render_image. The close share must pass
    tests/test_tracer.py's 0.98, and the frame tests/test_pallas.py's
    statistical gates (tonemapped RMSE < 5e-3, mean within a relative
    1e-3). The RMSE on the close pixels must pass test_tracer.py's 1e-4, or
    where even the JAX package's XLA path is further than that from its
    own NumPy oracle on the same frame (RTiOW's glass at 8 bounces: 5.5e-4;
    textured: 1.1e-4), come within 1.25 times that distance."""
    want, oracle = jax_frames[name]
    got = _port_frames(name)
    assert np.isfinite(got).all()
    share, rmse = _close_rmse(got, want)
    assert share > 0.98, share
    assert rmse < max(1e-4, 1.25 * _close_rmse(want, oracle)[1]), rmse
    f = _FRAME
    tm = [np.asarray(to_srgb_u8(jnp.asarray(a.reshape(f["h"], f["w"], 3)))).astype(np.float32)
          / 255 for a in (got, want)]
    assert _rmse(*tm) < 5e-3
    assert abs(got.mean() - want.mean()) / want.mean() < 1e-3


def test_pixel_batching_invariant():
    """Batches of 128 and of 100 (a ragged last batch) give the whole
    image's bits: each lane's arithmetic is its own."""
    full = _port_frames("three", frames=1, spp=2)
    for batch in (128, 100):
        np.testing.assert_array_equal(_port_frames("three", pixel_batch=batch, frames=1,
                                                   spp=2), full)


def test_sphere_chunking_invariant():
    """RTiOW's 486 spheres in one chunk, and in chunks of 64 (the last one
    padded with unhittable spheres), hit the same spheres."""
    a = _port_frames("rtiow", frames=1, spp=1)
    b = _port_frames("rtiow", sphere_chunk=64, frames=1, spp=1)
    np.testing.assert_array_equal(a, b)


# --- the oracle -----------------------------------------------------------------

_ORACLE_CASES = {"single": (16, 12, 2, 4), "three": (16, 12, 2, 4),
                 "textured": (16, 10, 2, 4)}


@pytest.mark.parametrize("name", list(_ORACLE_CASES))
def test_oracle_equals_jax_oracle_in_every_bit(name):
    w, h, spp, bounces = _ORACLE_CASES[name]
    want = JOracle(jscenes.SCENES[name][0](), jscenes.SCENES[name][1](), w, h)
    got = OracleTracer(tscenes.SCENES[name][0](), tscenes.SCENES[name][1](), w, h)
    np.testing.assert_array_equal(got.render(spp, bounces, frame=3),
                                  want.render(spp, bounces, frame=3))


@pytest.mark.parametrize("name,w,h,spp,bounces", [("single", 40, 24, 4, 6),
                                                  ("three", 40, 24, 4, 6),
                                                  ("textured", 32, 18, 2, 4)])
def test_xla_backend_matches_port_oracle(name, w, h, spp, bounces):
    """tests/test_tracer.py's oracle parity, on the port: render_pixels
    through the Renderer's xla path against the port's own oracle."""
    desc, cam = tscenes.SCENES[name][0](), tscenes.SCENES[name][1]()
    params = twrt.RenderParams(camera=cam, viewport_size=(w, h),
                               sampling=twrt.SamplingParams(max_samples_per_pixel=spp,
                                                            num_samples_per_pixel=spp,
                                                            num_bounces=bounces))
    r = twrt.Renderer(desc, params, backend="xla", device="cpu")
    assert r.render_frame()
    got = r.mean_radiance().numpy()
    want = OracleTracer(desc, cam, w, h).render(spp, bounces) / spp
    _assert_oracle_match(got, want)


# --- the Renderer -----------------------------------------------------------------

def _params(pkg, scenes, name, size=(32, 18), max_spp=8, spp=2, bounces=6):
    return pkg.RenderParams(camera=scenes.SCENES[name][1](), viewport_size=size,
                            sampling=pkg.SamplingParams(max_samples_per_pixel=max_spp,
                                                        num_samples_per_pixel=spp,
                                                        num_bounces=bounces))


@pytest.mark.parametrize("name", ["three", "textured"])
def test_renderer_xla_matches_jax_renderer(name, monkeypatch):
    """Renderer(backend="xla") on the CPU against the JAX Renderer's xla
    backend through render(): four frames of 2 spp; it runs no fused
    backend's function."""
    def _refuse(*a, **k):
        raise AssertionError("the xla backend ran a fused backend")

    for fn in ("render_image_megakernel", "render_image_regrouped", "render_image_wavefront"):
        monkeypatch.setattr(trenderer, fn, _refuse)
    jr = jwrt.Renderer(jscenes.SCENES[name][0](), _params(jwrt, jscenes, name), backend="xla")
    js = jr.render()
    tr = twrt.Renderer(tscenes.SCENES[name][0](), _params(twrt, tscenes, name),
                       backend="xla", device="cpu")
    ts = tr.render()
    assert jr.backend == tr.backend == "xla"
    assert (ts.frames, ts.samples_per_pixel, ts.rays) == (js.frames, js.samples_per_pixel,
                                                          js.rays)
    _assert_oracle_match(tr.mean_radiance().numpy(), np.asarray(jr.mean_radiance()))


@pytest.mark.parametrize("spp,bounces", [(2, 4), (3, 4), (4, 1), (128, 8), (6, 2)])
def test_auto_never_picks_xla(spp, bounces, monkeypatch):
    """'auto' resolves as in the JAX package, to regroup or the megakernel,
    never to xla, and its frame runs no xla function."""
    def _no_xla(*a, **k):
        raise AssertionError("'auto' ran the xla tracer")

    monkeypatch.setattr(trenderer, "render_image", _no_xla)
    params = _params(twrt, tscenes, "three", size=(8, 4), max_spp=spp, spp=spp,
                     bounces=bounces)
    r = twrt.Renderer(tscenes.three_spheres(), params, device="cpu")
    jr = jwrt.Renderer(jscenes.three_spheres(), _params(jwrt, jscenes, "three", size=(8, 4),
                                                        max_spp=spp, spp=spp,
                                                        bounces=bounces))
    assert r.backend == jr.backend != "xla"
    if spp <= 4:
        assert r.render_frame()


def test_xla_backend_ignores_budget_and_takes_odd_spp():
    """The xla backend takes any spp and bounce depth, and budget_texels
    changes none of its bits (it samples the full-resolution pool)."""
    params = _params(twrt, tscenes, "textured", size=(16, 10), max_spp=3, spp=3, bounces=1)
    imgs = []
    for budget in (None, 512):
        r = twrt.Renderer(tscenes.textured_spheres(), params, backend="xla", device="cpu",
                          budget_texels=budget)
        assert r.render().frames == 1
        imgs.append(r.mean_radiance())
    assert torch.equal(imgs[0], imgs[1])


def test_default_pixel_batch_is_the_jax_rule():
    from weekend_raytracer_tpu.renderer import _default_pixel_batch as j_batch

    for n in (1, 1 << 17, (1 << 17) + 1, 1920 * 1080, 3840 * 2160):
        assert trenderer._default_pixel_batch(n) == j_batch(n)


def test_exports_and_import_boundary():
    for name in ("render_image", "render_pixels", "trace_paths", "CheckpointMismatchError"):
        assert name in twrt.__all__ and name in jwrt.__all__
    code = ("import sys, weekend_raytracer_tpu_torch as w; "
            "import weekend_raytracer_tpu_torch.reference; "
            "import weekend_raytracer_tpu_torch.ops.tracer; "
            "import weekend_raytracer_tpu_torch.ops.scatter; "
            "import weekend_raytracer_tpu_torch.ops.sky_radiance; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m); "
            "assert 'weekend_raytracer_tpu' not in sys.modules")
    env = dict(os.environ, PYTHONPATH=_REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=_REPO, env=env, timeout=120)
