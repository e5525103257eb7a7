"""The port's host prep for the kernel against the JAX package, bit for bit.

``ops/bvh.py`` and ``prepare_scene_arrays`` must give the same arrays as
the JAX functions, called eagerly, on three scenes: RTiOW (486 spheres,
chunk 16, no super-chunks), random_spheres(n=1024, seed=7) (the
super-chunk path) and textured (texture pool and descriptors). Every step
is elementwise f32 arithmetic, an exact min/max, a stable sort or a
fixed-order sum, so equality is exact.

(Under ``jax.jit`` XLA:CPU contracts kq = cx*cx + cy*cy + cz*cz - r*r into
fused multiply-adds, so the JAX megakernel's own kq can differ from the
eager value in the last ulp; the comparison is against the eager call.)
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from weekend_raytracer_tpu.models import scenes as jscenes  # noqa: E402
from weekend_raytracer_tpu.models.camera import CameraBasis as JBasis  # noqa: E402
from weekend_raytracer_tpu.models.materials import Material as JMaterial  # noqa: E402
from weekend_raytracer_tpu.models.materials import MaterialTable as JTable  # noqa: E402
from weekend_raytracer_tpu.models.sky import SkyParams as JSkyParams  # noqa: E402
from weekend_raytracer_tpu.models.sky import to_sky_state as j_to_sky_state  # noqa: E402
from weekend_raytracer_tpu.models.textures import Texture as JTexture  # noqa: E402
from weekend_raytracer_tpu.ops import bvh as jbvh  # noqa: E402
from weekend_raytracer_tpu.ops.pallas import megakernel as jmk  # noqa: E402
from weekend_raytracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from weekend_raytracer_tpu_torch.models.camera import CameraBasis  # noqa: E402
from weekend_raytracer_tpu_torch.models.materials import Material, MaterialTable  # noqa: E402
from weekend_raytracer_tpu_torch.models.sky import SkyParams, to_sky_state  # noqa: E402
from weekend_raytracer_tpu_torch.models.textures import Texture  # noqa: E402
from weekend_raytracer_tpu_torch.ops import bvh  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import megakernel as mk  # noqa: E402

# scene name -> keyword arguments of its scene function
_SCENES = {"rtiow": {}, "random10k": dict(n=1024, seed=7), "textured": {}}
_VIEW = (64, 48)


def _assert_bits_equal(ref, got, what):
    ref = np.ascontiguousarray(np.asarray(ref))
    got = np.ascontiguousarray(got.cpu().numpy())
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    assert ref.dtype == got.dtype, (what, ref.dtype, got.dtype)
    assert ref.tobytes() == got.tobytes(), (what, int((ref != got).sum()))


def _both(name):
    kw = _SCENES[name]
    jdesc = jscenes.SCENES[name][0](**kw)
    tdesc = tscenes.SCENES[name][0](**kw)
    jb = JBasis.create(jscenes.SCENES[name][1](), _VIEW)
    tb = CameraBasis.create(tscenes.SCENES[name][1](), _VIEW, device="cpu")
    return jdesc.build(), jb, tdesc.build(device="cpu"), tb


def _attrs(scene, lib):
    """The 12 per-sphere attributes, gathered as prepare_scene_arrays does."""
    sph, mat = scene.spheres, scene.materials
    if lib is torch:
        midx = sph.material_idx.long()
        ids = mat.ids[midx].float()
    else:
        midx = sph.material_idx
        ids = mat.ids[midx].astype(jnp.float32)
    return (sph.centers[:, 0], sph.centers[:, 1], sph.centers[:, 2], sph.radii,
            ids, mat.x[midx],
            mat.albedo1[midx, 0], mat.albedo1[midx, 1], mat.albedo1[midx, 2],
            mat.albedo2[midx, 0], mat.albedo2[midx, 1], mat.albedo2[midx, 2])


def test_morton_codes_bit_exact():
    rs = np.random.RandomState(5)
    pts = (rs.randn(3, 2048) * 20).astype(np.float32)
    lo = np.percentile(pts, 5, axis=1).astype(np.float32)
    hi = np.percentile(pts, 95, axis=1).astype(np.float32)
    ref = jbvh.morton_codes(*map(jnp.asarray, pts), jnp.asarray(lo), jnp.asarray(hi))
    got = bvh.morton_codes(*map(torch.from_numpy, pts), torch.from_numpy(lo),
                           torch.from_numpy(hi))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).astype(np.int64))


@pytest.mark.parametrize("name", ["rtiow", "random10k"])
def test_bvh_chunks_order_supers_bit_exact(name):
    js, jb, ts, tb = _both(name)
    cs = jmk.default_chunk_size(int(js.spheres.centers.shape[0]))
    jc = jbvh.build_chunks(_attrs(js, jnp), cs)
    tc = bvh.build_chunks(_attrs(ts, torch), cs)
    for i, (a, b) in enumerate(zip(jc.attrs + jc.bounds, tc.attrs + tc.bounds)):
        _assert_bits_equal(a, b, f"build_chunks[{i}]")
    jo = jbvh.order_front_to_back(jc, jb.eye, cs)
    to = bvh.order_front_to_back(tc, tb.eye, cs)
    for i, (a, b) in enumerate(zip(jo.attrs + jo.bounds, to.attrs + to.bounds)):
        _assert_bits_equal(a, b, f"order_front_to_back[{i}]")
    jp, jsup = jbvh.super_bounds(jo, 16)
    tp, tsup = bvh.super_bounds(to, 16)
    for i, (a, b) in enumerate(zip(jp + jsup, tp + tsup)):
        _assert_bits_equal(a, b, f"super_bounds[{i}]")


@pytest.mark.parametrize("name", ["rtiow", "random10k", "textured"])
def test_prepare_scene_arrays_bit_exact(name):
    js, jb, ts, tb = _both(name)
    cs = jmk.default_chunk_size(int(js.spheres.centers.shape[0]))
    assert mk.default_chunk_size(ts.spheres.num_spheres) == cs
    (j_attrs, j_chunks, j_supers, j_n, j_nc, j_ns, j_pool,
     _retrieval_lut) = jmk.prepare_scene_arrays(js, jb, cs, 16)
    got = mk.prepare_scene_arrays(ts, tb, cs, 16)
    assert (got.n_spheres, got.n_chunks, got.n_super) == (j_n, j_nc, j_ns)
    assert len(got.s_attrs) == len(j_attrs)
    for i, (a, b) in enumerate(zip(j_attrs, got.s_attrs)):
        _assert_bits_equal(a, b, f"s_attrs[{i}]")
    for i, (a, b) in enumerate(zip(j_chunks, got.chunk_arrays)):
        _assert_bits_equal(a, b, f"chunk_arrays[{i}]")
    for i, (a, b) in enumerate(zip(j_supers, got.super_arrays)):
        _assert_bits_equal(a, b, f"super_arrays[{i}]")
    assert (j_pool is None) == (got.tex_pool is None)
    if j_pool is not None:
        _assert_bits_equal(j_pool, got.tex_pool, "tex_pool")
    expected = {"rtiow": (496, 31, 0), "random10k": (1024, 64, 4),
                "textured": (5, 0, 0)}[name]
    assert (got.n_spheres, got.n_chunks, got.n_super) == expected


@pytest.mark.parametrize("budget", [1000, 8192, 1 << 20])
def test_texture_pool_bit_exact(budget):
    """Box-filtered mips, a strided mip (102 is no multiple of 4), a
    full-size texture and shared textures deduplicated, at three budgets."""
    rs = np.random.RandomState(9)
    imgs = [rs.rand(60, 102, 3).astype(np.float32),
            rs.rand(64, 128, 3).astype(np.float32)]

    def mats(M, T):
        return [M.lambertian(T(imgs[0])), M.checkerboard(T(imgs[1]), (0.2, 0.3, 0.4)),
                M.metal((0.5, 0.5, 0.5), 0.1), M.emissive(T(imgs[0]), 3.0)]

    jt = JTable.build(mats(JMaterial, JTexture))
    tt = MaterialTable.build(mats(Material, Texture), device="cpu")
    assert tt.tex_meta == jt.tex_meta and tt.all_solid == jt.all_solid
    ref = jmk.build_kernel_texture_pool(jt, budget)
    got = mk.build_kernel_texture_pool(tt, budget)
    for i, (a, b) in enumerate(zip(ref, got)):
        _assert_bits_equal(a, b, f"pool[{i}]")


def test_pack_camera_and_sky_bit_exact():
    cam = jscenes.rtiow_final_camera()
    _assert_bits_equal(jmk.pack_camera(JBasis.create(cam, (1920, 1080))),
                       mk.pack_camera(CameraBasis.create(cam, (1920, 1080),
                                                         device="cpu")), "cam")
    sp = dict(azimuth_degrees=40.0, zenith_degrees=60.0, turbidity=3.0)
    _assert_bits_equal(jmk.pack_sky(j_to_sky_state(JSkyParams(**sp))),
                       mk.pack_sky(to_sky_state(SkyParams(**sp), device="cpu")),
                       "sky")
