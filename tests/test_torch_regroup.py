"""The port's regroup pipeline against the JAX package's, on the CPU.

The JAX kernels run in Pallas interpret mode, as tests/test_regroup.py runs
them; the port runs its plain PyTorch twins (``k0_plain``, ``pack_plain``,
``k1_plain``, ``combine_plain``), which are what a CPU tensor takes.

- PACK and COMBINE are integer work and permutations: on the same seeded
  synthetic pools the twins match the JAX kernels bit for bit, with +0.0
  and -0.0 held equal (the JAX v2 kernels' one-hot matmuls turn -0.0 into
  +0.0, regroup.py:457-465, 902-906).
- K0 and K1 trace Monte-Carlo paths: the home slots match exactly, the
  alive masks agree on >= 99% of records, and the images they give meet
  tests/test_pallas.py's gates (tonemapped RMSE < 5e-3, linear mean within
  a relative 1e-3), as torch and XLA round transcendentals differently.
- The slice as a whole, ``render_image_regrouped`` on a CPU accumulator,
  meets the same gates against the JAX ``render_image_regrouped``, and
  against the port's own megakernel twin < 1% of pixels differ by more
  than 1e-6.

JAX compiles each interpret-mode kernel once per shape (tens of seconds),
so the JAX outputs are cached in module-scoped fixtures and the sizes are
small: at most 64x32, spp <= 4, <= 8 bounces.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

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

_F32 = jnp.float32
_SDS = jax.ShapeDtypeStruct
_BASIS_FIELDS = ("eye", "horizontal", "vertical", "u", "v", "lens_radius",
                 "lower_left_corner")
# name -> (w, h, frames, spp, bounces, cuts) of the whole-slice comparison
_SLICE = {
    "rtiow": (64, 32, 8, 4, 8, (2, 4)),
    "three": (64, 32, 8, 4, 8, (3,)),
    "textured": (64, 32, 8, 4, 6, (2,)),
}


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


def _setup(name, w, h):
    jscene = jscenes.SCENES[name][0]().build()
    jsky = j_to_sky_state(JSkyParams())
    jbasis = JBasis.create(jscenes.SCENES[name][1](), (w, h))
    return (jscene, jsky, jbasis), _port(jscene, jsky, jbasis)


# --- layout conversions: port SoA [C, cap] <-> JAX (tiles, C, 32, 128) ----

def _to_jax(a, n_tiles=None):
    a = np.asarray(a)
    c = a.shape[0]
    tiles = a.shape[1] // 4096
    out = a.reshape(c, tiles, 32, 128).transpose(1, 0, 2, 3)
    if n_tiles is not None and n_tiles > tiles:
        out = np.concatenate([out, np.zeros((n_tiles - tiles, c, 32, 128), a.dtype)])
    return jnp.asarray(out)


def _from_jax(a):
    a = np.asarray(a)
    return a.transpose(1, 0, 2, 3).reshape(a.shape[1], -1)


def _inv_positions(jinv):
    """Dense position of each slot from the JAX inverse map, or -1."""
    jinv = np.asarray(jinv)
    row = jinv[:, jrg._INV_ROW].reshape(-1)
    lane = jinv[:, jrg._INV_LANE].reshape(-1)
    return np.where(row < jrg._DEAD_ROW, row * 128 + lane, -1).astype(np.int64)


def _equal_pm0(a, b):
    """Element for element equality, +0.0 and -0.0 held equal."""
    return np.array_equal(np.asarray(a) + np.float32(0.0),
                          np.asarray(b) + np.float32(0.0))


# --- the JAX kernels, wired as in render_image_regrouped -----------------

def _smem():
    return pl.BlockSpec(memory_space=pltpu.SMEM)


def _clamped_blk(comps):
    """Block map clamped to the last live tile of the prefetched count
    (regroup.py:1233-1257)."""
    return pl.BlockSpec(
        (1, comps, 32, 128),
        lambda i, c: (jnp.minimum(i, jnp.maximum((c[0] + 31) // 32 - 1, 0)), 0, 0, 0),
        memory_space=pltpu.VMEM)


@jax.jit
def _jax_pack(pool_j, count_rows):
    """The default pack (v2) at regroup.py:1279-1331; count_rows is a
    traced i32[1], so every case shares one compile."""
    n_tiles = pool_j.shape[0]
    scratch = [pltpu.VMEM((rg.N_COMP, 8, 128), _F32),
               pltpu.VMEM((rg.N_COMP, 40, 128), _F32),
               pltpu.SMEM((1,), jnp.int32), pltpu.SMEM((1,), jnp.int32),
               pltpu.SemaphoreType.DMA((33,))]
    return pl.pallas_call(
        jrg._make_pack_kernel_v2(indirect=False),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(n_tiles,),
            in_specs=[_clamped_blk(rg.N_COMP)],
            out_specs=(pl.BlockSpec(memory_space=pl.ANY), _clamped_blk(jrg.N_INV),
                       pl.BlockSpec(memory_space=pltpu.SMEM)),
            scratch_shapes=scratch),
        out_shape=(_SDS((n_tiles + 1, rg.N_COMP, 32, 128), _F32),
                   _SDS((n_tiles, jrg.N_INV, 32, 128), _F32),
                   _SDS((1,), jnp.int32)),
        compiler_params=pltpu.CompilerParams(has_side_effects=True),
        interpret=True,
    )(count_rows, pool_j)


@jax.jit
def _jax_level(inv_j, src_count, dest_count, src_j, base_j):
    """One default (v2) combine level, regroup.py:1414-1475; the counts
    are i32[1] rows."""
    n_tiles = inv_j.shape[0]
    tiles_alive = jnp.arange(n_tiles, dtype=jnp.int32) * 32 < dest_count[0]
    tbl = jnp.where(tiles_alive, inv_j[:, jrg._INV_FIRST, 0, 0].astype(jnp.int32),
                    src_count[0])
    tbl = jnp.clip(tbl, 0, jnp.maximum(src_count[0] - 1, 0))
    tbl = jnp.concatenate([tbl, src_count])
    comps = base_j.shape[1]
    return pl.pallas_call(
        jrg._make_level_kernel_v2(indirect=False),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(n_tiles,),
            in_specs=[_smem(), _smem(), _clamped_blk(jrg.N_INV),
                      pl.BlockSpec(memory_space=pl.ANY), _clamped_blk(comps)],
            out_specs=_clamped_blk(comps),
            scratch_shapes=[pltpu.VMEM((3, 4, 32, 128), _F32),
                            pltpu.SemaphoreType.DMA((3,))]),
        out_shape=_SDS(base_j.shape, _F32),
        input_output_aliases={5: 0},
        interpret=True,
    )(dest_count, tbl, src_count, inv_j, src_j, base_j)


def _jax_scene_arrays(jscene, jbasis):
    n = int(jscene.spheres.centers.shape[0])
    chunk = jmk.default_chunk_size(n)
    return chunk, jmk.prepare_scene_arrays(jscene, jbasis, chunk, 16)


def _jax_k0(jscene, jsky, jbasis, t, b1):
    """K0 as at regroup.py:1093-1208 (no sweep variants), as a function of
    the frame number, compiled once."""
    chunk, (s_attrs, chunk_arrays, super_arrays, n_spheres, n_chunks, n_super,
            tex_pool, retr_lut) = _jax_scene_arrays(jscene, jbasis)
    n_tiles = t.tiles_x * t.tiles_y
    extra = [a for a in (tex_pool, retr_lut) if a is not None]
    fr = []
    if n_chunks > 0:
        flist = jmk.build_frustum_lists(jbasis, chunk_arrays[:6], t.tiles_x,
                                       t.tiles_y, t.block_w, 32, t.width, t.height,
                                       row_offset=0, full_height=t.height)
        pad = (-n_tiles) % 8
        fr = [jnp.concatenate([flist, jnp.zeros((pad, flist.shape[1]), jnp.int32)])]
    k0 = jrg._make_k0(t.width, t.height, t.spp, b1, n_spheres, chunk, n_chunks, 16,
                      n_super, t.tiles_x, t.block_w, t.spp_shift,
                      textures=tex_pool is not None, frustum=n_chunks > 0,
                      full_height=t.height, retr=retr_lut is not None,
                      lut_rows=-(-n_spheres // 128))
    blk = lambda c: pl.BlockSpec((1, c, 32, 128), lambda i: (i, 0, 0, 0),
                                 memory_space=pltpu.VMEM)
    in_specs = ([_smem()] * (3 + len(s_attrs) + 13)
                + [pl.BlockSpec(memory_space=pltpu.VMEM)] * len(extra)
                + [pl.BlockSpec((8, f.shape[1]), lambda i: (i // 8, 0),
                                memory_space=pltpu.SMEM) for f in fr])
    call = pl.pallas_call(
        k0, grid=(n_tiles,), in_specs=in_specs, out_specs=(blk(rg.N_COMP), blk(3)),
        out_shape=(_SDS((n_tiles, rg.N_COMP, 32, 128), _F32),
                   _SDS((n_tiles, 3, 32, 128), _F32)),
        interpret=True)
    fn = jax.jit(lambda meta: call(meta, jmk.pack_camera(jbasis), jmk.pack_sky(jsky),
                                   *s_attrs, *chunk_arrays, *super_arrays, *extra, *fr))
    return lambda frame: fn(jnp.asarray([frame, 0], jnp.uint32))


def _jax_k1(jscene, jsky, jbasis, t, b_lo, b_hi):
    """K1 with its base-radiance pool, as at regroup.py:1342-1391, as a
    function of (dense pool, dense rows, frame), compiled once."""
    chunk, (s_attrs, chunk_arrays, super_arrays, n_spheres, n_chunks, n_super,
            tex_pool, retr_lut) = _jax_scene_arrays(jscene, jbasis)
    n_tiles = t.tiles_x * t.tiles_y
    extra = [a for a in (tex_pool, retr_lut) if a is not None]
    k1 = jrg._make_k1(n_spheres, chunk, n_chunks, 16, n_super, t.width, t.height,
                      t.spp, t.tiles_x, t.block_w, t.spp_shift,
                      textures=tex_pool is not None, retr=retr_lut is not None,
                      lut_rows=-(-n_spheres // 128), emit_r8=True)
    n_in = 3 + len(s_attrs) + 13 + len(extra) + 1
    call = pl.pallas_call(
        k1,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(n_tiles,),
            in_specs=([_smem()] * (3 + len(s_attrs) + 13)
                      + [pl.BlockSpec(memory_space=pltpu.VMEM)] * len(extra)
                      + [_clamped_blk(rg.N_COMP)]),
            out_specs=(_clamped_blk(rg.N_COMP), _clamped_blk(4))),
        out_shape=(_SDS((n_tiles + 1, rg.N_COMP, 32, 128), _F32),
                   _SDS((n_tiles, 4, 32, 128), _F32)),
        input_output_aliases={n_in: 0},
        interpret=True)
    fn = jax.jit(lambda dense_j, rows, meta0: call(
        rows, jnp.asarray([b_lo, b_hi], jnp.int32), meta0, jmk.pack_sky(jsky),
        *s_attrs, *chunk_arrays, *super_arrays, *extra, dense_j))
    return lambda dense_j, rows, frame: fn(dense_j, _rows(rows),
                                           jnp.asarray([frame, 0], jnp.uint32))


# --- helpers on images ---------------------------------------------------

def _tonemapped(img, w, h):
    return np.asarray(to_srgb_u8(np.asarray(img).reshape(h, w, 3))).astype(np.float32) / 255


def _assert_statistically_equal(a, b, w, h):
    rmse = float(np.sqrt(((_tonemapped(a, w, h) - _tonemapped(b, w, h)) ** 2).mean()))
    assert rmse < 5e-3, rmse
    assert abs(a.mean() - b.mean()) / max(abs(a.mean()), 1e-6) < 1e-3, (a.mean(), b.mean())


def _fold(per_slot, t):
    """[3, cap] per-slot radiance -> [H*W, 3] pixel sums."""
    acc = torch.zeros((t.width * t.height, 3))
    rg._fold_plain(torch.as_tensor(np.ascontiguousarray(per_slot)), acc, t, True)
    return acc.numpy()


def _rows(n):
    return jnp.asarray([n], jnp.int32)


def _synthetic_pool(seed, n_tiles, alive_frac):
    """A pool of random records (some components -0.0) with exact home
    slots and a seeded alive mask."""
    r = np.random.RandomState(seed)
    cap = n_tiles * 4096
    pool = r.standard_normal((rg.N_COMP, cap)).astype(np.float32)
    pool[r.rand(rg.N_COMP, cap) < 0.01] = -0.0
    slot = np.arange(cap)
    pool[rg._HLO] = slot & 4095
    pool[rg._HHI] = slot >> 12
    pool[rg._SPARE] = 0.0
    pool[rg._AL] = (r.rand(cap) < alive_frac).astype(np.float32)
    return pool


# pack case -> (alive fraction, input rows: None = every row)
_PACK_CASES = {"random": (0.3, None), "all_live": (1.0, None),
               "all_dead": (0.0, None), "partial_tail": (0.6, 81)}
_PACK_TILES = 3


@pytest.fixture(scope="module")
def packs():
    """Each pack case through the JAX pack kernel and the port's twin."""
    out = {}
    for i, (name, (frac, rows)) in enumerate(_PACK_CASES.items()):
        pool = _synthetic_pool(i, _PACK_TILES, frac)
        cap = pool.shape[1]
        rows = cap // 128 if rows is None else rows
        jdense, jinv, jcount = _jax_pack(_to_jax(pool), _rows(rows))
        counts = torch.tensor([rows * 128, 0], dtype=torch.int32)
        dst = torch.full((rg.N_COMP, cap), 9.0)
        inv = torch.full((cap,), -7, dtype=torch.int32)
        rg.pack_plain(torch.from_numpy(pool), dst, inv, counts, 1)
        out[name] = dict(pool=pool, rows=rows, jdense=_from_jax(jdense), jinv=jinv,
                         jcount=int(np.asarray(jcount)[0]), dst=dst.numpy(),
                         inv=inv.numpy(), live=int(counts[1]))
    return out


@pytest.mark.parametrize("case", list(_PACK_CASES))
def test_pack_matches_jax(case, packs):
    p = packs[case]
    n_in = p["rows"] * 128
    alive = p["pool"][rg._AL, :n_in] > 0.5
    assert p["live"] == int(alive.sum())
    assert p["jcount"] == -(-p["live"] // 128)  # JAX counts dense rows
    end = p["jcount"] * 128
    assert _equal_pm0(p["dst"][:, :end], p["jdense"][:, :end])
    np.testing.assert_array_equal(p["inv"][:n_in], _inv_positions(p["jinv"])[:n_in])
    if case == "all_dead":
        assert p["live"] == 0 and (p["inv"][:n_in] == rg.DEAD).all()


@pytest.mark.parametrize("level", ["intermediate", "home"])
def test_combine_matches_jax(level, packs):
    """One reverse-combine level through a pack's inverse map: a phase
    level writes over an r4 base pool; the home level combines over K0's
    contributions and folds them, leaving those contributions as they are
    (as the CUDA kernel does)."""
    p = packs["random"]
    cap = p["pool"].shape[1]
    r = np.random.RandomState(11)
    src = r.standard_normal((3, cap)).astype(np.float32)
    src[r.rand(3, cap) < 0.01] = -0.0
    base = r.standard_normal((3, cap)).astype(np.float32)
    pad = np.zeros((1, cap), np.float32)
    if level == "intermediate":
        jout = _jax_level(p["jinv"], _rows(p["jcount"]), _rows(p["rows"]),
                          _to_jax(np.vstack([src, pad])), _to_jax(np.vstack([base, pad])))
        counts, k = torch.tensor([cap, cap], dtype=torch.int32), 2
    else:
        jout = _jax_level(p["jinv"], _rows(p["jcount"]), _rows(p["rows"]),
                          _to_jax(np.vstack([src, pad])), _to_jax(base))
        counts, k = torch.tensor([cap, p["live"]], dtype=torch.int32), 1
    got = torch.from_numpy(base.copy())
    t, _ = rg.plan(384, 32, 1, 2, (1,))  # 3 tiles of 128 one-sample pixels
    assert t.cap == cap
    acc = torch.zeros((384 * 32, 3))
    rg.combine_plain(torch.from_numpy(p["inv"]), torch.from_numpy(src), got, counts, k,
                     accum=acc, t=t, clear=True)
    if level == "intermediate":
        assert _equal_pm0(got.numpy(), _from_jax(jout)[:3])
    else:  # spp 1: the fold is the crop of the combined slots
        np.testing.assert_array_equal(got.numpy(), base)
        np.testing.assert_array_equal(acc.numpy(), _fold(_from_jax(jout)[:3], t))


def test_fold_sums_samples_in_order():
    """The fold adds a pixel's spp lanes one by one from 0 (not a tree)."""
    t, _ = rg.plan(40, 24, 4, 2, (1,))
    r = np.random.RandomState(5)
    contrib = r.standard_normal((3, t.cap)).astype(np.float32) * 1e3
    got = _fold(contrib, t)
    lanes = contrib.reshape(3, t.tiles_y, t.tiles_x, 32, t.block_w, 4)
    ref = np.zeros(lanes.shape[:-1], np.float32)
    for s in range(4):
        ref = ref + lanes[..., s]
    ref = ref.transpose(0, 1, 3, 2, 4).reshape(3, 32 * t.tiles_y, -1)[:, :24, :40]
    np.testing.assert_array_equal(got, ref.reshape(3, -1).T)


_KERNEL_FRAMES = 8


@pytest.fixture(scope="module")
def kernels_rtiow():
    """K0 and K1 of the JAX package and of the port on rtiow, 64x32, spp 4,
    over 8 frames: K0 runs bounces [0, 2), and K1 bounces [2, 4) on the
    port's dense pool of the same frame. Images are summed over frames."""
    w, h, spp = 64, 32, 4
    (jscene, jsky, jbasis), (scene, sky, basis) = _setup("rtiow", w, h)
    t, _ = rg.plan(w, h, spp, 8, (2,))
    inp = mk.kernel_inputs(scene, sky, basis)
    jk0 = _jax_k0(jscene, jsky, jbasis, t, 2)
    jk1 = _jax_k1(jscene, jsky, jbasis, t, 2, 4)
    out = dict(t=t, home_exact=True, k0_alive=[], k1_alive=[], live=[],
               k0=np.zeros((2, w * h, 3), np.float32),
               k1=np.zeros((2, w * h, 3), np.float32))
    for f in range(_KERNEL_FRAMES):
        jpool, jcontrib = (_from_jax(a) for a in jk0(f))
        pool = torch.empty((rg.N_COMP, t.cap))
        contrib = torch.empty((3, t.cap))
        rg.k0_plain(inp, pool, contrib, t, f, 2)
        pool_np = pool.numpy()
        out["home_exact"] &= all(np.array_equal(pool_np[c], jpool[c])
                                 for c in (rg._HLO, rg._HHI))
        out["k0_alive"].append((pool_np[rg._AL] == jpool[rg._AL]).mean())
        out["live"].append(pool_np[rg._AL].mean())
        out["k0"] += [_fold(jcontrib, t), _fold(contrib.numpy(), t)]

        counts = torch.tensor([t.cap, 0], dtype=torch.int32)
        dense = torch.empty((rg.N_COMP, t.cap))
        rg.pack_plain(pool, dense, torch.empty((t.cap,), dtype=torch.int32), counts, 1)
        n = int(counts[1])
        before = dense.numpy()[:, :n].copy()
        jdense, jr8 = (_from_jax(a) for a in jk1(
            _to_jax(dense.numpy(), t.tiles_x * t.tiles_y + 1), -(-n // 128), f))
        r8 = torch.zeros((3, t.cap))
        rg.k1_plain(inp, dense, r8, counts, 1, t, f, 2, 4)
        dense = dense.numpy()
        out["home_exact"] &= all(
            np.array_equal(d[c, :n], before[c]) for d in (dense, jdense)
            for c in (rg._HLO, rg._HHI))
        out["k1_alive"].append((dense[rg._AL, :n] == jdense[rg._AL, :n]).mean())
        out["k1"] += [_home_image(jdense, jr8[:3], n, t), _home_image(dense, r8.numpy(), n, t)]
    return out


def _home_image(records, r8, n, t):
    """Radiance of n dense records put back on their home slots, folded."""
    slot = (records[rg._HHI, :n].astype(np.int64) * 4096
            + records[rg._HLO, :n].astype(np.int64))
    per_slot = np.zeros((3, t.cap), np.float32)
    per_slot[:, slot] = r8[:, :n]
    return _fold(per_slot, t)


@pytest.mark.parametrize("kernel", ["k0", "k1"])
def test_k0_k1_match_jax(kernel, kernels_rtiow):
    k = kernels_rtiow
    t = k["t"]
    assert k["home_exact"]  # HLO and HHI, every frame
    assert min(k[f"{kernel}_alive"]) >= 0.99
    assert all(0.05 < live < 0.95 for live in k["live"])  # live and dead paths at the cut
    jimg, img = k[kernel] / (_KERNEL_FRAMES * t.spp)
    _assert_statistically_equal(jimg, img, t.width, t.height)


def _run_slice(fn, scene, sky, basis, w, h, frames, spp, bounces, cuts):
    acc = torch.zeros((w * h, 3))
    for f in range(frames):
        fn(acc, f, f == 0, scene, sky, basis, width=w, height=h, spp=spp,
           num_bounces=bounces, cuts=cuts)
    return acc.numpy() / (frames * spp)


@pytest.fixture(scope="module")
def slices():
    """Each scene's JAX regrouped image (interpret mode), cached."""
    cache = {}

    def get(name):
        if name not in cache:
            w, h, frames, spp, bounces, cuts = _SLICE[name]
            jargs, port = _setup(name, w, h)
            acc = jnp.zeros((w * h, 3), jnp.float32)
            for f in range(frames):
                acc = jrg.render_image_regrouped(
                    acc, jnp.uint32(f), jnp.bool_(f == 0), *jargs, width=w, height=h,
                    spp=spp, num_bounces=bounces, cuts=cuts)
            cache[name] = (np.asarray(acc) / (frames * spp), port)
        return cache[name]

    return get


@pytest.fixture(scope="module")
def port_slices(slices):
    """Each scene's image from the port's regrouped twins on the JAX
    case's leaves, cached."""
    cache = {}

    def get(name):
        if name not in cache:
            _, (scene, sky, basis) = slices(name)
            cache[name] = _run_slice(rg.render_image_regrouped, scene, sky, basis,
                                     *_SLICE[name])
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(_SLICE))
def test_slice_matches_jax(name, slices, port_slices):
    ref = slices(name)[0]
    w, h, frames, spp, bounces, cuts = _SLICE[name]
    got = port_slices(name)
    assert np.isfinite(got).all() and got.mean() > 0.01
    _assert_statistically_equal(ref, got, w, h)


# The JAX package's images that chip_smoke.py's [reference] holds the
# kernels to on the card, where there is no JAX (tools/jax_images.py)
_JAX_IMAGES = os.path.join(os.path.dirname(__file__), "data", "jax_images.npz")
_FIXTURE_CASES = ["rtiow", "textured"]


@pytest.mark.parametrize("name", _FIXTURE_CASES)
def test_committed_jax_images_are_the_jax_kernels(name, slices):
    """tests/data/jax_images.npz holds render_image_regrouped's image of
    the case at this module's parameters and cuts, in every bit (exact, as
    tests/test_torch_megakernel.py says why)."""
    with np.load(_JAX_IMAGES) as z:
        params, cuts, image = (z[f"regroup_{name}_params"], z[f"regroup_{name}_cuts"],
                               z[f"regroup_{name}"])
    assert tuple(params) + (tuple(cuts),) == _SLICE[name]
    np.testing.assert_array_equal(image, slices(name)[0])


@pytest.mark.parametrize("name", _FIXTURE_CASES)
def test_twin_meets_gates_against_committed_jax_images(name, port_slices):
    """The port's regrouped twins against the fixture, at the gates that
    [reference] holds the CUDA kernels to on the card."""
    w, h = _SLICE[name][:2]
    with np.load(_JAX_IMAGES) as z:
        ref = z[f"regroup_{name}"]
    _assert_statistically_equal(ref, port_slices(name), w, h)


@pytest.mark.parametrize("name", ["rtiow", "textured"])
def test_slice_matches_megakernel_twin(name):
    """Regroup and the megakernel run the same per-ray body on the same
    samples; < 1% of pixels may differ by more than 1e-6."""
    w, h, frames, spp, bounces, cuts = _SLICE[name]
    _, (scene, sky, basis) = _setup(name, w, h)
    a = _run_slice(rg.render_image_regrouped, scene, sky, basis, w, h, 2, spp,
                   bounces, cuts)
    acc = torch.zeros((w * h, 3))
    for f in range(2):
        mk.render_image_megakernel(acc, f, f == 0, scene, sky, basis, width=w,
                                   height=h, spp=spp, num_bounces=bounces)
    b = acc.numpy() / (2 * spp)
    mismatch = (np.abs(a - b) > 1e-6).any(axis=1).mean()
    assert mismatch < 0.01, mismatch


def _three(w, h):
    return _setup("three", w, h)[1]


def test_debug_counts_shrink():
    w, h = 64, 32
    _, (scene, sky, basis) = _setup("rtiow", w, h)
    acc = torch.zeros((w * h, 3))
    out, rows = rg.render_image_regrouped(acc, 0, True, scene, sky, basis, width=w,
                                          height=h, spp=4, num_bounces=8,
                                          cuts=(2, 4, 6), debug_counts=True)
    assert out is acc
    assert rows[0] == 2 * 32  # two padded tiles of 32 rows
    assert rows[0] > rows[1] > rows[2] > rows[3] > 0


def test_clear_false_accumulates_two_frames():
    w, h = 40, 24
    scene, sky, basis = _three(w, h)
    kw = dict(width=w, height=h, spp=2, num_bounces=6, cuts=(2, 4))
    acc = torch.full((w * h, 3), 7.0)  # stale data
    rg.render_image_regrouped(acc, 0, True, scene, sky, basis, **kw)
    first = acc.clone()
    assert float(first.min()) < 1.0  # clear=True discarded the stale 7.0
    rg.render_image_regrouped(acc, 1, False, scene, sky, basis, **kw)
    again = torch.zeros_like(acc)
    rg.render_image_regrouped(again, 1, True, scene, sky, basis, **kw)
    torch.testing.assert_close(acc, first + again, rtol=0, atol=0)


def test_cut_schedules_agree():
    """Every record's contribution is its own tr * cr, wherever its path
    ended, so cut schedules agree (bit for bit on the card, where every
    schedule runs the same kernels; here up to the CPU twins' batch-shape
    rounding, held to < 1% of pixels)."""
    w, h = 40, 24
    scene, sky, basis = _three(w, h)
    outs = []
    for cuts in ((3,), (1, 2, 5), (2, 4)):
        acc = torch.zeros((w * h, 3))
        rg.render_image_regrouped(acc, 2, True, scene, sky, basis, width=w, height=h,
                                  spp=2, num_bounces=6, cuts=cuts)
        outs.append(acc.numpy())
    for other in outs[1:]:
        assert (np.abs(outs[0] - other) > 1e-6).any(axis=1).mean() < 0.01


def test_validation_errors():
    """The JAX function's errors (regroup.py:1072-1091)."""
    scene, sky, basis = _three(16, 8)
    acc = torch.zeros((16 * 8, 3))
    kw = dict(width=16, height=8, num_bounces=8)
    with pytest.raises(ValueError, match="power of two"):
        rg.render_image_regrouped(acc, 0, True, scene, sky, basis, spp=3, **kw)
    with pytest.raises(ValueError, match="<= 128"):
        rg.render_image_regrouped(acc, 0, True, scene, sky, basis, spp=256, **kw)
    with pytest.raises(ValueError, match="k1_tsub"):
        rg.render_image_regrouped(acc, 0, True, scene, sky, basis, spp=4, k1_tsub=24,
                                  **kw)
    with pytest.raises(ValueError, match="at least one cut"):
        rg.render_image_regrouped(acc, 0, True, scene, sky, basis, spp=4, cuts=(), **kw)
    with pytest.raises(ValueError, match="at least one cut"):
        rg.render_image_regrouped(acc, 0, True, scene, sky, basis, spp=4, cuts=(0, 8),
                                  **kw)
    with pytest.raises(ValueError, match="2\\^28"):  # refused before any allocation
        rg.render_image_regrouped(acc, 0, True, scene, sky, basis, width=16384,
                                  height=16384, spp=1, num_bounces=8)


def test_default_cuts_match_jax():
    for bounces in range(2, 12):
        for n in (None, 3, 64, 65, 486, 10000):
            assert rg.default_cuts(bounces, n) == jrg.default_cuts(bounces, n)


@pytest.mark.parametrize("knob,value", [
    ("listed", True), ("k1_subcull", 8), ("rowsweep", True),
    ("rowsweep_k0", True), ("profile_stop", "k0")])
def test_tpu_only_knobs_raise(knob, value):
    scene, sky, basis = _three(8, 8)
    with pytest.raises(NotImplementedError, match=knob):
        rg.render_image_regrouped(torch.zeros((64, 3)), 0, True, scene, sky, basis,
                                  width=8, height=8, spp=1, num_bounces=4,
                                  **{knob: value})


def test_mechanism_knobs_change_nothing():
    """pack_v2, combine_v2, skip_dead, dyn_grid, k1_tsub and k1_chunk_size
    pick TPU mechanisms the JAX tests show bit-identical; the port has one
    implementation of their contract."""
    w, h = 24, 16
    scene, sky, basis = _three(w, h)
    kw = dict(width=w, height=h, spp=2, num_bounces=5, cuts=(2,))
    ref = torch.zeros((w * h, 3))
    rg.render_image_regrouped(ref, 1, True, scene, sky, basis, **kw)
    got = torch.zeros((w * h, 3))
    rg.render_image_regrouped(got, 1, True, scene, sky, basis, pack_v2=False,
                              combine_v2=False, skip_dead=False, dyn_grid=False,
                              k1_tsub=8, k1_chunk_size=64, **kw)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


# --- the CUDA wrappers, with a stub library ------------------------------

class _StubLib:
    """Stands in for the built library: records each C call."""

    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return self.rc
        return call


def _stubbed(monkeypatch, rc=0):
    """Make the wrappers treat CPU tensors as CUDA ones and launch a stub;
    the plain twins must then never run."""
    lib = _StubLib(rc)

    class _Built:
        pass

    built = _Built()
    built.lib = lib
    monkeypatch.setattr(rg, "_device_type", lambda t: "cuda")
    monkeypatch.setattr(rg, "_library", lambda: built)
    monkeypatch.setattr(rg, "_stream_handle", lambda device: 1234)

    def _no_plain(*a, **k):
        raise AssertionError("a plain twin ran for a CUDA tensor")

    for name in ("k0_plain", "pack_plain", "k1_plain", "combine_plain",
                 "combine_chain_plain"):
        monkeypatch.setattr(rg, name, _no_plain)
    return lib


def _launch_counts():
    return [getattr(rg, f"launch_{k}").launches for k in ("k0", "pack", "k1", "combine")]


def test_wrapper_launches_kernels_for_cuda_tensor(monkeypatch):
    w, h = 20, 12
    scene, sky, basis = _three(w, h)
    lib = _stubbed(monkeypatch)
    acc = torch.zeros((w * h, 3))
    before = _launch_counts()
    out = rg.render_image_regrouped(acc, 5, True, scene, sky, basis, width=w, height=h,
                                    spp=4, num_bounces=8, cuts=(2, 4, 6))
    assert out is acc
    assert [a - b for a, b in zip(_launch_counts(), before)] == [1, 3, 3, 1]
    names = [n for n, _ in lib.calls]
    assert names == ["wrt_regroup_k0", "wrt_regroup_pack", "wrt_regroup_k1",
                     "wrt_regroup_pack", "wrt_regroup_k1", "wrt_regroup_pack",
                     "wrt_regroup_k1", "wrt_regroup_combine"]
    k0 = lib.calls[0][1]
    t, _ = rg.plan(w, h, 4, 8)
    assert k0[4] is None and k0[5] == 5  # no textures; five spheres, unpadded
    assert k0[8:13] == (t.cap, w, h, t.tiles_x, 2)
    assert k0[15:18] == (5, 0, 2)  # frame, row offset, b_hi = first cut
    assert k0[-1] == 1234  # the stream, after the (empty) chunk hierarchy
    assert [c[1][15:17] for c in lib.calls if c[0] == "wrt_regroup_k1"] == [
        (2, 4), (4, 6), (6, 8)]
    assert all(c[1][-8:-3] == (0, 0, 0, 16, 16) and c[1][-3:] == (0.0, 0.0, 1234)
               for c in lib.calls if c[0] in ("wrt_regroup_k0", "wrt_regroup_k1"))
    home = lib.calls[-1][1]
    assert home[3] == acc.data_ptr() and home[4] == 3 and home[-2] == 1  # phases, clear


def test_wrapper_raises_on_launch_error(monkeypatch):
    w, h = 8, 8
    scene, sky, basis = _three(w, h)
    _stubbed(monkeypatch, rc=700)
    before = _launch_counts()
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        rg.render_image_regrouped(torch.zeros((w * h, 3)), 0, True, scene, sky, basis,
                                  width=w, height=h, spp=1, num_bounces=4)
    assert _launch_counts() == before


def test_build_key_hashes_headers(tmp_path, monkeypatch):
    """Changing any header under csrc/ changes every library's build key,
    so a library that includes it is rebuilt rather than loaded stale; no
    list of includes is kept."""
    from weekend_raytracer_tpu_torch.ops.cuda import build

    (tmp_path / "k.cu").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// one\n")
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "c.h").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    key = build.build_key("lib", ("k.cu",))
    assert key == build.build_key("lib", ("k.cu",))
    (tmp_path / "b.cuh").write_text("// two\n")
    key2 = build.build_key("lib", ("k.cu",))
    assert key2 != key
    (tmp_path / "sub" / "c.h").write_text("// two\n")  # included by nothing listed
    key3 = build.build_key("lib", ("k.cu",))
    assert key3 not in (key, key2)
    (tmp_path / "d.cuh").write_text("// new\n")  # a header added later
    key4 = build.build_key("lib", ("k.cu",))
    assert key4 not in (key, key2, key3)
    (tmp_path / "notes.txt").write_text("not a header\n")
    assert build.build_key("lib", ("k.cu",)) == key4
    assert len(rg.LIBRARY) == len(mk.LIBRARY) == 2


def test_textured_band_of_tile_rows_is_the_full_image():
    """The textured scene (image textures through the texture pool): a band
    of whole tile rows, rendered at its global row offset, equals the same
    rows of the full image in every bit, as chip_smoke.py's textured 1080p
    band does on the card."""
    w, h, lo, rows = 24, 96, 32, 32
    _, (scene, sky, basis) = _setup("textured", w, h)
    kw = dict(width=w, spp=4, num_bounces=6, cuts=(2,))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        full = torch.zeros((w * h, 3))
        rg.render_image_regrouped(full, 3, True, scene, sky, basis, height=h, **kw)
        band = torch.zeros((w * rows, 3))
        rg.render_image_regrouped(band, 3, True, scene, sky, basis, height=rows,
                                  row_offset=lo, full_height=h, **kw)
    finally:
        torch.set_num_threads(threads)
    torch.testing.assert_close(band, full[lo * w:(lo + rows) * w], rtol=0, atol=0)
    assert float(band.mean()) > 0.01


def test_row_band_reproduces_full_image():
    """A band rendered at a global row offset seeds and aims in full-image
    coordinates, so it gives the same rows as the full render (up to the
    CPU twins' batch-shape rounding; bit for bit on the card)."""
    w, h = 24, 40
    scene, sky, basis = _three(w, h)
    kw = dict(width=w, spp=2, num_bounces=5, cuts=(2,))
    full = torch.zeros((w * h, 3))
    rg.render_image_regrouped(full, 3, True, scene, sky, basis, height=h, **kw)
    band = torch.zeros((w * 6, 3))
    rg.render_image_regrouped(band, 3, True, scene, sky, basis, height=6,
                              row_offset=33, full_height=h, **kw)
    diff = (band - full[33 * w:39 * w]).abs()
    assert (diff > 1e-6).any(dim=1).float().mean() < 0.01
    assert float(band.mean()) > 0.01
