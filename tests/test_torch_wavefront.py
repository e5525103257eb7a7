"""The port's row-compacted wavefront against the JAX package's, on the CPU.

The JAX kernels run in Pallas interpret mode, as tests/test_wavefront.py
runs them: the three pallas_calls are built here exactly as
weekend_raytracer_tpu/ops/pallas/wavefront.py:404-478 builds them. The port
runs its plain PyTorch twins (``k0_plain``, ``compact_plain``,
``k1_plain``), which are what a CPU tensor takes.

- COMPACT moves rows: fed the JAX K0's own pool, the twin gives the JAX
  kernel's row count and dense rows bit for bit (+0.0 and -0.0 held equal).
- K0 and K1 trace Monte-Carlo paths: home rows match exactly, alive flags
  agree on >= 99% of lanes, and the contributions they write, folded into
  images, meet tests/test_pallas.py's gates (tonemapped RMSE < 5e-3, linear
  mean within a relative 1e-3), as torch and XLA round transcendentals
  differently.
- The slice as a whole, ``render_image_wavefront`` on a CPU accumulator,
  meets the same gates at three cut schedules against the JAX function,
  with its live row counts within 1% of the JAX ones.
- Twin against twin (cut schedules, the port's regroup, the megakernel at
  one sample): fewer than 1% of pixels may differ by more than 1e-6, the
  limit of tests/test_torch_regroup.py::test_cut_schedules_agree, since the
  CPU twins may round differently with batch shape; where the twins trace
  the same batches the test asks for the same bits.

JAX compiles each interpret-mode kernel once per shape, so its outputs are
computed once in module-scoped fixtures at 48x32, spp 4.
"""
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
from weekend_raytracer_tpu.ops.pallas import wavefront as jwf  # noqa: E402
from weekend_raytracer_tpu.ops.tonemap import to_srgb_u8  # noqa: E402
from weekend_raytracer_tpu_torch.models.camera import CameraBasis  # noqa: E402
from weekend_raytracer_tpu_torch.models.sky import SkyState  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import megakernel as mk  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import regroup as rg  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import wavefront as wf  # noqa: E402
from weekend_raytracer_tpu_torch.ops.tracer import Scene  # noqa: E402

_F32 = jnp.float32
_SDS = jax.ShapeDtypeStruct
_BASIS_FIELDS = ("eye", "horizontal", "vertical", "u", "v", "lens_radius",
                 "lower_left_corner")
W, H, SPP, BOUNCES = 48, 32, 4, 8
CUT, B_HI = 2, 4  # the kernels' case: K0 over [0, 2), COMPACT, K1 over [2, 4)
_FRAMES = 4
# (scene, phase_cuts) of the whole-slice comparison
_SLICE = [("rtiow", ()), ("rtiow", (2,)), ("rtiow", (2, 4)), ("textured", (2,))]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twins run on tensors of a few thousand rays, where threads buy
    little: one thread keeps this module from oversubscribing the cores
    that the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(name, w=W, h=H):
    """A JAX scene, sky and basis, and the same leaves carried into the port."""
    jscene = jscenes.SCENES[name][0]().build()
    jsky = j_to_sky_state(JSkyParams())
    jbasis = JBasis.create(jscenes.SCENES[name][1](), (w, h))
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
    return (jscene, jsky, jbasis), (scene, sky, basis)


def _equal_pm0(a, b):
    """Bit for bit equality, +0.0 and -0.0 held equal (the RNG state's bits
    may read as NaNs, so the bits are compared, not the floats)."""
    def bits(x):
        v = np.ascontiguousarray(x, dtype=np.float32).view(np.int32)
        return np.where(v == np.int32(-2**31), 0, v)
    return np.array_equal(bits(a), bits(b))


# --- the JAX kernels, built as at wavefront.py:404-478 --------------------

def _smem():
    return pl.BlockSpec(memory_space=pltpu.SMEM)


def _blk(comps):
    return pl.BlockSpec((1, comps, 32, 128), lambda i: (i, 0, 0, 0),
                        memory_space=pltpu.VMEM)


def _jax_scene(jscene, jsky, jbasis):
    """What every wavefront kernel reads (wavefront.py:372-396)."""
    chunk = jmk.default_chunk_size(int(jscene.spheres.centers.shape[0]))
    (s_attrs, chunk_arrays, super_arrays, n_spheres, n_chunks, n_super, tex_pool,
     retr_lut) = jmk.prepare_scene_arrays(jscene, jbasis, chunk, 16)
    extra = [a for a in (tex_pool, retr_lut) if a is not None]
    specs = ([_smem()] * (len(s_attrs) + 13)
             + [pl.BlockSpec(memory_space=pltpu.VMEM)] * len(extra))
    return dict(arrays=(*s_attrs, *chunk_arrays, *super_arrays, *extra), specs=specs,
                n_attrs=len(s_attrs), n_extra=len(extra),
                make=dict(n_spheres=n_spheres, chunk_size=chunk, n_chunks=n_chunks,
                          super_factor=16, n_super=n_super, textures=tex_pool is not None,
                          retr=retr_lut is not None, lut_rows=-(-n_spheres // 128)),
                cam=jmk.pack_camera(jbasis), sky=jmk.pack_sky(jsky))


def _jax_kernels(jargs, t):
    """K0 (bounces [0, CUT)) as a function of the frame, COMPACT of (pool,
    row count) and K1 (bounces [CUT, B_HI)) of (dense pool, contributions,
    row count), each compiled once."""
    sc = _jax_scene(*jargs)
    m = sc["make"]
    n_tiles = t.tiles_x * t.tiles_y
    pool_sds = _SDS((n_tiles, wf.N_COMP, 32, 128), _F32)
    contrib_sds = _SDS((n_tiles, 3, 32, 128), _F32)
    k0 = jwf._make_k0(t.width, t.height, t.spp, CUT, m["n_spheres"], m["chunk_size"],
                      m["n_chunks"], 16, m["n_super"], t.tiles_x, t.block_w, 32, t.spp_shift,
                      textures=m["textures"], retr=m["retr"], lut_rows=m["lut_rows"])
    k0_call = pl.pallas_call(
        k0, grid=(n_tiles,), in_specs=[_smem()] * 3 + sc["specs"],
        out_specs=(_blk(wf.N_COMP), _blk(3)), out_shape=(pool_sds, contrib_sds),
        interpret=True)
    compact_call = pl.pallas_call(
        jwf._compact_kernel, grid=(n_tiles,), in_specs=[_smem(), _blk(wf.N_COMP)],
        out_specs=(pl.BlockSpec(memory_space=pl.ANY), pl.BlockSpec(memory_space=pltpu.SMEM)),
        out_shape=(pool_sds, _SDS((1,), jnp.int32)),
        scratch_shapes=[pltpu.VMEM((32, 128), _F32), pltpu.SMEM((32,), jnp.int32),
                        pltpu.SMEM((1,), jnp.int32), pltpu.SemaphoreType.DMA((32,))],
        compiler_params=pltpu.CompilerParams(has_side_effects=True), interpret=True)
    k1 = jwf._make_k1(m["n_spheres"], m["chunk_size"], m["n_chunks"], 16, m["n_super"],
                      textures=m["textures"], retr=m["retr"], lut_rows=m["lut_rows"])
    k1_call = pl.pallas_call(
        k1, grid=(n_tiles,),
        in_specs=[_smem()] * 3 + sc["specs"] + [_blk(wf.N_COMP),
                                                pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=(_blk(wf.N_COMP), pl.BlockSpec(memory_space=pl.ANY)),
        out_shape=(pool_sds, contrib_sds),
        scratch_shapes=[pltpu.VMEM((32, 3, 128), _F32), pltpu.SMEM((32,), jnp.int32),
                        pltpu.SemaphoreType.DMA((32,))],
        input_output_aliases={3 + sc["n_attrs"] + 13 + sc["n_extra"] + 1: 1},
        compiler_params=pltpu.CompilerParams(has_side_effects=True), interpret=True)
    k0_fn = jax.jit(lambda meta: k0_call(meta, sc["cam"], sc["sky"], *sc["arrays"]))
    k1_fn = jax.jit(lambda cpool, contrib, count: k1_call(
        jnp.asarray([CUT, B_HI], jnp.int32), count, sc["sky"], *sc["arrays"], cpool, contrib))
    return (lambda frame: k0_fn(jnp.asarray([frame], jnp.uint32)),
            jax.jit(compact_call), k1_fn)


# --- helpers on images ---------------------------------------------------

def _tonemapped(img, w, h):
    return np.asarray(to_srgb_u8(np.asarray(img).reshape(h, w, 3))).astype(np.float32) / 255


def _assert_statistically_equal(a, b, w=W, h=H):
    rmse = float(np.sqrt(((_tonemapped(a, w, h) - _tonemapped(b, w, h)) ** 2).mean()))
    assert rmse < 5e-3, rmse
    assert abs(a.mean() - b.mean()) / max(abs(a.mean()), 1e-6) < 1e-3, (a.mean(), b.mean())


def _fold(contrib, t):
    """[tiles, 3, 32, 128] contributions -> [H*W, 3] pixel sums."""
    acc = torch.zeros((t.width * t.height, 3))
    wf._fold(torch.from_numpy(np.array(contrib)), acc, t, True)
    return acc.numpy()


@pytest.fixture(scope="module")
def kernels():
    """K0, COMPACT and K1 of the JAX package and of the port on rtiow, over
    _FRAMES frames. The port's COMPACT takes the JAX K0's pool and its K1
    the JAX COMPACT's dense pool and the JAX K0's contributions; images
    are summed over frames."""
    jargs, (scene, sky, basis) = _setup("rtiow")
    t = wf.plan(W, H, SPP)
    n_rows = t.cap // wf.LANES
    inp = mk.kernel_inputs(scene, sky, basis)
    jk0, jcompact, jk1 = _jax_kernels(jargs, t)
    out = dict(t=t, n_rows=n_rows, home_exact=True, compact_exact=True, counts=[],
               k0_alive=[], k1_alive=[], live_rows=[],
               k0=np.zeros((2, W * H, 3), np.float32), k1=np.zeros((2, W * H, 3), np.float32))
    for f in range(_FRAMES):
        jpool, jcontrib = (np.asarray(a) for a in jk0(f))
        pool = torch.empty(jpool.shape)
        contrib = torch.empty(jcontrib.shape)
        wf.k0_plain(inp, pool, contrib, t, f, CUT)
        pool = pool.numpy()
        out["home_exact"] &= np.array_equal(pool[:, wf._HOME], jpool[:, wf._HOME])
        out["k0_alive"].append((pool[:, wf._AL] == jpool[:, wf._AL]).mean())
        out["k0"] += [_fold(jcontrib, t), _fold(contrib.numpy(), t)]

        jcpool, jcount = (np.asarray(a) for a in jcompact(
            jnp.asarray([n_rows], jnp.int32), jnp.asarray(jpool)))
        n = int(jcount[0])
        counts = torch.tensor([n_rows, -1], dtype=torch.int32)
        dense = torch.full(jpool.shape, 7.0)
        wf.compact_plain(torch.from_numpy(np.array(jpool)), dense, counts, 1)
        out["counts"].append((int(counts[1]), n))
        rows = dense.numpy().transpose(0, 2, 1, 3).reshape(-1, wf.N_COMP, 128)[:n]
        jrows = jcpool.transpose(0, 2, 1, 3).reshape(-1, wf.N_COMP, 128)[:n]
        out["compact_exact"] &= _equal_pm0(rows, jrows)
        out["live_rows"].append(n / n_rows)

        jpool1, jcontrib1 = (np.asarray(a) for a in jk1(
            jnp.asarray(jcpool), jnp.asarray(jcontrib), jnp.asarray(jcount)))
        pool1 = torch.from_numpy(jcpool.copy())
        contrib1 = torch.from_numpy(jcontrib.copy())
        wf.k1_plain(inp, pool1, contrib1, torch.tensor([n_rows, n], dtype=torch.int32), 1,
                    CUT, B_HI)
        rows1 = pool1.numpy().transpose(0, 2, 1, 3).reshape(-1, wf.N_COMP, 128)[:n]
        jrows1 = jpool1.transpose(0, 2, 1, 3).reshape(-1, wf.N_COMP, 128)[:n]
        out["home_exact"] &= (np.array_equal(rows1[:, wf._HOME], jrows[:, wf._HOME])
                              and np.array_equal(jrows1[:, wf._HOME], jrows[:, wf._HOME]))
        out["k1_alive"].append((rows1[:, wf._AL] == jrows1[:, wf._AL]).mean())
        out["k1"] += [_fold(jcontrib1, t), _fold(contrib1.numpy(), t)]
    return out


def test_k0_matches_jax(kernels):
    k = kernels
    assert k["home_exact"]
    assert min(k["k0_alive"]) >= 0.99
    jimg, img = k["k0"] / (_FRAMES * SPP)
    _assert_statistically_equal(jimg, img)


def test_compact_matches_jax_bit_for_bit(kernels):
    """Fed the JAX K0's pool, the twin keeps the JAX kernel's rows: the
    same count and every dense row below it, bit for bit (+-0 equal)."""
    k = kernels
    assert all(a == b for a, b in k["counts"]), k["counts"]
    assert k["compact_exact"]
    assert all(0.5 < f < 1.0 for f in k["live_rows"])  # rows kept and rows dropped


def test_k1_matches_jax(kernels):
    """K1 on the JAX COMPACT's dense pool: home rows unchanged on both sides
    and equal, alive flags agree on >= 99% of lanes, and the contributions
    written to the home rows give statistically equal images."""
    k = kernels
    assert k["home_exact"]
    assert min(k["k1_alive"]) >= 0.99
    jimg, img = k["k1"] / (_FRAMES * SPP)
    _assert_statistically_equal(jimg, img)


@pytest.fixture(scope="module")
def slices():
    """Each _SLICE case through the port, _FRAMES progressive frames, and
    the JAX function (interpret mode) once per scene, at that scene's
    deepest schedule: the JAX wavefront gives the same image at every cut
    schedule (tests/test_wavefront.py::test_wavefront_phase_invariance), and
    a schedule's row counts are the first ones of any schedule it begins,
    so one JAX compile serves each scene's cases. Row counts are summed
    over the frames."""
    deepest = {}
    for name, cuts in _SLICE:
        deepest[name] = max(deepest.get(name, ()), cuts, key=len)
    out, ref = {}, {}
    for name, cuts in deepest.items():
        jargs, port = _setup(name)
        kw = dict(width=W, height=H, spp=SPP, num_bounces=BOUNCES, phase_cuts=cuts,
                  debug_counts=True)
        jacc = jnp.zeros((W * H, 3), jnp.float32)
        jrows = np.zeros(len(cuts) + 1)
        for f in range(_FRAMES):
            jacc, jc = jwf.render_image_wavefront(jacc, jnp.uint32(f), jnp.bool_(f == 0),
                                                  *jargs, **kw)
            jrows += [int(np.asarray(x)[0]) for x in jc]
        ref[name] = (np.asarray(jacc) / (_FRAMES * SPP), jrows, port)
    for name, cuts in _SLICE:
        jimg, jrows, port = ref[name]
        acc = torch.zeros((W * H, 3))
        rows = np.zeros(len(cuts) + 1)
        for f in range(_FRAMES):
            got, c = wf.render_image_wavefront(acc, f, f == 0, *port, width=W, height=H,
                                               spp=SPP, num_bounces=BOUNCES, phase_cuts=cuts,
                                               debug_counts=True)
            assert got is acc
            rows += [int(x[0]) for x in c]
        out[(name, cuts)] = (jimg, acc.numpy() / (_FRAMES * SPP), jrows[:len(rows)], rows)
    return out


@pytest.mark.parametrize("name,cuts", _SLICE)
def test_slice_matches_jax(name, cuts, slices):
    ref, got, jrows, rows = slices[(name, cuts)]
    assert np.isfinite(got).all() and got.mean() > 0.01
    _assert_statistically_equal(ref, got)
    assert rows[0] == jrows[0] == _FRAMES * 64  # two tiles of 32 rows, every frame
    np.testing.assert_allclose(rows, jrows, rtol=0.01)


def _frames(fn, scene, sky, basis, w, h, frames, spp, bounces, **kw):
    acc = torch.zeros((w * h, 3))
    for f in range(frames):
        fn(acc, f, f == 0, scene, sky, basis, width=w, height=h, spp=spp,
           num_bounces=bounces, **kw)
    return acc.numpy() / (frames * spp)


def _mismatch(a, b):
    return (np.abs(a - b) > 1e-6).any(axis=1).mean()


def test_twin_phase_invariance():
    """Every cut schedule gives the same image: a lane's contribution is its
    own tr * cr, wherever its path ended. On the CPU the twins trace these
    schedules in the same batches here, so the bits agree."""
    _, (scene, sky, basis) = _setup("rtiow")
    ref = _frames(wf.render_image_wavefront, scene, sky, basis, W, H, 1, SPP, BOUNCES)
    for cuts in ((2,), (2, 4), (1, 2, 3, 4, 5, 6, 7)):
        got = _frames(wf.render_image_wavefront, scene, sky, basis, W, H, 1, SPP, BOUNCES,
                      phase_cuts=cuts)
        assert _mismatch(got, ref) < 0.01, cuts
        np.testing.assert_array_equal(got, ref, err_msg=str(cuts))


def test_twin_matches_regroup_twin():
    """The JAX package's own invariant (tests/test_renderer.py:283-301):
    regroup and the wavefront give the same pixels. The twins trace the same
    live records in the same batches, so the bits agree, over two frames,
    the second accumulated onto the first."""
    _, (scene, sky, basis) = _setup("textured")
    cuts = (2, 4, 6)
    a = _frames(wf.render_image_wavefront, scene, sky, basis, W, H, 2, SPP, BOUNCES,
                phase_cuts=cuts)
    b = _frames(rg.render_image_regrouped, scene, sky, basis, W, H, 2, SPP, BOUNCES,
                cuts=cuts)
    assert _mismatch(a, b) < 0.01
    np.testing.assert_array_equal(a, b)


def test_twin_matches_megakernel_twin_at_one_sample():
    """At one sample per pixel the wavefront and the megakernel run the same
    sample per pixel; the twins batch them differently (slots against
    pixels), so < 1% of pixels may differ by more than 1e-6."""
    _, (scene, sky, basis) = _setup("rtiow")
    kw = dict(w=W, h=H, frames=1, spp=1, bounces=BOUNCES)
    a = _frames(wf.render_image_wavefront, scene, sky, basis, phase_cuts=(2,), **kw)
    b = _frames(mk.render_image_megakernel, scene, sky, basis, **kw)
    assert np.isfinite(a).all() and a.mean() > 0.01
    assert _mismatch(a, b) < 0.01


def _three(w, h):
    return _setup("three", w, h)[1]


@pytest.mark.parametrize("spp", [3, 256, 0])
def test_bad_spp_raises(spp):
    scene, sky, basis = _three(16, 8)
    with pytest.raises(ValueError, match="power of two"):
        wf.render_image_wavefront(torch.zeros((16 * 8, 3)), 0, True, scene, sky, basis,
                                  width=16, height=8, spp=spp, num_bounces=4)


def test_compact_edge_cases():
    """COMPACT's twin on a seeded pool: only rows below the input count are
    kept, rows with one live lane are kept, NaN-state bits move as they are,
    an all-dead pool gives 0 rows, and rows past the new count are left as
    they were."""
    r = np.random.RandomState(3)
    n_tiles = 3
    pool = r.standard_normal((n_tiles, wf.N_COMP, 32, 128)).astype(np.float32)
    pool.view(np.int32)[:, wf._ST] = r.randint(-2**31, 2**31 - 1, (n_tiles, 32, 128))
    live = r.rand(n_tiles * 32) < 0.5
    alive = np.zeros((n_tiles * 32, 128), np.float32)
    alive[live, r.randint(0, 128, live.sum())] = 1.0
    pool[:, wf._AL] = alive.reshape(n_tiles, 32, 128)
    for n_in in (n_tiles * 32, 70):
        dst = torch.full(pool.shape, 9.0)
        counts = torch.tensor([n_in, -1], dtype=torch.int32)
        wf.compact_plain(torch.from_numpy(pool), dst, counts, 1)
        keep = np.nonzero(live[:n_in])[0]
        assert int(counts[1]) == keep.size
        rows = pool.transpose(0, 2, 1, 3).reshape(-1, wf.N_COMP, 128)
        got = dst.numpy().transpose(0, 2, 1, 3).reshape(-1, wf.N_COMP, 128)
        np.testing.assert_array_equal(got[:keep.size].view(np.int32), rows[keep].view(np.int32))
        assert (got[keep.size:] == 9.0).all()
    pool[:, wf._AL] = 0.0
    counts = torch.tensor([n_tiles * 32, -1], dtype=torch.int32)
    wf.compact_plain(torch.from_numpy(pool), torch.zeros(pool.shape), counts, 1)
    assert int(counts[1]) == 0


def test_debug_counts_and_clear():
    """debug_counts gives the home pool's rows (one tile of 32 here), then
    the live rows after each cut, as device tensors; clear=False adds onto
    the accumulator."""
    w, h = 40, 24
    scene, sky, basis = _three(w, h)
    kw = dict(width=w, height=h, spp=2, num_bounces=6, phase_cuts=(2, 4))
    acc = torch.full((w * h, 3), 7.0)  # stale data
    out, rows = wf.render_image_wavefront(acc, 0, True, scene, sky, basis, debug_counts=True,
                                          **kw)
    assert out is acc and float(acc.min()) < 1.0
    assert all(r.shape == (1,) and r.dtype == torch.int32 for r in rows)
    assert int(rows[0]) == 32 and int(rows[0]) >= int(rows[1]) >= int(rows[2]) > 0
    first = acc.clone()
    wf.render_image_wavefront(acc, 1, False, scene, sky, basis, **kw)
    again = torch.zeros_like(acc)
    wf.render_image_wavefront(again, 1, True, scene, sky, basis, **kw)
    torch.testing.assert_close(acc, first + again, rtol=0, atol=0)


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
    monkeypatch.setattr(wf, "_device_type", lambda t: "cuda")
    monkeypatch.setattr(wf, "_library", lambda: built)
    monkeypatch.setattr(wf, "_stream_handle", lambda device: 1234)

    def _no_plain(*a, **k):
        raise AssertionError("a plain twin ran for a CUDA tensor")

    for name in ("k0_plain", "compact_plain", "k1_plain"):
        monkeypatch.setattr(wf, name, _no_plain)
    return lib


def _launch_counts():
    return [getattr(wf, f"launch_{k}").launches for k in ("k0", "compact", "k1")]


@pytest.mark.parametrize("cuts", [(), (2,), (2, 4, 6)])
def test_wrapper_launches_kernels_for_cuda_tensor(cuts, monkeypatch):
    """One K0 per frame, one COMPACT and one K1 per cut, with the C entry
    points' arguments (K0's and K1's followed by the cull hierarchy, here
    empty, and the two terms of each lane's box margin, before the
    stream); the row counts stay in one device tensor."""
    w, h = 20, 12
    scene, sky, basis = _three(w, h)
    lib = _stubbed(monkeypatch)
    acc = torch.zeros((w * h, 3))
    before = _launch_counts()
    out = wf.render_image_wavefront(acc, 5, True, scene, sky, basis, width=w, height=h,
                                    spp=4, num_bounces=8, phase_cuts=cuts + (0, 9))
    assert out is acc
    assert [a - b for a, b in zip(_launch_counts(), before)] == [1, len(cuts), len(cuts)]
    assert [n for n, _ in lib.calls] == (["wrt_wavefront_k0"]
                                         + ["wrt_wavefront_compact", "wrt_wavefront_k1"]
                                         * len(cuts))
    t = wf.plan(w, h, 4)
    k0 = lib.calls[0][1]
    assert k0[4] is None and k0[5] == 5  # no textures; five spheres, unpadded
    assert k0[8:13] == (t.cap, w, h, t.tiles_x, 2)
    assert k0[15:17] == (5, cuts[0] if cuts else 8)  # frame, b_hi
    assert len(k0) == 28 and k0[-8:-3] == (0, 0, 0, 16, 16) and k0[-3:] == (0.0, 0.0, 1234)
    compacts = [a for n, a in lib.calls if n == "wrt_wavefront_compact"]
    k1s = [a for n, a in lib.calls if n == "wrt_wavefront_k1"]
    src = k0[6]  # K0's pool
    for k, (c, k1) in enumerate(zip(compacts, k1s)):
        assert c[0] == src and c[1] != src  # the pools take turns
        assert c[3] - c[2] == 4 and c[5:] == (t.cap, 1234)  # counts[k] -> counts[k + 1]
        assert k1[:5] == k0[1:6] and k1[6] == k0[7]  # the scene; K0's contributions
        assert k1[5] == c[1] and k1[7] == c[3] and k1[8] == t.cap  # the dense pool, its count
        assert k1[9:11] == (cuts[k], cuts[k + 1] if k + 1 < len(cuts) else 8)
        assert len(k1) == 22 and k1[-8:-3] == (0, 0, 0, 16, 16) and k1[-3:] == (0.0, 0.0, 1234)
        src = c[1]


def test_wrapper_raises_on_launch_error(monkeypatch):
    w, h = 8, 8
    scene, sky, basis = _three(w, h)
    _stubbed(monkeypatch, rc=700)
    before = _launch_counts()
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        wf.render_image_wavefront(torch.zeros((w * h, 3)), 0, True, scene, sky, basis,
                                  width=w, height=h, spp=1, num_bounces=4, phase_cuts=(2,))
    assert _launch_counts() == before
