"""The port's cull counters against the JAX package's stats=True kernels.

On the CPU the port's counters come from the plain twins
(``render_image_megakernel(..., stats=True)`` on a CPU accumulator, and
``k1_plain(..., stats=...)``); the JAX kernels run in Pallas interpret mode,
as tests/test_pallas.py and tests/test_regroup.py run them. Each table has
one row per TPU tile: col 0 bounce iterations of the tile's loop, col 1
live lanes summed over them, col 2 chunk bodies and col 3 super-chunk bodies
the whole-tile cull enters, cols 4-7 zero.

- At one bounce the counters depend only on the camera rays (the
  megakernel) or on the records of one dense pool that both K1s read (K1),
  so they are equal per tile.
- Over more bounces the paths diverge statistically (ROADMAP,
  "Statistical"): torch and XLA round transcendentals differently, and a
  path that turns differently changes the iterations, lanes and chunks of
  its tile. The tolerances below are per column.

The CUDA kStats instantiations are held to these twins by
tests/test_torch_cuda.py and chip_smoke.py, which need a card; here their
wrappers are tested with stub libraries.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import test_torch_regroup as trg  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from weekend_raytracer_tpu.models import scenes as jscenes  # noqa: E402
from weekend_raytracer_tpu.models.camera import Camera as JCamera  # noqa: E402
from weekend_raytracer_tpu.models.camera import CameraBasis as JBasis  # noqa: E402
from weekend_raytracer_tpu.models.sky import SkyParams as JSkyParams  # noqa: E402
from weekend_raytracer_tpu.models.sky import to_sky_state as j_to_sky_state  # noqa: E402
from weekend_raytracer_tpu.ops.pallas import megakernel as jmk  # noqa: E402
from weekend_raytracer_tpu.ops.pallas import regroup as jrg  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import megakernel as mk  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import regroup as rg  # noqa: E402

# case -> (scene, camera, w, h, spp, chunk_size): tests/test_pallas.py:241-255's
# RTiOW case, and a scene with super-chunks (75 chunks of 16, 5 supers of
# 16 chunks; RTiOW's 31 chunks are below 2 * super_factor) seen through a
# narrow lens, so that a tile's rays miss some super-chunks
_CASES = {
    "rtiow": (lambda: jscenes.rtiow_final(), jscenes.rtiow_final_camera, 128, 72, 2, None),
    "super": (lambda: jscenes.random_spheres(1200),
              lambda: JCamera.look_at((0.0, 6.0, 60.0), (30.0, 0.5, 30.0),
                                      vfov_degrees=8.0, aperture=0.02),
              128, 64, 2, 16),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twins' small tensors gain nothing from intra-op threads, and
    beside the other test workers those threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_case(name):
    build, cam, w, h, _, _ = _CASES[name]
    return (build().build(), j_to_sky_state(JSkyParams()),
            JBasis.create(cam(), (w, h)))


def _render(name, bounces):
    """(JAX table, port table, port image) of one frame with stats."""
    jargs = _jax_case(name)
    _, _, w, h, spp, chunk = _CASES[name]
    kw = dict(width=w, height=h, spp=spp, num_bounces=bounces, chunk_size=chunk)
    _, jst = jmk.render_image_pallas(jnp.zeros((w * h, 3), jnp.float32), jnp.uint32(0),
                                     jnp.bool_(True), *jargs, stats=True, **kw)
    acc = torch.zeros((w * h, 3))
    img, st = mk.render_image_megakernel(acc, 0, True, *trg._port(*jargs), stats=True, **kw)
    return np.asarray(jst), st.numpy(), img.numpy()


@pytest.fixture(scope="module")
def counters():
    cache = {}

    def get(name, bounces):
        if (name, bounces) not in cache:
            cache[name, bounces] = _render(name, bounces)
        return cache[name, bounces]

    return get


def _assert_invariants(st, max_iters, chunked=True):
    """tests/test_pallas.py:252-255, on every tile."""
    assert st.shape[1] == 8 and (st[:, 4:] == 0).all()
    assert (st[:, 0] >= 1).all() and (st[:, 0] <= max_iters).all()
    assert (st[:, 1] > 0).all()
    if chunked:
        assert (st[:, 2] >= st[:, 0]).all()


@pytest.mark.parametrize("name", list(_CASES))
def test_megakernel_counters_equal_at_one_bounce(name, counters):
    """Bounce 0 depends only on the camera rays, which the port reproduces:
    every column equal per tile. In the super-chunk case some tile misses
    a super-chunk, so col 3 is more than a count of every super."""
    jst, st, _ = counters(name, 1)
    spp = _CASES[name][4]
    assert st.shape == jst.shape == (mk.stats_tiles(*_CASES[name][2:4]), 8)
    np.testing.assert_array_equal(st, jst)
    _assert_invariants(st, spp)
    assert (st[:, 0] == spp).all() and (st[:, 1] == 4096 * spp).all()
    if name == "super":
        assert (st[:, 3] > 0).all() and (st[:, 3] < 5 * spp).any()


def test_megakernel_counters_within_tolerance(counters):
    """RTiOW over 8 bounces: per tile, col 0 within one iteration per
    sample and col 1 within 1%; col 2 within 15% per tile and 2% summed
    over tiles (the paths diverge statistically, see the module
    docstring); no super level."""
    jst, st, _ = counters("rtiow", 8)
    spp = _CASES["rtiow"][4]
    _assert_invariants(st, 8 * spp)
    _assert_invariants(jst, 8 * spp)
    assert (np.abs(st[:, 0] - jst[:, 0]) <= spp).all()
    np.testing.assert_allclose(st[:, 1], jst[:, 1], rtol=0.01)
    np.testing.assert_allclose(st[:, 2], jst[:, 2], rtol=0.15)
    np.testing.assert_allclose(st[:, 2].sum(), jst[:, 2].sum(), rtol=0.02)
    assert (st[:, 3] == 0).all() and (jst[:, 3] == 0).all()


def test_stats_leave_the_image_alone(counters):
    """stats=True gives the image of stats=False in every bit
    (tests/test_pallas.py:250)."""
    _, _, img = counters("rtiow", 8)
    jargs = _jax_case("rtiow")
    _, _, w, h, spp, _ = _CASES["rtiow"]
    plain = mk.render_image_megakernel(torch.zeros((w * h, 3)), 0, True, *trg._port(*jargs),
                                       width=w, height=h, spp=spp, num_bounces=8)
    np.testing.assert_array_equal(img, plain.numpy())


def test_padded_lanes_count_like_the_tpu():
    """A 70 x 66 image pads to 2 x 2 TPU tiles of 64 x 64; the padded lanes
    trace their clamped pixel again. With one bounce every lane is live
    once per sample, so col 1 is 4096 * spp in every tile."""
    jscene, jsky, jbasis = (jscenes.three_spheres().build(), j_to_sky_state(JSkyParams()),
                            JBasis.create(jscenes.three_spheres_camera(), (70, 66)))
    _, st = mk.render_image_megakernel(torch.zeros((70 * 66, 3)), 0, True,
                                       *trg._port(jscene, jsky, jbasis), width=70, height=66,
                                       spp=3, num_bounces=1, stats=True)
    np.testing.assert_array_equal(st[:, :2].numpy(), [[3, 3 * 4096]] * 4)
    assert (st[:, 2:] == 0).all()  # five spheres: no chunk hierarchy, nothing culled


def test_table_counts_chunks_only_inside_entered_supers():
    """A chunk the tile's rays would enter counts only when its super-chunk
    is entered too, as the JAX loops nest them; supers count on their own."""
    inp = mk.KernelInputs(*([None] * 6), chunk_bounds=torch.zeros((6, 8)),
                          super_bounds=torch.zeros((6, 2)), prior_idx=None, n_chunks=7,
                          n_super=2, chunk_size=16, super_factor=4, cull_reach=0.0,
                          cull_scale=0.0)
    c = mk.CullStats(inp, n_groups=2, n_iters=1, device="cpu")
    c.ran[0] = True
    c.chunks[0, 0] = torch.tensor([1, 1, 0, 0, 1, 1, 1, 0])  # 3 inside super 1
    c.supers[0, 0] = torch.tensor([0, 2])
    c.chunks[0, 1, 0] = 1
    c.supers[0, 1, 0] = 1
    np.testing.assert_array_equal(c.table(2).numpy(), [[2, 0, 4, 2, 0, 0, 0, 0]])
    np.testing.assert_array_equal(c.table(1)[:, 2:4].numpy(), [[3, 1], [1, 1]])


# --- K1: _make_k1(stats=True) on one dense pool built by the JAX K0 and PACK


def _jax_k1_stats(jscene, jsky, jbasis, t):
    """_make_k1(stats=True) as benchmarks/profile_regroup.py:233-252 wires
    it, as a function of (dense pool, dense rows, b_lo, b_hi), compiled
    once."""
    chunk, (s_attrs, chunk_arrays, super_arrays, n_spheres, n_chunks, n_super,
            tex_pool, retr_lut) = trg._jax_scene_arrays(jscene, jbasis)
    n_tiles = t.tiles_x * t.tiles_y
    extra = [a for a in (tex_pool, retr_lut) if a is not None]
    k1 = jrg._make_k1(n_spheres, chunk, n_chunks, 16, n_super, t.width, t.height, t.spp,
                      t.tiles_x, t.block_w, t.spp_shift, textures=tex_pool is not None,
                      stats=True, retr=retr_lut is not None, lut_rows=-(-n_spheres // 128))
    pool_blk = pl.BlockSpec((1, rg.N_COMP, 32, 128), lambda i: (i, 0, 0, 0),
                            memory_space=pltpu.VMEM)
    call = pl.pallas_call(
        k1, grid=(n_tiles,),
        in_specs=([trg._smem()] * (4 + len(s_attrs) + 13)
                  + [pl.BlockSpec(memory_space=pltpu.VMEM)] * len(extra) + [pool_blk]),
        out_specs=(pool_blk, pl.BlockSpec((1, 8, 128), lambda i: (i, 0, 0),
                                          memory_space=pltpu.VMEM)),
        out_shape=(jax.ShapeDtypeStruct((n_tiles, rg.N_COMP, 32, 128), jnp.float32),
                   jax.ShapeDtypeStruct((n_tiles, 8, 128), jnp.float32)),
        interpret=True)
    fn = jax.jit(lambda dense_j, rows, span: call(
        rows, span, jnp.asarray([0, 0], jnp.uint32), jmk.pack_sky(jsky), *s_attrs,
        *chunk_arrays, *super_arrays, *extra, dense_j)[1])
    return lambda dense_j, rows, b_lo, b_hi: np.asarray(fn(
        dense_j, trg._rows(rows), jnp.asarray([b_lo, b_hi], jnp.int32)))[:, :, 0]


_K1 = dict(w=128, h=64, spp=4, cut=2)  # 8 tiles of slots; the first cut of (2, 4, 6)
_K1_SPANS = ((2, 3), (2, 4))


@pytest.fixture(scope="module")
def k1_counters():
    """The JAX K0 (bounces [0, 2)) and pack give one dense pool; the JAX K1
    and the port's k1_plain count on it, for each span of bounces."""
    w, h, spp, cut = _K1["w"], _K1["h"], _K1["spp"], _K1["cut"]
    (jscene, jsky, jbasis), (scene, sky, basis) = trg._setup("rtiow", w, h)
    t, _ = rg.plan(w, h, spp, 8, (cut,))
    jpool, _ = trg._jax_k0(jscene, jsky, jbasis, t, cut)(0)
    jdense, _, jrows = trg._jax_pack(jpool, trg._rows(t.cap // 128))
    rows = int(np.asarray(jrows)[0])
    dense = trg._from_jax(jdense)[:, :t.cap]
    n = int((dense[rg._AL, :rows * 128] > 0.5).sum())
    inp = mk.kernel_inputs(scene, sky, basis)
    out = {"rows": rows, "live_tiles": -(-rows // 32), "t": t}
    jk1 = _jax_k1_stats(jscene, jsky, jbasis, t)
    for b_lo, b_hi in _K1_SPANS:
        jst = jk1(jnp.asarray(np.asarray(jdense)[:t.tiles_x * t.tiles_y]), rows, b_lo, b_hi)
        st = torch.full((t.cap // rg.TILE_RECORDS, 8), -1.0)
        pool = torch.from_numpy(dense.copy())
        counts = torch.tensor([t.cap, n], dtype=torch.int32)
        rg.k1_plain(inp, pool, torch.zeros((3, t.cap)), counts, 1, t, 0, b_lo, b_hi, stats=st)
        out[b_lo, b_hi] = (jst, st.numpy())
    return out


def test_k1_counters_equal_at_one_bounce(k1_counters):
    k = k1_counters
    live = k["live_tiles"]
    jst, st = k[2, 3]
    assert live >= 2
    np.testing.assert_array_equal(st[:live], jst[:live])
    _assert_invariants(st[:live], 1)
    assert (st[live:] == 0).all()  # tiles past the count


def test_k1_counters_within_tolerance(k1_counters):
    """Bounces [2, 4), the span profile_regroup.py's stats_main counts: col
    0 within one iteration per tile, col 1 within 1% per tile, col 2 within
    2% summed; no super level (RTiOW)."""
    k = k1_counters
    live = k["live_tiles"]
    jst, st = (a[:live] for a in k[2, 4])
    _assert_invariants(st, 2)
    assert (np.abs(st[:, 0] - jst[:, 0]) <= 1).all()
    np.testing.assert_allclose(st[:, 1], jst[:, 1], rtol=0.01)
    np.testing.assert_allclose(st[:, 2].sum(), jst[:, 2].sum(), rtol=0.02)
    assert (st[:, 3] == 0).all() and (jst[:, 3] == 0).all()


def test_k1_stats_refuse_other_layouts():
    """A stats table of another shape, and an empty span of bounces."""
    t, _ = rg.plan(64, 32, 4, 8, (2,))
    inp = mk.kernel_inputs(*trg._setup("rtiow", 64, 32)[1])
    pool = torch.zeros((rg.N_COMP, t.cap))
    args = (inp, pool, torch.zeros((3, t.cap)), torch.tensor([t.cap, 0], dtype=torch.int32),
            1, t, 0, 2, 4)
    good = torch.zeros((t.cap // 4096, 8))
    with pytest.raises(ValueError):
        rg.k1_plain(*args, stats=torch.zeros((t.cap // 4096, 4)))
    with pytest.raises(ValueError, match="at least one bounce"):
        rg.k1_plain(*args[:-1], 2, stats=good)


def test_kernel_inputs_carry_the_chunk_hierarchy():
    """kernel_inputs hands the kStats kernels prepare_scene_arrays' chunk
    and super bounds and priors, as the JAX prep builds them."""
    jscene, jsky, jbasis = _jax_case("super")
    inp = mk.kernel_inputs(*trg._port(jscene, jsky, jbasis), chunk_size=16)
    (_, chunk_arrays, super_arrays, _, n_chunks, n_super, _, _) = jmk.prepare_scene_arrays(
        jscene, jbasis, 16, 16)
    assert (inp.n_chunks, inp.n_super, inp.n_tests) == (n_chunks, n_super, 16 * n_super)
    np.testing.assert_array_equal(inp.chunk_bounds.numpy(),
                                  np.stack([np.asarray(a) for a in chunk_arrays[:6]]))
    np.testing.assert_array_equal(inp.super_bounds.numpy(),
                                  np.stack([np.asarray(a) for a in super_arrays]))
    np.testing.assert_array_equal(inp.prior_idx.numpy(), np.asarray(chunk_arrays[6]))
    assert inp.chunk_bounds.nbytes + inp.super_bounds.nbytes + inp.prior_idx.nbytes < 4096


# --- the wrappers with stub libraries: CUDA tensors launch or raise --------


class _Stub:
    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


def _no_plain(*a, **k):
    raise AssertionError("the plain version ran for a CUDA tensor")


@pytest.mark.parametrize("rc", [0, 700])
def test_megakernel_stats_launch_or_raise(monkeypatch, rc):
    w, h = 70, 40
    jargs = (jscenes.rtiow_final().build(), j_to_sky_state(JSkyParams()),
             JBasis.create(jscenes.rtiow_final_camera(), (w, h)))
    stub = _Stub(rc)

    class _Built:
        lib = type("Lib", (), {"wrt_megakernel_stats_launch": stub,
                               "wrt_megakernel_launch": _no_plain})()

    monkeypatch.setattr(mk, "_device_type", lambda t: "cuda")
    monkeypatch.setattr(mk, "_library", lambda: _Built())
    monkeypatch.setattr(mk, "_stream_handle", lambda device: 99)
    monkeypatch.setattr(mk, "render_image_megakernel_plain", _no_plain)
    before = (mk.render_image_megakernel.launches, mk.render_image_megakernel.stats_launches)
    acc = torch.zeros((w * h, 3))
    kw = dict(width=w, height=h, spp=3, num_bounces=5, stats=True)
    if rc:
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            mk.render_image_megakernel(acc, 1, True, *trg._port(*jargs), **kw)
        assert mk.render_image_megakernel.stats_launches == before[1]
        return
    out, table = mk.render_image_megakernel(acc, 1, True, *trg._port(*jargs), **kw)
    assert out is acc and tuple(table.shape) == (2, 8)  # 2 x 1 tiles of 64 x 64
    assert mk.render_image_megakernel.launches == before[0]
    assert mk.render_image_megakernel.stats_launches == before[1] + 1
    (args,) = stub.calls
    assert args[5] == acc.data_ptr() and args[7:9] == (w, h) and args[14:16] == (3, 5)
    # chunk hierarchy: RTiOW's 31 chunks of 16, no super level
    assert args[19:24] == (31, 31, 0, 16, 16)
    words = 2 * 3 * (2 + 5 * (1 + 0))
    assert args[24] is not None and args[25] == words
    assert args[26] == table.data_ptr() and args[27] == 99


def test_k1_stats_launch(monkeypatch):
    t, _ = rg.plan(64, 32, 4, 8, (2,))
    inp = mk.kernel_inputs(*trg._setup("rtiow", 64, 32)[1])
    stub = _Stub()

    class _Built:
        lib = type("Lib", (), {"wrt_regroup_k1_stats": stub, "wrt_regroup_k1": _no_plain})()

    monkeypatch.setattr(rg, "_library", lambda: _Built())
    monkeypatch.setattr(rg, "_stream_handle", lambda device: 7)
    before = (rg.launch_k1.launches, rg.launch_k1.stats_launches)
    stats = torch.zeros((t.cap // 4096, 8))
    rg.launch_k1(inp, torch.zeros((rg.N_COMP, t.cap)), torch.zeros((3, t.cap)),
                 torch.tensor([t.cap, 5], dtype=torch.int32), 1, t, 0, 2, 4, stats=stats)
    assert (rg.launch_k1.launches, rg.launch_k1.stats_launches) == (before[0], before[1] + 1)
    (args,) = stub.calls
    assert args[15:17] == (2, 4) and args[20:25] == (31, 31, 0, 16, 16)
    assert args[26] == (t.cap // 4096) * (2 + 2 * 1) and args[27] == stats.data_ptr()
    stub.rc = 700
    with pytest.raises(RuntimeError, match="K1 stats launch failed: CUDA error 700"):
        rg.launch_k1(inp, torch.zeros((rg.N_COMP, t.cap)), torch.zeros((3, t.cap)),
                     torch.tensor([t.cap, 5], dtype=torch.int32), 1, t, 0, 2, 4, stats=stats)
