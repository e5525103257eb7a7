"""The wavefront's culled K0 and K1, on the CPU.

csrc/wavefront.cu's K0 and K1 cull their sweep per warp, as regroup's do
(bounce.cuh ``sweep_culled``), but group their lanes otherwise: each K0
warp walks slices of 32 slots, a lane refilled with its next slot as soon
as a path ends, and each K1 block regroups the live lanes of its dense rows
into a list (``wavefront.k1_block_order``) that its threads trace with
refill. ``cull.wavefront_census`` counts a frame's work grouped so. Here:

- the constants the census groups lanes by are wavefront.cu's;
- K1's block order is a stable sort of each block's live lanes, for 2, 8
  and 32 rows a block, with all-dead and all-live rows and a last block
  part full;
- the census gives every live lane the full sweep's (t, index) in every
  bit, on RTiOW and on tests/test_torch_cull.py's adversarial far cluster
  of small spheres; each lane's own counts are regroup's (``cull_census``,
  the same rays); the warp vote runs at least what the lanes need; its
  live segments and dense rows are the frame's;
- ``launch_k0`` and ``launch_k1`` hand the library the chunk hierarchy and
  the two terms of each lane's box margin, from which it stages the boxes
  in shared memory (RTiOW) or reads them from global memory
  (random_spheres(60000));
- the twins' frame still meets the JAX ``render_image_wavefront`` in
  interpret mode, culling there on chunks of 16 in super-chunks of 4.

The kernels themselves are held to the full-sweep wavefront in every bit
by tests/test_torch_cuda.py and chip_smoke.py's ``[cull]``.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import test_torch_cull as tcull  # noqa: E402
import test_torch_wavefront as twf  # noqa: E402

from weekend_raytracer_tpu.ops.pallas import wavefront as jwf  # noqa: E402
from weekend_raytracer_tpu_torch import CameraBasis, SkyParams, to_sky_state  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import build, cull  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import megakernel as mk  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import regroup as rg  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import wavefront as wf  # noqa: E402

_CUTS = (2, 4, 6)
_FRAME = 3
# bounce.cuh kStageBytes, and what stage_cull puts in shared memory: the
# priors' four sweep rows and indices, six bounds per chunk and super box
_STAGE_BYTES = 44 * 1024


def _stage_bytes(n_tests: int, n_super: int) -> int:
    return mk.N_PRIORS * (16 + 4) + 6 * 4 * (n_tests + n_super)


def _k1_list_bytes(rows: int = wf.K1_ROWS) -> int:
    """csrc/wavefront.cu kK1StaticBytes: K1's lane list (u16 a lane) and
    its rank prefixes (an int a warp and pass, and the live count)."""
    return rows * 128 * 2 + (rows * 128 // 256 * 8 + 1) * 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_census_constants_are_the_kernels():
    """wavefront.K0_MAX_SLICES, K1_ROWS and _K1_THREADS, which the census
    and k1_block_order group lanes by, are csrc/wavefront.cu's kK0MaxSlices,
    kK1Rows and kThreads."""
    src = (build.CSRC_DIR / "wavefront.cu").read_text()

    def const(name):
        return int(re.search(rf"^constexpr int {name} = (\d+);", src, re.M).group(1))

    assert ((const("kK0MaxSlices"), const("kK1Rows"), const("kThreads"))
            == (wf.K0_MAX_SLICES, wf.K1_ROWS, wf._K1_THREADS))


# --- K1's block order --------------------------------------------------------

@pytest.mark.parametrize("rows_per_block", [2, 8, 32])
@pytest.mark.parametrize("pattern", ["random", "dead_rows", "live_rows", "one_lane"])
def test_k1_block_order_is_a_stable_sort_of_live_lanes(rows_per_block, pattern):
    """Each block's entries are its live lanes in lane order (a stable
    argsort on the dead flags), then -1; n_live counts them. 45 rows: the
    last block is part full for every rows_per_block."""
    r = np.random.RandomState(rows_per_block)
    rows = 45
    alive = r.rand(rows, 128) < 0.3
    if pattern == "dead_rows":
        alive[::3] = False
    elif pattern == "live_rows":
        alive[1::2] = True
    elif pattern == "one_lane":
        alive[:] = False
        alive[np.arange(rows), r.randint(0, 128, rows)] = True
    order, n_live = wf.k1_block_order(torch.from_numpy(alive), rows_per_block)
    blocks = -(-rows // rows_per_block)
    assert tuple(order.shape) == (blocks, rows_per_block * 128)
    padded = np.zeros((blocks * rows_per_block, 128), bool)
    padded[:rows] = alive
    for b in range(blocks):
        lanes = padded[b * rows_per_block:(b + 1) * rows_per_block].reshape(-1)
        want = np.argsort(~lanes, kind="stable")[:lanes.sum()]
        assert int(n_live[b]) == lanes.sum()
        np.testing.assert_array_equal(order[b, :lanes.sum()].numpy(), want)
        assert bool((order[b, lanes.sum():] == -1).all())


def test_k1_block_order_needs_whole_passes():
    """A block's lanes are taken 256 at a time: an odd row count is refused."""
    with pytest.raises(ValueError, match="even number of rows"):
        wf.k1_block_order(torch.ones((4, 128), dtype=torch.bool), 3)


# --- the census ----------------------------------------------------------------

def _total(steps):
    """A span's CullCount summed over its steps (zeros with no step)."""
    total = cull.CullCount(0, 0, 0, 0, 0, 0)
    for st in steps:
        total = total.plus(st.count)
    return total


@pytest.fixture(scope="module")
def census():
    """RTiOW at 64x32, 4 spp (a frame with padding lanes past no edge) and
    the far cluster at 64x32, 2 spp (camera rays some 400 from the origin,
    where each lane's box margin is widest): the wavefront census at _CUTS
    and with no cuts, each live lane held against the full sweep, and
    regroup's census of the same frame."""
    out = {}
    for name in ("rtiow", "far_cluster"):
        if name == "rtiow":
            inp = mk.kernel_inputs(*twf._setup("rtiow", 64, 32)[1])
            t = wf.plan(64, 32, 4)
        else:
            inp = tcull._far_cluster()
            t = wf.plan(64, 32, 2)
        out[name] = (inp, t, {cuts: cull.wavefront_census(inp, t, _FRAME, cuts, 8, exact=True)
                              for cuts in (_CUTS, ())},
                     rg.cull_census(inp, rg.plan(t.width, t.height, t.spp, 8, _CUTS)[0], _FRAME,
                                    _CUTS, 8))
    return out


@pytest.mark.parametrize("name", ["rtiow", "far_cluster"])
def test_census_lanes_get_the_full_sweep(name, census):
    """Every live lane of every step, grouped as the kernels group them,
    gets the full sweep's closest hit in every bit; the far cluster's
    small spheres set box faces that the lanes graze."""
    inp, _, spans, _ = census[name]
    assert inp.n_chunks >= 8
    for cuts, sp in spans.items():
        assert [s.parted for s in sp] == [0] * len(sp), cuts
        assert sum(st.count.live for s in sp for st in s.steps) > 0


@pytest.mark.parametrize("name", ["rtiow", "far_cluster"])
def test_census_own_counts_are_regroups(name, census):
    """Each lane's own counts (live segments, prior, sphere and box tests)
    of each kernel equal regroup's census of the same rays, whatever the
    grouping; the warp vote runs at least what the lanes need and at most
    the full sweep (the far cluster's rays enter every chunk); with no cuts
    K0 counts the whole frame's."""
    inp, _, spans, regroup = census[name]
    fields = ("live", "prior_tests", "own_sphere_tests", "own_box_tests")
    for sp, (span, counts) in zip(spans[_CUTS], regroup):
        assert sp.span == span
        got, want = _total(sp.steps), cull.CullCount(*map(sum, zip(*counts)))
        assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields], span
        assert got.own_sphere_tests <= got.sphere_tests <= got.live * inp.n_spheres
        assert got.own_box_tests <= got.box_tests
        assert sp.live == [c.live for c in counts]
    (nocut,) = spans[()]
    assert nocut.span == (0, 8)
    assert nocut.live == [c.live for _, counts in regroup for c in counts]


@pytest.fixture(scope="module")
def alive(census):
    """RTiOW's slots alive entering each bounce (K0's twin run to each
    depth), [8, slots] bool in slot order."""
    inp, t, _, _ = census["rtiow"]
    out = [torch.ones((t.cap,), dtype=torch.bool)]
    for b in range(1, 8):
        pool = torch.empty((t.cap // 4096, wf.N_COMP, 32, 128))
        wf.k0_plain(inp, pool, torch.empty((t.cap // 4096, 3, 32, 128)), t, _FRAME, b)
        out.append((pool[:, wf._AL] > 0.5).reshape(-1))
    return torch.stack(out)


def test_census_follows_the_frame(census, alive):
    """The census's live segments entering each bounce are the paths alive
    there (K0 run to each depth), and its dense rows are COMPACT's row
    counts of the twins' frame."""
    inp, t, spans, _ = census["rtiow"]
    live = [n for sp in spans[_CUTS] for n in sp.live]
    assert live == alive.sum(dim=1).tolist()
    _, rows = wf.wavefront_plain_with_inputs(torch.zeros((t.width * t.height, 3)), inp, _FRAME,
                                             True, width=t.width, height=t.height, spp=t.spp,
                                             num_bounces=8, phase_cuts=_CUTS, debug_counts=True)
    assert [sp.rows for sp in spans[_CUTS]] == [int(r) for r in rows]


def test_census_groupings(census, alive):
    """The kernels' groupings against one slot or lane a thread, each warp
    in step for its longest path (the full-sweep kernels' grouping,
    counted here from the slots alive entering each bounce): refilled, K0's
    warps with no cuts run fewer warp steps; regrouped, K1's warps hold
    more live lanes a step and run fewer warp steps. K0 at the first cut
    starts with every lane live; K1's dense rows are the rows with a lane
    alive entering its span."""
    inp, t, spans, _ = census["rtiow"]

    def warp_steps(sp):
        return sum(st.warps for s in sp for st in s.steps)

    def in_step(lanes, b_lo, b_hi):  # warps of 32 slots of ``lanes``
        depth = alive[b_lo:b_hi, lanes].sum(dim=0)
        return int(depth.view(-1, 32).max(dim=1).values.sum())

    assert warp_steps(spans[()]) < in_step(torch.arange(t.cap), 0, 8)
    k1 = 0
    for sp in spans[_CUTS][1:]:
        kept = alive[sp.span[0]].view(-1, wf.LANES).any(dim=1)
        assert sp.rows == int(kept.sum())
        lanes = torch.arange(t.cap).view(-1, wf.LANES)[kept].reshape(-1)
        k1 += in_step(lanes, *sp.span)
    assert warp_steps(spans[_CUTS][1:]) < k1
    assert spans[_CUTS][0].steps[0].count.live == t.cap // wf.k0_slices(t.spp)


# --- the wrappers --------------------------------------------------------------

@pytest.mark.parametrize("scene", ["rtiow", "random60k"])
def test_wrappers_pass_the_cull_hierarchy(monkeypatch, scene):
    """launch_k0 and launch_k1 hand the library cull_args (the chunk
    hierarchy), then the two scene terms of each lane's box margin, before
    the stream, and the library picks where the boxes sit from those
    sizes: K0 and K1 stage RTiOW's 31 chunks in shared memory (K1 beside
    its lane list), and read random_spheres(60000)'s 1,888 chunk and 118
    super boxes from global memory."""
    w, h = 32, 16
    if scene == "random60k":
        from weekend_raytracer_tpu_torch.models.scenes import random_spheres, random_spheres_camera

        case = (random_spheres(60000).build(device="cpu"), to_sky_state(SkyParams(), device="cpu"),
                CameraBasis.create(random_spheres_camera(), (w, h), device="cpu"))
    else:
        case = twf._setup("rtiow", w, h)[1]
    lib = twf._stubbed(monkeypatch)
    wf.render_image_wavefront(torch.zeros((w * h, 3)), _FRAME, True, *case, width=w, height=h,
                              spp=4, num_bounces=8, phase_cuts=_CUTS)
    inp = mk.kernel_inputs(*case)
    calls = [(name, args) for name, args in lib.calls
             if name in ("wrt_wavefront_k0", "wrt_wavefront_k1")]
    assert [name for name, _ in calls] == ["wrt_wavefront_k0"] + ["wrt_wavefront_k1"] * 3
    sizes = mk.cull_args(inp, torch.device("cpu"))[3:]
    terms = (mk._f32(inp.cull_reach), mk._f32(inp.cull_scale))
    for _, args in calls:
        assert all(a is not None for a in args[-11:-8])
        assert args[-8:-3] == sizes and args[-3:] == (*terms, 1234)
    staged = [_stage_bytes(inp.n_tests, inp.n_super) + extra <= _STAGE_BYTES
              for extra in (0, _k1_list_bytes())]
    if scene == "rtiow":
        assert sizes == (31, 31, 0, 16, 16) and min(terms) > 0 and staged == [True, True]
    else:
        assert sizes[:3] == (1875, 1888, 118) and staged == [False, False]


# --- the slice against the JAX package -----------------------------------------

def test_twin_frame_matches_jax_with_culling():
    """The twins' frame on RTiOW 48x32, two frames of 4 spp at cuts (2, 4),
    against the JAX render_image_wavefront in interpret mode, whose K0 and
    K1 cull per tile on chunks of 16 in super-chunks of 4 (prepared alike
    for the port's kernels): tests/test_pallas.py's image gates, and the
    live row counts within 1%."""
    w, h, spp, frames, cuts = 48, 32, 4, 2, (2, 4)
    jargs, port = twf._setup("rtiow", w, h)
    kw = dict(width=w, height=h, spp=spp, num_bounces=8, phase_cuts=cuts, chunk_size=16,
              super_factor=4, debug_counts=True)
    assert mk.kernel_inputs(*port, chunk_size=16, super_factor=4).n_super == 8
    jacc = jnp.zeros((w * h, 3), jnp.float32)
    acc = torch.zeros((w * h, 3))
    jrows, rows = np.zeros(len(cuts) + 1), np.zeros(len(cuts) + 1)
    for f in range(frames):
        jacc, jc = jwf.render_image_wavefront(jacc, jnp.uint32(f), jnp.bool_(f == 0), *jargs,
                                              **kw)
        _, c = wf.render_image_wavefront(acc, f, f == 0, *port, **kw)
        jrows += [int(np.asarray(x)[0]) for x in jc]
        rows += [int(x[0]) for x in c]
    ref, got = np.asarray(jacc) / (frames * spp), acc.numpy() / (frames * spp)
    assert np.isfinite(got).all() and got.mean() > 0.01
    twf._assert_statistically_equal(ref, got, w, h)
    assert rows[0] == jrows[0] == frames * 64
    np.testing.assert_allclose(rows, jrows, rtol=0.01)
