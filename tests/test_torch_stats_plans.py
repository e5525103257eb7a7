"""The stats kernels' plan and walk, replicated in PyTorch on the CPU (the
CUDA kernels run only on the card).

The stats megakernel and K1's stats kernel (csrc/bounce.cuh's stats
section) sweep every sphere from a table staged in shared memory: in
windows where it does not fit a block's share (``mk.stats_plan``), each
window starting at a chunk boundary; two spheres' discriminants before
any root; and the TPU's whole-tile cull tests before each chunk's first
pair (its super-chunk's first where the chunk starts one), the padded
boxes' tests after the last window. Here every plan covers each sphere
once in windows that fit the card's shared memory, and a replica of that
walk in the twin's arithmetic equals the twin's sequential counted sweep
(``mk._closest_hit`` and ``mk._cull_tests``, which ``CullStats`` counts):
the same (t, index) and the same chunk and super-chunk bits for every ray,
on RTiOW's rays, on exact ties (spheres that repeat) with windows of one
chunk, and on a super-chunk scene with windows of one chunk. A replica of
their persistent grid (stats.cuh take_item: a thread's first item by its
index, then the ticket's, a warp's lanes in lane order) takes every pixel
or record exactly once, whatever the paths' lengths and the order in which
the warps reach the ticket. The bound the stats kernels are held to
(``probes.stats_bound``) is counted here too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from weekend_raytracer_tpu_torch import (SCENES, Camera, CameraBasis, SkyParams,  # noqa: E402
                                         to_sky_state)
from weekend_raytracer_tpu_torch.models.scenes import (random_spheres,  # noqa: E402
                                                       random_spheres_camera)
from weekend_raytracer_tpu_torch.ops.cuda import megakernel as mk  # noqa: E402
from weekend_raytracer_tpu_torch.probes import (FP32_PEAK, PAIR_OPS, ROOT_OPS,  # noqa: E402
                                                SLAB_TEST_OPS, stats_bound)

_F32 = torch.float32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(name, **kw):
    """Kernel inputs of a scene at 64x36: SCENES' own, random_spheres(60000),
    or chip_smoke.py's super-chunk case (random_spheres(1200) in 75 chunks
    of 16 and 5 super-chunks, through a narrow lens)."""
    if name == "super":
        desc = random_spheres(1200)
        cam = Camera.look_at((0.0, 6.0, 60.0), (30.0, 0.5, 30.0), vfov_degrees=8.0,
                             aperture=0.02)
        kw = {"chunk_size": 16, **kw}
    elif name == "random60k":
        desc, cam = random_spheres(60000), random_spheres_camera()
    else:
        desc, cam = SCENES[name][0](), SCENES[name][1]()
    return mk.kernel_inputs(desc.build(device="cpu"), to_sky_state(SkyParams(), device="cpu"),
                            CameraBasis.create(cam, (64, 36), device="cpu"), **kw)


# --- the plan ----------------------------------------------------------------

_PLAN_CASES = {"rtiow": {}, "random10k": {}, "random60k": {}, "textured": {},
               "random10k_no_chunks": {"chunk_size": 0}}


@pytest.mark.parametrize("case", list(_PLAN_CASES))
def test_stats_plan_covers_every_sphere_once(case):
    """Each sphere lies in exactly one window; each window starts at a
    chunk boundary (in a scene with chunks), fits a block's share beside
    the cull tables and the card's shared memory; no fewer windows of
    whole chunks would fit."""
    inp = _inputs(case.split("_no_chunks")[0], **_PLAN_CASES[case])
    plan = mk.stats_plan_of(inp)
    n, window = inp.n_spheres, plan["window"]
    starts = list(range(0, n, window))
    assert len(starts) == plan["windows"]
    seen = np.zeros(n, np.int64)
    for w0 in starts:
        seen[w0:min(w0 + window, n)] += 1
    assert (seen == 1).all()
    cull = mk.cull_smem_bytes(inp.n_chunks, inp.n_tests, inp.n_super)
    assert plan["table_offset"] % 16 == 0 and cull <= plan["table_offset"] < cull + 16
    assert plan["smem"] == plan["table_offset"] + min(window, n) * mk.STATS_SPHERE_BYTES
    assert plan["smem"] <= min(mk.STATS_SMEM_BYTES, mk.CARD_SMEM_BYTES)
    unit = inp.chunk_size if inp.n_chunks else 1
    assert window % unit == 0 and all(w0 % unit == 0 for w0 in starts)
    units = inp.n_chunks if inp.n_chunks else n
    most = (mk.STATS_SMEM_BYTES - plan["table_offset"]) // mk.STATS_SPHERE_BYTES // unit
    assert plan["windows"] == -(-units // most)
    if case == "rtiow":
        assert plan["windows"] == 1  # 496 spheres: 15.9 KB
    if case in ("random10k", "random60k", "random10k_no_chunks"):
        assert plan["windows"] > 1
    if case == "random60k":  # its boxes pass what a block stages
        assert plan["table_offset"] == mk.N_PRIORS * 20


def test_stats_plan_opts_in_for_a_chunk_past_the_share():
    """A chunk larger than a block's share is one window of its own, which
    the launch opts in to; it still fits the card."""
    plan = mk.stats_plan(8192, 4, 4, 0, 2048)
    assert plan["window"] == 2048 and plan["windows"] == 4
    assert mk.STATS_SMEM_BYTES < plan["smem"] <= mk.CARD_SMEM_BYTES


# --- the walk, replicated ------------------------------------------------------

def _slab(bounds, o, inv, tb):
    return mk._slab_enters(bounds, o, inv, tb[:, None])[:, 0]


def staged_walk(o, d, inp, window):
    """The stats kernels' walk of one bounce (csrc/bounce.cuh
    begin_counted, sweep_window, end_counted) in the twin's arithmetic: the
    priors' best t first, then the table window by window; before each
    chunk's first pair, its super-chunk's test where it starts one and its
    own, against min(priors' best t, best t so far); the pairs two at a time
    from the staged (c, 2c), both discriminants first, then the roots in
    sphere order where the ray has a positive one, strict <; after the last
    window the padded boxes' tests. Returns (t, index, chunk bits [n,
    n_tests], super bits [n, n_super])."""
    sweep = inp.sweep
    n_rays = o[0].shape[0]
    od, oo = (v[:, 0] for v in mk._od_oo(o, d))
    bt = torch.full((n_rays,), mk.MAX_T, dtype=_F32)
    bi = torch.full((n_rays,), -1, dtype=torch.int64)
    pbt = torch.full((n_rays,), mk.MAX_T, dtype=_F32)
    if inp.n_chunks:
        for p in inp.prior_idx.tolist():
            ts = mk._sphere_ts(o, d, od[:, None], oo[:, None], sweep[p:p + 1])[:, 0]
            pbt = torch.where(ts < pbt, ts, pbt)
    inv = [1.0 / (torch.where(v >= 0.0, 1.0, -1.0).to(_F32) * torch.clamp(torch.abs(v),
                                                                           min=1.0e-12))
           for v in d]
    chunk_hit = torch.zeros((n_rays, inp.n_tests), dtype=torch.bool)
    super_hit = torch.zeros((n_rays, inp.n_super), dtype=torch.bool)

    def tests(c):
        tb = torch.minimum(pbt, bt)
        if inp.n_super and c % inp.super_factor == 0:
            q = c // inp.super_factor
            super_hit[:, q] = _slab(inp.super_bounds[:, q:q + 1], o, inv, tb)
        chunk_hit[:, c] = _slab(inp.chunk_bounds[:, c:c + 1], o, inv, tb)

    def pairs(lo, hi):
        nonlocal bt, bi
        for j in range(lo, hi, 2):
            rows = range(j, min(j + 2, hi))
            bq, disc = [], []
            for i in rows:
                cx, cy, cz, kq = sweep[i]
                tx, ty, tz = cx + cx, cy + cy, cz + cz  # the staged 2c
                cd = cx * d[0] + cy * d[1] + cz * d[2]
                co2 = tx * o[0] + ty * o[1] + tz * o[2]
                bq.append(cd - od)
                disc.append(bq[-1] * bq[-1] - (oo - co2 + kq))
            most = disc[0] if len(disc) == 1 else torch.fmax(disc[0], disc[1])
            for i, b, q in zip(rows, bq, disc):
                sq = torch.sqrt(q)
                t0, t1 = b - sq, b + sq
                ts = torch.where(t0 > mk.MIN_T, t0, t1)
                take = (most > 0.0) & (q > 0.0) & (ts > mk.MIN_T) & (ts < bt)
                bt = torch.where(take, ts, bt)
                bi = torch.where(take, i, bi)

    n, csz = inp.n_spheres, inp.chunk_size
    for w0 in range(0, n, window):
        nw = min(window, n - w0)
        if not inp.n_chunks:
            pairs(w0, w0 + nw)
            continue
        for c in range(w0 // csz, (w0 + nw) // csz):
            tests(c)
            pairs(c * csz, (c + 1) * csz)
    for c in range(inp.n_chunks, inp.n_tests):
        tests(c)
    return bt, bi, chunk_hit, super_hit


def _rtiow_rays(inp, w=12, h=8):
    """Camera rays of an RTiOW image and, of the paths a bounce leaves
    alive, their next rays (origins on the spheres)."""
    gen = np.random.default_rng(5)
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    xf = torch.from_numpy(xs.ravel().astype(np.float32))
    yf = torch.from_numpy(ys.ravel().astype(np.float32))
    state = torch.from_numpy(gen.integers(0, 2**32, xf.numel(), dtype=np.int64))
    state, o, d = mk.camera_rays_plain([mk._f32(v) for v in inp.cam.tolist()], xf, yf,
                                       mk._f32(1.0 / w), mk._f32(1.0 / h), state)
    tr = torch.ones((xf.numel(), 3), dtype=_F32)
    p = mk.trace_bounces_plain(o, d, tr, state, inp, 0, 1)
    alive = p.alive
    return (tuple(torch.cat([a, b[alive]]) for a, b in zip(o, p.o.unbind(1))),
            tuple(torch.cat([a, b[alive]]) for a, b in zip(d, p.d.unbind(1))))


def _random_rays(n, seed, lo, hi):
    gen = np.random.default_rng(seed)
    o = gen.uniform(lo, hi, (3, n)).astype(np.float32)
    d = gen.normal(size=(3, n))
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    return tuple(torch.from_numpy(v) for v in o), tuple(torch.from_numpy(v) for v in d)


def _ties():
    """RTiOW's first 48 spheres, then the same 48 again, in chunks of 16
    with the chunk boxes of the spheres they hold: exact ties, where the
    first index must win; the last rays start far out and point away."""
    base = _inputs("rtiow")
    sweep = torch.cat([base.sweep[:48], base.sweep[:48]])
    c = sweep[:, :3]
    r = torch.sqrt(torch.clamp((c * c).sum(1) - sweep[:, 3], min=0.0))
    lo, hi = (c - r[:, None]).reshape(6, 16, 3), (c + r[:, None]).reshape(6, 16, 3)
    bounds = torch.cat([lo.amin(1).T, hi.amax(1).T]).contiguous()
    inp = base._replace(sweep=sweep, n_spheres=96, n_chunks=6, chunk_bounds=bounds,
                        prior_idx=torch.tensor([0, 48, 5, 53], dtype=torch.int32))
    o, d = _random_rays(300, 3, -6.0, 6.0)
    for v in o:
        v[-40:] = 500.0
    for v in d:
        v[-40:] = float(np.float32(1.0 / np.sqrt(3.0)))
    return inp, o, d


def _rtiow_case(window):
    inp = _inputs("rtiow")
    return inp, *_rtiow_rays(inp), window


def _super_case():
    inp = _inputs("super")
    o, d = _random_rays(160, 9, 0.0, 60.0)
    return inp, o, d, inp.chunk_size


_WALK_CASES = {
    "rtiow_whole": lambda: _rtiow_case(None),
    "rtiow_one_chunk_windows": lambda: _rtiow_case(16),
    "ties_one_chunk_windows": lambda: (*_ties(), 16),
    "super_one_chunk_windows": _super_case,
}


@pytest.mark.parametrize("case", list(_WALK_CASES))
def test_staged_walk_is_the_sequential_counted_sweep(case):
    """The walk's (t, index) is the twin's full sweep in every bit, and its
    chunk and super-chunk bits are _cull_tests' for every ray."""
    inp, o, d, window = _WALK_CASES[case]()
    window = window or mk.stats_plan_of(inp)["window"]
    t, i, chunk_hit, super_hit = staged_walk(o, d, inp, window)
    want_t, want_i = mk._closest_hit(o, d, inp.sweep)
    want_chunk, want_super = mk._cull_tests(o, d, inp)
    assert torch.equal(t.view(torch.int32), want_t.view(torch.int32))
    assert torch.equal(i, want_i)
    assert torch.equal(chunk_hit, want_chunk)
    if inp.n_super:
        assert torch.equal(super_hit, want_super)
        assert super_hit.any() and not super_hit.all()
    assert chunk_hit.any() and not chunk_hit.all()
    if case.startswith("ties"):
        hit = i >= 0
        assert hit.any() and (i[hit] < 48).all()  # the first copy of each sphere
        assert (i[-40:] == -1).all()
    if case.startswith("rtiow"):
        assert (i >= 0).float().mean() > 0.3


# --- the persistent grid, replicated ------------------------------------------

def persistent_walk(items, blocks, threads, lengths, seed):
    """The stats kernels' persistent grid (stats.cuh take_item): thread t
    of the grid first holds item t; each step every lane with an item runs
    one bounce of it, and the lanes whose item ends this step (after
    ``lengths[item]`` steps) take new ones: a warp's wanting lanes, in lane
    order, get first + base + rank, where first is the grid's thread count
    and base the ticket's count before the warp's one atomic; warps reach
    the ticket in a seeded random order each step. Returns how many times
    each item was traced to its end."""
    gen = np.random.default_rng(seed)
    lanes = blocks * threads
    held = np.arange(lanes, dtype=np.int64)
    held[held >= items] = -1
    left = np.where(held >= 0, lengths[np.clip(held, 0, None)], 0)
    done = np.zeros(items, np.int64)
    ticket = 0
    while (held >= 0).any():
        left[held >= 0] -= 1
        need = (held >= 0) & (left == 0)
        np.add.at(done, held[need], 1)
        held[need] = -1
        for w in gen.permutation(lanes // 32):
            want = np.flatnonzero(need[32 * w:32 * (w + 1)])
            if want.size == 0:
                continue
            base = ticket
            ticket += want.size
            for rank, lane in enumerate(want):
                item = lanes + base + rank
                if item < items:
                    held[32 * w + lane] = item
                    left[32 * w + lane] = lengths[item]
    return done


@pytest.mark.parametrize("items, blocks", [(50_000, 4), (3_000, 4), (700, 8), (1, 2)])
def test_persistent_grid_takes_every_item_once(items, blocks):
    """Every pixel (or record) is traced once and to its end: more items
    than the grid's threads, fewer, and a grid mostly past the count."""
    lengths = np.random.default_rng(items).integers(1, 9, items)
    done = persistent_walk(items, blocks, 256, lengths, seed=blocks)
    assert (done == 1).all()


# --- the bound -----------------------------------------------------------------

def test_stats_bound_counts_pairs_boxes_and_roots():
    """15 operations a pair (the priors' too), 12 a box test, 3 more a pair
    with a real root; at RTiOW 1080p x 32 spp's 174M segments about 20.5
    ms at the FP32 peak."""
    b = stats_bound(1000, 40, 0, 496, 31, 0, 4)
    assert b["ops"] == 1000 * (500 * PAIR_OPS + 31 * SLAB_TEST_OPS) + 40 * ROOT_OPS
    assert (PAIR_OPS, ROOT_OPS, SLAB_TEST_OPS) == (15, 3, 12)
    assert b["bound_by"] == "operations" and b["bound_ms"] == b["ops"] / FP32_PEAK * 1e3
    none = stats_bound(1000, 0, 0, 5, 0, 0, 0)  # no chunks: no priors, no boxes
    assert none["ops"] == 1000 * 5 * PAIR_OPS
    assert 20.0 < stats_bound(174e6, 0, 0, 496, 31, 0, 4)["bound_ms"] < 21.0
    assert stats_bound(1, 0, 1e9, 5, 0, 0, 0)["bound_by"] == "bytes"
