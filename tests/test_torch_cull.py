"""The per-warp chunk cull of regroup K0 and K1, on the CPU.

csrc/bounce.cuh's ``sweep_culled`` sweeps a chunk's spheres for a warp of 32
lanes iff one of its lanes' slab tests enters the chunk (and its
super-chunk) closer than the lane's bound. Its twin, ``warp_cull_plain``,
makes the same decisions in PyTorch; here it is held to

- the full sweep: the same closest hit in every bit, on seeded rays that
  include rays aimed at sphere poles lying on chunk-box faces, dead lanes
  and a last group shorter than 32;
- a brute-force count of the same votes from the TPU kernel's per-lane
  cull decisions (``megakernel._cull_tests``, which takes the full sweep's
  running best-t), on the boxes as K0 and K1 widen them per lane
  (``cull.lane_margin``), and of what each lane's own decisions need;
- the full sweep on rays built to part from a cull on the exact boxes
  (a far cluster of small spheres, grazing exits at their box faces),
  where each winner's offset from its sphere stays inside the first-order
  bound that megakernel.py's CULL_MARGIN_ULPS is derived from;
- the TPU's whole-tile cull: a tile of 4096 records enters the union of
  what its 128 warps enter, so a warp's entered chunks, averaged over a
  tile's warps, never exceed the tile's count from ``k1_plain(stats=...)``
  (tests/test_torch_stats.py holds that count against the JAX
  ``_make_k1(stats=True)`` in interpret mode).

The twins' regroup frame still meets the JAX ``render_image_regrouped``
(interpret mode) at tests/test_torch_regroup.py's gates: the slice did not
move. The CUDA kernels are held to the full-sweep wavefront (its K0's and
K1's kCull = false instantiations), and at one sample per pixel to the
stats megakernel's full sweep, in every bit by tests/test_torch_cuda.py and
chip_smoke.py's ``[cull]``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import test_torch_regroup as trg  # noqa: E402

from weekend_raytracer_tpu.models import scenes as jscenes  # noqa: E402
from weekend_raytracer_tpu.models.camera import Camera as JCamera  # noqa: E402
from weekend_raytracer_tpu.models.camera import CameraBasis as JBasis  # noqa: E402
from weekend_raytracer_tpu.models.sky import SkyParams as JSkyParams  # noqa: E402
from weekend_raytracer_tpu.models.sky import to_sky_state as j_to_sky_state  # noqa: E402
from weekend_raytracer_tpu.ops.pallas import regroup as jrg  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import cull  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import megakernel as mk  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import regroup as rg  # noqa: E402

# scene -> (build, camera, w, h, spp, chunk_size): tests/test_torch_stats.py's
# two cases, RTiOW (31 chunks of 16, no super level) and random_spheres(1200)
# (75 chunks of 16 in 5 super-chunks) through a narrow lens
_SCENES = {
    "rtiow": (jscenes.rtiow_final, jscenes.rtiow_final_camera, 96, 64, 4, None),
    "super": (lambda: jscenes.random_spheres(1200),
              lambda: JCamera.look_at((0.0, 6.0, 60.0), (30.0, 0.5, 30.0),
                                      vfov_degrees=8.0, aperture=0.02),
              256, 128, 2, 16),
}
_CUTS = (2, 4, 6)
_FRAME_CASE = dict(w=96, h=64, frames=2, spp=4, bounces=8)  # RTiOW, the slice


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_case(name):
    build, cam, w, h, spp, chunk = _SCENES[name]
    jscene, jsky, jbasis = (build().build(), j_to_sky_state(JSkyParams()),
                            JBasis.create(cam(), (w, h)))
    scene, sky, basis = trg._port(jscene, jsky, jbasis)
    return mk.kernel_inputs(scene, sky, basis, chunk_size=chunk)


def _pole_rays(inp, r):
    """Rays from seeded origins aimed at the sphere poles that lie on a
    chunk box's face: for each chunk, the sphere that sets each of its six
    bounds, at its extreme point along that axis."""
    cs = inp.chunk_size
    c = inp.sweep[:, :3].numpy()
    rad = np.abs(inp.attrs[3].numpy())
    bounds = inp.chunk_bounds.numpy()
    targets = []
    for ch in range(inp.n_chunks):
        lo = slice(ch * cs, (ch + 1) * cs)
        for axis in range(3):
            for side, pick in ((-1.0, np.argmin), (1.0, np.argmax)):
                ext = c[lo, axis] + side * rad[lo]
                j = pick(ext)
                assert ext[j] == bounds[axis + (3 if side > 0 else 0), ch]
                p = c[lo][j].copy()
                p[axis] = ext[j]
                targets.append(p)
    targets = np.asarray(targets, np.float32)
    origin = targets + r.uniform(-6.0, 6.0, targets.shape).astype(np.float32)
    return origin, targets - origin


def _rays(name, n_random=4000, seed=0):
    """Seeded rays of one scene: camera rays and the rays they scatter into
    (origins on surfaces), rays at chunk-box poles, random rays; about 20%
    dead lanes, and a count that leaves a last group short of 32."""
    inp = _port_case(name)
    _, _, w, h, spp, _ = _SCENES[name]
    r = np.random.RandomState(seed)
    t, _ = rg.plan(w, h, spp, 8, _CUTS)
    slots = torch.from_numpy(np.sort(r.choice(t.cap, 2048, replace=False)))
    state, x, y_g = rg._seeds(t, slots, 0)
    cam = [mk._f32(v) for v in inp.cam.tolist()]
    state, o, d = mk.camera_rays_plain(cam, x.to(torch.float32),
                                       y_g.to(torch.int32).to(torch.float32),
                                       mk._f32(1.0 / w), mk._f32(1.0 / h), state)
    p = mk.trace_bounces_plain(o, d, torch.ones((2048, 3)), state, inp, 0, 1)
    po, pd = _pole_rays(inp, r)
    ro = r.uniform(-40.0, 40.0, (n_random, 3)).astype(np.float32)
    ro[:, 1] = np.abs(ro[:, 1]) * 0.2
    rd = r.standard_normal((n_random, 3)).astype(np.float32)
    ov = np.concatenate([torch.stack(o, 1).numpy(), p.o.numpy(), po, ro])
    dv = np.concatenate([torch.stack(d, 1).numpy(), p.d.numpy(), pd, rd])
    dv /= np.linalg.norm(dv, axis=1, keepdims=True)
    n = (ov.shape[0] - 13) // 32 * 32 + 13  # a last group of 13 lanes
    alive = r.rand(n) > 0.2
    alive[:2048] = True  # the camera rays all live
    ov, dv = torch.from_numpy(ov[:n].copy()), torch.from_numpy(dv[:n].copy())
    return inp, tuple(ov.T), tuple(dv.T), torch.from_numpy(alive)


@pytest.fixture(scope="module")
def culled():
    """Each scene's rays through warp_cull_plain and the full sweep."""
    out = {}
    for name in _SCENES:
        inp, o, d, alive = _rays(name)
        out[name] = (inp, o, d, alive, cull.warp_cull_plain(o, d, alive, inp),
                     mk._closest_hit(o, d, inp.sweep))
    return out


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("name", list(_SCENES))
def test_culled_sweep_is_the_full_sweep(name, culled):
    inp, o, d, alive, wc, (bt, bi) = culled[name]
    assert inp.n_chunks and (inp.n_super > 0) == (name == "super")
    torch.testing.assert_close(_bits(wc.bt[alive]), _bits(bt[alive]), rtol=0, atol=0)
    torch.testing.assert_close(wc.bi[alive], bi[alive], rtol=0, atol=0)
    hits = bi[alive] >= 0
    assert 0.2 < float(hits.float().mean()) < 0.99  # hits and misses both
    # the pole rays hit spheres that set box faces, culled or not
    assert wc.count.live == int(alive.sum())
    assert 0 < wc.count.sphere_tests < wc.count.live * inp.n_spheres


def _brute_force(inp, o, d, alive, group=32):
    """The warp votes counted group by group, chunk by chunk, from each
    lane's cull decisions as the TPU kernel's counters take them
    (megakernel._cull_tests: slab tests against min(priors' best-t, the
    full sweep's best-t before the chunk)), on the boxes as K0 and K1 widen
    them (each lane's cull.lane_margin); and the tests each lane's own
    decisions need: (sphere, box, entered per group, own sphere, own box)."""
    chunk_hit, super_hit = (None if x is None else x.numpy() for x in mk._cull_tests(
        o, d, inp, margin=cull.lane_margin(o, inp)))
    alive = alive.numpy()
    n = alive.shape[0]
    live = np.nonzero(alive)[0]
    own_box = own_sphere = 0
    per = inp.super_factor if inp.n_super else inp.n_chunks
    for c0 in range(0, inp.n_chunks, per):
        mine = super_hit[live, c0 // per] if inp.n_super else np.ones(len(live), bool)
        own_box += len(live) if inp.n_super else 0
        for c in range(c0, min(c0 + per, inp.n_chunks)):
            own_box += int(mine.sum())
            own_sphere += inp.chunk_size * int((mine & chunk_hit[live, c]).sum())
    sphere = box = 0
    entered = []
    per = inp.super_factor if inp.n_super else inp.n_chunks
    for g0 in range(0, n, group):
        lanes = np.nonzero(alive[g0:g0 + group])[0] + g0
        got = 0
        for c0 in range(0, inp.n_chunks, per):
            if inp.n_super:
                box += len(lanes)
                mine = super_hit[lanes, c0 // per]
                if not mine.any():
                    continue
            else:
                mine = np.ones(len(lanes), bool)
            for c in range(c0, min(c0 + per, inp.n_chunks)):
                box += len(lanes)
                if (mine & chunk_hit[lanes, c]).any():
                    got += 1
                    sphere += inp.chunk_size * len(lanes)
        entered.append(got)
    return sphere, box, np.asarray(entered), own_sphere, own_box


@pytest.mark.parametrize("name", list(_SCENES))
def test_counts_match_brute_force(name, culled):
    inp, o, d, alive, wc, _ = culled[name]
    sphere, box, entered, own_sphere, own_box = _brute_force(inp, o, d, alive)
    assert (wc.count.sphere_tests, wc.count.box_tests) == (sphere, box)
    assert (wc.count.own_sphere_tests, wc.count.own_box_tests) == (own_sphere, own_box)
    assert wc.count.prior_tests == mk.N_PRIORS * wc.count.live
    np.testing.assert_array_equal(wc.entered.numpy(), entered)
    assert len(entered) == -(-alive.numel() // 32)


@pytest.mark.parametrize("name", list(_SCENES))
def test_own_counts_are_the_lanes_alone(name, culled):
    """A lane's own decisions do not depend on its group: the own counts
    under the vote of 32 are the counts of groups of one, and the vote
    makes its lanes test more, never less."""
    inp, o, d, alive, wc, _ = culled[name]
    one = cull.warp_cull_plain(o, d, alive, inp, group=1).count
    assert (one.sphere_tests, one.box_tests) == (one.own_sphere_tests, one.own_box_tests)
    assert (wc.count.own_sphere_tests, wc.count.own_box_tests) == (
        one.sphere_tests, one.box_tests)
    assert wc.count.own_sphere_tests < wc.count.sphere_tests
    assert wc.count.own_box_tests <= wc.count.box_tests


# Rays of random_spheres(10000) (4K camera) that leave a small sphere near
# the pole on its chunk box's bottom face and hit the same sphere again just
# past MIN_T, outside the exact box (found by a search of the twins' rays
# of rows 1024-1279 of a 3840x2160 x 4 spp frame): (origin, direction,
# sphere). On the exact boxes the chunk is skipped and the ground wins.
_REHITS = (
    ((24.967369079589844, 0.0003611519932746887, -16.987592697143555),
     (0.3939213752746582, -0.4025239646434784, -0.8263173699378967), 6234),
    ((36.402923583984375, 0.00025588274002075195, -14.258475303649902),
     (0.45690053701400757, -0.5063105821609497, 0.7313628792762756), 6641),
    ((34.916107177734375, -0.00033405423164367676, -16.266199111938477),
     (-0.6624739170074463, -0.5578655004501343, -0.4999144673347473), 7249),
    ((35.33790969848633, -2.2523105144500732e-05, -15.52612590789795),
     (0.7247464656829834, -0.2951187193393707, -0.6226135492324829), 6618),
    ((-42.283294677734375, -6.0439109802246094e-05, -19.018051147460938),
     (0.5793343782424927, -0.3939875662326813, -0.7135443687438965), 5790),
    ((-22.782615661621094, 0.0005382169038057327, 8.349809646606445),
     (-0.6838144659996033, -0.5615476965904236, -0.46589919924736023), 4604),
)


def test_margin_keeps_rehits_at_box_faces():
    """Each lane's widened boxes keep the full sweep's hit for rays that
    hit their own sphere again just outside its exact chunk box; with the
    exact boxes (cull_scale 0) the cull skips the chunk."""
    from weekend_raytracer_tpu_torch import SCENES, CameraBasis, SkyParams, to_sky_state

    build, cam = SCENES["random10k"]
    inp = mk.kernel_inputs(build().build(device="cpu"), to_sky_state(SkyParams(), device="cpu"),
                           CameraBasis.create(cam(), (3840, 2160), device="cpu"))
    o = tuple(torch.tensor([r[0][k] for r in _REHITS], dtype=torch.float32) for k in range(3))
    d = tuple(torch.tensor([r[1][k] for r in _REHITS], dtype=torch.float32) for k in range(3))
    assert inp.n_super and bool((cull.lane_margin(o, inp) > 0.1).all())
    alive = torch.ones((len(_REHITS),), dtype=torch.bool)
    bt, bi = mk._closest_hit(o, d, inp.sweep)
    assert bi.tolist() == [r[2] for r in _REHITS] and bool((bt < 0.002).all())
    wc = cull.warp_cull_plain(o, d, alive, inp, group=1)
    assert torch.equal(wc.bi, bi) and torch.equal(_bits(wc.bt), _bits(bt))
    exact = cull.warp_cull_plain(o, d, alive, inp._replace(cull_scale=0.0), group=1)
    assert not bool((exact.bi == bi).any())


def _far_cluster():
    """A scene built against the slab test: 120 small spheres (r 0.02-0.08)
    about 400 from the origin, where the expanded quadratic's rounding is
    largest against r, with a ground and three larger spheres as the
    priors (16 a chunk: 8 chunks)."""
    from weekend_raytracer_tpu_torch import CameraBasis, SkyParams, to_sky_state
    from weekend_raytracer_tpu_torch.models.camera import Camera
    from weekend_raytracer_tpu_torch.models.materials import Material
    from weekend_raytracer_tpu_torch.models.scenes import SceneDesc
    from weekend_raytracer_tpu_torch.models.spheres import Sphere

    far = (300.0, 40.0, -250.0)
    r = np.random.RandomState(11)
    spheres = [Sphere((0.0, -1000.0, 0.0), 1000.0, 0)]
    spheres += [Sphere((far[0] + 20.0 * k, far[1], far[2] - 30.0), 5.0, 0) for k in range(3)]
    c = np.asarray(far) + r.uniform(-6.0, 6.0, (120, 3))
    rad = r.uniform(0.02, 0.08, 120)
    spheres += [Sphere(tuple(map(float, c[i])), float(rad[i]), 0) for i in range(120)]
    desc = SceneDesc(materials=[Material.lambertian((0.5, 0.5, 0.5))], spheres=spheres)
    cam = Camera.look_at((280.0, 45.0, -220.0), far, vfov_degrees=30.0, aperture=0.0)
    return mk.kernel_inputs(desc.build(device="cpu"), to_sky_state(SkyParams(), device="cpu"),
                            CameraBasis.create(cam, (64, 32), device="cpu"))


def _grazing_rays(inp, per_pole=24):
    """From the pole of every non-prior sphere that sets a face of its
    chunk's box: rays leaving the pole along the tangent plane tipped out
    of (or into) the sphere by 1e-5 to 3e-2, and rays from 2 to 40 away
    aimed at the pole along that plane."""
    r = np.random.RandomState(5)
    cs = inp.chunk_size
    c = inp.sweep[:, :3].numpy().astype(np.float64)
    rad = np.abs(inp.attrs[3].numpy()).astype(np.float64)
    priors = set(inp.prior_idx.tolist())
    origins, dirs = [], []
    for ch in range(inp.n_chunks):
        lanes = np.arange(ch * cs, (ch + 1) * cs)
        for axis in range(3):
            for side, pick in ((-1.0, np.argmin), (1.0, np.argmax)):
                j = lanes[pick(c[lanes, axis] + side * rad[lanes])]
                if j in priors:
                    continue
                pole = c[j].copy()
                pole[axis] += side * rad[j]
                out = np.eye(3)[axis] * side
                t1 = np.eye(3)[(axis + 1) % 3]
                t2 = np.cross(out, t1)
                for _ in range(per_pole):
                    th = r.uniform(0.0, 2.0 * np.pi)
                    tangent = np.cos(th) * t1 + np.sin(th) * t2
                    tip = 10.0 ** r.uniform(-5.0, -1.5) * r.choice([-1.0, 1.0])
                    origins.append(pole)
                    dirs.append(tangent + tip * out)
                    start = pole - r.uniform(2.0, 40.0) * tangent + r.uniform(-1e-3, 1e-3, 3)
                    origins.append(start)
                    dirs.append(pole - start)
    dirs = np.asarray(dirs)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return (tuple(torch.from_numpy(np.asarray(origins, np.float32).T.copy())),
            tuple(torch.from_numpy(dirs.astype(np.float32).T.copy())))


def test_margin_holds_on_an_adversarial_scene():
    """Small spheres far from the origin, whose poles set box faces, and
    grazing exits and approaches at those poles: lanes alone (group 1) on
    each lane's widened boxes give the full sweep's hit in every bit, where
    the exact boxes part; and every non-prior winner's computed hit point
    lies within megakernel.py's first-order bound, 15u (|o| + |c| + r)^2 / r,
    of its sphere, which the margin (32u ...) covers with the slab test's
    own rounding."""
    inp = _far_cluster()
    assert inp.n_chunks == 8
    o, d = _grazing_rays(inp)
    alive = torch.ones((o[0].numel(),), dtype=torch.bool)
    bt, bi = mk._closest_hit(o, d, inp.sweep)
    wc = cull.warp_cull_plain(o, d, alive, inp, group=1)
    assert torch.equal(wc.bi, bi) and torch.equal(_bits(wc.bt), _bits(bt))
    exact = cull.warp_cull_plain(o, d, alive, inp._replace(cull_scale=0.0), group=1)
    parted = (exact.bi != bi) | (_bits(exact.bt) != _bits(bt))
    assert int(parted.sum()) >= 10
    prior = torch.zeros((inp.sweep.shape[0],), dtype=torch.bool)
    prior[inp.prior_idx.long()] = True
    won = (bi >= 0) & ~prior[bi.clamp(min=0)]
    assert int(won.sum()) > 100
    ov, dv = torch.stack(o, 1).double()[won], torch.stack(d, 1).double()[won]
    c, rad = inp.sweep[bi[won], :3].double(), inp.attrs[3][bi[won]].double().abs()
    off = torch.linalg.vector_norm(ov + bt[won].double()[:, None] * dv - c, dim=1) - rad
    reach = torch.linalg.vector_norm(ov, dim=1) + torch.linalg.vector_norm(c, dim=1) + rad
    assert bool((off > 1e-3).any())  # hits well off their spheres
    assert bool((off <= 15 * 2.0 ** -24 * reach ** 2 / rad).all())


def test_counts_without_chunks():
    """A scene below two chunks keeps the full sweep: every live lane tests
    every sphere, and there is nothing to vote on."""
    scene, sky, basis = trg._setup("three", 32, 16)[1]
    inp = mk.kernel_inputs(scene, sky, basis)
    assert inp.n_chunks == 0
    r = np.random.RandomState(3)
    o = tuple(torch.from_numpy(r.uniform(-2, 2, (3, 70)).astype(np.float32)))
    dv = r.standard_normal((3, 70)).astype(np.float32)
    d = tuple(torch.from_numpy(dv / np.linalg.norm(dv, axis=0)))
    alive = torch.from_numpy(r.rand(70) > 0.5)
    wc = cull.warp_cull_plain(o, d, alive, inp)
    bt, bi = mk._closest_hit(o, d, inp.sweep)
    assert torch.equal(wc.bi, bi) and torch.equal(_bits(wc.bt), _bits(bt))
    live = int(alive.sum())
    full = live * inp.n_spheres
    assert wc.count == cull.CullCount(live, full, 0, 0, full, 0)
    assert wc.entered.tolist() == [0, 0, 0]


@pytest.fixture(scope="module")
def k1_warps():
    """Per scene: a dense pool from the twins' K0 and PACK at the first cut;
    k1_plain's per-tile counters over [2, 4); and each warp's chunks
    entered under the vote, summed over those bounces, on the same rays."""
    out = {}
    for name in _SCENES:
        inp = _port_case(name)
        _, _, w, h, spp, _ = _SCENES[name]
        t, _ = rg.plan(w, h, spp, 8, _CUTS)
        pool = torch.empty((rg.N_COMP, t.cap))
        rg.k0_plain(inp, pool, torch.empty((3, t.cap)), t, 0, _CUTS[0])
        dense = torch.zeros_like(pool)
        counts = torch.tensor([t.cap, 0], dtype=torch.int32)
        rg.pack_plain(pool, dense, torch.empty((t.cap,), dtype=torch.int32), counts, 1)
        n = int(counts[1])
        st = torch.zeros((t.cap // rg.TILE_RECORDS, 8))
        rg.k1_plain(inp, dense.clone(), torch.empty((3, t.cap)), counts, 1, t, 0,
                    _CUTS[0], _CUTS[1], stats=st)
        rec = dense[:, :n]
        o, d = rec[rg._OX:rg._OZ + 1].clone(), rec[rg._DX:rg._DZ + 1].clone()
        tr = rec[rg._TR:rg._TB + 1].T.contiguous()
        slot = rec[rg._HHI].long() * 4096 + rec[rg._HLO].long()
        state = rg._seeds(t, slot, 0)[0]
        for _ in range(4 * (_CUTS[0] + 1)):
            state = rg.rng.next_state(state)
        alive = torch.ones((n,), dtype=torch.bool)
        entered = 0
        for b in range(_CUTS[0], _CUTS[1]):
            entered = entered + cull.warp_cull_plain(tuple(o), tuple(d), alive, inp).entered
            idx = torch.nonzero(alive).squeeze(1)
            p = mk.trace_bounces_plain(tuple(o[:, idx]), tuple(d[:, idx]), tr[idx], state[idx],
                                       inp, b, b + 1)
            o[:, idx], d[:, idx], tr[idx], state[idx] = p.o.T, p.d.T, p.tr, p.state
            alive[idx] = p.alive
        out[name] = (inp, n, st.numpy(), entered.numpy())
    return out


@pytest.mark.parametrize("name", list(_SCENES))
def test_warps_enter_no_more_than_their_tile(name, k1_warps):
    inp, n, st, entered = k1_warps[name]
    warps = rg.TILE_RECORDS // 32
    tiles = -(-n // rg.TILE_RECORDS)
    assert tiles >= 2
    per_tile = [entered[k * warps:(k + 1) * warps].mean() for k in range(tiles)]
    assert all(m <= col2 for m, col2 in zip(per_tile, st[:tiles, 2])), (per_tile, st[:tiles, 2])
    assert sum(per_tile) < st[:tiles, 2].sum()
    assert max(entered) > 0


def test_census_follows_the_frame():
    """cull_census traces the frame the twins render: its live lanes at each
    bounce are the paths alive there (K0 run to each depth), each K1's
    first bounce sees PACK's count, and the per-warp cull tests fewer
    spheres than the full sweep."""
    w, h, spp = 64, 32, 4
    port = trg._setup("rtiow", w, h)[1]
    inp = mk.kernel_inputs(*port)
    t, cuts = rg.plan(w, h, spp, 8, _CUTS)
    census = rg.cull_census(inp, t, 3, cuts, 8)
    assert [span for span, _ in census] == [(0, 2), (2, 4), (4, 6), (6, 8)]
    live = [c.live for _, counts in census for c in counts]
    want = [t.cap]
    for b in range(1, 8):
        pool = torch.empty((rg.N_COMP, t.cap))
        rg.k0_plain(inp, pool, torch.empty((3, t.cap)), t, 3, b)
        want.append(int((pool[rg._AL] > 0.5).sum()))
    assert live == want
    _, rows = rg.render_image_regrouped_plain(torch.zeros((w * h, 3)), 3, True, *port,
                                              width=w, height=h, spp=spp, num_bounces=8,
                                              cuts=cuts, debug_counts=True)
    assert [-(-live[b] // 128) for b in cuts] == list(rows[1:])
    for _, counts in census:
        for c in counts:
            assert c.prior_tests == mk.N_PRIORS * c.live
            assert c.box_tests == c.own_box_tests == inp.n_chunks * c.live  # no supers
            assert 0 < c.own_sphere_tests < c.sphere_tests < c.live * inp.n_spheres


def test_regroup_frame_matches_jax():
    """The twins' regroup frame on RTiOW 96x64, two frames of 4 spp, cuts
    (2, 4, 6), against the JAX render_image_regrouped (interpret mode) at
    tests/test_pallas.py's gates."""
    c = _FRAME_CASE
    w, h = c["w"], c["h"]
    jargs, port = trg._setup("rtiow", w, h)
    acc = jnp.zeros((w * h, 3), jnp.float32)
    got = torch.zeros((w * h, 3))
    for f in range(c["frames"]):
        kw = dict(width=w, height=h, spp=c["spp"], num_bounces=c["bounces"], cuts=_CUTS)
        acc = jrg.render_image_regrouped(acc, jnp.uint32(f), jnp.bool_(f == 0), *jargs, **kw)
        rg.render_image_regrouped(got, f, f == 0, *port, **kw)
    n = c["frames"] * c["spp"]
    ref, img = np.asarray(acc) / n, got.numpy() / n
    assert np.isfinite(img).all() and img.mean() > 0.01
    trg._assert_statistically_equal(ref, img, w, h)


def test_wrappers_pass_the_cull_hierarchy(monkeypatch):
    """K0 and K1 hand their kernels prepare_scene_arrays' chunk hierarchy
    (cull_args) and the two scene terms of each lane's box margin, before
    the stream: RTiOW's 31 chunks of 16."""
    w, h = 64, 32
    lib = trg._stubbed(monkeypatch)
    rg.render_image_regrouped(torch.zeros((w * h, 3)), 0, True, *trg._setup("rtiow", w, h)[1],
                              width=w, height=h, spp=4, num_bounces=8, cuts=_CUTS)
    calls = [args for name, args in lib.calls if name in ("wrt_regroup_k0", "wrt_regroup_k1")]
    assert len(calls) == 4
    inp = mk.kernel_inputs(*trg._setup("rtiow", w, h)[1])
    terms = (inp.cull_reach, inp.cull_scale)
    assert terms == mk.cull_terms(inp.sweep, inp.attrs[3], inp.prior_idx) and min(terms) > 0
    for args in calls:
        assert args[-11:-3][3:] == (31, 31, 0, 16, 16) and args[-3:] == (*terms, 1234)
