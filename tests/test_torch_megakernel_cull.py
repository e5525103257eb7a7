"""The megakernel's per-warp cull and its census, on the CPU.

csrc/megakernel.cu culls its sweep per warp as regroup K0 and K1 do
(bounce.cuh ``sweep_culled``), but its warps are 16 x 2 pixel patches of
16 x 16 blocks, and its refill loop moves each lane through its own
pixel's samples. ``cull.megakernel_lanes`` lays the pixels out as those
warps, ``cull.megakernel_warp_cull`` runs ``warp_cull_plain`` on them, and
``cull.megakernel_census`` counts a frame's work with a warp's lanes in
step (one sample and bounce at a time) or refilled per lane. Here:

- the warp-grouped cull gives the full sweep's (t, index) in every bit on
  an RTiOW frame's rays and on tests/test_torch_cull.py's adversarial rays
  (a far cluster of small spheres, and rays that hit their sphere again
  just outside its exact box);
- each lane's own counts of the census, in both groupings, equal the
  regroup census's over the same rays (an image whose slots hold no
  padding), and the warp vote runs at least what the lanes need;
- ``launch_megakernel`` hands its library the chunk hierarchy, the two
  terms of each lane's box margin and the table sizes the library reads
  its boxes from shared or global memory by.

The kernel itself is held to the stats megakernel's full sweep in every
bit by tests/test_torch_cuda.py and chip_smoke.py's ``[megakernel]``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_cull as tcull  # noqa: E402
import test_torch_megakernel as tmk  # noqa: E402
import test_torch_regroup as trg  # noqa: E402

from weekend_raytracer_tpu_torch import CameraBasis, SkyParams, to_sky_state  # noqa: E402
from weekend_raytracer_tpu_torch.ops import rng  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import cull  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import megakernel as mk  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import regroup as rg  # noqa: E402

_W, _H, _SPP = 64, 32, 2  # RTiOW: regroup's slots of this image hold no padding
_BOUNCES = 8
_FRAME = 3
# bounce.cuh kStageBytes and the bytes stage_cull puts in shared memory:
# the priors' four sweep rows and indices, six bounds per chunk and super box
_STAGE_BYTES = 44 * 1024


def _stage_bytes(n_tests: int, n_super: int) -> int:
    return mk.N_PRIORS * (16 + 4) + 6 * 4 * (n_tests + n_super)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _frame_rays(inp, w, h):
    """An RTiOW frame's camera rays and the rays they scatter into, as the
    pixels of two w x h images, with a fifth of the pixels dead."""
    n = w * h
    idx = torch.arange(n)
    state = rng.init_sample_state(idx, _FRAME, 0)
    cam = [mk._f32(v) for v in inp.cam.tolist()]
    state, o, d = mk.camera_rays_plain(cam, (idx % w).to(torch.float32),
                                       (idx // w).to(torch.float32), mk._f32(1.0 / w),
                                       mk._f32(1.0 / h), state)
    p = mk.trace_bounces_plain(o, d, torch.ones((n, 3)), state, inp, 0, 1)
    o = tuple(torch.cat([a, p.o[:, k]]) for k, a in enumerate(o))
    d = tuple(torch.cat([a, p.d[:, k]]) for k, a in enumerate(d))
    live = torch.from_numpy(np.random.RandomState(1).rand(2 * n) > 0.2)
    return o, d, live, (w, 2 * h)


def _as_pixels(o, d, w):
    """Loose rays as the pixels of an image w wide (the last row part dead)."""
    n = o[0].numel()
    h = -(-n // w)
    pad = w * h - n
    o = tuple(torch.cat([v, v.new_zeros(pad)]) for v in o)
    d = tuple(torch.cat([v, v.new_ones(pad)]) for v in d)
    live = torch.cat([torch.ones(n, dtype=torch.bool), torch.zeros(pad, dtype=torch.bool)])
    return o, d, live, (w, h)


def _rtiow():
    return mk.kernel_inputs(*trg._setup("rtiow", _W, _H)[1])


def _rays(name):
    if name == "rtiow":
        inp = _rtiow()
        return (inp, *_frame_rays(inp, _W, _H))
    if name == "far_cluster":
        inp = tcull._far_cluster()
        return (inp, *_as_pixels(*tcull._grazing_rays(inp), 37))
    from weekend_raytracer_tpu_torch import SCENES

    build, cam = SCENES["random10k"]
    inp = mk.kernel_inputs(build().build(device="cpu"), to_sky_state(SkyParams(), device="cpu"),
                           CameraBasis.create(cam(), (3840, 2160), device="cpu"))
    o = tuple(torch.tensor([r[0][k] for r in tcull._REHITS], dtype=torch.float32)
              for k in range(3))
    d = tuple(torch.tensor([r[1][k] for r in tcull._REHITS], dtype=torch.float32)
              for k in range(3))
    return (inp, *_as_pixels(o, d, 3))


@pytest.fixture(scope="module")
def grouped():
    """Each case's rays through the megakernel's warps and the full sweep."""
    out = {}
    for name in ("rtiow", "far_cluster", "rehits"):
        inp, o, d, live, (w, h) = _rays(name)
        lanes = cull.megakernel_lanes(w, h)
        out[name] = (inp, live, cull.megakernel_warp_cull(o, d, live, lanes, inp),
                     mk._closest_hit(o, d, inp.sweep))
    return out


def test_lanes_are_the_kernels_warps():
    """Blocks of 16 x 16 threads over a 40 x 20 image: each warp is a 16 x 2
    patch, every pixel is one lane, and lanes past the edge are -1."""
    lanes = cull.megakernel_lanes(40, 20)
    assert lanes.numel() == 3 * 2 * 256
    assert lanes[:32].tolist() == [y * 40 + x for y in (0, 1) for x in range(16)]
    warp = lanes.view(-1, 32)[8]  # block 0, rows 0-15 done: block 0 has 8 warps
    assert warp.tolist() == [y * 40 + 16 + x for y in (0, 1) for x in range(16)]
    real = lanes[lanes >= 0]
    assert sorted(real.tolist()) == list(range(40 * 20))
    # the third block column holds x 32-47, of which 40-47 are past the edge
    assert int((lanes < 0).sum()) == 3 * 2 * 256 - 40 * 20


@pytest.mark.parametrize("name", ["rtiow", "far_cluster", "rehits"])
def test_warp_grouped_cull_is_the_full_sweep(name, grouped):
    inp, live, wc, (bt, bi) = grouped[name]
    assert inp.n_chunks
    torch.testing.assert_close(_bits(wc.bt[live]), _bits(bt[live]), rtol=0, atol=0)
    torch.testing.assert_close(wc.bi[live], bi[live], rtol=0, atol=0)
    assert wc.count.live == int(live.sum())
    assert bool((wc.bi[~live] == -1).all())
    if name == "rtiow":  # hits, misses and a vote that skips chunks
        assert 0.2 < float((bi[live] >= 0).float().mean()) < 0.99
        assert 0 < wc.count.sphere_tests < wc.count.live * inp.n_spheres
    if name == "rehits":  # on the exact boxes the cull would lose these hits
        assert bi[live].tolist() == [r[2] for r in tcull._REHITS]


@pytest.fixture(scope="module")
def census():
    inp = _rtiow()
    t, cuts = rg.plan(_W, _H, _SPP, _BOUNCES, tcull._CUTS)
    assert t.cap == _W * _H * _SPP  # no padding slots
    return (inp, {g: cull.megakernel_census(inp, _W, _H, _SPP, _BOUNCES, _FRAME,
                                            refill=g == "refill")
                  for g in ("lockstep", "refill")},
            [c for _, counts in rg.cull_census(inp, t, _FRAME, cuts, _BOUNCES) for c in counts])


def _total(steps):
    return cull.CullCount(*map(sum, zip(*(c.count if isinstance(c, cull.CensusStep) else c
                                          for c in steps))))


@pytest.mark.parametrize("grouping", ["lockstep", "refill"])
def test_census_own_counts_are_regroups(grouping, census):
    inp, mega, regroup = census
    got, want = _total(mega[grouping]), _total(regroup)
    for field in ("live", "prior_tests", "own_sphere_tests", "own_box_tests"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.own_sphere_tests <= got.sphere_tests < got.live * inp.n_spheres
    assert got.own_box_tests <= got.box_tests


def test_census_steps_follow_the_paths(census):
    """In step, each sample's bounces follow one another: the first step of
    every sample has every pixel live, and there are at most spp x bounces
    steps. Refilled, a warp runs until its longest lane has done all its
    samples, which takes no more steps than the lockstep loop and fewer
    warp steps in all."""
    _, mega, regroup = census
    lock, refill = mega["lockstep"], mega["refill"]
    assert lock[0].count.live == _W * _H and len(lock) <= _SPP * _BOUNCES
    assert sum(c.count.live == _W * _H for c in lock) == _SPP
    assert len(refill) <= len(lock)
    # every warp of the image runs the first step; refilled, the warps run
    # fewer steps in all
    assert lock[0].warps == refill[0].warps == _W * _H // 32
    assert sum(c.warps for c in refill) < sum(c.warps for c in lock)
    # the segments entering bounce 0 of both samples are regroup's K0 slots
    assert regroup[0].live == _W * _H * _SPP


@pytest.mark.parametrize("scene", ["rtiow", "random60k", "textured"])
def test_launch_passes_the_cull_hierarchy(monkeypatch, scene):
    """launch_megakernel hands the library cull_args (the chunk hierarchy),
    then the two scene terms of each lane's box margin, before the stream.
    The library stages the boxes in shared memory while they fit
    kStageBytes (RTiOW's 31 chunks) and reads them from global memory
    above (random_spheres(60000)); a scene below two chunks (the textured
    one) passes none and keeps the full sweep."""
    if scene == "random60k":
        from weekend_raytracer_tpu_torch.models.scenes import random_spheres, random_spheres_camera

        case = (random_spheres(60000).build(device="cpu"), to_sky_state(SkyParams(), device="cpu"),
                CameraBasis.create(random_spheres_camera(), (_W, _H), device="cpu"))
    else:
        case = trg._setup(scene, _W, _H)[1]
    launch = tmk._stubbed_wrapper(monkeypatch)
    acc = torch.zeros((_W * _H, 3))
    mk.render_image_megakernel(acc, _FRAME, True, *case, width=_W, height=_H, spp=3,
                               num_bounces=_BOUNCES)
    (args,) = launch.calls
    inp = mk.kernel_inputs(*case)
    assert args[11:16] == (_FRAME, 0, 1, 3, _BOUNCES)
    assert args[19:24] == mk.cull_args(inp, torch.device("cpu"))[3:]
    assert all(a is not None for a in args[16:19])
    assert args[24:] == (mk._f32(inp.cull_reach), mk._f32(inp.cull_scale), 1234)
    staged = _stage_bytes(inp.n_tests, inp.n_super) <= _STAGE_BYTES
    if scene == "rtiow":
        assert args[19:24] == (31, 31, 0, 16, 16) and staged and min(args[24:26]) > 0
    elif scene == "random60k":
        assert inp.n_chunks == 1875 and inp.n_super and not staged
    else:
        assert args[4] is not None and inp.n_chunks == 0 and args[24:26] == (0.0, 0.0)
