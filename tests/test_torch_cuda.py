"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU: the
kernel is CUDA C++ and has no CPU mode. The module imports only the port
(no JAX), so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Images are held to the plain version at tests/test_pallas.py's statistical
gates (tonemapped RMSE < 5e-3, mean radiance within a relative 1e-3; < 1%
of first-hit pixels may differ): the kernel contracts multiply-adds into
FMAs and the CUDA math library rounds sin/cos/exp differently from
PyTorch's, so chaotic Monte-Carlo paths may diverge at silhouettes. The
regroup pipeline's PACK and COMBINE (one launch a cut, one a frame) are
held bit for bit with their twins; its K0 and K1
run the megakernel's own per-ray body, so at one sample per pixel regroup
and the megakernel give the same bits; regroup's K0 and K1, the megakernel
and the wavefront's K0 and K1 cull their sweep per warp, with the boxes in
shared or (a large scene) global memory, the megakernel and the
wavefront's K0 refill each lane's samples and the wavefront's K1 regroups
each block's live lanes, which changes no bit against the wavefront's
full-sweep instantiations, the stats megakernel and K1's stats kernel (which
sweep every sphere, in windows where the table is large), or with a last warp or block part full.
The row-compacted wavefront runs the
same body on the same slots: it gives regroup's image in every bit, and
its COMPACT equals its twin bit for bit. The record reorder kernels equal
their twins bit for bit (dma_rate's twin repeats its sum order), and K1 on
a binned pool, scattered back, equals home-order K1 in every bit. Of the
sweep probe kernels, the layout remap and the FP32 dot (at M of 16 to 64,
N up to 2^20) equal their twins bit for bit, and so does the indexed-access
kernel smem_rw's "direct" route (wraps, overlapping writes, every width); the TF32 and 3xTF32 dots are within probes/mxu_sweep.py's
DOT_TOL of sum |a||b| of their twins (the products are exact, the tensor
cores sum in their own order); the sweeps hit the same spheres as their
twins with t within probes/mxu_sweep.py's t_tolerance on every ray at the
TPU probe's shapes and past sweep_mma's first shared-memory window, and on
all but FILL_WRONG_SHARE of the rays at the card-filling shape. The
``"xla"`` backend, which is plain PyTorch on the card, is held to the same
frames on the CPU at the statistical gates and launches no kernel of the
port; a checkpoint saved on the card resumes there in every bit, for
regroup and for xla.
"""
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from weekend_raytracer_tpu_torch import (  # noqa: E402
    SCENES, Camera, CameraBasis, Material, RenderParams, Renderer,
    SamplingParams, SceneDesc, SkyParams, SkyState, Sphere, to_sky_state)
from weekend_raytracer_tpu_torch.ops import tonemap  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import megakernel as mk  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import regroup as rg  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import reorder as ro  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import sweep as sw  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import wavefront as wf  # noqa: E402
from weekend_raytracer_tpu_torch.probes import binned, dma, mxu_sweep  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(name, w, h, device):
    if name == "first_hit":
        desc = SceneDesc(materials=[Material.lambertian((0.3, 0.4, 0.5))],
                         spheres=[Sphere((0.0, 0.0, -3.0), 1.0, 0)])
        cam = Camera.look_at((0, 0, 1), (0, 0, -3), vfov_degrees=40.0, aperture=0.0)
        params = np.zeros((3, 9), np.float32)
        params[:, 2] = 1.0
        sky = SkyState.from_raw(params, np.ones(3), np.array([0.0, 1.0, 0.0]),
                                device=device)
    else:
        desc, cam = SCENES[name][0](), SCENES[name][1]()
        sky = to_sky_state(SkyParams(), device=device)
    return mk.kernel_inputs(desc.build(device=device), sky,
                            CameraBasis.create(cam, (w, h), device=device))


def _render(fn, inp, w, h, frames, spp, bounces, device, **kw):
    acc = torch.zeros((w * h, 3), dtype=torch.float32, device=device)
    for f in range(frames):
        fn(acc, inp, f, f == 0, width=w, height=h, spp=spp, num_bounces=bounces, **kw)
    torch.cuda.synchronize()
    return acc / (frames * spp)


def _tonemapped(img, w, h):
    return tonemap.to_srgb_u8(img.reshape(h, w, 3)).float() / 255.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["three", "rtiow", "textured"])
def test_kernel_matches_plain(name, cuda):
    w, h, frames, spp, bounces = 64, 48, 4, 4, 8
    inp = _inputs(name, w, h, cuda)
    a = _render(mk.launch_megakernel, inp, w, h, frames, spp, bounces, cuda)
    b = _render(mk.render_plain_with_inputs, inp, w, h, frames, spp, bounces, cuda)
    assert bool(torch.isfinite(a).all())
    rmse = float(((_tonemapped(a, w, h) - _tonemapped(b, w, h)) ** 2).mean().sqrt())
    assert rmse < 5e-3, rmse
    assert abs(float(a.mean()) - float(b.mean())) / float(b.mean()) < 1e-3


@pytest.mark.cuda
def test_first_hit_geometry(cuda):
    w, h = 64, 48
    inp = _inputs("first_hit", w, h, cuda)
    a = _render(mk.launch_megakernel, inp, w, h, 1, 1, 1, cuda)
    b = _render(mk.render_plain_with_inputs, inp, w, h, 1, 1, 1, cuda)
    mismatch = float(((a - b).abs() > 1e-6).any(dim=1).float().mean())
    assert mismatch < 0.01, mismatch


@pytest.mark.cuda
def test_row_band_reproduces_full_image(cuda):
    """A band at a global row offset equals the same rows of the full image
    (both from the kernel, so bit for bit)."""
    w, h = 48, 32
    inp = _inputs("three", w, h, cuda)
    full = _render(mk.launch_megakernel, inp, w, h, 1, 2, 4, cuda)
    band = torch.zeros((w * 8, 3), device=cuda)
    mk.launch_megakernel(band, inp, 0, True, width=w, height=8, spp=2,
                         num_bounces=4, row_offset=12, full_height=h)
    torch.cuda.synchronize()
    torch.testing.assert_close(band / 2, full[12 * w:20 * w], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rtiow", "textured", "first_hit"])
def test_megakernel_is_the_full_sweep(name, cuda):
    """The megakernel (per-warp cull on RTiOW's chunks, samples refilled per
    lane) equals the stats megakernel, which sweeps every sphere from a
    staged table, in every bit: 3 spp, two frames, the second added."""
    w, h = 70, 40
    inp = _inputs(name, w, h, cuda)
    assert (inp.n_chunks > 0) == (name == "rtiow")
    bounces = 1 if name == "first_hit" else 8
    a = torch.zeros((w * h, 3), device=cuda)
    b = torch.zeros_like(a)
    for f in range(2):
        kw = dict(width=w, height=h, spp=3, num_bounces=bounces)
        mk.launch_megakernel(a, inp, f, f == 0, **kw)
        mk.launch_megakernel(b, inp, f, f == 0, stats=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_megakernel_budget_has_no_spills(cuda):
    """Every megakernel instantiation builds without spills, and the culled
    ones (the FMA and the MXU route) stay inside their launch bounds'
    register budget."""
    usage = {k: v for k, v in mk._library().ptxas_usage().items()
             if "megakernel" in k and "stats_finish" not in k}
    # 2 textures x 2 box placements x (culled, its MXU route, stats staged
    # whole, in windows)
    assert len(usage) == 16
    assert all(v["spill_stores"] == 0 and v["spill_loads"] == 0 for v in usage.values()), usage
    threads, blocks = mk.launch_bounds()
    mxu_threads, mxu_blocks = mk.launch_bounds(mxu=True)
    assert blocks > 0 and mxu_blocks > 0
    for textured in (False, True):
        for staged in (True, False):
            regs = mk.kernel_attributes(textured, False, staged)["registers"]
            assert regs <= 65536 // (threads * blocks), (textured, staged, regs)
            regs = mk.mxu_kernel_attributes(textured, staged)["registers"]
            assert regs <= 65536 // (mxu_threads * mxu_blocks), (textured, staged, regs)


@pytest.mark.cuda
def test_renderer_counts_one_launch_per_frame(cuda):
    params = RenderParams(
        camera=SCENES["three"][1](), viewport_size=(64, 36),
        sampling=SamplingParams(max_samples_per_pixel=12,
                                num_samples_per_pixel=4, num_bounces=4))
    r = Renderer(SCENES["three"][0](), params, backend="pallas", device=cuda)
    before = mk.render_image_megakernel.launches
    stats = r.render()
    assert stats.frames == 3
    assert mk.render_image_megakernel.launches - before == 3
    assert r.image().shape == (36, 64, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rtiow", "textured"])
def test_regroup_matches_plain(name, cuda):
    w, h, frames, spp, bounces = 64, 48, 4, 4, 8
    inp = _inputs(name, w, h, cuda)
    a = _render(rg.launch_regrouped, inp, w, h, frames, spp, bounces, cuda, cuts=(2, 4, 6))
    b = _render(rg.regrouped_plain_with_inputs, inp, w, h, frames, spp, bounces, cuda,
                cuts=(2, 4, 6))
    assert bool(torch.isfinite(a).all())
    rmse = float(((_tonemapped(a, w, h) - _tonemapped(b, w, h)) ** 2).mean().sqrt())
    assert rmse < 5e-3, rmse
    assert abs(float(a.mean()) - float(b.mean())) / float(b.mean()) < 1e-3


def _pack_both(pool, n_in, cuda):
    """PACK and its twin on the first n_in records of pool, onto poisoned
    buffers; asserts that they agree in every bit and returns the kernel's
    (live count, dense pool, inverse map)."""
    out = []
    for pack in (rg.launch_pack, rg.pack_plain):
        counts = torch.tensor([n_in, 0], dtype=torch.int32, device=cuda)
        dst = torch.full((rg.N_COMP, pool.shape[1]), 7.0, device=cuda)
        inv = torch.full((pool.shape[1],), -7, dtype=torch.int32, device=cuda)
        pack(pool, dst, inv, counts, 1, rg.pack_scratch(pool.shape[1], cuda))
        out.append((int(counts[1]), dst, inv))
    torch.cuda.synchronize()
    n = out[1][0]
    end = -(-n // 128) * 128
    assert out[0][0] == n
    assert torch.equal(out[0][1][:, :end] + 0.0, out[1][1][:, :end] + 0.0)
    assert torch.equal(out[0][2], out[1][2])
    return out[0]


def _combine_both(inv, r8, contrib, t, gen, cuda):
    """COMBINE and its twin onto one random accumulator, with clear off and
    on: equal in every bit, and the inputs left as they were."""
    kept = [x.clone() for x in (inv, r8, contrib)]
    for clear in (False, True):
        accum = torch.rand((t.width * t.height, 3), device=cuda, generator=gen)
        got, ref = accum.clone(), accum.clone()
        rg.launch_combine(inv, r8, contrib, got, t, clear)
        rg.combine_chain_plain(inv, r8, contrib, ref, t, clear)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), clear
    assert all(_same_bits(a, b) for a, b in zip(kept, (inv, r8, contrib)))


@pytest.mark.cuda
@pytest.mark.parametrize("alive", ["k0", "random", "all_live", "all_dead", "ragged"])
def test_pack_and_combine_bit_for_bit(alive, cuda):
    """PACK (one launch) against pack_plain on K0's pool with K0's alive
    mask, a random one, all live and all dead, and the random mask over an
    input count that is no multiple of the tile or of 4; then COMBINE
    through that inverse map against its twin."""
    w, h = 96, 64
    inp = _inputs("rtiow", w, h, cuda)
    t, _ = rg.plan(w, h, 4, 8, (2, 4, 6))
    pool = torch.empty((rg.N_COMP, t.cap), device=cuda)
    rg.launch_k0(inp, pool, torch.empty((3, t.cap), device=cuda), t, 0, 2)
    gen = torch.Generator(device=cuda).manual_seed(1)
    if alive != "k0":
        pool[rg._AL] = {"all_live": torch.ones(t.cap, device=cuda),
                        "all_dead": torch.zeros(t.cap, device=cuda)}.get(
            alive, (torch.rand(t.cap, device=cuda, generator=gen) < 0.3).float())
    n_in = t.cap - 4096 - 1234 - 3 if alive == "ragged" else t.cap
    n, _, inv = _pack_both(pool, n_in, cuda)
    assert n == {"all_live": t.cap, "all_dead": 0}.get(alive, n)
    inv[n_in:] = rg.DEAD
    _combine_both(inv[None], torch.rand((1, 3, t.cap), device=cuda, generator=gen),
                  torch.rand((3, t.cap), device=cuda, generator=gen), t, gen, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("spp", [1, 2, 32, 128])
def test_pack_chain_and_combine_bit_for_bit(spp, cuda):
    """A frame's chain at cuts (2, 4, 6) on a ragged image (100 x 70): each
    PACK against its twin (PACK 2 and 3 take a live count below the
    capacity, no multiple of the tile), then COMBINE over the frame's
    inverse maps and radiance against its twin, with clear off and on."""
    w, h = 100, 70
    inp = _inputs("rtiow", w, h, cuda)
    t, cuts = rg.plan(w, h, spp, 8, (2, 4, 6))
    pools = [torch.empty((rg.N_COMP, t.cap), device=cuda) for _ in range(2)]
    contrib = torch.empty((3, t.cap), device=cuda)
    rg.launch_k0(inp, pools[0], contrib, t, 0, cuts[0])
    inv = torch.empty((len(cuts), t.cap), dtype=torch.int32, device=cuda)
    r8 = torch.empty((len(cuts), 3, t.cap), device=cuda)
    n_in = t.cap
    for k, b_lo in enumerate(cuts, 1):
        n, dense, inv[k - 1] = _pack_both(pools[(k - 1) % 2], n_in, cuda)
        assert 0 < n < n_in
        pools[k % 2] = dense
        counts = torch.tensor([n_in, n], dtype=torch.int32, device=cuda)
        rg.launch_k1(inp, dense, r8[k - 1], counts, 1, t, 0, b_lo,
                     cuts[k] if k < len(cuts) else 8)
        n_in = n
    _combine_both(inv, r8, contrib, t, torch.Generator(device=cuda).manual_seed(2), cuda)


@pytest.mark.cuda
def test_regroup_equals_megakernel_at_one_sample(cuda):
    """K0 and K1 run the megakernel's per-ray body: with one sample per
    pixel (no sum to contract) the two CUDA paths give the same bits, for
    any cut schedule."""
    w, h = 96, 64
    inp = _inputs("rtiow", w, h, cuda)
    m = _render(mk.launch_megakernel, inp, w, h, 1, 1, 8, cuda)
    for cuts in ((2, 4, 6), (1,), (3, 5)):
        a = _render(rg.launch_regrouped, inp, w, h, 1, 1, 8, cuda, cuts=cuts)
        assert torch.equal(a, m), cuts


@pytest.mark.cuda
def test_renderer_auto_counts_regroup_launches(cuda):
    params = RenderParams(
        camera=SCENES["rtiow"][1](), viewport_size=(64, 36),
        sampling=SamplingParams(max_samples_per_pixel=12,
                                num_samples_per_pixel=4, num_bounces=8))
    r = Renderer(SCENES["rtiow"][0](), params, device=cuda)
    assert r.backend == "regroup"
    names = ("k0", "pack", "k1", "combine")
    before = [getattr(rg, f"launch_{k}").launches for k in names]
    mk_before = mk.render_image_megakernel.launches
    assert r.render().frames == 3
    after = [getattr(rg, f"launch_{k}").launches for k in names]
    assert [a - b for a, b in zip(after, before)] == [3, 9, 9, 3]
    assert mk.render_image_megakernel.launches == mk_before
    assert r.image().shape == (36, 64, 3)


@pytest.mark.cuda
def test_regroup_row_band_reproduces_full_image(cuda):
    """A band at a global row offset equals the same rows of the full
    regrouped image, bit for bit."""
    w, h = 48, 40
    inp = _inputs("three", w, h, cuda)
    kw = dict(spp=2, num_bounces=6, cuts=(2, 4))
    full = torch.zeros((w * h, 3), device=cuda)
    rg.launch_regrouped(full, inp, 0, True, width=w, height=h, **kw)
    band = torch.zeros((w * 6, 3), device=cuda)
    rg.launch_regrouped(band, inp, 0, True, width=w, height=6, row_offset=33,
                        full_height=h, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(band, full[33 * w:39 * w], rtol=0, atol=0)


def _stats_case(name, w, h, device):
    if name == "super":  # 75 chunks of 16 in 5 super-chunks
        from weekend_raytracer_tpu_torch.models.scenes import (random_spheres,
                                                               random_spheres_camera)

        return mk.kernel_inputs(random_spheres(1200).build(device=device),
                                to_sky_state(SkyParams(), device=device),
                                CameraBasis.create(random_spheres_camera(), (w, h),
                                                   device=device), chunk_size=16)
    return _inputs(name, w, h, device)


@pytest.mark.cuda
@pytest.mark.parametrize("name, w, h", [("rtiow", 96, 64), ("super", 96, 64),
                                         ("rtiow", 70, 66)])
def test_megakernel_stats_match_plain(name, w, h, cuda):
    """The stats megakernel against its twin: equal per tile at one
    bounce, each column's sum within 1% at eight; and its image is the
    kStats = false kernel's, bit for bit. 96 and 70 x 66 pad to whole
    64 x 64 TPU tiles, whose padded lanes count as the edge pixel's."""
    spp = 4
    inp = _stats_case(name, w, h, cuda)
    for bounces in (1, 8):
        kw = dict(width=w, height=h, spp=spp, num_bounces=bounces, stats=True)
        img, st = mk.launch_megakernel(torch.zeros((w * h, 3), device=cuda), inp, 1, True, **kw)
        _, ref = mk.render_plain_with_inputs(torch.zeros((w * h, 3), device=cuda), inp, 1,
                                             True, **kw)
        plain_img = mk.launch_megakernel(torch.zeros((w * h, 3), device=cuda), inp, 1, True,
                                         width=w, height=h, spp=spp, num_bounces=bounces)
        torch.cuda.synchronize()
        assert torch.equal(img, plain_img)
        if bounces == 1:
            assert torch.equal(st, ref)
            assert bool((st[:, 1] == 4096 * spp).all())  # every lane of a tile, once
        else:
            torch.testing.assert_close(st.sum(0), ref.sum(0), rtol=0.01, atol=0)
        assert bool((st[:, 0] >= 1).all() and (st[:, 0] <= spp * bounces).all())
        assert bool((st[:, 1] > 0).all() and (st[:, 2] >= st[:, 0]).all())


@pytest.mark.cuda
def test_k1_stats_match_plain(cuda):
    """K1's kStats instantiation against k1_plain on one dense pool (K0 and
    PACK kernels, RTiOW 96x64 x 4 spp, cut 2): equal per tile over one
    bounce, each column's sum within 1% over [2, 4)."""
    w, h = 96, 64
    inp = _inputs("rtiow", w, h, cuda)
    t, _ = rg.plan(w, h, 4, 8, (2, 4, 6))
    pool = torch.empty((rg.N_COMP, t.cap), device=cuda)
    rg.launch_k0(inp, pool, torch.empty((3, t.cap), device=cuda), t, 0, 2)
    dense = torch.empty_like(pool)
    counts = torch.tensor([t.cap, 0], dtype=torch.int32, device=cuda)
    rg.launch_pack(pool, dense, torch.empty((t.cap,), dtype=torch.int32, device=cuda), counts,
                   1, rg.pack_scratch(t.cap, cuda))
    live = -(-int(counts[1]) // rg.TILE_RECORDS)
    for b_hi in (3, 4):
        out = []
        for k1 in (rg.launch_k1, rg.k1_plain):
            st = torch.full((t.cap // rg.TILE_RECORDS, 8), -1.0, device=cuda)
            k1(inp, dense.clone(), torch.empty((3, t.cap), device=cuda), counts, 1, t, 0, 2,
               b_hi, stats=st)
            out.append(st)
        torch.cuda.synchronize()
        assert bool((out[0][live:] == 0).all())
        if b_hi == 3:
            assert torch.equal(out[0], out[1])
        else:
            torch.testing.assert_close(out[0].sum(0), out[1].sum(0), rtol=0.01, atol=0)
        assert bool((out[0][:live, 0] >= 1).all() and (out[0][:live, 1] > 0).all())


def _random3000(w, h, device, **kw):
    from weekend_raytracer_tpu_torch.models.scenes import random_spheres, random_spheres_camera

    return mk.kernel_inputs(random_spheres(3000).build(device=device),
                            to_sky_state(SkyParams(), device=device),
                            CameraBasis.create(random_spheres_camera(), (w, h), device=device),
                            **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_size", [None, 0])
def test_stats_kernels_in_windows_match(chunk_size, cuda):
    """random_spheres(3000), whose table (96 KB) the stats kernels sweep in
    windows that the block walks in step, in chunks of 32 and without
    chunks: the stats megakernel's image is the culled kernel's in every
    bit and its counters the twin's per tile at one bounce; K1's stats
    kernel (cut 2 of K0 and PACK) equals k1_plain per tile over one bounce
    and its pool K1's."""
    w, h, spp = 128, 64, 4
    inp = _random3000(w, h, cuda, chunk_size=chunk_size)
    plan = mk.stats_plan_of(inp)
    assert plan["windows"] > 1 and (inp.n_chunks > 0) == (chunk_size is None)
    assert mk.stats_plan_built(inp.n_spheres, inp.n_chunks, inp.n_tests, inp.n_super,
                               inp.chunk_size) == plan
    for bounces in (1, 8):
        kw = dict(width=w, height=h, spp=spp, num_bounces=bounces)
        img, st = mk.launch_megakernel(torch.zeros((w * h, 3), device=cuda), inp, 1, True,
                                       stats=True, **kw)
        culled = mk.launch_megakernel(torch.zeros((w * h, 3), device=cuda), inp, 1, True, **kw)
        torch.cuda.synchronize()
        assert torch.equal(img, culled)
        if bounces == 1:
            _, ref = mk.render_plain_with_inputs(torch.zeros((w * h, 3), device=cuda), inp, 1,
                                                 True, stats=True, **kw)
            assert torch.equal(st, ref)
            assert bool(st[:, 2].sum() > 0) == (inp.n_chunks > 0)
    t, _ = rg.plan(w, h, spp, 8, (2, 4, 6))
    pool = torch.empty((rg.N_COMP, t.cap), device=cuda)
    rg.launch_k0(inp, pool, torch.empty((3, t.cap), device=cuda), t, 0, 2)
    dense = torch.empty_like(pool)
    counts = torch.tensor([t.cap, 0], dtype=torch.int32, device=cuda)
    rg.launch_pack(pool, dense, torch.empty((t.cap,), dtype=torch.int32, device=cuda), counts,
                   1, rg.pack_scratch(t.cap, cuda))
    n = int(counts[1])
    assert n > 0
    out = []
    for k1, stats in ((rg.launch_k1, True), (rg.k1_plain, True), (rg.launch_k1, False)):
        p = dense.clone()
        st = torch.full((t.cap // rg.TILE_RECORDS, 8), -1.0, device=cuda) if stats else None
        k1(inp, p, torch.empty((3, t.cap), device=cuda), counts, 1, t, 0, 2, 3, stats=st)
        out.append((p, st))
    torch.cuda.synchronize()
    assert torch.equal(out[0][1], out[1][1])
    assert torch.equal(out[0][0][:, :n].view(torch.int32), out[2][0][:, :n].view(torch.int32))


# --- the per-warp cull of regroup K0 and K1 ----------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("spp", [1, 4])
@pytest.mark.parametrize("name", ["rtiow", "textured", "super"])
def test_culled_regroup_equals_unculled_paths(name, spp, cuda):
    """K0 and K1 sweep only the chunks some lane of a warp enters, and
    change no bit: over two frames the regroup accumulator equals the
    full-sweep wavefront's (its kCull = false kernels, which sweep every
    sphere), and at one sample per pixel the megakernel's; a frame launches
    K0 and COMBINE once and PACK and K1 once per cut. (textured has no
    chunks: the full sweep.)"""
    w, h = 96, 64
    inp = _stats_case(name, w, h, cuda)
    assert (inp.n_chunks > 0) == (name != "textured") and (inp.n_super > 0) == (name == "super")
    assert rg.cull_placement(inp)["boxes"] == ("shared" if inp.n_chunks else "none")
    names = ("k0", "pack", "k1", "combine")
    before = [getattr(rg, f"launch_{k}").launches for k in names]
    got = _render(rg.launch_regrouped, inp, w, h, 2, spp, 8, cuda, cuts=(2, 4, 6))
    after = [getattr(rg, f"launch_{k}").launches for k in names]
    assert [a - b for a, b in zip(after, before)] == [2, 6, 6, 2]
    ref = _render(wf._launch_wavefront_full_sweep, inp, w, h, 2, spp, 8, cuda)
    assert torch.equal(got, ref)
    if spp == 1:
        a = _render(rg.launch_regrouped, inp, w, h, 1, 1, 8, cuda, cuts=(2, 4, 6))
        m = _render(mk.launch_megakernel, inp, w, h, 1, 1, 8, cuda)
        assert torch.equal(a, m)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rtiow", "super"])
def test_culled_k1_with_a_ragged_count(name, cuda):
    """K1 on a dense pool whose count is not a multiple of 32 (the last
    warp part full): it leaves the records past the count alone, equals
    the kStats instantiation (which sweeps every sphere) in every bit, and
    its twin at the gates of chip_smoke's K1 checks over one bounce (alive
    flags on 99% of the records; K1's radiance put on K0's contributions at
    the records' home slots and folded, at tonemapped RMSE < 5e-3 and mean
    radiance within 1e-3)."""
    w, h, spp = (96, 64, 4) if name == "rtiow" else (256, 192, 4)
    inp = _stats_case(name, w, h, cuda)
    t, _ = rg.plan(w, h, spp, 8, (2, 4, 6))
    pool = torch.empty((rg.N_COMP, t.cap), device=cuda)
    contrib = torch.empty((3, t.cap), device=cuda)
    rg.launch_k0(inp, pool, contrib, t, 0, 2)
    dense = torch.empty_like(pool)
    counts = torch.tensor([t.cap, 0], dtype=torch.int32, device=cuda)
    rg.launch_pack(pool, dense, torch.empty((t.cap,), dtype=torch.int32, device=cuda), counts,
                   1, rg.pack_scratch(t.cap, cuda))
    n = int(counts[1]) // 32 * 32 - 5
    assert n > 4096 and n % 32 == 27
    counts[1] = n
    runs = []
    for k1, stats in ((rg.launch_k1, None), (rg.launch_k1, True), (rg.k1_plain, None)):
        p, r8 = dense.clone(), torch.zeros((3, t.cap), device=cuda)
        st = torch.empty((t.cap // rg.TILE_RECORDS, 8), device=cuda) if stats else None
        k1(inp, p, r8, counts, 1, t, 0, 2, 3, stats=st)
        runs.append((p, r8))
    torch.cuda.synchronize()
    (pk, rk), (ps, rs), (pp, rp) = runs
    assert _same_bits(pk[:, n:], dense[:, n:]) and not bool(rk[:, n:].any())
    assert _same_bits(pk, ps) and _same_bits(rk, rs)
    same = pk[rg._AL, :n] == pp[rg._AL, :n]
    assert float(same.float().mean()) >= 0.99
    imgs = []
    for r8 in (rk, rp):
        slot = dense[rg._HHI, :n].long() * 4096 + dense[rg._HLO, :n].long()
        per_slot = contrib.clone()
        per_slot[:, slot] = r8[:, :n]
        acc = torch.zeros((w * h, 3), device=cuda)
        rg._fold_plain(per_slot, acc, t, True)
        imgs.append(acc / spp)
    a, b = imgs
    rmse = float(((_tonemapped(a, w, h) - _tonemapped(b, w, h)) ** 2).mean().sqrt())
    assert rmse < 5e-3, rmse
    assert abs(float(a.mean()) - float(b.mean())) / float(b.mean()) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("spp", [1, 4])
def test_culled_regroup_with_boxes_in_global_memory(spp, cuda):
    """random_spheres(60000) has 1,875 chunks of 32 in 118 super-chunks,
    48,144 bytes of boxes: past regroup.cu's kStageBytes, so K0 and K1
    stage only the priors' rows (80 bytes) and read the boxes from global
    memory (kStaged = false). The accumulator still equals the full-sweep
    wavefront's in every bit over two frames, and at one sample per pixel
    the megakernel's."""
    from weekend_raytracer_tpu_torch.models.scenes import random_spheres, random_spheres_camera

    w, h = 96, 64
    inp = mk.kernel_inputs(random_spheres(60000).build(device=cuda),
                           to_sky_state(SkyParams(), device=cuda),
                           CameraBasis.create(random_spheres_camera(), (w, h), device=cuda))
    assert (inp.n_chunks, inp.n_tests, inp.n_super) == (1875, 1888, 118)
    assert rg.cull_placement(inp) == {"smem_bytes": 80, "boxes": "global"}
    got = _render(rg.launch_regrouped, inp, w, h, 2, spp, 8, cuda, cuts=(2, 4, 6))
    assert torch.equal(got, _render(wf._launch_wavefront_full_sweep, inp, w, h, 2, spp, 8,
                                    cuda))
    if spp == 1:
        a = _render(rg.launch_regrouped, inp, w, h, 1, 1, 8, cuda, cuts=(2, 4, 6))
        assert torch.equal(a, _render(mk.launch_megakernel, inp, w, h, 1, 1, 8, cuda))


class _Refusing:
    """A loaded regroup library whose K0 and K1 entry points return
    cudaErrorLaunchOutOfResources (701), as a refused launch does."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        if name in ("wrt_regroup_k0", "wrt_regroup_k1"):
            return lambda *args: 701
        return getattr(self._lib, name)


@pytest.mark.cuda
def test_refused_culled_launch_raises(monkeypatch, cuda):
    """A refused K0 or K1 launch: the wrappers raise and count no launch."""
    w, h = 64, 32
    inp = _inputs("rtiow", w, h, cuda)
    built = type("Built", (), {"lib": _Refusing(rg._library().lib)})()
    monkeypatch.setattr(rg, "_library", lambda: built)
    t, _ = rg.plan(w, h, 4, 8, (2,))
    pool = torch.empty((rg.N_COMP, t.cap), device=cuda)
    r8 = torch.empty((3, t.cap), device=cuda)
    counts = torch.tensor([t.cap, t.cap], dtype=torch.int32, device=cuda)
    before = (rg.launch_k0.launches, rg.launch_k1.launches)
    with pytest.raises(RuntimeError, match="K0 launch failed: CUDA error 701"):
        rg.launch_k0(inp, pool, r8, t, 0, 2)
    with pytest.raises(RuntimeError, match="K1 launch failed: CUDA error 701"):
        rg.launch_k1(inp, pool, r8, counts, 1, t, 0, 2, 8)
    assert (rg.launch_k0.launches, rg.launch_k1.launches) == before


# --- the row-compacted wavefront ---------------------------------------------

def _wf_pool(t, comps, device):
    return torch.empty((t.cap // 4096, comps, 32, 128), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rtiow", "textured"])
def test_wavefront_equals_regroup_bit_for_bit(name, cuda):
    """The JAX package's invariant (tests/test_renderer.py:283-301): the
    wavefront gives regroup's pixels, in every bit on the card, for every
    cut schedule, over two frames (the second accumulated)."""
    w, h, spp, bounces = 96, 64, 4, 8
    inp = _inputs(name, w, h, cuda)
    ref = _render(rg.launch_regrouped, inp, w, h, 2, spp, bounces, cuda, cuts=(2, 4, 6))
    for cuts in ((), (2,), (2, 4, 6), (1, 2, 3, 4, 5, 6, 7)):
        got = _render(wf.launch_wavefront, inp, w, h, 2, spp, bounces, cuda, phase_cuts=cuts)
        assert torch.equal(got, ref), cuts


@pytest.mark.cuda
def test_wavefront_equals_megakernel_at_one_sample(cuda):
    w, h = 96, 64
    inp = _inputs("rtiow", w, h, cuda)
    m = _render(mk.launch_megakernel, inp, w, h, 1, 1, 8, cuda)
    a = _render(wf.launch_wavefront, inp, w, h, 1, 1, 8, cuda, phase_cuts=(2,))
    assert torch.equal(a, m)


@pytest.mark.cuda
@pytest.mark.parametrize("alive", ["k0", "random", "all_live", "all_dead"])
def test_wavefront_compact_bit_for_bit(alive, cuda):
    """COMPACT against its twin on K0's pool with its own, a random (one
    lane per live row), an all-live and an all-dead alive component, over
    every row and over the first 70: the count and every dense row, and
    no row written past the count."""
    w, h = 96, 64
    inp = _inputs("rtiow", w, h, cuda)
    t = wf.plan(w, h, 4)
    n_rows = t.cap // 128
    pool = _wf_pool(t, wf.N_COMP, cuda)
    wf.launch_k0(inp, pool, _wf_pool(t, 3, cuda), t, 0, 2)
    gen = torch.Generator(device=cuda).manual_seed(2)
    if alive != "k0":
        rows = torch.zeros((n_rows, 128), device=cuda)
        if alive == "random":
            live = torch.rand(n_rows, device=cuda, generator=gen) < 0.5
            lane = torch.randint(0, 128, (n_rows,), device=cuda, generator=gen)
            rows[live, lane[live]] = 1.0
        elif alive == "all_live":
            rows[:] = 1.0
        pool[:, wf._AL] = rows.reshape(-1, 32, 128)
    for n_in in (n_rows, 70):
        out = []
        for compact in (wf.launch_compact, wf.compact_plain):
            counts = torch.tensor([n_in, -1], dtype=torch.int32, device=cuda)
            dst = torch.full_like(pool, 7.0)
            compact(pool, dst, counts, 1, torch.empty((t.cap // 4096,), dtype=torch.int32,
                                                      device=cuda))
            out.append((counts, dst))
        torch.cuda.synchronize()
        n = int(out[1][0][1])
        assert int(out[0][0][1]) == n
        a = out[0][1].permute(0, 2, 1, 3).reshape(n_rows, -1)
        b = out[1][1].permute(0, 2, 1, 3).reshape(n_rows, -1)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))  # rows past n stay 7.0


_WF_SCHEDULES = ((), (2,), (2, 4, 6), (1, 2, 3, 4, 5, 6, 7))


def _random60k(w, h, device):
    from weekend_raytracer_tpu_torch.models.scenes import random_spheres, random_spheres_camera

    return mk.kernel_inputs(random_spheres(60000).build(device=device),
                            to_sky_state(SkyParams(), device=device),
                            CameraBasis.create(random_spheres_camera(), (w, h), device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rtiow", "textured", "super"])
def test_culled_wavefront_equals_full_sweep(name, cuda):
    """The wavefront's K0 (per-warp cull, slots refilled per lane) and K1
    (per-warp cull, each block's live lanes regrouped) change no bit: at
    every cut schedule, over two frames of 4 spp (the second accumulated),
    the accumulator equals the full-sweep wavefront's (K0's and K1's
    kCull = false instantiations), whose launches count apart; the culled
    frame launches K0 once and COMPACT and K1 once a cut. (textured has no
    chunks; super has a super-chunk level.)"""
    w, h = 96, 64
    inp = _stats_case(name, w, h, cuda)
    for cuts in _WF_SCHEDULES:
        names = ("k0", "compact", "k1")
        before = [getattr(wf, f"launch_{k}").launches for k in names]
        full = (wf._launch_k0_full_sweep.launches, wf._launch_k1_full_sweep.launches)
        got = _render(wf.launch_wavefront, inp, w, h, 2, 4, 8, cuda, phase_cuts=cuts)
        after = [getattr(wf, f"launch_{k}").launches for k in names]
        assert [a - b for a, b in zip(after, before)] == [2, 2 * len(cuts), 2 * len(cuts)]
        ref = _render(wf._launch_wavefront_full_sweep, inp, w, h, 2, 4, 8, cuda,
                      phase_cuts=cuts)
        assert (wf._launch_k0_full_sweep.launches - full[0],
                wf._launch_k1_full_sweep.launches - full[1]) == (2, 2 * len(cuts))
        assert torch.equal(got, ref), (name, cuts)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rtiow", "random60k"])
def test_culled_wavefront_equals_stats_megakernel_at_one_sample(name, cuda):
    """At one sample per pixel every path's contribution is the stats
    megakernel's (the full sweep, no sum to contract): the culled wavefront
    gives it in every bit, with no cuts and at (2, 4, 6); random60k reads
    its boxes from global memory."""
    w, h = 96, 64
    inp = _inputs(name, w, h, cuda) if name == "rtiow" else _random60k(w, h, cuda)
    ref = torch.zeros((w * h, 3), device=cuda)
    mk.launch_megakernel(ref, inp, 0, True, width=w, height=h, spp=1, num_bounces=8,
                         stats=True)
    for cuts in ((), (2, 4, 6)):
        a = _render(wf.launch_wavefront, inp, w, h, 1, 1, 8, cuda, phase_cuts=cuts)
        assert torch.equal(a, ref), cuts


@pytest.mark.cuda
def test_culled_wavefront_with_boxes_in_global_memory(cuda):
    """random_spheres(60000)'s 48,144 bytes of boxes pass what a block
    stages, so the culled K0 and K1 stage only the priors' rows and read
    the boxes from global memory (kStaged = false); over two frames of 4
    spp at cuts (2, 4, 6) the accumulator equals the full sweep's."""
    w, h = 96, 64
    inp = _random60k(w, h, cuda)
    assert wf.cull_placement(inp) == {"k0": {"smem_bytes": 80, "boxes": "global"},
                                      "k1": {"smem_bytes": 80, "boxes": "global"}}
    kw = dict(phase_cuts=(2, 4, 6))
    got = _render(wf.launch_wavefront, inp, w, h, 2, 4, 8, cuda, **kw)
    assert torch.equal(got, _render(wf._launch_wavefront_full_sweep, inp, w, h, 2, 4, 8, cuda,
                                    **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rtiow", "super"])
def test_culled_wavefront_k1_with_a_ragged_count(cuda, name):
    """The culled K1 on a dense pool whose row count leaves its last block
    part full (count = 8k + 3 rows, past a row whose lanes are all dead):
    it equals the full-sweep K1 in every bit, pool and contributions, and
    leaves the rows past the count as they were."""
    w, h, spp = (96, 64, 4) if name == "rtiow" else (256, 192, 4)
    inp = _stats_case(name, w, h, cuda)
    t = wf.plan(w, h, spp)
    pool, contrib = _wf_pool(t, wf.N_COMP, cuda), _wf_pool(t, 3, cuda)
    wf.launch_k0(inp, pool, contrib, t, 0, 2)
    dense = torch.full_like(pool, 7.0)
    counts = torch.tensor([t.cap // 128, -1], dtype=torch.int32, device=cuda)
    wf.launch_compact(pool, dense, counts, 1, torch.empty((t.cap // 4096,), dtype=torch.int32,
                                                          device=cuda))
    n = (int(counts[1]) // 8 - 1) * 8 + 3
    assert n > 8
    dense[(n - 2) // 32, wf._AL, (n - 2) % 32] = 0.0  # a dense row whose lanes all ended
    counts[1] = n
    runs = []
    for k1 in (wf.launch_k1, wf._launch_k1_full_sweep):
        p, c = dense.clone(), contrib.clone()
        k1(inp, p, c, counts, 1, 2, 5)
        runs.append((p, c))
    torch.cuda.synchronize()
    (pk, ck), (pf, cf) = runs
    assert _same_bits(pk, pf) and _same_bits(ck, cf)
    def rows(x):
        return x.permute(0, 2, 1, 3).reshape(-1, wf.N_COMP, 128)

    assert _same_bits(rows(pk)[n:], rows(dense)[n:])
    assert _same_bits(rows(pk)[n - 2], rows(dense)[n - 2])  # nothing live: left as it was


@pytest.mark.cuda
def test_wavefront_budget_has_no_spills(cuda):
    """Every wavefront instantiation (culled, full-sweep, the culled ones'
    MXU route; boxes staged and in global memory; textured and not) and
    COMPACT build without spills; the culled K0 and K1 and their MXU route
    stay inside their launch bounds' register budget."""
    usage = {k: v for k, v in wf._library().ptxas_usage().items()
             if "wavefront" in k and "stats_finish" not in k}
    assert len(usage) == 12 + 8 + 3, sorted(usage)
    assert all(v["spill_stores"] == 0 and v["spill_loads"] == 0 for v in usage.values()), usage
    threads, min_blocks = wf.launch_bounds()
    assert (threads, min_blocks) == (256, 4)
    assert wf.launch_bounds(mxu=True) == (256, 2)
    attrs = wf.kernel_attributes()
    for k in ("k0", "k0_textured", "k0_global", "k0_global_textured", "k1", "k1_textured",
              "k1_global", "k1_global_textured"):
        assert attrs[k]["registers"] <= 65536 // (threads * min_blocks), (k, attrs[k])
        mxu = k[:2] + "_mxu" + k[2:]
        assert attrs[mxu]["registers"] <= 65536 // (threads * 2), (mxu, attrs[mxu])


@pytest.mark.cuda
def test_renderer_wavefront_counts_one_k0_per_frame(cuda):
    params = RenderParams(
        camera=SCENES["rtiow"][1](), viewport_size=(64, 36),
        sampling=SamplingParams(max_samples_per_pixel=12,
                                num_samples_per_pixel=4, num_bounces=8))
    r = Renderer(SCENES["rtiow"][0](), params, backend="wavefront", device=cuda)
    before = [getattr(wf, f"launch_{k}").launches for k in ("k0", "compact", "k1")]
    assert r.render().frames == 3
    after = [getattr(wf, f"launch_{k}").launches for k in ("k0", "compact", "k1")]
    assert [a - b for a, b in zip(after, before)] == [3, 0, 0]
    ra = Renderer(SCENES["rtiow"][0](), params, device=cuda)
    ra.render()
    assert torch.equal(r.mean_radiance(), ra.mean_radiance())


class _Recording:
    """The built library, with each C call recorded (or, with ``rc``, not
    made and answered with that error)."""

    def __init__(self, lib, rc=0):
        self.lib, self.rc, self.calls = lib, rc, []

    def __getattr__(self, name):
        fn = getattr(self.lib, name)

        def call(*args):
            self.calls.append((name, args))
            return self.rc if self.rc else fn(*args)
        return call


def _recorded(monkeypatch, rc=0):
    built = wf._library()
    rec = _Recording(built.lib, rc)

    class _Built:
        lib = rec

    monkeypatch.setattr(wf, "_library", lambda: _Built)

    def _no_plain(*a, **k):
        raise AssertionError("a plain twin ran for a CUDA tensor")

    for name in ("k0_plain", "compact_plain", "k1_plain"):
        monkeypatch.setattr(wf, name, _no_plain)
    return rec


@pytest.mark.cuda
@pytest.mark.parametrize("cuts", [(), (2,), (2, 4, 6)])
def test_wavefront_wrapper_launches_for_cuda_tensors(cuts, monkeypatch, cuda):
    """render_image_wavefront on CUDA tensors calls the C entry points, one
    K0 and one COMPACT and K1 per cut, with the device pointers of its
    buffers and the current stream, and never a twin."""
    w, h = 40, 24
    params = RenderParams(camera=SCENES["three"][1](), viewport_size=(w, h),
                          sampling=SamplingParams(max_samples_per_pixel=4,
                                                  num_samples_per_pixel=4, num_bounces=8))
    r = Renderer(SCENES["three"][0](), params, backend="wavefront", device=cuda)
    rec = _recorded(monkeypatch)
    before = [getattr(wf, f"launch_{k}").launches for k in ("k0", "compact", "k1")]
    acc = torch.zeros((w * h, 3), device=cuda)
    out, rows = wf.render_image_wavefront(acc, 3, True, r._scene, r._sky, r._basis, width=w,
                                          height=h, spp=4, num_bounces=8, phase_cuts=cuts,
                                          debug_counts=True)
    torch.cuda.synchronize()
    assert out is acc and bool(torch.isfinite(acc).all())
    after = [getattr(wf, f"launch_{k}").launches for k in ("k0", "compact", "k1")]
    assert [a - b for a, b in zip(after, before)] == [1, len(cuts), len(cuts)]
    assert [n for n, _ in rec.calls] == (["wrt_wavefront_k0"]
                                         + ["wrt_wavefront_compact", "wrt_wavefront_k1"]
                                         * len(cuts))
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert all(args[-1] == stream for _, args in rec.calls)
    t = wf.plan(w, h, 4)
    k0 = rec.calls[0][1]
    assert k0[8:13] == (t.cap, w, h, t.tiles_x, 2) and k0[15:17] == (3, cuts[0] if cuts else 8)
    counts_ptr = rows[0].data_ptr()
    src = k0[6]
    for k, i in enumerate(range(1, len(rec.calls), 2)):
        c, k1 = rec.calls[i][1], rec.calls[i + 1][1]
        assert c[0] == src and c[2] == counts_ptr + 4 * k and c[3] == counts_ptr + 4 * (k + 1)
        assert k1[5] == c[1] and k1[6] == k0[7] and k1[7] == c[3]
        assert k1[9:11] == (cuts[k], cuts[k + 1] if k + 1 < len(cuts) else 8)
        src = c[1]
    assert [int(x) for x in rows] == [t.cap // 128] + [int(x) for x in rows[1:]]


@pytest.mark.cuda
def test_wavefront_wrapper_raises_on_launch_error(monkeypatch, cuda):
    inp = _inputs("three", 16, 8, cuda)
    _recorded(monkeypatch, rc=700)
    before = [getattr(wf, f"launch_{k}").launches for k in ("k0", "compact", "k1")]
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        wf.launch_wavefront(torch.zeros((16 * 8, 3), device=cuda), inp, 0, True, width=16,
                            height=8, spp=1, num_bounces=4, phase_cuts=(2,))
    assert [getattr(wf, f"launch_{k}").launches for k in ("k0", "compact", "k1")] == before


# --- the record reorder kernels (csrc/reorder.cu) -------------------------

def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 128), (300, 8, 128), (4099, 3), (777, 5, 16),
                                   (64800, 11, 128)])
def test_record_gather_and_scatter_match_plain(shape, cuda):
    """Row records of every width the probes use (the 16-byte path) and of
    odd widths (the 4-byte path), against the twins bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    src = torch.randn(shape, generator=gen, device=cuda)
    idx = torch.randperm(shape[0], generator=gen, device=cuda).to(torch.int32)[:-5]
    before = (ro.record_gather.launches, ro.record_scatter.launches)
    got = ro.record_gather(src, idx)
    dst = torch.randn(shape, generator=gen, device=cuda)
    ref = dst.clone()
    ro.record_scatter(got, idx, dst)
    torch.cuda.synchronize()
    assert _same_bits(got, ro.gather_plain(src, idx, torch.empty_like(got)))
    assert _same_bits(dst, ro.scatter_plain(got, idx, ref))
    assert (ro.record_gather.launches, ro.record_scatter.launches) == (before[0] + 1,
                                                                       before[1] + 1)


@pytest.mark.cuda
def test_record_gather_and_scatter_match_plain_on_columns(cuda):
    """The SoA form, the binned path's: columns of [16, cap] into a pool of
    another capacity, and back."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    src = torch.randn((16, 50000), generator=gen, device=cuda)
    idx = torch.randperm(50000, generator=gen, device=cuda).to(torch.int32)[:40001]
    out = torch.full((16, 65536), 3.0, device=cuda)
    ro.record_gather(src, idx, out, dim=1)
    ref = ro.gather_plain(src, idx, torch.full_like(out, 3.0), dim=1)
    back = ro.record_scatter(out, idx, torch.zeros_like(src), dim=1)
    torch.cuda.synchronize()
    assert _same_bits(out, ref)
    assert _same_bits(back, ro.scatter_plain(out, idx, torch.zeros_like(src), dim=1))
    assert _same_bits(back[:, idx.long()], src[:, idx.long()])


@pytest.mark.cuda
@pytest.mark.parametrize("fill", ["ones", "uniform"])
def test_dma_rate_matches_plain(fill, cuda):
    records = 4096
    values = (None if fill == "ones" else
              np.random.default_rng(6).random((records, 11, 128), dtype=np.float32))
    pool, perm = dma.rate_inputs(cuda, records, values)
    before = ro.dma_rate.launches
    out = ro.dma_rate(pool, perm)
    torch.cuda.synchronize()
    assert _same_bits(out, ro.dma_rate_plain(pool, perm))
    assert ro.dma_rate.launches == before + 1
    if fill == "ones":
        assert bool((out == 4096.0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", [n for n, _ in dma.PROBES[:6]])
def test_dma_probes_pass(name, cuda):
    """probes/dma.py's probes at the TPU probes' shapes; each checks the
    kernel against the probe's expectation and its twin, bit for bit."""
    assert dict(dma.PROBES)[name](cuda)["max_abs_err"] == 0.0


@pytest.mark.cuda
def test_binned_k1_scattered_back_equals_home_k1(cuda):
    """probes/binned.py on the kernels, at a small size: every scheme's K1,
    scattered back, equals home-order K1 in every bit (run raises if not),
    through the counted wrappers."""
    before = (ro.record_gather.launches, ro.record_scatter.launches, rg.launch_k1.launches,
              rg.launch_k1.stats_launches)
    rows = binned.run(2, "rtiow", device=cuda, width=256, height=128, reps=1)
    assert [r["scheme"] for r in rows] == list(binned.SCHEMES)
    assert all(r["scatter_back"] in ("home", "bit-exact") for r in rows)
    after = (ro.record_gather.launches, ro.record_scatter.launches, rg.launch_k1.launches,
             rg.launch_k1.stats_launches)
    # each scatter back names every record of a narrow-record pool: the
    # inverse route, two launches
    assert [a - b for a, b in zip(after, before)] == [1 + 7, 2 * 14, 1 + 8, 8]


@pytest.mark.cuda
def test_reorder_launch_error_raises(cuda):
    """A launch the card refuses (70,000 planes: a grid's y dimension is at
    most 65,535) raises, and is not counted."""
    before = ro.record_gather.launches
    src = torch.zeros((70000, 8), device=cuda)
    with pytest.raises(RuntimeError, match="record_gather launch failed: CUDA error"):
        ro.record_gather(src, torch.arange(8, dtype=torch.int32, device=cuda), dim=1)
    assert ro.record_gather.launches == before


@pytest.mark.cuda
def test_reorder_refuses_2_31_values(cuda):
    """A move of 2^31 values (two records of 2^30) the library refuses
    before any launch: it raises, and is not counted."""
    before = ro.record_gather.launches
    src = torch.empty((1, 1 << 30), device=cuda)
    with pytest.raises(RuntimeError, match="record_gather launch failed: CUDA error"):
        ro.record_gather(src, torch.zeros(2, dtype=torch.int32, device=cuda))
    assert ro.record_gather.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dim", [((16, 50001), 1), ((3, 4097), 1), ((4099, 3), 0),
                                       ((777, 5, 16), 0), ((1025, 7), 0), ((257, 300), 0),
                                       ((2048, 4096), 0)])
@pytest.mark.parametrize("cover", ["permutation", "short"])
def test_record_scatter_routes_match_plain(shape, dim, cover, cuda):
    """record_scatter's two routes against scatter_plain bit for bit: a
    permutation of dst's records (the inverse route where records are
    narrower than a sector, two launches) and a shorter list (stores where
    it points, one launch; the records not named keep their bits); and
    record_gather by the same list against gather_plain, at column,
    narrow-row (4-byte) and wide-row (16-byte) widths."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    records = shape[dim]
    idx = torch.randperm(records, generator=gen, device=cuda).to(torch.int32)
    if cover == "short":
        idx = idx[:records - 11]
    src = torch.randn(shape, generator=gen, device=cuda)
    dst = torch.randn(shape, generator=gen, device=cuda)
    ref = dst.clone()
    width = 1 if dim == 1 else math.prod(shape[1:])
    inverse = ro.inverts(idx.numel(), records, width)
    assert inverse == (cover == "permutation" and width < ro.SECTOR_FLOATS)
    before = (ro.record_gather.launches, ro.record_scatter.launches)
    ro.record_scatter(src, idx, dst, dim=dim)
    got = ro.record_gather(src, idx, torch.zeros_like(src), dim=dim)
    torch.cuda.synchronize()
    assert _same_bits(dst, ro.scatter_plain(src, idx, ref, dim=dim))
    assert _same_bits(got, ro.gather_plain(src, idx, torch.zeros_like(src), dim=dim))
    assert (ro.record_gather.launches - before[0],
            ro.record_scatter.launches - before[1]) == (1, 2 if inverse else 1)


# --- the sweep probe kernels (csrc/sweep.cu) -------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["fp32", "tf32", "3xtf32"])
def test_dot_mma_matches_plain(prec, cuda):
    """p3's product: FP32 bit for bit (and the probe's FMA-order
    reference); TF32 and 3xTF32 against their twins within DOT_TOL."""
    an, bn, ref = mxu_sweep.dot_inputs()
    a, b = torch.from_numpy(an).to(cuda), torch.from_numpy(bn).to(cuda)
    before = sw.dot_mma.launches
    got = sw.dot_mma(a, b, prec)
    plain = sw.dot_plain(a, b, prec)
    torch.cuda.synchronize()
    assert sw.dot_mma.launches == before + 1
    if prec == "fp32":
        assert _same_bits(got, plain) and _same_bits(got.cpu(), torch.from_numpy(ref))
    mag = (a.abs() @ b.abs()).cpu()
    assert bool(((got - plain).abs().cpu() <= mxu_sweep.DOT_TOL * mag).all())


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["fp32", "tf32", "3xtf32"])
@pytest.mark.parametrize("n", [8, 4104, 1 << 20])  # 4104: 64 tiles of 64 and one of 8
@pytest.mark.parametrize("m", [16, 48, 64])
def test_dot_mma_shapes_match_plain(m, n, prec, cuda):
    """dot_mma's two kernels at M of 16, 48 and 64 (a block's rows halved
    until the grid fills the card, or a partial 64-row block), N not a
    multiple of a block's columns, and the card-filling 2^20: FP32 bit for
    bit with its twin, TF32 and 3xTF32 within DOT_TOL of theirs."""
    gen = torch.Generator(device=cuda).manual_seed(m * 7 + n)
    a = torch.randn((m, 8), generator=gen, device=cuda)
    b = torch.randn((8, n), generator=gen, device=cuda) * 3.0
    before = sw.dot_mma.launches
    got = sw.dot_mma(a, b, prec)
    plain = sw.dot_plain(a, b, prec)
    torch.cuda.synchronize()
    assert sw.dot_mma.launches == before + 1
    if prec == "fp32":
        assert _same_bits(got, plain)
    keep = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        mag = a.abs() @ b.abs()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep
    assert bool(((got - plain).abs() <= mxu_sweep.DOT_TOL * mag).all())


@pytest.mark.cuda
def test_p3_fill_holds(cuda):
    """p3 with its card-filling B[8, 2^20]: every mode against its twin
    inside the probe (FP32 bit for bit), with exactly dot_launches calls."""
    sw.zero_launch_counts()
    out = mxu_sweep.p3(cuda, reps=2, device_reps=2)
    torch.cuda.synchronize()
    assert sw.launch_counts()["dot_mma"] == mxu_sweep.dot_launches(2, 2)
    assert out["fill"]["fp32"]["max_abs_err"] == 0.0 and out["fp32"]["bit_identical"]
    sw.zero_launch_counts()


# smem_rw "direct": batch, words, read offsets, read width, (offset, width)
# of each write, base dtype
_DIRECT_CASES = {
    # reads and writes past both ends, overlapping writes, 16-byte items
    # that leave alignment or wrap
    "wrapping": (5, 300, [-7, 295, 1000, 3], 12, [(298, 9), (-5, 9), (100, 9)], "i32"),
    "odd_width": (64, 4096, [2816, 4090, -1], 7, [(4093, 5)], "i32"),  # 4-byte items
    "above_shfl": (1000, 2048, [643, 0, 2040], 128, [(700, 64), (736, 64)], "f32"),
    "whole_scratch": (4096, 4096, [0], 4096, [(2816, 128)], "f32"),  # 10h at the fill
    "many_writes": (32, 1024, list(range(0, 1024, 3)), 1, [(i * 7, 1) for i in range(1024)],
                    "i32"),
    "tiny_words": (7, 3, [1, -2], 8, [(2, 2)], "i32"),  # a 16-byte item wraps twice
    "no_writes": (4096, 4096, [2048], 1024, [], "f32"),  # 10e at the fill
}


def _direct_inputs(case, cuda):
    batch, words, reads, width, writes, dtype = _DIRECT_CASES[case]
    rng = np.random.default_rng(len(case))
    bits = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.integers(-(1 << 31), 1 << 31, size=shape, dtype=np.int64).astype(np.int32))
    base = bits(batch, words)
    special = np.asarray([0x80000000, 0x7FC00001, 0x7F800001, 1, 0xFF800000], np.uint32)
    base[:, :min(words, 5)] = torch.from_numpy(special.view(np.int32)[:words])
    view = torch.float32 if dtype == "f32" else torch.int32
    read_idx = torch.tensor(reads, dtype=torch.int32)
    vals = write_idx = None
    if writes:
        ww = writes[0][1]
        vals = bits(len(writes), ww).to(cuda).view(view)
        write_idx = torch.tensor([w[0] for w in writes], dtype=torch.int32).to(cuda)
    return base.to(cuda).view(view), read_idx.to(cuda), width, vals, write_idx


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_DIRECT_CASES))
def test_smem_rw_direct_bit_for_bit(case, cuda):
    """smem_rw's "direct" route equal to its twin in every bit (NaN
    payloads, -0.0, denormals kept) and to "smem" where the scratch fits
    shared memory, one launch each."""
    from weekend_raytracer_tpu_torch.ops.cuda import access as ac

    base, read_idx, width, vals, write_idx = _direct_inputs(case, cuda)
    ac.zero_launch_counts()
    got = ac.smem_rw(base, read_idx, width, vals=vals, write_idx=write_idx, route="direct")
    want = ac.smem_rw_plain(base, read_idx, width, vals, write_idx)
    torch.cuda.synchronize()
    assert ac.launch_counts()["smem_rw"] == 1
    assert _same_bits(got, want)
    if base.shape[1] * 4 <= ac.MAX_SHARED_BYTES:
        smem = ac.smem_rw(base, read_idx, width, vals=vals, write_idx=write_idx, route="smem")
        torch.cuda.synchronize()
        assert _same_bits(smem, want) and ac.launch_counts()["smem_rw"] == 2
    ac.zero_launch_counts()


@pytest.mark.cuda
def test_smem_rw_direct_refused_launch_raises(monkeypatch, cuda):
    """With the wrapper's limit lifted, more writes than a block stages
    reach wrt_smem_rw, which refuses them: the wrapper raises and does not
    count the launch."""
    from weekend_raytracer_tpu_torch.ops.cuda import access as ac

    n = ac.MAX_DIRECT_WRITES + 1
    monkeypatch.setattr(ac, "MAX_DIRECT_WRITES", n)
    before = ac.smem_rw.launches
    with pytest.raises(RuntimeError, match=r"smem_rw \(direct\) launch failed: CUDA error"):
        ac.smem_rw(torch.zeros((2, 64), device=cuda), torch.zeros(3, dtype=torch.int32,
                                                                    device=cuda),
                   vals=torch.zeros((n, 1), device=cuda),
                   write_idx=torch.zeros(n, dtype=torch.int32, device=cuda), route="direct")
    assert ac.smem_rw.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape, reverse, affine", [((32, 128), False, (2.0, 1.0)),
                                                    ((6, 4096), True, None),
                                                    ((4096, 4096), False, (2.0, 1.0)),
                                                    ((65535, 12), True, (-0.5, 3.0))])
def test_layout_remap_bit_for_bit(shape, reverse, affine, cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(shape, generator=gen, device=cuda)
    before = sw.layout_remap.launches
    got = sw.layout_remap(x, reverse, affine)
    torch.cuda.synchronize()
    assert _same_bits(got, sw.remap_plain(x, reverse, affine))
    assert sw.layout_remap.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("chains", [1, 4])
def test_layout_chain_within_tolerance(chains, cuda):
    """256 FMA steps against the twin's 256 multiply-then-add steps, within
    CHAIN_RTOL, on values in [0.99, 1) and an odd count."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = 0.99 + 0.01 * torch.rand((1_000_003,), generator=gen, device=cuda)
    got = sw.layout_chain(x, 256, chains)
    torch.cuda.synchronize()
    plain = sw.chain_plain(x, 256)
    assert bool(((got - plain).abs() <= mxu_sweep.CHAIN_RTOL * plain.abs()).all())


def _probe_case(name, cuda):
    """(table, planes, amats, chunk) of p5 (32 spheres) or p8 (10 x 32)."""
    n_chunks, cs = (1, 32) if name == "p5" else (10, 32)
    c, r, o, d = mxu_sweep.scene(n_chunks * cs, 4096)
    kq = mxu_sweep.sphere_kq(c, r)
    table = mxu_sweep.probe_table(c, kq, cuda)
    return (table, mxu_sweep.probe_planes(o, d, cuda),
            torch.from_numpy(mxu_sweep.probe_amats(c, kq, n_chunks, cs)).to(cuda), cs)


def _held_everywhere(got, want, table, planes, what):
    held = mxu_sweep.hold_sweep(got, want, table, planes, what)
    assert held["mask_agree"] == held["idx_agree"] == held["t_agree"] == 1.0, held


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["p5", "p8"])
def test_sweep_fma_matches_plain(name, cuda):
    """At the TPU probe's shapes: every ray hits or misses as the twin
    does, the same sphere, t within t_tolerance; several passes change no
    bit."""
    table, planes, _, cs = _probe_case(name, cuda)
    before = sw.sweep_fma.launches
    got = sw.sweep_fma(table, planes, cs)
    again = sw.sweep_fma(table, planes, cs, iters=3)
    torch.cuda.synchronize()
    assert sw.sweep_fma.launches == before + 2
    assert all(_same_bits(a, b) for a, b in zip(got, again))
    _held_everywhere(got, sw.sweep_plain(table, planes, "fma"), table, planes, name)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["narrow", "wide"])
def test_sweep_fma_windows_match_plain(case, cuda):
    """sweep_fma over more spheres than a block stages at once
    (FMA_WINDOW): each window restaged behind a barrier, each warp's run of
    every window. narrow: 2,500 spheres x 4,096 rays x 2 passes, one ray a
    thread, a ray group's passes and spheres split over the warps of a
    block; wide: 2,100 spheres over enough rays that the plan takes
    FMA_RAYS rays a thread. Every ray in every bit as the least (t, index)
    of the windows swept apart, each window holding closest hits, and as
    its twin's (hold_sweep, no ray parted); the first 64 rays hit
    nothing."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if case == "narrow":
        n_spheres, n_rays, iters = 2500, 4096, 2
    else:
        n_spheres, iters = 2100, 1
        n_rays = sms * sw.FMA_BLOCKS * (sw.FMA_THREADS // 32) * 32 * sw.FMA_RAYS + 77
    plan = sw.fma_plan(n_rays, n_spheres, iters, sms)
    assert plan == sw.fma_plan_built(n_rays, n_spheres, iters, sms)
    assert plan["window"] == sw.FMA_WINDOW < n_spheres
    if case == "narrow":
        assert plan["rays"] == 1 and plan["splits"] > plan["pass_parts"] > 1, plan
    else:
        assert plan["rays"] == sw.FMA_RAYS and plan["splits"] == 1, plan
    c, r, o, d = mxu_sweep.scene(n_spheres, n_rays)
    table = mxu_sweep.probe_table(c, mxu_sweep.sphere_kq(c, r), cuda)
    planes = mxu_sweep.probe_planes(o, d, cuda)
    planes[:, :64] = _far_planes(64, cuda)
    before = sw.sweep_fma.launches
    got = sw.sweep_fma(table, planes, 16, iters)
    torch.cuda.synchronize()
    assert sw.sweep_fma.launches == before + 1
    assert bool((got[1][:64] == -1).all()) and bool((got[0][:64] == sw.MAX_T).all())
    t, i = got
    want_t = torch.full_like(t, sw.MAX_T)
    want_i = torch.full_like(i, -1)
    for w0 in range(0, n_spheres, sw.FMA_WINDOW):
        assert bool(((i >= w0) & (i < w0 + sw.FMA_WINDOW)).any()), (case, w0)
        tw, iw = sw.sweep_fma(table[w0:w0 + sw.FMA_WINDOW].contiguous(), planes, 16, iters)
        iw = torch.where(iw >= 0, iw + w0, iw)
        take = (tw < want_t) | ((tw == want_t) & (iw < want_i))
        want_t, want_i = torch.where(take, tw, want_t), torch.where(take, iw, want_i)
    torch.cuda.synchronize()
    assert _same_bits(t, want_t) and torch.equal(i, want_i)
    _held_everywhere(got, sw.sweep_plain(table, planes, "fma"), table, planes, case)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["p5", "p8"])
@pytest.mark.parametrize("prec", ["tf32", "3xtf32"])
@pytest.mark.parametrize("packed", [False, True])
def test_sweep_mma_matches_plain(name, prec, packed, cuda):
    """The tensor-core sweep against its twin at its own precision (the
    TF32 twin rounds operands as cvt.rna does), and 3xTF32 against the FP32
    twin as well, from the planes and from the packed B."""
    table, planes, amats, _ = _probe_case(name, cuda)
    rays = sw.packed_b(planes) if packed else planes
    got = sw.sweep_mma(amats, rays, prec)
    torch.cuda.synchronize()
    _held_everywhere(got, sw.sweep_plain(amats, rays, prec), table, planes, (name, prec))
    if prec == "3xtf32":
        _held_everywhere(got, sw.sweep_plain(amats, rays, "fp32"), table, planes, name)


@pytest.mark.cuda
def test_fill_probe_holds(cuda):
    """The card-filling shape: every sweep form on all but FILL_WRONG_SHARE
    of the rays, a share below the control (the fewest rays a tile holds)."""
    before = sw.launch_counts()
    out = mxu_sweep.fill(cuda, reps=2)
    after = sw.launch_counts()
    assert all(after[k] > before[k] for k in ("sweep_fma", "sweep_mma_tf32",
                                                "sweep_mma_3xtf32"))
    assert out["fma"]["bound_by"] == "operations"
    assert out["control"] > mxu_sweep.FILL_WRONG_SHARE


@pytest.mark.cuda
def test_window_probe_holds_every_ray(cuda):
    """sweep_mma over 64 tiles (three of 3xTF32's shared-memory windows,
    two of TF32's): every ray as its twin's."""
    before = sw.launch_counts()
    out = mxu_sweep.window(cuda)
    after = sw.launch_counts()
    for prec in ("tf32", "3xtf32"):
        assert after[f"sweep_mma_{prec}"] == before[f"sweep_mma_{prec}"] + 1
        assert out[prec]["mask_agree"] == out[prec]["idx_agree"] == out[prec]["t_agree"] == 1.0


def _far_planes(n, cuda):
    """n rays from far above the probe's scene, pointing away: no hit."""
    planes = torch.zeros((6, n), device=cuda)
    planes[1] = 100.0
    planes[4] = 1.0
    return planes


# Rays of the 131,077 of test_sweep_mma_edge_shapes_match_plain's "windows"
# case that may part from the twin (hold_sweep): an H100 parted 2 at TF32
# (a root at MIN_T or a near tie, as at the fill); a sweep that lost one
# 16-sphere tile would part at least 825 (the fewest closest hits a tile
# holds there, which the test reads as its control).
WINDOWS_PARTED = 8


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["tf32", "3xtf32"])
@pytest.mark.parametrize("packed", [False, True])
def test_sweep_mma_edge_shapes_match_plain(prec, packed, cuda):
    """sweep_mma where its launch splits and wraps. 4,109 rays (one 8-ray
    tile a warp, the tiles split over warps, a last group part full) over
    32 spheres: every ray as its twin's. 131,077 rays (the wide ray groups)
    over 40 tiles of 16 (3xTF32's window holds 32: two windows merged):
    every ray in every bit as the least (t, index) of the first 32 tiles'
    sweep and the last 8's, swept apart, and held against the twin as the
    fill is (hold_sweep: at most WINDOWS_PARTED rays part, fewer than a
    lost tile would move). Rays that hit nothing miss; three passes change
    no bit."""
    c, r, o, d = mxu_sweep.scene(640, 131_077)
    kq = mxu_sweep.sphere_kq(c, r)
    cases = {"narrow": (mxu_sweep.probe_amats(c[:32], kq[:32], 1, 32), 4109),
             "windows": (mxu_sweep.probe_amats(c, kq, 40, 16), 131_077)}
    for name, (amats_np, n) in cases.items():
        amats = torch.from_numpy(amats_np).to(cuda)
        planes = mxu_sweep.probe_planes(o[:, :n], d[:, :n], cuda)
        planes[:, :64] = _far_planes(64, cuda)
        rays = sw.packed_b(planes) if packed else planes
        got = sw.sweep_mma(amats, rays, prec)
        again = sw.sweep_mma(amats, rays, prec, iters=3)
        torch.cuda.synchronize()
        assert all(_same_bits(a, b) for a, b in zip(got, again)), name
        assert bool((got[1][:64] == -1).all()) and bool((got[0][:64] == sw.MAX_T).all())
        if name == "narrow":
            table = mxu_sweep.probe_table(c[:32], kq[:32], cuda)
            _held_everywhere(got, sw.sweep_plain(amats, rays, prec), table, planes, (name, prec))
        else:
            (ta, ia), (tb, ib) = sw.sweep_mma(amats[:32], rays, prec), sw.sweep_mma(
                amats[32:], rays, prec)
            ib = torch.where(ib >= 0, ib + 32 * 16, ib)
            take = (tb < ta) | ((tb == ta) & (ib < ia))
            assert _same_bits(got[0], torch.where(take, tb, ta))
            assert torch.equal(got[1], torch.where(take, ib, ia))
            assert 0.5 < float((got[1] >= 0).float().mean()) < 1.0
            want = sw.sweep_plain(amats, rays, prec)
            assert mxu_sweep.tile_control(want[1], 640) * n > WINDOWS_PARTED
            table = mxu_sweep.probe_table(c, kq, cuda)
            mxu_sweep.hold_sweep(got, want, table, planes, (name, prec), WINDOWS_PARTED / n)


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["tf32", "3xtf32"])
def test_sweep_mma_census_counts_the_survivors(prec, cuda):
    """The census launch sweeps as sweep_mma does, bit for bit, and counts
    what the twin's census counts on the twin's products: the same steps,
    the kept pairs and rounds within 1% (TF32 products round apart)."""
    table, planes = mxu_sweep.fill_inputs(cuda, 65_536)
    amats = sw.sphere_amats(table, 16)
    (t, i), census = sw.sweep_mma_census(amats, planes, prec)
    want = sw.sweep_mma(amats, planes, prec)
    torch.cuda.synchronize()
    assert _same_bits(t, want[0]) and torch.equal(i, want[1])
    _, plain = sw.survivor_plain(amats, planes, prec)
    assert census["steps"] == plain["steps"] and census["pairs"] == plain["pairs"]
    for k in ("kept", "rounds"):
        assert abs(census[k] - plain[k]) <= 0.01 * plain[k], (k, census, plain)
    assert 0 < census["rounds"] <= census["kept"] < 0.01 * census["pairs"]


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["global", "shared", "arith"])
def test_table_gather_edge_cases_match_plain(route, cuda):
    """Every route against its twin in every bit where the stepped walk
    must wrap or give way to the two modulos (gather_cost.edge_cases):
    spans longer than the table, tables of 24 and 100 rows, negative
    indices, n_fetch 0 and 1, a tile spread over 2^31 and one whose span
    passes 2^31 ("shared" stages its rows as the int32 flat wraps, as the
    twin does)."""
    from weekend_raytracer_tpu_torch.ops.cuda import access as ac
    from weekend_raytracer_tpu_torch.probes import gather_cost

    for name, (tab, idx, span, n_fetch) in gather_cost.edge_cases(cuda).items():
        got = ac.table_gather(tab, idx, span, n_fetch, route)
        want = ac.table_gather_plain(tab, idx, span, n_fetch, route)
        torch.cuda.synchronize()
        assert _same_bits(got, want), name


@pytest.mark.cuda
@pytest.mark.parametrize("name", [n for n, _ in mxu_sweep.PROBES if n not in ("fill", "window")])
def test_mxu_sweep_probes_pass(name, cuda):
    assert mxu_sweep.run(name, dict(mxu_sweep.PROBES)[name], cuda, reps=2)


@pytest.mark.cuda
def test_sweep_launch_error_raises(monkeypatch, cuda):
    """A launch the library refuses raises, and is not counted: with the
    wrapper's chunk limit lifted, a chunk of 4000 spheres (over the 2048
    the C interface takes) reaches wrt_sweep_fma, which refuses it."""
    table, planes, _, _ = _probe_case("p8", cuda)
    monkeypatch.setattr(sw, "MAX_FMA_CHUNK", 4096)
    before = sw.sweep_fma.launches
    with pytest.raises(RuntimeError, match="sweep_fma launch failed: CUDA error"):
        sw.sweep_fma(table.repeat(13, 1)[:4000].contiguous(), planes, 4000)
    assert sw.sweep_fma.launches == before


# --- the "xla" backend (plain PyTorch on the card) and checkpoints ----------

def _every_launch():
    """Every launch count of the port's six CUDA libraries."""
    from weekend_raytracer_tpu_torch.ops.cuda import access

    return {"megakernel": mk.render_image_megakernel.launches,
            "megakernel_stats": mk.render_image_megakernel.stats_launches,
            **{f"regroup_{k}": getattr(rg, f"launch_{k}").launches
               for k in ("k0", "pack", "k1", "combine")},
            "k1_stats": rg.launch_k1.stats_launches,
            **{f"wavefront_{k}": getattr(wf, f"launch_{k}").launches
               for k in ("k0", "compact", "k1")},
            **{k: getattr(ro, k).launches for k in ("record_gather", "record_scatter",
                                                    "dma_rate")},
            **sw.launch_counts(), **access.launch_counts()}


def _xla_renderer(name, device, w=64, h=48, spp=4, frames=2, bounces=8, backend="xla"):
    params = RenderParams(camera=SCENES[name][1](), viewport_size=(w, h),
                          sampling=SamplingParams(max_samples_per_pixel=frames * spp,
                                                  num_samples_per_pixel=spp,
                                                  num_bounces=bounces))
    return Renderer(SCENES[name][0](), params, backend=backend, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rtiow", "textured"])
def test_xla_frame_on_the_card_matches_the_cpu(name, cuda):
    """The xla backend on the card against the same frames on the CPU, at
    tests/test_pallas.py's statistical gates (tonemapped RMSE < 5e-3, mean
    within a relative 1e-3): the card's math library rounds sin, cos and
    acos differently, so paths fork at a few silhouettes. No library of the
    port launches."""
    before = _every_launch()
    g = _xla_renderer(name, cuda)
    g.render()
    assert _every_launch() == before
    c = _xla_renderer(name, "cpu")
    c.render()
    a, b = g.mean_radiance().cpu().numpy(), c.mean_radiance().numpy()
    assert np.isfinite(a).all()
    ta = g.image().astype(np.float32) / 255
    tb = c.image().astype(np.float32) / 255
    assert float(np.sqrt(((ta - tb) ** 2).mean())) < 5e-3
    assert abs(a.mean() - b.mean()) / b.mean() < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["regroup", "xla"])
def test_checkpoint_resume_on_the_card(backend, cuda, tmp_path):
    """Save after two frames on the card, resume in a fresh renderer on the
    card, converge to the same accumulator in every bit."""
    a = _xla_renderer("rtiow", cuda, spp=4, frames=4, backend=backend)
    a.render_frame()
    a.render_frame()
    path = str(tmp_path / "ckpt.npz")
    a.save_checkpoint(path)
    while a.render_frame():
        pass
    b = _xla_renderer("rtiow", cuda, spp=4, frames=4, backend=backend)
    b.load_checkpoint(path)
    assert b._accum.device.type == "cuda" and b.accumulated_samples() == 8
    while b.render_frame():
        pass
    assert torch.equal(a._accum, b._accum)


@pytest.mark.cuda
def test_textured_paths_equal_the_full_sweep_at_32_spp(cuda):
    """The textured scene (image textures, no chunks) at the main path's 32
    spp and 8 bounces, over two frames (the second accumulated): regroup at
    cuts (2, 4, 6) and the culled wavefront at every cut schedule equal the
    full-sweep wavefront in every bit, and regroup on a band of whole tile
    rows equals the same rows of that image."""
    w, h, spp, lo, rows = 128, 96, 32, 32, 32
    inp = _inputs("textured", w, h, cuda)
    assert inp.tex_pool is not None and inp.n_chunks == 0
    ref = _render(wf._launch_wavefront_full_sweep, inp, w, h, 2, spp, 8, cuda)
    got = _render(rg.launch_regrouped, inp, w, h, 2, spp, 8, cuda, cuts=(2, 4, 6))
    assert torch.equal(got, ref)
    for cuts in _WF_SCHEDULES:
        got = _render(wf.launch_wavefront, inp, w, h, 2, spp, 8, cuda, phase_cuts=cuts)
        assert torch.equal(got, ref), cuts
    band = torch.zeros((w * rows, 3), device=cuda)
    for f in range(2):
        rg.launch_regrouped(band, inp, f, f == 0, width=w, height=rows, spp=spp,
                            num_bounces=8, cuts=(2, 4, 6), row_offset=lo, full_height=h)
    torch.cuda.synchronize()
    assert torch.equal(band / (2 * spp), ref[lo * w:(lo + rows) * w])


# tools/jax_images.py's fixture: the JAX package's own images
_JAX_IMAGES = os.path.join(os.path.dirname(__file__), "data", "jax_images.npz")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["first_hit", "rtiow", "textured"])
def test_megakernel_matches_committed_jax_images(name, cuda):
    """The megakernel against render_image_pallas's image of the same case
    (tests/test_torch_megakernel.py's _CASES), at the image gates: < 1% of
    first-hit pixels differ, else tonemapped RMSE < 5e-3 and the mean within
    a relative 1e-3."""
    with np.load(_JAX_IMAGES) as z:
        ref = torch.from_numpy(z[f"megakernel_{name}"]).to(cuda)
        w, h, frames, spp, bounces = (int(v) for v in z[f"megakernel_{name}_params"])
    got = _render(mk.launch_megakernel, _inputs(name, w, h, cuda), w, h, frames, spp,
                  bounces, cuda)
    if name == "first_hit":
        assert float(((got - ref).abs() > 1e-6).any(dim=1).float().mean()) < 0.01
        return
    rmse = float(((_tonemapped(got, w, h) - _tonemapped(ref, w, h)) ** 2).mean().sqrt())
    assert rmse < 5e-3, rmse
    assert abs(float(got.mean()) - float(ref.mean())) / float(ref.mean()) < 1e-3


@pytest.mark.cuda
def test_profiler_trace_keeps_every_event_of_50_regroup_frames(cuda, tmp_path):
    """50 traces through utils.metrics.profiler_trace, one regroup frame
    each: every trace keeps the device event of each of the frame's 8
    kernels (K0, PACK and K1 at each of 3 cuts, COMBINE)."""
    import re

    from torch.autograd import DeviceType

    from weekend_raytracer_tpu_torch.utils.metrics import profiler_trace

    w, h = 96, 64
    inp = _inputs("rtiow", w, h, cuda)
    acc = torch.zeros((w * h, 3), device=cuda)
    want = {"regroup_k0": 1, "regroup_pack": 3, "regroup_k1": 3, "regroup_combine": 1}

    def frame():
        rg.launch_regrouped(acc, inp, 0, True, width=w, height=h, spp=4, num_bounces=8,
                            cuts=(2, 4, 6))

    frame()
    torch.cuda.synchronize()
    for i in range(50):
        with profiler_trace(str(tmp_path)) as prof:
            frame()
        seen = {}
        for e in prof.events():
            m = re.search(r"(\w+)(<[^(]*>)?\(", e.name)
            if e.device_type == DeviceType.CUDA and m and m.group(1) in want:
                seen[m.group(1)] = seen.get(m.group(1), 0) + 1
        assert seen == want, (i, seen)
