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
regroup pipeline's PACK and COMBINE are held bit for bit; its K0 and K1
run the megakernel's own per-ray body, so at one sample per pixel regroup
and the megakernel give the same bits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from weekend_raytracer_tpu_torch import (  # noqa: E402
    SCENES, Camera, CameraBasis, Material, RenderParams, Renderer,
    SamplingParams, SceneDesc, SkyParams, SkyState, Sphere, to_sky_state)
from weekend_raytracer_tpu_torch.ops import tonemap  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import megakernel as mk  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import regroup as rg  # noqa: E402


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


@pytest.mark.cuda
@pytest.mark.parametrize("alive", ["k0", "random", "all_live", "all_dead"])
def test_pack_and_combine_bit_for_bit(alive, cuda):
    w, h = 96, 64
    inp = _inputs("rtiow", w, h, cuda)
    t, _ = rg.plan(w, h, 4, 8, (2, 4, 6))
    pool = torch.empty((rg.N_COMP, t.cap), device=cuda)
    rg.launch_k0(inp, pool, torch.empty((3, t.cap), device=cuda), t, 0, 2)
    gen = torch.Generator(device=cuda).manual_seed(1)
    if alive != "k0":
        pool[rg._AL] = {"random": (torch.rand(t.cap, device=cuda, generator=gen) < 0.3).float(),
                        "all_live": torch.ones(t.cap, device=cuda),
                        "all_dead": torch.zeros(t.cap, device=cuda)}[alive]
    out = []
    for pack in (rg.launch_pack, rg.pack_plain):
        counts = torch.tensor([t.cap, 0], dtype=torch.int32, device=cuda)
        dst = torch.full((rg.N_COMP, t.cap), 7.0, device=cuda)
        inv = torch.full((t.cap,), -7, dtype=torch.int32, device=cuda)
        pack(pool, dst, inv, counts, 1, torch.empty((t.cap // 1024,), dtype=torch.int32,
                                                    device=cuda))
        out.append((counts, dst, inv))
    torch.cuda.synchronize()
    n = int(out[1][0][1])
    end = -(-n // 128) * 128
    assert int(out[0][0][1]) == n
    assert torch.equal(out[0][1][:, :end] + 0.0, out[1][1][:, :end] + 0.0)
    assert torch.equal(out[0][2], out[1][2])
    src = torch.rand((3, t.cap), device=cuda, generator=gen)
    base = torch.rand((3, t.cap), device=cuda, generator=gen)
    accum = torch.rand((w * h, 3), device=cuda, generator=gen)
    level = [base.clone(), base.clone()]
    counts2 = torch.tensor([t.cap, t.cap], dtype=torch.int32, device=cuda)
    home = [accum.clone(), accum.clone()]
    home_base = [base.clone(), base.clone()]
    for i, combine in enumerate((rg.launch_combine, rg.combine_plain)):
        combine(out[1][2], src, level[i], counts2, 2)
        combine(out[1][2], src, home_base[i], out[1][0], 1, accum=home[i], t=t)
    torch.cuda.synchronize()
    assert torch.equal(level[0], level[1])
    assert torch.equal(home[0], home[1])
    assert torch.equal(home_base[0], base) and torch.equal(home_base[1], base)


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
    assert [a - b for a, b in zip(after, before)] == [3, 9, 9, 9]
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
    """The kStats megakernel against its twin: equal per tile at one
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
                   1, torch.empty((t.cap // 1024,), dtype=torch.int32, device=cuda))
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
