"""The CUDA megakernel against its plain PyTorch version, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU: the
kernel is CUDA C++ and has no CPU mode. The module imports only the port
(no JAX), so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Images are held to the plain version at tests/test_pallas.py's statistical
gates (tonemapped RMSE < 5e-3, mean radiance within a relative 1e-3; < 1%
of first-hit pixels may differ): the kernel contracts multiply-adds into
FMAs and the CUDA math library rounds sin/cos/exp differently from
PyTorch's, so chaotic Monte-Carlo paths may diverge at silhouettes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from weekend_raytracer_tpu_torch import (  # noqa: E402
    SCENES, Camera, CameraBasis, Material, RenderParams, Renderer,
    SamplingParams, SceneDesc, SkyParams, SkyState, Sphere, to_sky_state)
from weekend_raytracer_tpu_torch.ops import tonemap  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import megakernel as mk  # noqa: E402


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


def _render(fn, inp, w, h, frames, spp, bounces, device):
    acc = torch.zeros((w * h, 3), dtype=torch.float32, device=device)
    for f in range(frames):
        fn(acc, inp, f, f == 0, width=w, height=h, spp=spp, num_bounces=bounces)
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
    r = Renderer(SCENES["three"][0](), params, device=cuda)
    before = mk.render_image_megakernel.launches
    stats = r.render()
    assert stats.frames == 3
    assert mk.render_image_megakernel.launches - before == 3
    assert r.image().shape == (36, 64, 3)
