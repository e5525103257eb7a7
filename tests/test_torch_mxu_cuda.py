"""The MXU chunk sweep's CUDA kernels (csrc/mxu.cuh: the kMxu
instantiations of the megakernel, regroup's K0 and K1 and the wavefront's
culled K0 and K1) against their plain twins, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU. The
module imports only the port (no JAX):

    python -m pytest tests/test_torch_mxu_cuda.py --noconftest -q

The tensor cores' 3xTF32 products sum in their own order, the twin's f32
product in PyTorch's, so images are held at the statistical gates
(tonemapped RMSE < 5e-3, mean radiance within a relative 1e-3), against
the twin and against the FMA kernel on the same inputs.
"""
import pytest

torch = pytest.importorskip("torch")

from weekend_raytracer_tpu_torch import (SCENES, CameraBasis, RenderParams, Renderer,  # noqa: E402
                                         SamplingParams, SkyParams, to_sky_state)
from weekend_raytracer_tpu_torch.ops import tonemap  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import megakernel as mk  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import regroup as rg  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import wavefront as wf  # noqa: E402

CUTS = (2, 4, 6)
# backend -> (kernel, twin, keywords)
_ROUTES = {"megakernel": (mk.launch_megakernel, mk.render_plain_with_inputs, {}),
           "regroup": (rg.launch_regrouped, rg.regrouped_plain_with_inputs, {"cuts": CUTS}),
           "wavefront": (wf.launch_wavefront, wf.wavefront_plain_with_inputs,
                         {"phase_cuts": CUTS})}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _case(name, w, h, device):
    build, cam = SCENES[name]
    return (build().build(device=device), to_sky_state(SkyParams(), device=device),
            CameraBasis.create(cam(), (w, h), device=device))


def _render(fn, inp, w, h, frames, spp, bounces, device, **kw):
    acc = torch.zeros((w * h, 3), dtype=torch.float32, device=device)
    for f in range(frames):
        fn(acc, inp, f, f == 0, width=w, height=h, spp=spp, num_bounces=bounces, **kw)
    torch.cuda.synchronize()
    return acc / (frames * spp)


def _assert_gates(a, b, w, h):
    tm = [tonemap.to_srgb_u8(x.reshape(h, w, 3)).float() / 255.0 for x in (a, b)]
    rmse = float(((tm[0] - tm[1]) ** 2).mean().sqrt())
    assert rmse < 5e-3, rmse
    assert abs(float(a.mean()) - float(b.mean())) / float(b.mean()) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_size", [None, 32, 8])
@pytest.mark.parametrize("backend", list(_ROUTES))
def test_mxu_kernels_match_their_twins(backend, chunk_size, cuda):
    """RTiOW 100x70 (a part-full last warp and block), 2 frames of 4 spp:
    each backend's MXU route against its twin and against the FMA kernel;
    chunk sizes 16 (one sphere tile a chunk), 32 (two) and 8 (half a tile
    of padding)."""
    w, h, frames, spp, bounces = 100, 70, 2, 4, 8
    case = _case("rtiow", w, h, cuda)
    inp = mk.kernel_inputs(*case, chunk_size=chunk_size, mxu_sweep=True)
    fma = mk.kernel_inputs(*case, chunk_size=chunk_size)
    assert mk.mxu_route(inp)
    kernel, twin, kw = _ROUTES[backend]
    got = _render(kernel, inp, w, h, frames, spp, bounces, cuda, **kw)
    assert bool(torch.isfinite(got).all())
    _assert_gates(got, _render(twin, inp, w, h, frames, spp, bounces, cuda, **kw), w, h)
    _assert_gates(got, _render(kernel, fma, w, h, frames, spp, bounces, cuda, **kw), w, h)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["auto", "pallas", "wavefront"])
def test_renderer_launches_the_mxu_kernels(backend, cuda):
    """Renderer(..., mxu_sweep=True) goes through the MXU instantiations
    only: no FMA launch of K0, K1 or the megakernel."""
    params = RenderParams(camera=SCENES["rtiow"][1](), viewport_size=(64, 48),
                          sampling=SamplingParams(max_samples_per_pixel=8,
                                                  num_samples_per_pixel=4, num_bounces=6))
    counters = [(mk.render_image_megakernel, "launches"), (mk.render_image_megakernel,
                                                            "mxu_launches"),
                (rg.launch_k0, "launches"), (rg.launch_k0, "mxu_launches"),
                (rg.launch_k1, "launches"), (rg.launch_k1, "mxu_launches"),
                (wf.launch_k0, "launches"), (wf.launch_k0, "mxu_launches")]
    before = [getattr(f, a) for f, a in counters]
    r = Renderer(SCENES["rtiow"][0](), params, backend=backend, device=cuda, mxu_sweep=True)
    r.render()
    torch.cuda.synchronize()
    got = [getattr(f, a) - b for (f, a), b in zip(counters, before)]
    want = {"auto": [0, 0, 0, 2, 0, 2 * len(rg.default_cuts(6, 486)), 0, 0],
            "pallas": [0, 2, 0, 0, 0, 0, 0, 0],
            "wavefront": [0, 0, 0, 0, 0, 0, 0, 2]}[backend]
    assert got == want
    assert bool(torch.isfinite(r._accum).all())


@pytest.mark.cuda
def test_mxu_entry_points_refuse_a_scene_without_chunks(cuda):
    """The C entry points refuse a launch with no chunk hierarchy
    (cudaErrorInvalidValue): a scene without chunks has no MXU sweep."""
    w, h = 16, 8
    inp = mk.kernel_inputs(*_case("three", w, h, cuda))
    lib = mk._library().lib
    acc = torch.zeros((w * h, 3), device=cuda)
    args = (inp.cam.data_ptr(), inp.sky.data_ptr(), inp.sweep.data_ptr(), inp.attrs.data_ptr(),
            None, acc.data_ptr(), inp.n_spheres, w, h, 1.0 / w, 1.0 / h, 0, 0, 1, 1, 2,
            *mk.cull_args(inp, acc.device), 0.0, 0.0, acc.data_ptr(),
            torch.cuda.current_stream(cuda).cuda_stream)
    assert lib.wrt_megakernel_mxu_launch(*args) == 1  # cudaErrorInvalidValue
