"""The JAX package's ``mxu_sweep=True`` images committed for the card
(tests/data/jax_images.npz ``<kernel>_mxu_<case>``, written by
tools/jax_images.py), against the port's MXU twins on the CPU.

chip_smoke.py's ``[reference]`` holds the CUDA kernels' MXU route to these
images, where there is no JAX; here the twins meet the same gates
(tonemapped RMSE < 5e-3, mean within a relative 1e-3), so a fixture that
no longer matches the JAX package's knob fails on the CPU first. The
images' own bits against the JAX functions are tools/jax_images.py's to
regenerate (its FMA images are held bit for bit by
tests/test_torch_megakernel.py and tests/test_torch_regroup.py).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from weekend_raytracer_tpu_torch.models import scenes  # noqa: E402
from weekend_raytracer_tpu_torch.models.camera import CameraBasis  # noqa: E402
from weekend_raytracer_tpu_torch.models.sky import SkyParams, to_sky_state  # noqa: E402
from weekend_raytracer_tpu_torch.ops import tonemap  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import megakernel as mk  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import regroup as rg  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import wavefront as wf  # noqa: E402

_JAX_IMAGES = os.path.join(os.path.dirname(__file__), "data", "jax_images.npz")
_KEYS = ["megakernel_mxu_rtiow", "megakernel_mxu_textured", "regroup_mxu_rtiow",
         "regroup_mxu_textured", "wavefront_mxu_rtiow"]
# the fixture's parameters: tools/jax_images.py MEGAKERNEL_CASES and REGROUP_CASES
_PARAMS = {"megakernel_mxu_rtiow": ((48, 32, 8, 4, 8), None),
           "megakernel_mxu_textured": ((40, 24, 8, 4, 6), None),
           "regroup_mxu_rtiow": ((64, 32, 8, 4, 8), (2, 4)),
           "regroup_mxu_textured": ((64, 32, 8, 4, 6), (2,)),
           "wavefront_mxu_rtiow": ((64, 32, 8, 4, 8), (2, 4))}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _twin(key, w, h, frames, spp, bounces, cuts):
    backend, name = key.split("_mxu_")
    build, cam = scenes.SCENES[name]
    inp = mk.kernel_inputs(build().build(device="cpu"), to_sky_state(SkyParams(), device="cpu"),
                           CameraBasis.create(cam(), (w, h), device="cpu"), mxu_sweep=True)
    fn, extra = {"megakernel": (mk.render_plain_with_inputs, {}),
                 "regroup": (rg.regrouped_plain_with_inputs, {"cuts": cuts}),
                 "wavefront": (wf.wavefront_plain_with_inputs, {"phase_cuts": cuts})}[backend]
    acc = torch.zeros((w * h, 3))
    for f in range(frames):
        fn(acc, inp, f, f == 0, width=w, height=h, spp=spp, num_bounces=bounces, **extra)
    return inp, acc / (frames * spp)


@pytest.mark.parametrize("key", _KEYS)
def test_mxu_twin_meets_gates_against_committed_jax_images(key):
    params, cuts = _PARAMS[key]
    with np.load(_JAX_IMAGES) as z:
        assert tuple(z[f"{key}_params"]) == params
        assert (tuple(z[f"{key}_cuts"]) if cuts else None) == cuts
        ref = torch.from_numpy(z[key])
    w, h = params[:2]
    inp, got = _twin(key, *params, cuts)
    assert mk.mxu_route(inp) == key.endswith("rtiow")  # the textured scene has no chunks
    tm = [tonemap.to_srgb_u8(a.reshape(h, w, 3)).float() / 255 for a in (got, ref)]
    rmse = float(((tm[0] - tm[1]) ** 2).mean().sqrt())
    assert rmse < 5e-3, rmse
    assert abs(float(got.mean()) - float(ref.mean())) / float(ref.mean()) < 1e-3
