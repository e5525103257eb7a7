"""The port's Renderer checkpoints against the JAX package's behaviour.

Twins of tests/test_renderer.py's checkpoint tests (resume equal in every
bit, viewport and scene mismatches, extending spp, resuming across the
fused backends), run on the CPU, where the fused backends run their plain
PyTorch twins; and the estimator families: xla and fused refuse each
other's checkpoints, a textured scene's texture budget is part of the
fused family, and a checkpoint written by the JAX package is refused by
the package tag.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import weekend_raytracer_tpu as jwrt  # noqa: E402
from weekend_raytracer_tpu.models import scenes as jscenes  # noqa: E402
import weekend_raytracer_tpu_torch as twrt  # noqa: E402
from weekend_raytracer_tpu_torch import CheckpointMismatchError  # noqa: E402
from weekend_raytracer_tpu_torch import renderer as trenderer  # noqa: E402
from weekend_raytracer_tpu_torch.models import scenes  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(pkg=twrt, scn=scenes, name="three", size=(32, 18), max_spp=8, spp=2,
            bounces=4):
    return pkg.RenderParams(camera=scn.SCENES[name][1](), viewport_size=size,
                            sampling=pkg.SamplingParams(max_samples_per_pixel=max_spp,
                                                        num_samples_per_pixel=spp,
                                                        num_bounces=bounces))


def _renderer(backend="auto", name="three", budget_texels=None, **kw):
    return twrt.Renderer(scenes.SCENES[name][0](), _params(name=name, **kw),
                         backend=backend, device="cpu", budget_texels=budget_texels)


def _saved(r, tmp_path, frames=1):
    for _ in range(frames):
        assert r.render_frame()
    path = str(tmp_path / "ckpt.npz")
    r.save_checkpoint(path)
    return path


@pytest.mark.parametrize("backend", ["auto", "pallas", "xla"])
def test_checkpoint_resume(backend, tmp_path):
    """Save after two frames, resume in a fresh renderer, converge to the
    same accumulator in every bit."""
    a = _renderer(backend, max_spp=8, spp=2)
    path = _saved(a, tmp_path, frames=2)
    while a.render_frame():
        pass
    b = _renderer(backend, max_spp=8, spp=2)
    b.load_checkpoint(path)
    assert b.accumulated_samples() == 4 and b._frame_number == 2
    assert b._accum.device == b.device
    while b.render_frame():
        pass
    assert torch.equal(a._accum, b._accum)


def test_checkpoint_keys_are_the_jax_packages(tmp_path):
    path = _saved(_renderer(), tmp_path)
    with np.load(path) as data:
        assert sorted(data.files) == ["accum", "accumulated_spp", "fingerprint",
                                      "frame_number", "viewport"]
        assert data["accum"].dtype == np.float32 and data["accum"].shape == (32 * 18, 3)


def test_checkpoint_viewport_mismatch(tmp_path):
    path = _saved(_renderer(size=(32, 18)), tmp_path)
    with pytest.raises(CheckpointMismatchError, match="viewport"):
        _renderer(size=(16, 10)).load_checkpoint(path)


def test_checkpoint_scene_mismatch(tmp_path):
    """Another scene and camera, or the same scene at another bounce
    depth, refuses the checkpoint; nothing is loaded."""
    path = _saved(_renderer(), tmp_path)
    b = twrt.Renderer(scenes.rtiow_final(), _params(name="rtiow"), device="cpu")
    with pytest.raises(CheckpointMismatchError):
        b.load_checkpoint(path)
    c = _renderer(bounces=6)
    with pytest.raises(CheckpointMismatchError):
        c.load_checkpoint(path)
    assert c.accumulated_samples() == 0 and not c._accum.any()


def test_checkpoint_extends_spp(tmp_path):
    """A larger max spp on resume extends the render: sampling counts are
    outside the fingerprint."""
    a = _renderer(max_spp=4, spp=2)
    a.render()
    path = str(tmp_path / "ckpt.npz")
    a.save_checkpoint(path)
    b = _renderer(max_spp=8, spp=2)
    b.load_checkpoint(path)
    assert b.accumulated_samples() == 4
    assert b.render_frame()  # continues past the old max


def test_checkpoint_resumes_across_fused_backends(tmp_path):
    """The fused backends draw the same per-sample radiances: a pallas
    checkpoint resumes under regroup. Frame sums reassociate across the
    twins, so the accumulators agree to the last ulp, not in every bit
    (tests/test_renderer.py's tolerance)."""
    a = _renderer("pallas", max_spp=8, spp=4)
    path = _saved(a, tmp_path)
    while a.render_frame():
        pass
    b = _renderer("regroup", max_spp=8, spp=4)
    b.load_checkpoint(path)
    assert b.accumulated_samples() == 4
    while b.render_frame():
        pass
    np.testing.assert_allclose(b._accum.numpy(), a._accum.numpy(), rtol=1e-5, atol=1e-5)
    wavefront = _renderer("wavefront", max_spp=8, spp=4)
    wavefront.load_checkpoint(path)
    assert wavefront.accumulated_samples() == 4


@pytest.mark.parametrize("saver,loader", [("xla", "auto"), ("regroup", "xla"),
                                          ("pallas", "xla")])
def test_xla_and_fused_refuse_each_other(saver, loader, tmp_path):
    """xla samples textures at full resolution, the fused kernels from the
    mipped LUT: two estimators, two families."""
    path = _saved(_renderer(saver, spp=4), tmp_path)
    with pytest.raises(CheckpointMismatchError, match="estimator"):
        _renderer(loader, spp=4).load_checkpoint(path)


def test_texture_budget_is_part_of_the_fused_family(tmp_path):
    """On a textured scene a fused checkpoint at one texture budget is
    refused at another; the default is 8192. The xla backend ignores the
    budget, so its checkpoints resume at any. A solid scene hashes none."""
    kw = dict(name="textured", size=(16, 10), spp=4)
    path = _saved(_renderer("regroup", budget_texels=512, **kw), tmp_path)
    with pytest.raises(CheckpointMismatchError):
        _renderer("regroup", budget_texels=8192, **kw).load_checkpoint(path)
    _renderer("pallas", budget_texels=512, **kw).load_checkpoint(path)
    assert (_renderer("regroup", budget_texels=8192, **kw)._fingerprint()
            == _renderer("regroup", **kw)._fingerprint())
    path = _saved(_renderer("xla", budget_texels=512, **kw), tmp_path)
    _renderer("xla", budget_texels=65536, **kw).load_checkpoint(path)
    assert (_renderer("regroup", budget_texels=512, spp=4)._fingerprint()
            == _renderer("regroup", spp=4)._fingerprint())


@pytest.mark.parametrize("backend", ["regroup", "xla"])
def test_jax_checkpoint_is_refused_by_the_package_tag(backend, tmp_path, monkeypatch):
    """An .npz saved by the JAX Renderer has the port's keys and, but for
    the package tag, the port's fingerprint: with the tag the port refuses
    it."""
    jr = jwrt.Renderer(jscenes.three_spheres(), _params(jwrt, jscenes, spp=4),
                       backend=backend)
    path = str(tmp_path / "jax.npz")
    jr.save_checkpoint(path)
    r = _renderer(backend, spp=4)
    with pytest.raises(CheckpointMismatchError, match="package"):
        r.load_checkpoint(path)
    assert r.accumulated_samples() == 0
    monkeypatch.setattr(trenderer, "PACKAGE_TAG", "")
    assert r._fingerprint() == jr._fingerprint()


def test_checkpoint_without_fingerprint_is_refused(tmp_path):
    """A fingerprint-less checkpoint cannot be checked against this
    package's estimator, so it is refused, not blended."""
    path = str(tmp_path / "old.npz")
    np.savez_compressed(path, accum=np.zeros((32 * 18, 3), np.float32),
                        accumulated_spp=np.int64(2), frame_number=np.int64(1),
                        viewport=np.asarray((32, 18), dtype=np.int64))
    with pytest.raises(CheckpointMismatchError):
        _renderer().load_checkpoint(path)


def test_set_render_params_after_resume_resets(tmp_path):
    """After a resume, a parameter change behaves like a live one."""
    path = _saved(_renderer("xla"), tmp_path)
    r = _renderer("xla")
    r.load_checkpoint(path)
    assert r.accumulated_samples() == 2
    new = dataclasses.replace(r.params, sampling=dataclasses.replace(r.params.sampling,
                                                                     num_bounces=5))
    assert r.set_render_params(new)
    assert r.accumulated_samples() == 0


def test_checkpoint_with_a_malformed_accumulator_is_refused(tmp_path):
    """A file whose fingerprint matches but whose accumulator has another
    shape is refused before anything is loaded."""
    r = _renderer()
    path = _saved(r, tmp_path)
    with np.load(path) as data:
        fields = {k: data[k] for k in data.files}
    fields["accum"] = fields["accum"][:-1]
    np.savez_compressed(path, **fields)
    b = _renderer()
    with pytest.raises(CheckpointMismatchError, match="shape"):
        b.load_checkpoint(path)
    assert b.accumulated_samples() == 0
