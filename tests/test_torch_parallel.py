"""The port's mesh sharding (parallel/sharding.py, parallel/multihost.py and
Renderer(mesh=...)) on the CPU, against the JAX package on its 8 virtual
CPU devices (tests/conftest.py).

One process runs any mesh layout by calling ``render_shard`` for every
(tile, spp) cell and summing each tile's spp shards: the emulated mesh.
Real worlds are a one-rank gloo world started from a ``file://`` store in
this process, and two-process gloo worlds started by torchrun around the
port's CLI (``--standalone``: its rendezvous takes a free port).
"""
import os
import subprocess
import sys
from datetime import timedelta

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

import weekend_raytracer_tpu as jwrt  # noqa: E402
from weekend_raytracer_tpu.models import scenes as jscenes  # noqa: E402
from weekend_raytracer_tpu.models.camera import CameraBasis as JBasis  # noqa: E402
from weekend_raytracer_tpu.models.sky import SkyParams as JSky  # noqa: E402
from weekend_raytracer_tpu.models.sky import to_sky_state as jsky_state  # noqa: E402
from weekend_raytracer_tpu.ops.tonemap import to_srgb_u8  # noqa: E402
from weekend_raytracer_tpu.parallel import sharding as jsh  # noqa: E402
import weekend_raytracer_tpu_torch as twrt  # noqa: E402
from weekend_raytracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from weekend_raytracer_tpu_torch.models.params import RenderParamsValidationError  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda.megakernel import render_image_megakernel  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda.regroup import (default_cuts,  # noqa: E402
                                                          render_image_regrouped)
from weekend_raytracer_tpu_torch.ops.tracer import render_image  # noqa: E402
from weekend_raytracer_tpu_torch.parallel import multihost  # noqa: E402
from weekend_raytracer_tpu_torch.parallel import sharding as tsh  # noqa: E402
from weekend_raytracer_tpu_torch.renderer import rank_device, resolve_backend  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, BOUNCES = 64, 35, 4  # 35 rows: padded to 36 on 4 (and 2) tiles


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def port_setup():
    scene = tscenes.three_spheres().build(device="cpu")
    sky = twrt.to_sky_state(twrt.SkyParams(), device="cpu")
    basis = twrt.CameraBasis.create(tscenes.three_spheres_camera(), (W, H), device="cpu")
    return scene, sky, basis


def _padded(n_tiles):
    return -(-H // n_tiles) * n_tiles


def _emulated(setup, backend, n_tiles, n_spp, spp, frame):
    """The mesh's frame contribution, [padded H * W, 3]: every shard's
    render_shard, each tile's spp shards summed in spp order."""
    scene, sky, basis = setup
    bands = []
    for t in range(n_tiles):
        tot = None
        for s in range(n_spp):
            c = tsh.render_shard(frame, scene, sky, basis, tile_idx=t, spp_idx=s,
                                 n_tiles=n_tiles, n_spp=n_spp, width=W,
                                 height=_padded(n_tiles), spp=spp, num_bounces=BOUNCES,
                                 backend=backend, aim_height=H)
            tot = c if tot is None else tot + c
        bands.append(tot)
    return torch.cat(bands)


def _unsharded(setup, backend, accum, frame, clear, spp):
    scene, sky, basis = setup
    kw = dict(width=W, height=H, spp=spp, num_bounces=BOUNCES)
    if backend == "xla":
        return render_image(accum, frame, clear, scene, sky, basis, **kw)
    if backend == "pallas":
        return render_image_megakernel(accum, frame, clear, scene, sky, basis, **kw)
    return render_image_regrouped(accum, frame, clear, scene, sky, basis,
                                  cuts=default_cuts(BOUNCES, 4), **kw)


# --- the mesh and its validation -------------------------------------------------

@pytest.mark.parametrize("n,tiles,spp", [
    (8, None, 1), (8, None, 2), (8, None, 4), (8, 4, 2), (8, 2, 4), (8, 8, 1),
    (4, None, 1), (1, None, 1), (8, None, 3), (8, 3, 2), (8, None, 0), (6, None, 4),
    (8, 4, 1), (2, None, 2)])
def test_make_mesh_accepts_and_refuses_as_jax(n, tiles, spp):
    try:
        want = dict(jsh.make_mesh(jax.devices()[:n], tile_shards=tiles, spp_shards=spp).shape)
    except jwrt.RenderParamsValidationError:
        want = None
    if want is None:
        with pytest.raises(RenderParamsValidationError):
            tsh.make_mesh(range(n), tile_shards=tiles, spp_shards=spp)
        return
    mesh = tsh.make_mesh(range(n), tile_shards=tiles, spp_shards=spp)
    assert mesh.shape == want
    assert mesh.ranks.size == n and not mesh.distributed
    np.testing.assert_array_equal(mesh.ranks.ravel(), np.arange(n))


@pytest.mark.parametrize("n_spp,spp", [(1, 3), (2, 2), (2, 3), (4, 8), (4, 2), (8, 4)])
def test_validate_mesh_config_as_jax(n_spp, spp):
    jmesh = jsh.make_mesh(jax.devices()[:8], spp_shards=n_spp)
    tmesh = tsh.make_mesh(range(8), spp_shards=n_spp)
    try:
        jsh.validate_mesh_config(jmesh, (W, H), spp)
        refused = False
    except jwrt.RenderParamsValidationError:
        refused = True
    if refused:
        with pytest.raises(RenderParamsValidationError):
            tsh.validate_mesh_config(tmesh, (W, H), spp)
    else:
        tsh.validate_mesh_config(tmesh, (W, H), spp)
    with pytest.raises(RenderParamsValidationError):
        tsh.validate_mesh_config(object(), (W, H), spp)


@pytest.mark.parametrize("frame,n_spp", [(0, 1), (7, 2), (3, 4), (2**31 + 5, 4),
                                         (2**32 - 1, 2), (123456789, 8)])
def test_shard_seed_and_rows_match_the_jax_formula(frame, n_spp):
    """sharding.py:143's seed in uint32, wrapping past 2^32, and :137/:158's
    band rows, for every shard."""
    for s in range(n_spp):
        want = jnp.uint32(frame) * jnp.uint32(n_spp) + jnp.asarray(s).astype(jnp.uint32)
        assert tsh.shard_seed(frame, s, n_spp) == int(want)
    if frame * n_spp >= 2**32:
        assert tsh.shard_seed(frame, 0, n_spp) < frame * n_spp
    for n_tiles, height in ((4, 36), (2, 36), (8, 1088), (5, 1080)):
        for t in range(n_tiles):
            block = height // n_tiles
            want = (jnp.asarray(t) * block).astype(jnp.uint32)
            assert tsh.shard_rows(t, n_tiles, height) == (int(want), block)


# --- the emulated mesh against the JAX render_image_sharded -----------------------

@pytest.fixture(scope="module")
def jax_setup():
    scene = jscenes.three_spheres().build()
    basis = JBasis.create(jscenes.three_spheres_camera(), (W, H))
    return scene, jsky_state(JSky()), basis


def _tonemapped(img, h):
    return np.asarray(to_srgb_u8(jnp.asarray(img.reshape(h, W, 3)))).astype(np.float32) / 255


@pytest.mark.parametrize("spp", [2, 4])
@pytest.mark.parametrize("layout", [(4, 1), (2, 2)])
@pytest.mark.parametrize("backend", ["xla", "pallas", "regroup"])
def test_emulated_mesh_matches_jax_render_image_sharded(backend, layout, spp, jax_setup,
                                                        port_setup):
    """three_spheres at 64x35 (a padded 36th row), 4 bounces, frame 3: the
    whole padded accumulator's mean radiance against the JAX mesh's, at the
    tolerance the
    unsharded frames are held to. xla: test_torch_xla.py's (close share >
    0.98, RMSE on the close pixels < 1e-4, tonemapped RMSE < 5e-3, mean
    within a relative 1e-3); pallas and regroup (the CPU twins):
    test_torch_megakernel.py's and test_torch_regroup.py's statistical
    gates (tonemapped RMSE < 5e-3, mean within a relative 1e-3)."""
    n_tiles, n_spp = layout
    hp = _padded(n_tiles)
    jmesh = jsh.make_mesh(jax.devices()[:n_tiles * n_spp], spp_shards=n_spp)
    want = np.asarray(jsh.render_image_sharded(
        jsh.sharded_accumulator(W, hp, jmesh), jnp.uint32(3), jnp.bool_(True), *jax_setup,
        width=W, height=hp, aim_height=H, spp=spp, num_bounces=BOUNCES, mesh=jmesh,
        backend=backend)) / spp
    got = _emulated(port_setup, backend, n_tiles, n_spp, spp, frame=3).numpy() / spp
    assert got.shape == want.shape == (W * hp, 3) and np.isfinite(got).all()
    if backend == "xla":
        close = np.isclose(got, want, rtol=1e-2, atol=1e-3).all(axis=-1)
        assert close.mean() > 0.98, close.mean()
        assert np.sqrt(((got[close] - want[close]) ** 2).mean()) < 1e-4
    rmse = float(np.sqrt(((_tonemapped(got, hp) - _tonemapped(want, hp)) ** 2).mean()))
    assert rmse < 5e-3, rmse
    assert abs(got.mean() - want.mean()) / max(want.mean(), 1e-6) < 1e-3


@pytest.mark.parametrize("backend", ["xla", "pallas", "regroup"])
def test_tiles_only_mesh_is_the_unsharded_frame_in_every_bit(backend, port_setup):
    """Four tile shards (the last band holding the padding row) over two
    frames, the second accumulated as base + contrib: the real rows equal
    the unsharded frames in every bit (tests/test_parallel.py:190-213 asserts
    this for the JAX regroup); the padding row is finite."""
    acc_mesh = torch.zeros((W * _padded(4), 3))
    acc = torch.zeros((W * H, 3))
    for frame in range(2):
        contrib = _emulated(port_setup, backend, 4, 1, 2, frame)
        if frame == 0:
            acc_mesh.zero_()
        acc_mesh += contrib
        _unsharded(port_setup, backend, acc, frame, frame == 0, 2)
        assert torch.equal(acc_mesh[:W * H], acc), frame
    assert bool(torch.isfinite(acc_mesh[W * H:]).all())


# --- backend resolution and refusals ---------------------------------------------

@pytest.mark.parametrize("backend,n_spp,spp,bounces", [
    ("auto", 1, 2, 4), ("auto", 2, 4, 4), ("auto", 2, 6, 4), ("auto", 4, 4, 1),
    ("regroup", 2, 6, 4), ("regroup", 2, 4, 4), ("pallas", 2, 4, 4), ("xla", 1, 2, 4),
    ("wavefront", 1, 2, 4), ("auto", 4, 2, 4)])
def test_resolve_backend_under_a_mesh_as_jax(backend, n_spp, spp, bounces):
    """The JAX Renderer's rule under a mesh (renderer.py:163-204): the mesh
    config validated, spp per shard in the regroup rule, wavefront refused."""
    def params(pkg, scn):
        return pkg.RenderParams(camera=scn.three_spheres_camera(), viewport_size=(W, H),
                                sampling=pkg.SamplingParams(max_samples_per_pixel=2 * spp,
                                                            num_samples_per_pixel=spp,
                                                            num_bounces=bounces))
    try:
        jr = jwrt.Renderer(jscenes.three_spheres(), params(jwrt, jscenes), backend=backend,
                           mesh=jsh.make_mesh(jax.devices()[:n_spp], spp_shards=n_spp))
        want = jr.backend
    except jwrt.RenderParamsValidationError:
        want = None
    tmesh = tsh.make_mesh(range(n_spp), spp_shards=n_spp)
    if want is None:
        with pytest.raises(RenderParamsValidationError):
            resolve_backend(backend, params(twrt, tscenes), tmesh)
    else:
        assert resolve_backend(backend, params(twrt, tscenes), tmesh) == want


def test_wavefront_under_a_mesh_is_refused():
    params = twrt.RenderParams(camera=tscenes.three_spheres_camera(), viewport_size=(W, H))
    with pytest.raises(RenderParamsValidationError, match="wavefront"):
        twrt.Renderer(tscenes.three_spheres(), params, backend="wavefront", device="cpu",
                      mesh=tsh.make_mesh())
    r = twrt.Renderer(tscenes.three_spheres(), params, backend="wavefront", device="cpu")
    assert r.backend == "wavefront"


def test_a_mesh_without_a_world_renders_only_one_rank(port_setup):
    """Outside a torch.distributed world a mesh of 4 ranks names no rank of
    this process: render_image_sharded refuses; a 1-rank mesh renders."""
    scene, sky, basis = port_setup
    kw = dict(width=W, height=36, aim_height=H, spp=2, num_bounces=BOUNCES, backend="xla")
    mesh = tsh.make_mesh(range(4))
    with pytest.raises(RenderParamsValidationError, match="world"):
        tsh.render_image_sharded(torch.zeros((9 * W, 3)), 0, True, scene, sky, basis,
                                 mesh=mesh, **kw)
    one = tsh.make_mesh()
    assert one.shape == {"tiles": 1, "spp": 1} and one.rank == 0
    acc = tsh.sharded_accumulator(W, 36, one, device="cpu")
    with pytest.raises(ValueError, match="block"):
        tsh.render_image_sharded(torch.zeros((W, 3)), 0, True, scene, sky, basis,
                                 mesh=one, **kw)
    out = tsh.render_image_sharded(acc, 0, True, scene, sky, basis, mesh=one, **kw)
    assert out is acc and tuple(acc.shape) == (36 * W, 3)


# --- multihost -------------------------------------------------------------------

def test_initialize_without_a_cluster_is_single_process(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    multihost.initialize()
    multihost.initialize(num_processes=1)
    assert not dist.is_initialized()
    assert multihost.local_rank() == 0
    mesh = multihost.global_mesh()
    assert mesh.shape == {"tiles": 1, "spp": 1}
    acc = torch.arange(12.0).reshape(4, 3)
    np.testing.assert_array_equal(multihost.gather_frame(acc, 2, 1), acc[:2].numpy())


def test_initialize_fails_loudly(monkeypatch):
    """An explicit cluster that cannot start raises, and so does a detected
    one (WORLD_SIZE set) whose rendezvous is missing: neither turns into a
    single-process run."""
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="rendezvous"):
        multihost.initialize("nosuch://host:1", 2, 0, backend="gloo",
                             timeout=timedelta(seconds=5))
    with pytest.raises(ValueError):
        multihost.initialize(num_processes=2, backend="gloo")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError):
        multihost.initialize(backend="gloo", timeout=timedelta(seconds=5))
    assert not dist.is_initialized()


def _mesh_params(max_spp=4, spp=2, size=(W, H)):
    return twrt.RenderParams(camera=tscenes.three_spheres_camera(), viewport_size=size,
                             sampling=twrt.SamplingParams(max_samples_per_pixel=max_spp,
                                                          num_samples_per_pixel=spp,
                                                          num_bounces=BOUNCES))


def test_renderer_on_a_one_rank_gloo_world(tmp_path):
    """Renderer(mesh=global_mesh()) inside a real one-rank world (a gloo
    group from a file:// store): the all_reduce and the gather run, and the
    image, the checkpoint and gather_frame equal the unsharded Renderer's
    in every bit."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", world_size=1,
                            rank=0, timeout=timedelta(seconds=60))
    try:
        mesh = multihost.global_mesh()
        assert mesh.distributed and mesh.coords() == (0, 0)
        r = twrt.Renderer(tscenes.three_spheres(), _mesh_params(), device="cpu", mesh=mesh)
        ref = twrt.Renderer(tscenes.three_spheres(), _mesh_params(), device="cpu")
        marks = []
        r.render_frame()
        tsh.render_image_sharded(torch.zeros_like(r._accum), 0, True, r._scene, r._sky,
                                 r._basis, width=W, height=H, spp=2, num_bounces=BOUNCES,
                                 mesh=mesh, backend=r.backend, on_stage=marks.append)
        assert marks == ["shard", "all_reduce"]
        r.render()
        ref.render()
        assert r.backend == ref.backend == "regroup"
        np.testing.assert_array_equal(r.image(), ref.image())
        assert torch.equal(r.mean_radiance(), ref.mean_radiance())
        np.testing.assert_array_equal(multihost.gather_frame(r._accum, W, H, mesh),
                                      ref._accum.numpy())
        path = str(tmp_path / "ckpt.npz")
        r.save_checkpoint(path)
        again = twrt.Renderer(tscenes.three_spheres(), _mesh_params(), device="cpu")
        again.load_checkpoint(path)
        assert torch.equal(again._accum, ref._accum)
    finally:
        dist.destroy_process_group()


# --- two processes through torchrun and the port's CLI ---------------------------

def _torchrun_cli(tmp_path, *args, timeout=240):
    """The port's CLI in a 2-process gloo world under torchrun (its rendezvous
    on a free port); returns the rendered mean radiance [H, W, 3]."""
    hdr = str(tmp_path / "mesh.npz")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "weekend_raytracer_tpu_torch", "--device", "cpu",
           "--scene", "three", "--size", f"{W}x{H}", "--bounces", str(BOUNCES),
           "--stats-json", "--hdr", hdr, "-o", str(tmp_path / "mesh.png"), *args]
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, out.stdout  # rank 0 alone prints
    with np.load(hdr) as data:
        return data["mean_radiance"], int(data["samples"]), lines[0]


@pytest.mark.parametrize("layout", [(2, 1), (1, 2)])
def test_two_process_gloo_cli_equals_the_emulated_mesh(layout, tmp_path, port_setup):
    """4 spp in two frames of 2 over (2, 1) and (1, 2): the CLI's --hdr equals
    the emulated mesh's mean radiance in every bit (a sum of two shards is
    the same in either order)."""
    n_tiles, n_spp = layout
    mean, samples, line = _torchrun_cli(tmp_path, "--spp", "4", "--spp-per-frame", "2",
                                        "--tile-shards", str(n_tiles),
                                        "--spp-shards", str(n_spp))
    assert samples == 4 and '"devices": 2' in line and '"backend": "regroup"' in line
    acc = None
    for frame in range(2):
        c = _emulated(port_setup, "regroup", n_tiles, n_spp, 2, frame)
        acc = c if acc is None else acc + c
    want = (acc[:W * H] / 4).reshape(H, W, 3).numpy()
    np.testing.assert_array_equal(mean, want)


def test_checkpoints_move_between_a_mesh_and_one_device(tmp_path):
    """A single-device checkpoint (35 rows) resumes on a 2-process (2, 1)
    mesh, which grows it to 36 rows; the mesh's checkpoint (36 rows) resumes
    on one device, which trims the padding row. Each resumed render equals
    the uninterrupted single-device one in every bit."""
    def single(max_spp):
        return twrt.Renderer(tscenes.three_spheres(), _mesh_params(max_spp=max_spp),
                             device="cpu")

    refs = {}
    for max_spp in (4, 6):
        r = single(max_spp)
        r.render()
        refs[max_spp] = r
    path = str(tmp_path / "ckpt.npz")
    first = single(2)
    first.render()
    first.save_checkpoint(path)
    mean, samples, _ = _torchrun_cli(tmp_path, "--spp", "4", "--spp-per-frame", "2",
                                     "--tile-shards", "2", "--checkpoint", path)
    assert samples == 4
    np.testing.assert_array_equal(mean, refs[4].mean_radiance().numpy())
    with np.load(path) as data:
        assert data["accum"].shape == (W * 36, 3)
        assert int(data["accumulated_spp"]) == 4 and int(data["frame_number"]) == 2
    resumed = single(6)
    resumed.load_checkpoint(path)
    assert resumed.accumulated_samples() == 4
    assert torch.equal(resumed._accum, refs[4]._accum)
    resumed.render()
    assert torch.equal(resumed._accum, refs[6]._accum)


def test_new_modules_leave_jax_out():
    code = ("import sys, weekend_raytracer_tpu_torch as w; "
            "import weekend_raytracer_tpu_torch.parallel.sharding; "
            "import weekend_raytracer_tpu_torch.parallel.multihost; "
            "import weekend_raytracer_tpu_torch.cli; "
            "import weekend_raytracer_tpu_torch.interactive.fly_camera; "
            "import weekend_raytracer_tpu_torch.interactive.viewer; "
            "import weekend_raytracer_tpu_torch.utils.native as n; "
            "n.available(); "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m); "
            "assert 'weekend_raytracer_tpu' not in sys.modules")
    env = dict(os.environ, PYTHONPATH=_REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=_REPO, env=env,
                   timeout=120)


def test_renderer_mesh_device_is_the_ranks_card(monkeypatch):
    """Under a mesh, device="cuda" names the rank's own card."""
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert multihost.local_rank() == 3
    mesh = tsh.make_mesh()
    assert rank_device("cuda", mesh) == torch.device("cuda", 3)
    assert rank_device("cuda:1", mesh) == torch.device("cuda", 1)
    assert rank_device("cuda") == torch.device("cuda")
    assert rank_device("cpu", mesh) == torch.device("cpu")
