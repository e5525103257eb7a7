"""The port's MXU chunk sweep knob (``mxu_sweep``) on the CPU: its A table
against the JAX package's bit for bit, the twin's closest hit, the knob's
resolution, conditions and surface (Renderer, fingerprint, CLI, mesh
shard), and the wrappers' MXU entry points through a stub library.

The JAX package's ``mxu_sweep`` (weekend_raytracer_tpu/ops/pallas/
megakernel.py:560-610) runs the culled chunk sweep's products on the MXU;
the port's CUDA kernels run them on the tensor cores (csrc/mxu.cuh) and its
twins with one f32 product (megakernel.py ``_closest_hit_mxu``). The images
against the JAX package's are tests/test_torch_mxu_images.py's and
tests/test_torch_mxu_wavefront.py's.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from weekend_raytracer_tpu.models import scenes as jscenes  # noqa: E402
from weekend_raytracer_tpu.models.camera import CameraBasis as JBasis  # noqa: E402
from weekend_raytracer_tpu.ops.pallas import megakernel as jmk  # noqa: E402
import weekend_raytracer_tpu_torch as twrt  # noqa: E402
from weekend_raytracer_tpu_torch import CheckpointMismatchError  # noqa: E402
from weekend_raytracer_tpu_torch import cli as tcli  # noqa: E402
from weekend_raytracer_tpu_torch.models import scenes  # noqa: E402
from weekend_raytracer_tpu_torch.models.camera import CameraBasis  # noqa: E402
from weekend_raytracer_tpu_torch.models.sky import SkyParams, to_sky_state  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import megakernel as mk  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import regroup as rg  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import wavefront as wf  # noqa: E402
from weekend_raytracer_tpu_torch.ops.intersect import MAX_T, MIN_T  # noqa: E402
from weekend_raytracer_tpu_torch.parallel.sharding import render_shard  # noqa: E402

_BASIS_FIELDS = ("eye", "horizontal", "vertical", "u", "v", "lens_radius",
                 "lower_left_corner")
# the fused backends' render_image_* functions, by Renderer backend
_FUSED = {"regroup": rg.render_image_regrouped, "pallas": mk.render_image_megakernel,
          "wavefront": wf.render_image_wavefront}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    monkeypatch.delenv("WRT_MXU_SWEEP", raising=False)


def _case(name, w, h):
    """A scene of the port's catalog, its default sky and its camera basis."""
    build, cam = scenes.SCENES[name]
    return (build().build(device="cpu"), to_sky_state(SkyParams(), device="cpu"),
            CameraBasis.create(cam(), (w, h), device="cpu"))


def _params(name="three", size=(24, 16), max_spp=4, spp=2, bounces=5):
    return twrt.RenderParams(camera=scenes.SCENES[name][1](), viewport_size=size,
                             sampling=twrt.SamplingParams(max_samples_per_pixel=max_spp,
                                                          num_samples_per_pixel=spp,
                                                          num_bounces=bounces))


# --- (a) the A table, bit for bit -----------------------------------------

@pytest.mark.parametrize("chunk_size", [16, 32])
def test_amats_equal_the_jax_amats(chunk_size):
    """mxu_sweep_amats of the port's prepared RTiOW (16: its own chunk
    size; 32: two sphere tiles a chunk, random10k's size) equals the JAX
    package's of the JAX prepared scene in every bit, and kernel_inputs
    carries it."""
    w, h = 32, 18
    jscene = jscenes.SCENES["rtiow"][0]().build()
    jbasis = JBasis.create(jscenes.SCENES["rtiow"][1](), (w, h))
    jprep = jmk.prepare_scene_arrays(jscene, jbasis, chunk_size, 16)
    jarr = np.asarray(jmk.mxu_sweep_amats(jprep[0], chunk_size, int(jprep[4])))
    basis = CameraBasis.from_numpy(*[np.asarray(getattr(jbasis, f)) for f in _BASIS_FIELDS],
                                   device="cpu")
    scene, sky, _ = _case("rtiow", w, h)
    prep = mk.prepare_scene_arrays(scene, basis, chunk_size, 16)
    got = mk.mxu_sweep_amats(prep.s_attrs, chunk_size, prep.n_chunks).numpy()
    assert got.shape == jarr.shape == (prep.n_chunks, 8, 2 * chunk_size)
    assert np.array_equal(got.view(np.int32), jarr.view(np.int32))
    inp = mk.kernel_inputs(scene, sky, basis, chunk_size=chunk_size, mxu_sweep=True)
    assert np.array_equal(inp.amats.numpy().view(np.int32), jarr.view(np.int32))
    assert mk.mxu_route(inp)


def test_amats_only_where_asked_and_chunked():
    scene, sky, basis = _case("rtiow", 16, 8)
    assert mk.kernel_inputs(scene, sky, basis).amats is None
    three = _case("three", 16, 8)
    inp = mk.kernel_inputs(*three, mxu_sweep=True)
    assert inp.n_chunks == 0 and inp.amats is None and not mk.mxu_route(inp)


def test_route_needs_a_power_of_two_chunk():
    """The JAX condition (megakernel.py:1681-1682): a chunk size that is not
    a power of two leaves the knob ignored; 8 pads the 16-sphere tile."""
    scene, sky, basis = _case("rtiow", 16, 8)
    odd = mk.kernel_inputs(scene, sky, basis, chunk_size=24, mxu_sweep=True)
    assert odd.amats is not None and not mk.mxu_route(odd)
    assert mk.mxu_route(mk.kernel_inputs(scene, sky, basis, chunk_size=8, mxu_sweep=True))
    assert mk.mxu_route(odd, 16) and not mk.mxu_route(odd, 24)
    with pytest.raises(ValueError, match="mxu_sweep=True"):
        mk.with_route(mk.kernel_inputs(scene, sky, basis), True)
    with pytest.raises(ValueError, match="power-of-two"):
        mk.with_route(odd, True)
    assert mk.with_route(odd, False).amats is None and mk.with_route(odd, None) is odd


# --- the twin's closest hit ------------------------------------------------

def _rays(n, seed=0):
    """Rays from around RTiOW's camera, unit directions, as (o, d) tuples."""
    rng = np.random.default_rng(seed)
    o = rng.normal(0.0, 1.0, (n, 3)).astype(np.float32) * np.float32(2.0) + np.float32(
        [13.0, 2.0, 3.0])
    d = rng.normal(0.0, 1.0, (n, 3)).astype(np.float32)
    d[:, :] -= np.float32([1.3, 0.2, 0.3]) * np.float32(3.0)
    d /= np.linalg.norm(d, axis=1, keepdims=True).astype(np.float32)
    o, d = torch.from_numpy(o), torch.from_numpy(d.astype(np.float32))
    return tuple(o[:, k] for k in range(3)), tuple(d[:, k] for k in range(3))


def _float64_hits(o, d, sweep):
    """Closest hit of each ray over every sphere in float64 (the geometric
    quadratic), MAX_T and -1 on a miss."""
    oc = np.stack([v.numpy() for v in o], 1).astype(np.float64)
    dd = np.stack([v.numpy() for v in d], 1).astype(np.float64)
    c = sweep[:, :3].numpy().astype(np.float64)
    kq = sweep[:, 3].numpy().astype(np.float64)
    b = dd @ c.T - (oc * dd).sum(1, keepdims=True)
    cq = (oc * oc).sum(1, keepdims=True) - 2.0 * oc @ c.T + kq
    disc = b * b - cq
    sq = np.sqrt(np.where(disc > 0, disc, np.nan))
    t0, t1 = b - sq, b + sq
    ts = np.where(t0 > MIN_T, t0, t1)
    ts = np.where((disc > 0) & (ts > MIN_T) & (ts < MAX_T), ts, np.inf)
    i = ts.argmin(1)
    t = ts[np.arange(len(i)), i]
    return np.where(np.isfinite(t), t, MAX_T), np.where(np.isfinite(t), i, -1)


def test_mxu_twin_finds_the_closest_hit():
    """_closest_hit_mxu against the float64 quadratic and the FMA sweep on
    4096 rays through RTiOW: the same sphere on all but near ties, and t as
    near the float64 root as the FMA sweep's (the expanded quadratic's
    cancellation moves a grazing ray's t by up to ~1e-3 in either form)."""
    scene, sky, basis = _case("rtiow", 16, 8)
    inp = mk.kernel_inputs(scene, sky, basis, mxu_sweep=True)
    o, d = _rays(4096)
    bt, bi = mk._closest_hit_mxu(o, d, inp)
    ft, fi = mk._closest_hit(o, d, inp.sweep)
    rt, ri = _float64_hits(o, d, inp.sweep)
    assert (bi >= 0).float().mean() > 0.3  # most rays hit something
    assert (bi.numpy() == ri).mean() > 0.999 and (bi == fi).float().mean() > 0.999
    hit = (bi.numpy() == ri) & (fi.numpy() == ri) & (ri >= 0)
    err_mxu = np.abs(bt.numpy()[hit] - rt[hit]) / rt[hit]
    err_fma = np.abs(ft.numpy()[hit] - rt[hit]) / rt[hit]
    assert err_mxu.max() <= 2 * err_fma.max() and np.median(err_mxu) <= 2 * np.median(err_fma)
    assert (bt == ft).float().mean() > 0.8  # most t the FMA sweep's bits
    assert torch.equal(bt[bi < 0], torch.full_like(bt[bi < 0], MAX_T))


def test_mxu_twin_ties_go_to_the_least_index():
    """Two copies of one sphere in different chunks, and a prior among
    them: the least index wins the tie, the port's rule."""
    scene, sky, basis = _case("rtiow", 16, 8)
    inp = mk.kernel_inputs(scene, sky, basis, mxu_sweep=True)
    cs = inp.chunk_size
    p = int(inp.prior_idx[0])
    sweep = inp.sweep.clone()
    amats = inp.amats.clone()
    late = inp.n_spheres - 1  # the last sphere of the last chunk takes the prior's place
    sweep[late] = sweep[p]
    c, j = divmod(late, cs)
    pc, pj = divmod(p, cs)
    amats[c, :, j] = amats[pc, :, pj]
    amats[c, :, cs + j] = amats[pc, :, cs + pj]
    twin = inp._replace(sweep=sweep, amats=amats)
    o, d = _rays(2048, seed=1)
    bt, bi = mk._closest_hit_mxu(o, d, twin)
    assert (bi == p).any() and not (bi == late).any()


# --- (c) no chunks: the knob changes no bit ---------------------------------

@pytest.mark.parametrize("backend", ["regroup", "pallas", "wavefront", "xla"])
def test_knob_changes_nothing_without_chunks(backend):
    """Three spheres have no chunk hierarchy, so the MXU sweep has nothing
    to run and every backend gives the same bits with the knob on; only
    the fused fingerprint records it."""
    accums = {}
    for mxu in (None, True):
        r = twrt.Renderer(scenes.three_spheres(), _params(), backend=backend, device="cpu",
                          mxu_sweep=mxu)
        r.render()
        accums[mxu] = r._accum
    assert torch.equal(accums[None], accums[True])


@pytest.mark.parametrize("backend", list(_FUSED))
def test_render_image_knob_changes_nothing_without_chunks(backend):
    w, h = 24, 16
    case = _case("three", w, h)
    kw = dict(width=w, height=h, spp=2, num_bounces=5)
    if backend == "regroup":
        kw["cuts"] = (2,)
    ref, got = torch.zeros((w * h, 3)), torch.zeros((w * h, 3))
    _FUSED[backend](ref, 3, True, *case, **kw)
    _FUSED[backend](got, 3, True, *case, mxu_sweep=True, **kw)
    assert torch.equal(ref, got)


# --- the knob on a scene with chunks ----------------------------------------

def test_knob_takes_the_mxu_route_and_keeps_the_estimator():
    """On RTiOW the knob changes the megakernel twin's frame (it takes
    _closest_hit_mxu), statistically not at all: the JAX test's assertions
    (test_regroup.py test_mxu_sweep_statistical_equivalence)."""
    w, h = 24, 16
    case = _case("rtiow", w, h)
    kw = dict(width=w, height=h, spp=2, num_bounces=5)
    ref, got = torch.zeros((w * h, 3)), torch.zeros((w * h, 3))
    mk.render_image_megakernel(ref, 1, True, *case, **kw)
    mk.render_image_megakernel(got, 1, True, *case, mxu_sweep=True, **kw)
    assert not torch.equal(ref, got)
    assert abs(float(got.mean()) - float(ref.mean())) / float(ref.mean()) < 2e-3
    assert (got == ref).float().mean() > 0.5
    # a chunk size that is not a power of two leaves the knob ignored
    odd, fma = torch.zeros((w * h, 3)), torch.zeros((w * h, 3))
    mk.render_image_megakernel(odd, 1, True, *case, chunk_size=24, mxu_sweep=True, **kw)
    mk.render_image_megakernel(fma, 1, True, *case, chunk_size=24, **kw)
    assert torch.equal(odd, fma)


@pytest.mark.parametrize("k1_chunk_size", [24, 512])
def test_k1_reads_its_own_chunk_size(k1_chunk_size):
    """regroup.py:1171-1174: K1 takes the MXU sweep only where its own
    k1_chunk_size is a power of two giving chunks (24 is not one; 512 leaves
    RTiOW's 486 spheres unchunked); K0 takes it either way."""
    w, h = 24, 16
    case = _case("rtiow", w, h)
    kw = dict(width=w, height=h, spp=2, num_bounces=5, cuts=(2,))
    got = torch.zeros((w * h, 3))
    rg.render_image_regrouped(got, 1, True, *case, mxu_sweep=True,
                              k1_chunk_size=k1_chunk_size, **kw)
    want = torch.zeros((w * h, 3))
    inp = mk.kernel_inputs(*case, mxu_sweep=True)
    rg.regrouped_plain_with_inputs(want, inp, 1, True, mxu=(True, False), **kw)
    assert torch.equal(got, want)


def test_stats_with_the_knob_raise():
    w, h = 16, 8
    case = _case("rtiow", w, h)
    with pytest.raises(NotImplementedError, match="stats=True with mxu_sweep"):
        mk.render_image_megakernel(torch.zeros((w * h, 3)), 0, True, *case, width=w, height=h,
                                   spp=1, num_bounces=2, stats=True, mxu_sweep=True)
    inp = mk.kernel_inputs(*case, mxu_sweep=True)
    t = rg.plan(w, h, 1, 4, (2,))[0]
    pool = torch.zeros((rg.N_COMP, t.cap))
    counts = torch.tensor([t.cap, 0], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rg.k1_plain(inp, pool, torch.zeros((3, t.cap)), counts, 1, t, 0, 2, 4,
                    stats=torch.zeros((t.cap // rg.TILE_RECORDS, 8)))


# --- (d) resolution, as tests/test_renderer.py:370-397 ----------------------

def test_resolved_mxu_sweep_precedence(monkeypatch):
    """Explicit knob > WRT_MXU_SWEEP > scene-size default
    (MXU_DEFAULT_MIN_SPHERES, None: never)."""
    r = twrt.Renderer(scenes.three_spheres(), _params(), backend="xla", device="cpu")
    assert mk.MXU_DEFAULT_MIN_SPHERES is None
    assert r.resolved_mxu_sweep() is False
    monkeypatch.setattr(mk, "MXU_DEFAULT_MIN_SPHERES", 2)
    assert r.resolved_mxu_sweep() is True  # 3 spheres >= 2
    monkeypatch.setattr(mk, "MXU_DEFAULT_MIN_SPHERES", 100)
    assert r.resolved_mxu_sweep() is False
    monkeypatch.setattr(mk, "MXU_DEFAULT_MIN_SPHERES", 2)
    monkeypatch.setenv("WRT_MXU_SWEEP", "0")  # env beats scene size
    assert r.resolved_mxu_sweep() is False
    monkeypatch.setenv("WRT_MXU_SWEEP", "1")
    assert r.resolved_mxu_sweep() is True
    explicit = twrt.Renderer(scenes.three_spheres(), _params(), backend="xla", device="cpu",
                             mxu_sweep=False)
    assert explicit.resolved_mxu_sweep() is False  # knob beats env


def test_env_turns_the_render_functions_on(monkeypatch):
    """WRT_MXU_SWEEP=1 reaches a render_image_* call that leaves the knob at
    None, as the JAX wrappers resolve it."""
    w, h = 24, 16
    case = _case("rtiow", w, h)
    kw = dict(width=w, height=h, spp=1, num_bounces=3)
    on, env = torch.zeros((w * h, 3)), torch.zeros((w * h, 3))
    mk.render_image_megakernel(on, 0, True, *case, mxu_sweep=True, **kw)
    monkeypatch.setenv("WRT_MXU_SWEEP", "1")
    mk.render_image_megakernel(env, 0, True, *case, **kw)
    assert torch.equal(on, env)


# --- (e) the fingerprint and checkpoints ------------------------------------

def test_fingerprint_records_the_sweep(tmp_path):
    """The fused family hashes mxu={resolved} (renderer.py:486-494 of the
    JAX package): a checkpoint of one setting is refused by the other and
    resumed by its own; the xla backend ignores the knob."""
    kw = dict(backend="regroup", device="cpu")
    fma = twrt.Renderer(scenes.SCENES["rtiow"][0](), _params("rtiow"), **kw)
    mxu = twrt.Renderer(scenes.SCENES["rtiow"][0](), _params("rtiow"), mxu_sweep=True, **kw)
    assert fma._fingerprint() != mxu._fingerprint()
    assert mxu.render_frame()
    path = str(tmp_path / "mxu.npz")
    mxu.save_checkpoint(path)
    with pytest.raises(CheckpointMismatchError):
        twrt.Renderer(scenes.SCENES["rtiow"][0](), _params("rtiow"), **kw).load_checkpoint(path)
    again = twrt.Renderer(scenes.SCENES["rtiow"][0](), _params("rtiow"), mxu_sweep=True,
                          backend="pallas", device="cpu")
    again.load_checkpoint(path)
    assert again.accumulated_samples() == mxu.accumulated_samples()
    xla = [twrt.Renderer(scenes.three_spheres(), _params(), backend="xla", device="cpu",
                         mxu_sweep=m)._fingerprint() for m in (None, True)]
    assert xla[0] == xla[1]


# --- (f) the CLI and the mesh shard -----------------------------------------

def test_cli_mxu_sweep_renders(tmp_path, capsys):
    """--mxu-sweep runs (the JAX flag's help text) on the CPU twins."""
    out = str(tmp_path / "x.png")
    assert tcli.main(["--device", "cpu", "--scene", "rtiow", "--size", "16x8", "--spp", "2",
                      "--bounces", "3", "--mxu-sweep", "--stats-json", "-o", out]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["backend"] == "regroup" and line["spp"] == 2
    help_text = tcli.main.__code__.co_consts
    assert any("MXU" in str(c) for c in help_text)


@pytest.mark.parametrize("backend", ["regroup", "pallas"])
def test_render_shard_takes_the_knob(backend):
    """render_shard passes mxu_sweep to the fused backend: the band of a
    (2, 1) mesh's tile 1 equals the backend's own MXU frame of those rows,
    and differs from the FMA one."""
    w, h = 24, 16
    case = _case("rtiow", w, h)
    kw = dict(n_tiles=2, n_spp=1, width=w, height=h, spp=2, num_bounces=4, backend=backend)
    got = render_shard(5, *case, tile_idx=1, spp_idx=0, mxu_sweep=True, **kw)
    fma = render_shard(5, *case, tile_idx=1, spp_idx=0, **kw)
    want = torch.zeros((w * h // 2, 3))
    extra = {"cuts": rg.default_cuts(4, 486)} if backend == "regroup" else {}
    _FUSED[backend](want, 5, True, *case, width=w, height=h // 2, spp=2, num_bounces=4,
                    row_offset=h // 2, full_height=h, mxu_sweep=True, **extra)
    assert torch.equal(got, want) and not torch.equal(got, fma)


# --- the CUDA wrappers' MXU entry points, with a stub library ---------------

class _StubLib:
    """Stands in for a built library: records each C call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


def _stubbed(monkeypatch, module):
    lib = _StubLib()

    class _Built:
        pass

    built = _Built()
    built.lib = lib
    monkeypatch.setattr(module, "_device_type", lambda t: "cuda")
    monkeypatch.setattr(module, "_library", lambda: built)
    monkeypatch.setattr(module, "_stream_handle", lambda device: 1234)
    return lib


_ENTRIES = {
    "pallas": (mk, ["wrt_megakernel_mxu_launch"], ["wrt_megakernel_launch"]),
    "regroup": (rg, ["wrt_regroup_k0_mxu", "wrt_regroup_pack", "wrt_regroup_k1_mxu",
                     "wrt_regroup_combine"],
                ["wrt_regroup_k0", "wrt_regroup_pack", "wrt_regroup_k1", "wrt_regroup_combine"]),
    "wavefront": (wf, ["wrt_wavefront_k0_mxu", "wrt_wavefront_compact", "wrt_wavefront_k1_mxu"],
                  ["wrt_wavefront_k0", "wrt_wavefront_compact", "wrt_wavefront_k1"]),
}


@pytest.mark.parametrize("scene_name", ["rtiow", "three"])
@pytest.mark.parametrize("backend", list(_ENTRIES))
def test_wrappers_launch_the_mxu_entry_points(backend, scene_name, monkeypatch):
    """A CUDA accumulator with the knob on launches the MXU entry points,
    the A table's pointer before the stream, counted apart; without chunks
    the FMA ones: no twin runs and no kernel falls back."""
    module, mxu_calls, fma_calls = _ENTRIES[backend]
    lib = _stubbed(monkeypatch, module)
    w, h = 16, 8
    case = _case(scene_name, w, h)
    kw = dict(width=w, height=h, spp=1, num_bounces=4)
    if backend == "regroup":
        kw["cuts"] = (2,)
    elif backend == "wavefront":
        kw["phase_cuts"] = (2,)
    counters = {"pallas": [(mk.render_image_megakernel, "mxu_launches")],
                "regroup": [(rg.launch_k0, "mxu_launches"), (rg.launch_k1, "mxu_launches")],
                "wavefront": [(wf.launch_k0, "mxu_launches"),
                              (wf.launch_k1, "mxu_launches")]}[backend]
    before = [getattr(f, a) for f, a in counters]
    _FUSED[backend](torch.zeros((w * h, 3)), 0, True, *case, mxu_sweep=True, **kw)
    names = [n for n, _ in lib.calls]
    rtiow = scene_name == "rtiow"
    assert names == (mxu_calls if rtiow else fma_calls)
    assert [getattr(f, a) - b for (f, a), b in zip(counters, before)] == [int(rtiow)] * len(
        counters)
    if rtiow:
        for name, args in lib.calls:
            if name.endswith(("_mxu", "_mxu_launch")):
                assert args[-1] == 1234 and args[-2] != 0 and isinstance(args[-2], int)
