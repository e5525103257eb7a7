"""The port's record reorder kernels and binning probe against the JAX
package's probes, on the CPU.

- benchmarks/probe_dma.py's four small probes and probe_mosaic.py:143 run
  as they are, with ``pl.pallas_call`` in Pallas interpret mode; each
  kernel's inputs and output are captured and the port's twin
  (``record_gather`` / ``record_scatter`` on CPU tensors) must give the
  same output bit for bit. ``probe_dma_rate``'s pool (365 MB) is too large
  for interpret mode, so its kernel is restated here at 64 tiles of 32
  records: the twin equals it exactly on the probe's all-ones pool and
  within a relative 1e-6 on uniform random data (the two sum 4096 values
  in different orders; each partial sum is positive, so the orders differ
  by a few ulps of the total).
- The binning of benchmarks/probe_binned.py on the port's K0 and PACK
  twins (RTiOW 128x64, 4 spp, cut 2: three dense tiles of 4096 records):
  the keys equal a NumPy restatement of probe_binned.py:225-260 in every
  integer and the order equals ``np.argsort(kind="stable")``. On each
  permuted pool the JAX K1 ([2, 4)) and K1-stats ([2, 3)) run in
  interpret mode against ``k1_plain`` at tests/test_torch_regroup.py's K1
  gates (home slots exact, alive flags on >= 99% of records, the image at
  the RMSE/mean gates) and with the counters equal per tile over one
  bounce. The twin's K1 on a permuted pool, scattered back, equals its
  home-order K1 in every bit.

The module runs PyTorch on one thread and computes each JAX reference once.
"""
import contextlib
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import test_torch_regroup as trg  # noqa: E402
import test_torch_stats as tst  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from weekend_raytracer_tpu.ops.pallas import megakernel as jmk  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import megakernel as mk  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import regroup as rg  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import reorder as ro  # noqa: E402
from weekend_raytracer_tpu_torch.probes import binned  # noqa: E402
from weekend_raytracer_tpu_torch.probes import dma  # noqa: E402

_BENCH = pathlib.Path(__file__).resolve().parents[1] / "benchmarks"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twins' small tensors gain nothing from intra-op threads, and
    beside the other test workers those threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_bench_{name}", _BENCH / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def _interpreted(calls):
    """pl.pallas_call in interpret mode, recording each call's inputs and
    output as numpy arrays."""
    real = pl.pallas_call

    def recording(*args, **kwargs):
        call = real(*args, interpret=True, **kwargs)

        def run(*inputs):
            out = call(*inputs)
            calls.append(([np.asarray(x) for x in inputs], np.asarray(out)))
            return out

        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", recording)
        yield


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


# --- the DMA probes ------------------------------------------------------

# probe -> (module, function, the port's probe of the same name)
_PROBES = {
    "single_dma_2d": ("probe_dma", "probe_single_dma_2d"),
    "single_dma_3d": ("probe_dma", "probe_single_dma_3d"),
    "gather32_pipelined": ("probe_dma", "probe_gather32_pipelined"),
    "scatter_dma": ("probe_dma", "probe_scatter_dma"),
    "manual_dma_gather_rows": ("probe_mosaic", "probe_manual_dma_gather_rows"),
}


@pytest.fixture(scope="module")
def probes():
    """Each JAX probe run in interpret mode: its message and its one
    pallas_call's (inputs, output)."""
    modules = {name: _load(name) for name in ("probe_dma", "probe_mosaic")}
    out = {}
    for name, (module, fn) in _PROBES.items():
        calls = []
        with _interpreted(calls):
            message = getattr(modules[module], fn)()
        assert len(calls) == 1
        out[name] = (message, *calls[0])
    return out


@pytest.mark.parametrize("name", list(_PROBES))
def test_dma_probe_matches_jax(name, probes):
    """The JAX probe passes its own check, and the port's twin gives its
    output bit for bit on the same inputs; the port's probe of the same
    name passes on the CPU."""
    message, (idx, tab), out = probes[name]
    assert "works" in message
    idx_t = torch.from_numpy(idx.astype(np.int32))
    tab = np.array(tab)
    if name == "scatter_dma":
        # the probe writes only the named records of its output
        got = ro.record_scatter(torch.from_numpy(tab), idx_t, torch.zeros(out.shape))
        for j, i in enumerate(idx):
            assert _same_bits(got[int(i)].numpy(), out[int(i)])
    else:
        rows = tab.reshape(-1, 128) if tab.ndim == 1 else tab
        got = ro.record_gather(torch.from_numpy(rows), idx_t).numpy()
        assert _same_bits(got.reshape(out.shape), out)
    assert "works" in getattr(dma, _PROBES[name][1])("cpu")["message"]


def _jax_dma_rate(pool, perm):
    """probe_dma_rate's kernel (probe_dma.py:177-213) at the pool's size."""
    n_rows, comps, width = pool.shape
    n_tiles = n_rows // 32

    def kernel(idx_ref, hbm_ref, out_ref, scratch, sems):
        t = pl.program_id(0)

        def start(j, _):
            pltpu.make_async_copy(
                hbm_ref.at[idx_ref[t * 32 + j]], scratch.at[j], sems.at[j]).start()
            return 0

        jax.lax.fori_loop(0, 32, start, 0, unroll=True)

        def wait(j, _):
            pltpu.make_async_copy(
                hbm_ref.at[idx_ref[t * 32 + j]], scratch.at[j], sems.at[j]).wait()
            return 0

        jax.lax.fori_loop(0, 32, wait, 0, unroll=True)
        out_ref[:] = jnp.broadcast_to(jnp.sum(scratch[:, 0, :], keepdims=True), (8, 128))

    return np.asarray(pl.pallas_call(
        kernel,
        grid=(n_tiles,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((8, 128), lambda i: (i, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n_tiles * 8, 128), jnp.float32),
        scratch_shapes=[pltpu.VMEM((32, comps, width), jnp.float32),
                        pltpu.SemaphoreType.DMA((32,))],
        interpret=True,
    )(jnp.asarray(perm), jnp.asarray(pool)))


_RATE_RECORDS = 64 * 32


@pytest.mark.parametrize("fill", ["ones", "uniform"])
def test_dma_rate_matches_jax(fill):
    values = (None if fill == "ones" else
              np.random.default_rng(3).random((_RATE_RECORDS, 11, 128), dtype=np.float32))
    pool, perm = dma.rate_inputs("cpu", _RATE_RECORDS, values)
    ref = _jax_dma_rate(pool.numpy(), perm.numpy())
    got = ro.dma_rate(pool, perm).numpy()
    assert got.shape == ref.shape == (64 * 8, 128)
    if fill == "ones":
        assert _same_bits(got, ref) and (got == 32 * 128).all()
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6)
        assert (got == got[::8].repeat(8, 0)[:, :1]).all()  # each tile's block is one value


def test_dma_rate_twin_follows_the_kernel_order():
    """The twin adds in the kernel's order (reorder.cu): per thread of 256
    in turn, then the halving of each warp's 32 sums, then the 8 warps."""
    pool, perm = dma.rate_inputs("cpu", 64, np.random.default_rng(4).standard_normal(
        (64, 11, 128)).astype(np.float32) * 1e3)
    got = ro.dma_rate_plain(pool, perm)
    vals = pool.numpy()[perm.numpy(), 0].reshape(2, 16, 256)
    for t in range(2):
        s = np.zeros(256, np.float32)
        for m in range(16):
            s = s + vals[t, m]
        s = s.reshape(8, 32)
        for off in (16, 8, 4, 2, 1):
            s = s[:, :off] + s[:, off:2 * off]
        total = s[0, 0]
        for w in range(1, 8):
            total = np.float32(total + s[w, 0])
        assert _same_bits(got[8 * t:8 * t + 8].numpy(), np.full((8, 128), total, np.float32))


# --- the binning probe ---------------------------------------------------

_BIN = dict(w=128, h=64, spp=4, cut=2, bounces=4)


def _np_keys(recs, chunk_arrays):
    """probe_binned.py:225-272, on the host, as the probe computes them."""
    ox, oy, oz = recs[:, rg._OX], recs[:, rg._OY], recs[:, rg._OZ]
    dx, dy, dz = recs[:, rg._DX], recs[:, rg._DY], recs[:, rg._DZ]
    octant = ((dx >= 0).astype(np.int64) * 4 + (dy >= 0) * 2 + (dz >= 0))
    lo = np.array([ox.min(), oy.min(), oz.min()])
    hi = np.array([ox.max(), oy.max(), oz.max()])
    span = np.maximum(hi - lo, 1e-6)

    def cell(nx, ny, nz):
        cx = np.minimum(((ox - lo[0]) / span[0] * nx).astype(np.int64), nx - 1)
        cy = np.minimum(((oy - lo[1]) / span[1] * ny).astype(np.int64), ny - 1)
        cz = np.minimum(((oz - lo[2]) / span[2] * nz).astype(np.int64), nz - 1)
        return (cx * ny + cy) * nz + cz

    clox, cloy, cloz, chix, chiy, chiz = (np.asarray(a) for a in chunk_arrays[:6])
    n = recs.shape[0]
    chunk_of = np.zeros(n, np.int64)
    bs = 1 << 18
    for i in range(0, n, bs):
        sl = slice(i, min(i + bs, n))
        px, py, pz = ox[sl, None], oy[sl, None], oz[sl, None]
        qx = np.clip(px, clox[None], chix[None]) - px
        qy = np.clip(py, cloy[None], chiy[None]) - py
        qz = np.clip(pz, cloz[None], chiz[None]) - pz
        chunk_of[sl] = np.argmin(qx * qx + qy * qy + qz * qz, axis=1)
    return {"home": None, "oct": octant, "cell16xoct": cell(4, 1, 4) * 8 + octant,
            "cell64xoct": cell(8, 1, 8) * 8 + octant, "chunkxoct": chunk_of * 8 + octant,
            "cell64": cell(8, 1, 8), "cell256xoct": cell(16, 1, 16) * 8 + octant,
            "chunk": chunk_of}


@pytest.fixture(scope="module")
def binning():
    """The dense pool of the port's K0 and PACK twins at the cut, the bin
    keys of the port and of the NumPy restatement, and per scheme (lazily)
    the permuted pool through K1 and K1-stats of both packages."""
    b = _BIN
    (jscene, jsky, jbasis), (scene, sky, basis) = trg._setup("rtiow", b["w"], b["h"])
    t, _ = rg.plan(b["w"], b["h"], b["spp"], b["bounces"], (b["cut"],))
    inp = mk.kernel_inputs(scene, sky, basis)
    dense, counts, n = binned.dense_pool(inp, t, b["cut"], "cpu")
    _, (_, chunk_arrays, *_) = trg._jax_scene_arrays(jscene, jbasis)
    out = dict(t=t, inp=inp, dense=dense, counts=counts, n=n,
               keys=binned.bin_keys(dense, n, inp),
               np_keys=_np_keys(dense[:, :n].T.numpy(), chunk_arrays),
               jk1=trg._jax_k1(jscene, jsky, jbasis, t, b["cut"], b["bounces"]),
               jst=tst._jax_k1_stats(jscene, jsky, jbasis, t))
    cache = {}

    def scheme(name):
        if name not in cache:
            cache[name] = _run_scheme(out, name)
        return cache[name]

    out["scheme"] = scheme
    return out


def _run_scheme(b, name):
    t, inp, dense, counts, n = b["t"], b["inp"], b["dense"], b["counts"], b["n"]
    cut, bounces = _BIN["cut"], _BIN["bounces"]
    key = b["keys"][name]
    order = None if key is None else binned.stable_order(key)
    pool = (dense.clone() if order is None else binned.permute(
        dense, binned.with_tail(order, n, -(-n // 128) * 128), torch.empty_like(dense)))
    rows = -(-n // 128)
    jd, jr8 = (trg._from_jax(a) for a in b["jk1"](
        trg._to_jax(pool.numpy(), t.tiles_x * t.tiles_y + 1), rows, 0))
    jst = b["jst"](trg._to_jax(pool.numpy()), rows, cut, cut + 1)
    k1 = pool.clone()
    r8 = torch.zeros((3, t.cap))
    rg.k1_plain(inp, k1, r8, counts, 1, t, 0, cut, bounces)
    st = torch.full((t.cap // rg.TILE_RECORDS, 8), -1.0)
    rg.k1_plain(inp, pool.clone(), torch.zeros((3, t.cap)), counts, 1, t, 0, cut, cut + 1,
                stats=st)
    return dict(order=order, pool=pool.numpy(), jd=jd, jr8=jr8[:3], jst=jst,
                k1=k1.numpy(), r8=r8.numpy(), st=st.numpy())


def test_binning_case_has_several_dense_tiles(binning):
    """The case the binning tests run on has live records in three dense
    tiles, so a permutation moves records between the counters' tiles."""
    assert -(-binning["n"] // rg.TILE_RECORDS) == 3
    assert set(binning["keys"]) == set(binned.SCHEMES)
    assert set(binned.QUICK_SCHEMES) < set(binned.SCHEMES) and len(binned.SCHEMES) == 8


@pytest.mark.parametrize("name", binned.SCHEMES)
def test_bin_keys_match_numpy(name, binning):
    key, ref = binning["keys"][name], binning["np_keys"][name]
    if name == "home":
        assert key is None and ref is None
        return
    assert key.dtype == torch.int64
    np.testing.assert_array_equal(key.numpy(), ref)
    assert len(np.unique(ref)) > 1


@pytest.mark.parametrize("name", binned.SCHEMES[1:])
def test_order_is_a_stable_argsort(name, binning):
    order = binning["scheme"](name)["order"]
    assert order.dtype == torch.int32
    np.testing.assert_array_equal(order.numpy(),
                                  np.argsort(binning["np_keys"][name], kind="stable"))


@pytest.mark.parametrize("name", binned.SCHEMES)
def test_permuted_pool_keeps_the_records_and_the_dead_row(name, binning):
    """The permuted pool holds the live records in key order and PACK's
    dead records up to the end of the last dense row."""
    s, n = binning["scheme"](name), binning["n"]
    end = -(-n // 128) * 128
    dense = binning["dense"].numpy()
    order = np.arange(n) if s["order"] is None else s["order"].numpy()
    assert _same_bits(s["pool"][:, :n], dense[:, order])
    assert _same_bits(s["pool"][:, n:end], dense[:, n:end])
    assert (s["pool"][rg._AL, n:end] == 0).all()
    assert (s["pool"][rg._HHI, n:end] == rg._DEAD_HHI).all()


@pytest.mark.parametrize("name", binned.SCHEMES)
def test_binned_k1_matches_jax(name, binning):
    """K1 over [2, 4) on the permuted pool: the JAX kernel against the
    twin at tests/test_torch_regroup.py's K1 gates."""
    s, n, t = binning["scheme"](name), binning["n"], binning["t"]
    for c in (rg._HLO, rg._HHI):
        assert _same_bits(s["k1"][c, :n], s["pool"][c, :n])
        assert _same_bits(s["jd"][c, :n], s["pool"][c, :n])
    assert (s["k1"][rg._AL, :n] == s["jd"][rg._AL, :n]).mean() >= 0.99
    jimg = trg._home_image(s["jd"], s["jr8"], n, t) / t.spp
    img = trg._home_image(s["k1"], s["r8"], n, t) / t.spp
    trg._assert_statistically_equal(jimg, img, t.width, t.height)


@pytest.mark.parametrize("name", binned.SCHEMES)
def test_binned_k1_counters_equal_at_one_bounce(name, binning):
    s = binning["scheme"](name)
    live = -(-binning["n"] // rg.TILE_RECORDS)
    np.testing.assert_array_equal(s["st"][:live], s["jst"][:live])
    tst._assert_invariants(s["st"][:live], 1)
    assert (s["st"][live:] == 0).all()


@pytest.mark.parametrize("name", binned.SCHEMES[1:])
def test_binned_k1_scattered_back_is_home_k1(name, binning):
    """K1's result does not depend on where a record sits: the twin's K1 on
    the permuted pool, scattered back by the order, is its home-order K1 in
    every bit, records and radiance."""
    s, home, n = binning["scheme"](name), binning["scheme"]("home"), binning["n"]
    order = s["order"]
    for got, ref in ((s["k1"], home["k1"]), (s["r8"], home["r8"])):
        back = ro.record_scatter(torch.from_numpy(np.ascontiguousarray(got[:, :n])), order,
                                 torch.empty((got.shape[0], n)), dim=1)
        assert _same_bits(back.numpy(), ref[:, :n])
    assert not _same_bits(s["k1"][:, :n], home["k1"][:, :n])  # the pool did move


def test_binned_run_on_the_cpu():
    """The probe's entry point on the twins: a row per quick scheme with
    the probe's fields, the scatter-back gate held, no kernel launched."""
    before = (ro.record_gather.launches, ro.record_scatter.launches, rg.launch_k1.launches)
    lines = []
    rows = binned.run(2, "rtiow", quick=True, device="cpu", width=64, height=32, bounces=4,
                      reps=1, emit=lines.append)
    assert [r["scheme"] for r in rows] == list(binned.QUICK_SCHEMES)
    assert lines[0]["phase"] == "pool" and lines[1]["phase"] == "live_records"
    fields = {"scheme", "cut", "k1_ms", "iters_mean", "live_frac", "chunk_entry",
              "tests_per_seg", "in_sum_rel_err", "sort_ms", "permute_ms"}
    for r in rows:
        assert fields <= set(r) and r["device"] == "cpu"
        assert r["in_sum_rel_err"] < 1e-12 and r["iters_mean"] == 2.0
        assert r["scatter_back"] == ("home" if r["scheme"] == "home" else "bit-exact")
    assert (ro.record_gather.launches, ro.record_scatter.launches,
            rg.launch_k1.launches) == before


def test_binned_run_catches_a_position_dependent_k1(monkeypatch):
    """The scatter-back gate bites: a K1 whose radiance depends on where a
    record sits fails the first permuted scheme."""
    def k1_by_position(inp, pool, r8, counts, k, t, frame, b_lo, b_hi, stats=None):
        rg.k1_plain(inp, pool, r8, counts, k, t, frame, b_lo, b_hi, stats=stats)
        r8[0, :int(counts[k])] += torch.arange(int(counts[k]), dtype=torch.float32)

    monkeypatch.setattr(binned, "_kernels",
                        lambda device: (rg.k0_plain, rg.pack_plain, k1_by_position))
    with pytest.raises(AssertionError, match=r"binned K1 \(oct\) scattered back differs"):
        binned.run(2, "rtiow", quick=True, device="cpu", width=64, height=32, bounces=3, reps=1)


def test_dump_saves_the_live_records(tmp_path, monkeypatch):
    monkeypatch.setattr(binned.tempfile, "gettempdir", lambda: str(tmp_path))
    lines = []
    assert binned.run(2, "rtiow", dump=True, device="cpu", width=64, height=32,
                      emit=lines.append) == []
    saved = np.load(lines[-1]["path"])
    n = lines[1]["n"]
    assert saved["recs"].shape == (n, rg.N_COMP) and (saved["recs"][:, rg._AL] == 1).all()
    assert saved["chunk_bounds"].shape == (6, 31) and int(saved["chunk_size"]) == 16


# --- the wrappers: CPU tensors take the twins, CUDA tensors launch or raise


class _Stub:
    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


@pytest.fixture
def stub_library(monkeypatch):
    stubs = {name: _Stub() for name in ("wrt_record_gather", "wrt_record_scatter",
                                        "wrt_dma_rate")}

    class _Built:
        lib = type("Lib", (), stubs)()

    monkeypatch.setattr(ro, "_device_type", lambda t: "cuda")
    monkeypatch.setattr(ro, "_library", lambda: _Built())
    monkeypatch.setattr(ro, "_stream_handle", lambda device: 77)
    for name in ("gather_plain", "scatter_plain", "dma_rate_plain"):
        monkeypatch.setattr(ro, name, _no_plain)
    return stubs


def _no_plain(*a, **k):
    raise AssertionError("the plain version ran for a CUDA tensor")


def test_cpu_tensors_never_reach_the_library(monkeypatch):
    def no_library():
        raise AssertionError("a CPU tensor reached the CUDA library")

    monkeypatch.setattr(ro, "_library", no_library)
    before = (ro.record_gather.launches, ro.record_scatter.launches, ro.dma_rate.launches)
    src = torch.arange(40.0).reshape(10, 4)
    idx = torch.tensor([3, 1], dtype=torch.int32)
    assert torch.equal(ro.record_gather(src, idx), src[[3, 1]])
    assert torch.equal(ro.record_scatter(src, idx, torch.zeros(10, 4))[[3, 1]], src[:2])
    ro.dma_rate(*dma.rate_inputs("cpu", 32))
    assert (ro.record_gather.launches, ro.record_scatter.launches,
            ro.dma_rate.launches) == before


@pytest.mark.parametrize("form", ["rows", "rows_odd", "columns"])
def test_reorder_wrappers_launch_for_cuda_tensors(form, stub_library):
    if form == "rows":
        src, dim, want = torch.zeros((300, 8, 128)), 0, (1, 1024, 0, 0)
    elif form == "rows_odd":
        src, dim, want = torch.zeros((30, 3)), 0, (1, 3, 0, 0)
    else:
        src, dim, want = torch.zeros((16, 4096)), 1, (16, 1, 4096, 8192)
    idx = torch.tensor([5, 0, 7], dtype=torch.int32)
    dst = torch.zeros((16, 8192)) if dim == 1 else None
    before = (ro.record_gather.launches, ro.record_scatter.launches)
    out = ro.record_gather(src, idx, dst, dim=dim)
    (args,) = stub_library["wrt_record_gather"].calls
    assert args[:4] == (src.data_ptr(), out.data_ptr(), idx.data_ptr(), 3)
    assert args[4:8] == want and args[8] == 77
    ro.record_scatter(out, idx, src, dim=dim)
    (args,) = stub_library["wrt_record_scatter"].calls
    assert args[:4] == (out.data_ptr(), src.data_ptr(), idx.data_ptr(), 3)
    assert args[4:6] == want[:2] and args[8] is None and args[9] == 77
    assert (ro.record_gather.launches, ro.record_scatter.launches) == (before[0] + 1,
                                                                       before[1] + 1)
    ro.record_gather(src, idx[:0], dst, dim=dim)  # nothing to move: no launch
    assert ro.record_gather.launches == before[0] + 1


@pytest.mark.parametrize("form", ["columns", "rows_narrow", "rows_wide"])
def test_record_scatter_inverts_exactly_when_the_list_covers_dst(form, stub_library):
    """A list that names every record of dst, of records narrower than an
    L2 sector, takes the inverse route (int32 scratch of n values, two
    launches counted); a shorter list, or wide records, store where the
    list points (no scratch, one launch)."""
    shape, dim = {"columns": ((16, 6), 1), "rows_narrow": ((6, 3), 0),
                  "rows_wide": ((6, 8), 0)}[form]
    src, dst = torch.zeros(shape), torch.zeros(shape)
    for idx, inverse in ((torch.tensor([3, 0, 5, 1, 4, 2], dtype=torch.int32),
                          form != "rows_wide"),
                         (torch.tensor([3, 0, 5], dtype=torch.int32), False)):
        stub_library["wrt_record_scatter"].calls.clear()
        before = ro.record_scatter.launches
        ro.record_scatter(src, idx, dst, dim=dim)
        (args,) = stub_library["wrt_record_scatter"].calls
        assert args[3] == idx.numel() and (args[8] is not None) == inverse
        assert ro.record_scatter.launches == before + (2 if inverse else 1)
    assert [ro.inverts(n, 6, w) for n, w in ((6, 1), (6, 7), (6, 8), (5, 1))] == [
        True, True, False, False]


def test_short_scatter_keeps_the_records_it_does_not_name():
    """The direct route's function, on the twin: records not named keep
    what dst held, in every bit."""
    src = torch.arange(48.0).reshape(16, 3).T.contiguous()
    dst = torch.full((3, 10), -7.0)
    idx = torch.tensor([9, 2, 4], dtype=torch.int32)
    ro.record_scatter(src, idx, dst, dim=1)
    named = torch.zeros(10, dtype=torch.bool)
    named[idx.long()] = True
    assert bool((dst[:, ~named] == -7.0).all()) and torch.equal(dst[:, idx.long()], src[:, :3])


def test_reorder_library_is_bound_and_looked_up_once(monkeypatch):
    """The library is built, loaded and bound on the first call and kept:
    later calls neither walk load_library again nor rebind."""
    loads, binds = [], []
    stub = _Stub()

    class _Lib:
        wrt_record_gather = stub

    class _Built:
        lib = _Lib()

    monkeypatch.setattr(ro, "_BUILT", None)
    monkeypatch.setattr(ro, "load_library", lambda *a: loads.append(a) or _Built())
    monkeypatch.setattr(ro, "bind", lambda lib: binds.append(lib))
    monkeypatch.setattr(ro, "_device_type", lambda t: "cuda")
    monkeypatch.setattr(ro, "_stream_handle", lambda device: 77)
    src, idx = torch.zeros((10, 4)), torch.tensor([3, 1], dtype=torch.int32)
    for _ in range(3):
        ro.record_gather(src, idx)
    assert loads == [ro.LIBRARY] and len(binds) == 1 and len(stub.calls) == 3


def test_dma_rate_launches_for_cuda_tensors(stub_library):
    pool, perm = dma.rate_inputs("cpu", 64)
    before = ro.dma_rate.launches
    out = ro.dma_rate(pool, perm)
    (args,) = stub_library["wrt_dma_rate"].calls
    assert args == (pool.data_ptr(), perm.data_ptr(), out.data_ptr(), 2, 11 * 128, 128, 77)
    assert tuple(out.shape) == (16, 128) and ro.dma_rate.launches == before + 1


@pytest.mark.parametrize("which", ["wrt_record_gather", "wrt_record_scatter", "wrt_dma_rate"])
def test_reorder_wrappers_raise_on_launch_error(which, stub_library):
    stub_library[which].rc = 700
    before = (ro.record_gather.launches, ro.record_scatter.launches, ro.dma_rate.launches)
    src, idx = torch.zeros((64, 11, 128)), torch.arange(64, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="launch failed: CUDA error 700"):
        if which == "wrt_record_gather":
            ro.record_gather(src, idx)
        elif which == "wrt_record_scatter":
            ro.record_scatter(src, idx, torch.zeros_like(src))
        else:
            ro.dma_rate(src, idx)
    assert (ro.record_gather.launches, ro.record_scatter.launches,
            ro.dma_rate.launches) == before


@pytest.mark.parametrize("bad", ["dtype", "index_dtype", "records", "width", "rate_tiles",
                                 "rate_width", "dim"])
def test_reorder_wrappers_refuse_what_the_kernels_do_not_take(bad):
    src, idx = torch.zeros((64, 11, 128)), torch.arange(64, dtype=torch.int32)
    with pytest.raises(ValueError):
        if bad == "dtype":
            ro.record_gather(src.double(), idx)
        elif bad == "index_dtype":
            ro.record_gather(src, idx.long())
        elif bad == "records":
            ro.record_gather(src, idx, torch.zeros((10, 11, 128)))
        elif bad == "width":
            ro.record_scatter(src, idx, torch.zeros((64, 11, 64)))
        elif bad == "rate_tiles":
            ro.dma_rate(src, idx[:40])
        elif bad == "rate_width":
            ro.dma_rate(torch.zeros((64, 2, 1000)), idx)
        else:
            ro.record_gather(src, idx, dim=2)


def test_prep_chunk_bounds_are_the_probe_chunk_arrays(binning):
    """The port's chunk keys read KernelInputs.chunk_bounds; they are the
    JAX prepare_scene_arrays chunk arrays the probe reads."""
    t = binning["t"]
    (jscene, _, jbasis), _ = trg._setup("rtiow", t.width, t.height)
    _, (_, chunk_arrays, *_) = trg._jax_scene_arrays(jscene, jbasis)
    np.testing.assert_array_equal(binning["inp"].chunk_bounds.numpy(),
                                  np.stack([np.asarray(a) for a in chunk_arrays[:6]]))
    assert jmk.default_chunk_size(486) == binning["inp"].chunk_size
