"""The port's sweep probe kernels against benchmarks/probe_mxu_sweep.py, on
the CPU.

The probe script is loaded as it is, with its ``_call`` (bound to
``pl.pallas_call`` when the script is imported) replaced by an
interpret-mode wrapper that records each kernel's inputs and outputs, and
its ``timed`` by a single call. p1, p2, p3 and p4 run as they are; the
sweep kernels (p5's, p7's and p8's) are built from the script's own kernel
factories, with its in_specs, one pass, on its own inputs (``_scene``).
Each JAX kernel is held against the port's twin on the captured inputs:

- 13a (p1, 2x + 1) and 13b (p2, reversed rows): bit for bit.
- 13c (p3): the FP32 twin equals the probe's numpy FMA-order reference bit
  for bit. In interpret mode on the CPU both of the probe's precisions are
  float32 dots: they are within 16 * 2^-24 of sum_k |a_k| |b_k| of the
  FP32 twin (two float32 sums of the same eight products in any orders
  differ by at most twice gamma_8 ~ 8 * 2^-24 of that magnitude), the
  TF32 twin within 2^-10 more (each operand rounded to 10 mantissa bits
  moves a product by at most 2 * 2^-11 of its size) and the 3xTF32 twin
  within 2^-19 (the dropped lo.lo term and lo's own rounding: 3 * 2^-22).
- 13d (p4): each of the five chains within a relative 5e-5 of the twin
  (256 steps, each rounded once or twice: 256 * 3 * 2^-24 = 4.6e-5).
- 13e-13i: the hit and miss masks equal, the index equal on every hit and
  t within the probe's own tolerances (rtol = atol = 1e-5 for p5's forms,
  1e-4 for p7's and p8's), against the FMA twin and the FP32 and 3xTF32
  forms of the tensor-core twin; on a grazing ray (under 1% of the hits)
  t may move further by the rounding of its discriminant over 2 sqrt(disc),
  which XLA's contraction into FMAs and the twin's separate roundings both
  meet (one ray of p5's 370 hits parts by 1.8e-4, with sqrt(disc) =
  0.016). The TF32 twin (one product on operands rounded to 10 bits) is
  held to TF32's own error bound (test_tf32_sweep_within_its_rounding_of_jax).

Then the slice as a whole: every probe of ``probes/mxu_sweep.py`` on the
CPU at reduced sizes (its twins; each checks its own gates), and the
wrappers: CPU tensors never reach the library, CUDA tensors launch and
count, a launch error raises, shapes the kernels do not take are refused.

The module runs PyTorch on one thread and computes each JAX reference once.
"""
import contextlib
import importlib.util
import io
import pathlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from weekend_raytracer_tpu_torch.ops.cuda import sweep as sw  # noqa: E402
from weekend_raytracer_tpu_torch.probes import HBM_RATE  # noqa: E402
from weekend_raytracer_tpu_torch.probes import mxu_sweep as ms  # noqa: E402

_PROBE = pathlib.Path(__file__).resolve().parents[1] / "benchmarks" / "probe_mxu_sweep.py"
U = 2.0 ** -24  # float32's unit roundoff


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twins' small tensors gain nothing from intra-op threads, and
    beside the other test workers those threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _NoJit:
    """The jax module with ``jit`` as the identity: p4 jits its recorded
    call, whose recording must see concrete arrays."""

    def __getattr__(self, name):
        return (lambda f: f) if name == "jit" else getattr(jax, name)


def _load(calls):
    """The probe script, its _call recording (inputs, outputs) as numpy."""
    spec = importlib.util.spec_from_file_location("_bench_probe_mxu_sweep", _PROBE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)

    def recording(kernel, **kwargs):
        call = pl.pallas_call(kernel, interpret=True, **kwargs)

        def run(*inputs):
            out = call(*inputs)
            calls.append(([np.asarray(x) for x in inputs],
                          jax.tree_util.tree_map(np.asarray, out)))
            return out

        return run

    module._call = recording
    module.timed = lambda fn, *args, iters=20: (1.0, fn(*args))
    module.jax = _NoJit()
    return module


@pytest.fixture(scope="module")
def probe():
    """The loaded script and the recorded calls of p1, p2, p3 and p4."""
    runs = {}
    module = None
    for name in ("p1", "p2", "p3", "p4"):
        calls = []
        module = _load(calls)
        with contextlib.redirect_stdout(io.StringIO()) as out:
            getattr(module, name)()
        runs[name] = (calls, out.getvalue())
    return module, runs


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


# --- 13a, 13b: layout, remap mode ----------------------------------------

def test_p1_reshape_affine_bit_for_bit(probe):
    _, runs = probe
    calls, printed = runs["p1"]
    assert "LOWERS, correct = True" in printed and len(calls) == 1
    (x,), out = calls[0]
    got = sw.layout_remap(_t(x), affine=(2.0, 1.0))
    assert _same_bits(got.numpy(), out)


def test_p2_reversed_concat_bit_for_bit(probe):
    _, runs = probe
    calls, printed = runs["p2"]
    assert "LOWERS, correct = True" in printed and len(calls) == 1
    (a,), out = calls[0]
    assert _same_bits(sw.layout_remap(_t(a), reverse=True).numpy(), out)


# --- 13c: dot_mma --------------------------------------------------------

def test_p3_fp32_twin_is_the_fma_order_reference(probe):
    _, runs = probe
    calls, _ = runs["p3"]
    (a, b), _ = calls[0]
    ref = np.zeros((64, 4096), np.float32)
    for kk in range(8):
        ref += a[:, kk:kk + 1] * b[kk:kk + 1, :]
    assert _same_bits(sw.dot_mma(_t(a), _t(b), "fp32").numpy(), ref)
    an, bn, ref_ms = ms.dot_inputs()
    assert _same_bits(an, a) and _same_bits(bn, b) and _same_bits(ref_ms, ref)


@pytest.mark.parametrize("which", [0, 1])  # precision "highest", then the default
@pytest.mark.parametrize("prec, extra", [("fp32", 0.0), ("tf32", 2.0 ** -10),
                                         ("3xtf32", 2.0 ** -19)])
def test_p3_jax_dot_within_twin_bound(probe, which, prec, extra):
    _, runs = probe
    calls, _ = runs["p3"]
    assert len(calls) == 2
    (a, b), out = calls[which]
    mag = np.abs(a) @ np.abs(b)
    twin = sw.dot_plain(_t(a), _t(b), prec).numpy()
    assert (np.abs(out - twin) <= (16 * U + extra) * mag).all()


def test_p3_fill_case_runs_through_the_twin(monkeypatch):
    """p3's card-filling case, A[64, 8] . B[8, N] at a small N on the CPU:
    the twin's FP32 product (no error against itself), TF32 and 3xTF32
    within DOT_TOL, the byte bound of A, B and C, B drawn as dot_fill_b
    draws it, and exactly the dot_mma calls ``dot_launches`` counts (less
    the profiler's, which need the card)."""
    calls = []

    def counted(*a, _fn=sw.dot_mma, **k):
        calls.append(a[2] if len(a) > 2 else k.get("prec", "fp32"))
        return _fn(*a, **k)

    monkeypatch.setattr(sw, "dot_mma", counted)
    out = ms.p3("cpu", reps=1, fill_cols=1024)
    fill = out["fill"]
    assert fill["shape"] == [64, 8, 1024] and out["fp32"]["bit_identical"]
    assert fill["fp32"]["max_abs_err"] == 0.0
    for prec in sw.PRECISIONS:
        assert fill[prec]["bound_by"] == "bytes"
        assert fill[prec]["bound_ms"] == pytest.approx(
            (64 * 8 + 8 * 1024 + 64 * 1024) * 4 / HBM_RATE * 1e3)
        assert fill[prec]["host_ms"] > 0 and fill[prec]["ms"] > 0
    assert set(fill["library_ms"]) == {"fp32", "tf32"}
    assert len(calls) == ms.dot_launches(reps=1, device_reps=0)
    assert sorted(set(calls)) == sorted(sw.PRECISIONS)
    b = ms.dot_fill_b(1024)
    assert b.shape == (8, 1024) and _same_bits(b, ms.dot_fill_b(1024))


# --- 13d: layout, chain mode ---------------------------------------------

def test_p4_chains_within_relative_tolerance(probe):
    _, runs = probe
    calls, _ = runs["p4"]
    assert [c[0][0].shape for c in calls] == list(ms.CHAIN_SHAPES)
    for (x,), out in calls:
        for chains in (1, 4):
            got = sw.layout_chain(_t(x), 256, chains).numpy()
            assert (np.abs(got - out) <= ms.CHAIN_RTOL * np.abs(out)).all()


# --- 13e-13i: the sweeps -------------------------------------------------

def _smem():
    return pl.BlockSpec(memory_space=pltpu.SMEM)


def _vmem():
    return pl.BlockSpec(memory_space=pltpu.VMEM)


_PLANE_OUT = [jax.ShapeDtypeStruct((32, 128), jnp.float32)] * 2


@pytest.fixture(scope="module")
def sweeps(probe):
    """Each JAX sweep kernel, one pass, on the probe's inputs: {case:
    (t [4096], index [4096] as int32, port inputs)}. The scalar-broadcast
    forms take the SMEM sphere rows and the (32, 128) planes, the MXU forms
    p5's amat and bmat or amats and the planes."""
    module, _ = probe
    out = {}
    for n_chunks, cs in ((1, 32), (10, 32), (20, 16)):
        s = n_chunks * cs
        c, r, o, d = module._scene(s, 4096)
        kq = (c * c).sum(1) - r * r
        planes = [jnp.asarray(v.reshape(32, 128)) for v in (*o, *d)]
        rows = [jnp.asarray(v.reshape(1, -1)) for v in (c[:, 0], c[:, 1], c[:, 2], kq)]
        port = {"table": ms.probe_table(c, kq, "cpu"), "planes": ms.probe_planes(o, d, "cpu"),
                "c": c, "kq": kq, "o": o, "d": d}
        if n_chunks == 1:
            vpu = module._vpu_sweep_kernel(s, 1)
            amat, bmat = ms.probe_amat(c, kq), ms.probe_bmat(o, d)
            port.update(amats=_t(amat.T[None].copy()), bmat=_t(bmat))
            for prec in ("highest", None):
                t, i = pl.pallas_call(
                    module._mxu_sweep_kernel(s, 1, prec),
                    out_shape=[jax.ShapeDtypeStruct((32, 4096), jnp.float32)] * 2,
                    interpret=True)(jnp.asarray(amat), jnp.asarray(bmat))
                out[f"13f_{prec}"] = (np.asarray(t)[0], np.asarray(i)[0].astype(np.int32), port)
            t, i = pl.pallas_call(module._rowdot_sweep_kernel(s, 1, "highest"),
                                  in_specs=[_vmem()] * 7, out_specs=[_vmem()] * 2,
                                  out_shape=_PLANE_OUT, interpret=True)(jnp.asarray(amat),
                                                                        *planes)
            out["13g"] = (np.asarray(t).ravel(), np.asarray(i).ravel().astype(np.int32), port)
            name = "13e"
        else:
            vpu = module._chunked_vpu_kernel(n_chunks, cs, 1)
            amats = ms.probe_amats(c, kq, n_chunks, cs)
            port.update(amats=_t(amats))
            t, i = pl.pallas_call(module._chunked_mxu_kernel(n_chunks, cs, 1, "highest"),
                                  in_specs=[_vmem()] * 7, out_specs=[_vmem()] * 2,
                                  out_shape=_PLANE_OUT, interpret=True)(jnp.asarray(amats),
                                                                        *planes)
            out[f"13i_cs{cs}"] = (np.asarray(t).ravel(), np.asarray(i).ravel().astype(np.int32),
                                  port)
            name = f"13h_cs{cs}"
        t, i = pl.pallas_call(vpu, in_specs=[_smem()] * 4 + [_vmem()] * 6,
                              out_specs=[_vmem()] * 2, out_shape=_PLANE_OUT,
                              interpret=True)(*rows, *planes)
        out[name] = (np.asarray(t).ravel(), np.asarray(i).ravel().astype(np.int32), port)
    return out


def _root_slack(port, idx):
    """Per hit ray, how far float32 may move t beyond the probe's
    tolerance: t = b -+ sqrt(b^2 - cq), and rounding b^2 - cq (a few units
    of b^2 + |cq|) moves the root by that over 2 sqrt(b^2 - cq), which a
    grazing ray makes large. In float64 from the probe's inputs."""
    c, kq = port["c"].astype(np.float64)[idx], port["kq"].astype(np.float64)[idx]
    o = port["o"].T.astype(np.float64)
    d = port["d"].T.astype(np.float64)
    b = ((c - o) * d).sum(1)
    cq = (o * o).sum(1) - 2 * (c * o).sum(1) + kq
    sq = np.sqrt(np.maximum(b * b - cq, 0.0))
    return 8 * U * (b * b + np.abs(cq)) / (2 * np.maximum(sq, 1e-30))


def _hold(ref, got, tol, port):
    """The masks equal, the index equal on every hit, t within the probe's
    tolerance (rtol = atol = tol) plus the root's conditioning
    (_root_slack), which only grazing rays (under 1% of the hits) need."""
    (tr, ir), (tg, ig) = ref, (got[0].numpy(), got[1].numpy())
    hit = ir >= 0
    assert np.array_equal(hit, ig >= 0)
    assert np.array_equal(ir[hit], ig[hit])
    err = np.abs(tg[hit] - tr[hit])
    within = err <= tol + tol * np.abs(tr[hit])
    slack = _root_slack(port, ir)[hit]
    assert (within | (err <= tol + tol * np.abs(tr[hit]) + slack)).all()
    assert (~within).mean() <= 0.01
    assert (tg[~hit] == np.float32(sw.MAX_T)).all() and (tr[~hit] >= np.float32(sw.MAX_T)).all()
    return hit.mean()


def test_probe_scene_is_restated(probe):
    module, _ = probe
    for s, n in ((32, 4096), (320, 4096), (496, 1000)):
        for mine, theirs in zip(ms.scene(s, n), module._scene(s, n)):
            assert _same_bits(mine, theirs)


# case -> (port kernel, tolerance): the probe's own (:302, :419, :585)
_FMA_CASES = {"13e": 1e-5, "13h_cs32": 1e-4, "13h_cs16": 1e-4}
_MMA_CASES = {"13f_highest": 1e-5, "13f_None": 1e-5, "13g": 1e-4, "13i_cs32": 1e-4,
              "13i_cs16": 1e-4}


@pytest.mark.parametrize("case", list(_FMA_CASES))
def test_fma_sweep_matches_jax(sweeps, case):
    t, i, port = sweeps[case]
    chunk = 32 if case == "13e" else int(case.split("cs")[1])
    got = sw.sweep_fma(port["table"], port["planes"], chunk, iters=2)
    share = _hold((t, i), got, _FMA_CASES[case], port)
    assert 0.02 < share < 0.9  # 9% of the rays hit 32 spheres, 58% hit 320


@pytest.mark.parametrize("prec", ["fp32", "3xtf32"])
@pytest.mark.parametrize("case", list(_MMA_CASES))
def test_mma_sweep_matches_jax(sweeps, case, prec):
    t, i, port = sweeps[case]
    rays = port.get("bmat") if case.startswith("13f") else port["planes"]
    if prec == "fp32":
        got = sw.sweep_plain(port["amats"], rays, "fp32")
    else:
        got = sw.sweep_mma(port["amats"], rays, prec, iters=2)
    _hold((t, i), got, _MMA_CASES[case], port)


def _tf32_bound(port, idx):
    """Per ray and sphere idx, float64 from the probe's inputs: (t, disc,
    the bound on how far TF32 operands move t, and disc). Rounding each
    operand to 10 bits moves a product by at most 2^-10 of it, so b by
    db = 2^-10 sum |c_k d_k| and cq by dq = 2^-10 (2 sum |c_k o_k| + |kq|),
    disc = b^2 - cq by dd = 2 |b| db + dq, and sqrt(disc) by at most
    min(dd / (2 sqrt(disc)), sqrt(dd))."""
    c, kq = port["c"].astype(np.float64)[idx], port["kq"].astype(np.float64)[idx]
    o = port["o"].T.astype(np.float64)
    d = port["d"].T.astype(np.float64)
    b = ((c - o) * d).sum(1)
    cq = (o * o).sum(1) - 2 * (c * o).sum(1) + kq
    disc = b * b - cq
    sq = np.sqrt(np.maximum(disc, 0.0))
    t0 = b - sq
    t = np.where(t0 > sw.MIN_T, t0, b + sq)
    db = 2.0 ** -10 * np.abs(c * d).sum(1)
    dd = 2 * np.abs(b) * db + 2.0 ** -10 * (2 * np.abs(c * o).sum(1) + np.abs(kq))
    dsq = np.minimum(dd / (2 * np.maximum(sq, 1e-30)), np.sqrt(dd))
    return t, disc, db + dsq + 1e-4 * (1 + np.abs(t)), dd


@pytest.mark.parametrize("case", ["13f_highest", "13g", "13i_cs32", "13i_cs16"])
def test_tf32_sweep_within_its_rounding_of_jax(sweeps, case):
    """One TF32 product (the probe's default precision): where the twin
    and JAX's float32 sweep take the same sphere, t within the bound of
    _tf32_bound; a hit gained or lost only where the discriminant or the
    root lies within that bound of its limit (a grazing ray, or t at
    MIN_T); the same sphere on 99% of the rays both hit (a near tie may
    part). At 32 spheres TF32 leaves t within 1e-3 on under half of the
    hits (kq, up to |c|^2 = 192, moves by up to 0.1)."""
    t, i, port = sweeps[case]
    rays = port.get("bmat") if case.startswith("13f") else port["planes"]
    tg, ig = (x.numpy() for x in sw.sweep_mma(port["amats"], rays, "tf32"))
    hit, hit_g = i >= 0, ig >= 0
    t64, disc, dt, dd = _tf32_bound(port, np.where(hit, i, ig).clip(0))
    flip = hit != hit_g
    assert flip.mean() < 0.02
    assert ((np.abs(disc) <= dd) | (np.abs(t64 - sw.MIN_T) <= dt))[flip].all()
    both = hit & hit_g
    assert (ig[both] == i[both]).mean() >= 0.99
    same = both & (ig == i)
    assert (np.abs(tg - t) <= dt)[same].all()


def test_tf32_products_are_fp32_on_tf32_operands(sweeps):
    """The twins' tf32 product is the fp32 product of operands rounded as
    cvt.rna rounds them, in every bit; 3xtf32's hi and lo terms leave at
    most 2^-22 of the operand out."""
    _, _, port = sweeps["13i_cs16"]
    a, b = port["amats"][3].transpose(0, 1), sw.packed_b(port["planes"])
    got = sw.dot_plain(a, b, "tf32")
    assert _same_bits(got.numpy(), sw.dot_plain(sw.tf32_round(a), sw.tf32_round(b)).numpy())
    hi = sw.tf32_round(b)
    lo = sw.tf32_round(b - hi)
    assert bool(((hi + lo - b).abs() <= 2.0 ** -22 * b.abs()).all())


def test_p7_numpy_reference_agrees(sweeps):
    t, _, port = sweeps["13g"]
    ref = ms.numpy_closest(port["c"], port["kq"], port["o"], port["d"])
    assert np.isclose(ref, t, rtol=1e-4, atol=1e-4).all()


def test_sphere_amats_is_the_probes(sweeps):
    """The port's amats of a sweep table equal p8's construction."""
    for case, cs in (("13i_cs32", 32), ("13i_cs16", 16)):
        _, _, port = sweeps[case]
        assert _same_bits(sw.sphere_amats(port["table"], cs).numpy(), port["amats"].numpy())
    _, _, port = sweeps["13g"]
    assert _same_bits(sw.sphere_amats(port["table"], 32).numpy(), port["amats"].numpy())
    assert _same_bits(sw.packed_b(port["planes"]).numpy(), port["bmat"].numpy())


def test_tf32_round_is_cvt_rna():
    """Ties away from zero on the 13 dropped bits; inf, NaN and -0 kept."""
    bits = np.array([0x3F800000, 0x3F800FFF, 0x3F801000, 0x3F802FFF, 0x3F803000, 0xBF801000,
                     0x7F7FF000, 0x7F800000, 0x7FC00001, 0x80000000, 0x00001000],
                    dtype=np.uint32)
    want = np.array([0x3F800000, 0x3F800000, 0x3F802000, 0x3F802000, 0x3F804000, 0xBF802000,
                     0x7F800000, 0x7F800000, 0x7FC00001, 0x80000000, 0x00002000],
                    dtype=np.uint32)
    got = sw.tf32_round(torch.from_numpy(bits.view(np.float32).copy())).numpy()
    assert np.array_equal(got.view(np.uint32), want)


def test_the_port_never_imports_jax():
    for path in (sw.__file__, ms.__file__):
        assert "jax" not in pathlib.Path(path).read_text()


# --- the slice as a whole ------------------------------------------------

_SMALL = {"p1": dict(big=4096 * 4, reps=1), "p2": dict(big=4096 * 4, reps=1),
          "p3": dict(reps=1, fill_cols=2048), "p4": dict(big=4096 * 4, reps=1, steps=64),
          "p6": dict(rows=(64,), reps=1), "fill": dict(rays=2048, reps=1),
          "window": dict(rays=512)}


@pytest.mark.parametrize("name", [n for n, _ in ms.PROBES])
def test_probe_runs_on_the_cpu(name, capsys):
    kw = _SMALL.get(name, dict(fill_rays=2048, reps=1))
    before = sw.launch_counts()
    assert ms.run(name, dict(ms.PROBES)[name], "cpu", **kw)
    assert capsys.readouterr().out.startswith(f"[ok]   {name}: ")
    assert sw.launch_counts() == before  # the twins ran


def test_fill_inputs_are_rtiows_sweep_table():
    table, planes = ms.fill_inputs("cpu", 512)
    assert tuple(table.shape) == (496, 4) and tuple(planes.shape) == (6, 512)
    _, _, o, d = ms.scene(496, 512)
    assert _same_bits(planes.numpy(), np.concatenate([o, d]))
    t, i = sw.sweep_fma(table, planes, 16)
    assert 0.2 < float((i >= 0).float().mean()) <= 1.0 and int(i.max()) < 496


def test_hold_sweep_catches_a_wrong_kernel():
    table, planes = ms.fill_inputs("cpu", 1024)
    want = sw.sweep_plain(table, planes, "fma")
    wrong_t = want[0].clone()
    wrong_t[want[1] >= 0] *= 1.001
    with pytest.raises(AssertionError, match="WRONG"):
        ms.hold_sweep((wrong_t, want[1]), want, table, planes, "scaled t")
    wrong_i = torch.where(want[1] >= 0, want[1] + 1, want[1])
    with pytest.raises(AssertionError, match="WRONG"):
        ms.hold_sweep((want[0], wrong_i), want, table, planes, "shifted index")
    held = ms.hold_sweep(want, want, table, planes, "itself")
    assert held["mask_agree"] == held["idx_agree"] == held["t_agree"] == 1.0


def test_hold_sweep_allows_only_its_wrong_share():
    """One ray of 1024 moved: refused with no wrong share (the probe's
    shapes), passed at a share of 1/100, and FILL_WRONG_SHARE is the
    share the card-filling shape allows."""
    table, planes = ms.fill_inputs("cpu", 1024)
    want = sw.sweep_plain(table, planes, "fma")
    wrong_i = want[1].clone()
    wrong_i[int(torch.nonzero(want[1] >= 0)[0])] += 1
    with pytest.raises(AssertionError, match="WRONG"):
        ms.hold_sweep((want[0], wrong_i), want, table, planes, "one ray")
    held = ms.hold_sweep((want[0], wrong_i), want, table, planes, "one ray", 1e-2)
    assert 1.0 - 1e-2 <= held["idx_agree"] < 1.0
    assert ms.FILL_WRONG_SHARE == 1e-5


def test_tile_control_is_the_fewest_hits_a_tile_holds():
    idx = torch.tensor([0, 3, 17, 17, 40, -1, 47, 33], dtype=torch.int32)
    # tiles 0: 2 rays, 1: 2, 2: 3 (33, 40, 47); tile 3 holds no hit
    assert ms.tile_control(idx, 64) == 2 / 8


def test_sweep_bounds_count_what_the_sweep_needs():
    """fill's bounds: for the FMA sweep 15 FP32 operations a pair (2c is
    staged) and 3 more (the root, t0, t1) for each pair a pass with a real
    root; for the tensor-core sweep the larger of 14 product flops a pair
    (42 for 3xTF32) over the TF32 rate and the epilogue over the FP32 rate:
    4 operations a pair (b, cq, b^2 - cq) and the same 3 for each pair a
    pass with a real root. At the fill's 0.46% of such pairs that is the
    epilogue at TF32 and the products at 3xTF32."""
    n, r = 496, 2_097_152
    pairs = n * r
    kept = int(pairs * 0.0046)
    fma = ms.fma_bound(n, r, 1, kept)
    assert fma["bound_by"] == "operations"
    assert fma["bound_ms"] == pytest.approx((pairs * 15 + kept * 3) / 67e12 * 1e3)
    assert ms.fma_bound(n, r, 2, kept)["bound_ms"] == pytest.approx(2 * fma["bound_ms"])
    for prec, products, by in (("tf32", 1, "epilogue_ms"), ("3xtf32", 3, "mma_ms")):
        b = ms.mma_bound(n, r, 1, prec, False, kept)
        assert b["mma_ms"] == pytest.approx(pairs * 14 * products / 495e12 * 1e3)
        assert b["epilogue_ms"] == pytest.approx((pairs * 4 + kept * 3) / 67e12 * 1e3)
        assert b["bound_ms"] == b[by] and b["bound_by"] == "operations"
        twice = ms.mma_bound(n, r, 2, prec, False, kept)
        assert twice["epilogue_ms"] == pytest.approx(2 * b["epilogue_ms"])


# --- the wrappers: CPU tensors take the twins, CUDA tensors launch or raise


class _Stub:
    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


_C_FUNCTIONS = ("wrt_sweep_fma", "wrt_sweep_mma", "wrt_dot_mma", "wrt_layout_remap",
                "wrt_layout_chain")


@pytest.fixture
def stub_library(monkeypatch):
    stubs = {name: _Stub() for name in _C_FUNCTIONS}

    class _Built:
        lib = types.SimpleNamespace(**stubs)

    monkeypatch.setattr(sw, "_device_type", lambda t: "cuda")
    monkeypatch.setattr(sw, "_library", lambda: _Built())
    monkeypatch.setattr(sw, "_stream_handle", lambda device: 77)
    for name in ("sweep_plain", "dot_plain", "remap_plain", "chain_plain"):
        monkeypatch.setattr(sw, name, _no_plain)
    return stubs


def _no_plain(*a, **k):
    raise AssertionError("the plain version ran for a CUDA tensor")


def _small_sweep():
    table, planes = ms.fill_inputs("cpu", 300)
    return table, planes, sw.sphere_amats(table, 16)


def test_cpu_tensors_never_reach_the_library(monkeypatch):
    def no_library():
        raise AssertionError("a CPU tensor reached the CUDA library")

    monkeypatch.setattr(sw, "_library", no_library)
    before = sw.launch_counts()
    table, planes, amats = _small_sweep()
    sw.sweep_fma(table, planes, 16)
    for prec in ("tf32", "3xtf32"):
        sw.sweep_mma(amats, planes, prec)
    sw.dot_mma(torch.ones((16, 8)), torch.ones((8, 8)))
    sw.layout_remap(torch.ones((2, 8)), reverse=True)
    sw.layout_chain(torch.ones(5), 3)
    assert sw.launch_counts() == before


def test_sweep_wrappers_launch_for_cuda_tensors(stub_library):
    table, planes, amats = _small_sweep()
    sw.zero_launch_counts()
    t, i = sw.sweep_fma(table, planes, 16, iters=3)
    (args,) = stub_library["wrt_sweep_fma"].calls
    assert args == (table.data_ptr(), 496, 16, planes.data_ptr(), 300, 3, t.data_ptr(),
                    i.data_ptr(), 77)
    assert t.dtype == torch.float32 and i.dtype == torch.int32 and tuple(t.shape) == (300,)
    bmat = sw.packed_b(planes)
    sw.sweep_fma(table, planes)
    assert stub_library["wrt_sweep_fma"].calls[1][1:3] == (496, 496)
    t, i = sw.sweep_mma(amats, bmat, "tf32", iters=2)
    sw.sweep_mma(amats, planes, "3xtf32")
    calls = stub_library["wrt_sweep_mma"].calls
    assert calls[0] == (amats.data_ptr(), 31, 16, bmat.data_ptr(), 1, 300, 2, 1, t.data_ptr(),
                        i.data_ptr(), 77)
    assert calls[1][3:8] == (planes.data_ptr(), 0, 300, 1, 2)
    assert sw.launch_counts() == {"sweep_fma": 2, "sweep_mma_tf32": 1, "sweep_mma_3xtf32": 1,
                                  "dot_mma": 0, "layout": 0}


def test_dot_and_layout_wrappers_launch_for_cuda_tensors(stub_library):
    sw.zero_launch_counts()
    a, b = torch.ones((64, 8)), torch.ones((8, 4096))
    c = sw.dot_mma(a, b, "3xtf32")
    assert stub_library["wrt_dot_mma"].calls == [(a.data_ptr(), b.data_ptr(), c.data_ptr(), 64,
                                                  4096, 2, 77)]
    x = torch.ones((6, 4096))
    y = sw.layout_remap(x, reverse=True)
    z = sw.layout_remap(x, affine=(2.0, 1.0))
    calls = stub_library["wrt_layout_remap"].calls
    assert calls[0] == (x.data_ptr(), y.data_ptr(), 6, 4096, 1, 0, 1.0, 0.0, 77)
    assert calls[1] == (x.data_ptr(), z.data_ptr(), 6, 4096, 0, 1, 2.0, 1.0, 77)
    w = sw.layout_chain(x, 256, 4)
    assert stub_library["wrt_layout_chain"].calls == [(x.data_ptr(), w.data_ptr(), 6 * 4096,
                                                       256, 4, sw.CHAIN_C, 77)]
    assert sw.launch_counts() == {"sweep_fma": 0, "sweep_mma_tf32": 0, "sweep_mma_3xtf32": 0,
                                  "dot_mma": 1, "layout": 3}


@pytest.mark.parametrize("which", _C_FUNCTIONS)
def test_wrappers_raise_on_launch_error(which, stub_library):
    stub_library[which].rc = 700
    table, planes, amats = _small_sweep()
    before = sw.launch_counts()
    with pytest.raises(RuntimeError, match="launch failed: CUDA error 700"):
        if which == "wrt_sweep_fma":
            sw.sweep_fma(table, planes)
        elif which == "wrt_sweep_mma":
            sw.sweep_mma(amats, planes, "tf32")
        elif which == "wrt_dot_mma":
            sw.dot_mma(torch.ones((16, 8)), torch.ones((8, 8)))
        elif which == "wrt_layout_remap":
            sw.layout_remap(torch.ones((2, 8)))
        else:
            sw.layout_chain(torch.ones(8))
    assert sw.launch_counts() == before


@pytest.mark.parametrize("bad", ["table_width", "rays_rows", "chunk", "iters", "amats_depth",
                                 "amats_chunk", "precision", "dot_m", "dot_n", "dot_k",
                                 "remap_cols", "remap_rows", "chains", "dtype", "devices"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    table, planes, amats = _small_sweep()
    with pytest.raises(ValueError):
        if bad == "table_width":
            sw.sweep_fma(table[:, :3].contiguous(), planes)
        elif bad == "rays_rows":
            sw.sweep_fma(table, sw.packed_b(planes))
        elif bad == "chunk":
            sw.sweep_fma(table, planes, sw.MAX_FMA_CHUNK + 1)
        elif bad == "iters":
            sw.sweep_mma(amats, planes, "tf32", iters=0)
        elif bad == "amats_depth":
            sw.sweep_mma(amats[:, :6].contiguous(), planes)
        elif bad == "amats_chunk":
            sw.sweep_mma(torch.zeros((2, 8, 24)), planes)
        elif bad == "precision":
            sw.sweep_mma(amats, planes, "fp32")
        elif bad == "dot_m":
            sw.dot_mma(torch.ones((24, 8)), torch.ones((8, 8)))
        elif bad == "dot_n":
            sw.dot_mma(torch.ones((16, 8)), torch.ones((8, 12)))
        elif bad == "dot_k":
            sw.dot_mma(torch.ones((16, 4)), torch.ones((4, 8)))
        elif bad == "remap_cols":
            sw.layout_remap(torch.ones((2, 6)))
        elif bad == "remap_rows":
            sw.layout_remap(torch.ones((70000, 4)))
        elif bad == "chains":
            sw.layout_chain(torch.ones(8), chains=2)
        elif bad == "dtype":
            sw.layout_chain(torch.ones(8, dtype=torch.float64))
        else:
            sw.sweep_fma(table, planes.to("meta"))
