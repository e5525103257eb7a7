"""benchmarks/probe_mxu_sweep.py's probes on the port's sweep kernels: can
the closest-hit sweep's c.d and c.o ride the H100's tensor cores?

Each probe is built from the TPU probe's own inputs (``scene`` restates its
``_scene``; ``probe_amat``, ``probe_bmat`` and ``probe_amats`` its matrices)
and runs through ``ops/cuda/sweep.py``; each checks every kernel against
its plain twin (``hold_sweep``'s gates for the sweeps) and prints what the
TPU probe prints, with the bound, its share and the card:

    p1      (32, 128) -> 2x + 1 through shared memory       layout_remap
    p2      six (1, 4096) rows in reverse                   layout_remap
    p3      A[64, 8] . B[8, 4096], FP32 k order, TF32 and   dot_mma
            3xTF32, against the probe's FMA-order reference;
            then A[64, 8] . B[8, 2^20] (card-filling)
    p4      256-step acc = acc * v + 1e-7 on the probe's    layout_chain
            shapes, 1 and 4 chains a thread
    p5      32 spheres x 4096 rays x 64 passes: the FMA     sweep_fma,
            sweep against the tensor-core sweep (packed B)  sweep_mma
    p6      (R, 16, 128) -> (16, R, 128) transpose          PyTorch yardstick
    p7      p5's tensor-core sweep from the SoA planes      sweep_mma
    p8      320 spheres in 10 chunks of 32 x 16 passes,     sweep_fma,
            FMA against tensor cores (p8c16: 20 x 16)       sweep_mma
    fill    the sweep's anatomy at the card-filling shape:  sweep_fma,
            chunking, TF32, 3xTF32                          sweep_mma
    window  1024 spheres (64 tiles: three of 3xTF32's       sweep_mma
            shared-memory windows, two of TF32's) x 4096
            rays, held exactly

The probe's precision "highest" is 3xTF32 here, its default (bf16 passes on
the TPU; p5bf16, p7bf16, p8bf16) one TF32 product. Each sweep probe runs
twice: at the probe's shape, where a launch is most of what it measures,
and at a card-filling shape (FILL): 2,097,152 rays of the probe's
distribution against RTiOW's 496 prepared spheres (the port's
``kernel_inputs``) in 31 chunks of 16, one pass. p1, p2 and p4 add a
card-filling array (2^24 values). At the probe's shapes every sweep ray
must agree with the twin (``hold_sweep`` with no wrong share); at the
card-filling shape at most FILL_WRONG_SHARE of the rays may part.

    python -m weekend_raytracer_tpu_torch.probes.mxu_sweep [p1 ... p8c16 fill window]

Runs on the CUDA device; ``device="cpu"`` runs the twins (no timing means
anything there).
"""
from __future__ import annotations

import contextlib
import math
import sys
import time

import numpy as np
import torch

from ..ops.cuda import sweep as sw
from . import (FP32_PEAK, HBM_RATE, PAIR_OPS, ROOT_OPS, TF32_PEAK, card, check, device_times,
               host_ms, same_bits, sync, time_call, time_mean)

_F32 = torch.float32
# FP32 operations of sweep_fma's pair (PAIR_OPS: 2c is staged, so the
# sphere test's three c + c are not the pair's); what sweep_mma leaves on
# the FP32 units: per pair b, cq and b^2 - cq; per pair with a real root
# (the pairs either sweep takes a root of) ROOT_OPS; and the products' flops
# the sweep needs per pair: c.d (depth 3) and -2 c.o + kq (depth 4),
# multiply and add, once for TF32 and three times for 3xTF32
FMA_PAIR_OPS = PAIR_OPS
MMA_EPILOGUE_OPS = 4
MMA_FLOPS_PER_PAIR = 2 * (3 + 4)
PROBE = dict(spheres=32, rays=4096, iters=64, reps=30)  # p5, p7 (:258, :357)
P8 = dict(rays=4096, iters=16, reps=20, n_chunks=10, cs=32)  # :535
P8C16 = dict(n_chunks=20, cs=16)  # p8c16: p8 in chunks of 16
FILL = dict(rays=2_097_152, scene="rtiow", cs=16, iters=1, reps=20)
BIG = 1 << 24  # values of p1's, p2's and p4's card-filling arrays
CHAIN_SHAPES = ((32, 128), (8, 512), (1, 4096), (4, 4096), (32, 4096))  # :131
TRANSPOSE_ROWS = (4096, 16384)  # p6 (:606)
WINDOW = dict(spheres=1024, cs=32, rays=4096)  # more tiles than a block stages at once
# The share of rays that may part from the twin at the card-filling shape
# (hold_sweep). On an H100 the kernels part on 7 to 15 rays, at most 7.2e-6
# (a root choice that sits at MIN_T, or a near tie, moved by FMA
# contraction or the tensor cores' order); a kernel that lost one 16-sphere
# tile would part on every ray whose closest hit lies in it, which ``fill``
# reads as its control (the fewest rays any one tile holds: 28, 1.34e-5)
# and requires to be larger. At the probe's shapes no ray may part.
FILL_WRONG_SHARE = 1e-5
T_RTOL = 1e-5
T_EPS = 16 * 2.0 ** -24  # each term's rounding in t_tolerance: FMA contraction
# moves a sum by a unit or two, 3xTF32's split by 3 * 2^-22 of a product
CHAIN_RTOL = 5e-5  # 256 steps, each rounded once (FMA) or twice: 256 * 3 * 2^-24
DOT_TOL = 2.0 ** -18  # of sum_k |a_k| |b_k|: the tensor cores' order of the 8 sums
DOT_FILL_COLS = 1 << 20  # p3's card-filling B[8, 2^20]: C is 256 MB
DOT_DEVICE_REPS = 10  # p3: calls of each mode and library call under the profiler


def _dev(x, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x), dtype=_F32, device=device)


# --- the probe's inputs, restated ----------------------------------------

def scene(n_spheres: int, n_rays: int, seed: int = 0):
    """probe_mxu_sweep.py::_scene (:150-157): centres, radii, origins [3, R]
    and unit directions [3, R] as numpy float32, in the probe's draw order."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-8, 8, (n_spheres, 3)).astype(np.float32)
    r = rng.uniform(0.2, 1.0, n_spheres).astype(np.float32)
    o = rng.uniform(-1, 1, (3, n_rays)).astype(np.float32)
    d = rng.standard_normal((3, n_rays)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return c, r, o, d


def sphere_kq(c, r):
    """kq = |c|^2 - r^2 as the probe computes it (:259)."""
    return (c * c).sum(1) - r * r


def probe_table(c, kq, device) -> torch.Tensor:
    """The sweep table [n, 4] (cx, cy, cz, kq) of ``sweep_fma``."""
    return _dev(np.concatenate([c, kq[:, None]], axis=1), device)


def probe_planes(o, d, device) -> torch.Tensor:
    """The six SoA planes [6, R] (ox, oy, oz, dx, dy, dz)."""
    return _dev(np.concatenate([o, d]), device)


def probe_amat(c, kq):
    """p5's A [2S, 8] (:277-281): rows [0, S) c against d, [S, 2S) -2c and
    kq against o and 1."""
    s = c.shape[0]
    amat = np.zeros((2 * s, 8), np.float32)
    amat[0:s, 0:3] = c
    amat[s:, 3:6] = -2.0 * c
    amat[s:, 6] = kq
    return amat


def probe_bmat(o, d):
    """p5's B [8, R] (:282-286): d, o, ones, zeros."""
    bmat = np.zeros((8, o.shape[1]), np.float32)
    bmat[0:3] = d
    bmat[3:6] = o
    bmat[6] = 1.0
    return bmat


def probe_amats(c, kq, n_chunks: int, cs: int):
    """p8's amats [n_chunks, 8, 2 cs] (:550-556)."""
    amats = np.zeros((n_chunks, 8, 2 * cs), np.float32)
    for ci in range(n_chunks):
        blk = c[ci * cs:(ci + 1) * cs]
        amats[ci, 0:3, 0:cs] = blk.T
        amats[ci, 3:6, cs:2 * cs] = -2.0 * blk.T
        amats[ci, 6, cs:2 * cs] = kq[ci * cs:(ci + 1) * cs]
    return amats


def fill_inputs(device, rays: int = FILL["rays"]):
    """The card-filling shape: RTiOW's prepared sweep table [496, 4] (the
    port's kernel_inputs, 31 chunks of 16) and the planes of the ``rays``
    rays the probe's ``_scene(496, rays)`` draws."""
    from .binned import scene_inputs

    inp, _ = scene_inputs(FILL["scene"], 64, 36, device)
    check(inp.chunk_size == FILL["cs"] and inp.sweep.shape[0] % FILL["cs"] == 0,
           ("RTiOW's chunks", inp.chunk_size, tuple(inp.sweep.shape)))
    table = inp.sweep.contiguous()
    _, _, o, d = scene(table.shape[0], rays)
    return table, probe_planes(o, d, device)


# --- bounds, gates and timing --------------------------------------------

def _bound(ops_ms: float, bytes_moved: float) -> dict:
    byte_ms = bytes_moved / HBM_RATE * 1e3
    return {"bound_ms": max(ops_ms, byte_ms),
            "bound_by": "operations" if ops_ms >= byte_ms else "bytes"}


def _sweep_bytes(n_spheres: int, n_rays: int, packed: bool = False) -> int:
    """Each ray component read once (8 of the packed B), each sphere's
    operands once, t and the index written once."""
    return n_rays * 4 * (8 if packed else 6) + n_spheres * 16 + n_rays * 8


def fma_bound(n_spheres: int, n_rays: int, iters: int, kept: int = 0) -> dict:
    """sweep_fma's FP32 operations over the FP32 rate, or the bytes: those
    of every pair (FMA_PAIR_OPS) and the root's of the ``kept`` pairs a
    pass that have a real root (``real_root_pairs``)."""
    pairs = n_spheres * n_rays * iters
    ops_ms = (pairs * FMA_PAIR_OPS + kept * iters * ROOT_OPS) / FP32_PEAK * 1e3
    return _bound(ops_ms, _sweep_bytes(n_spheres, n_rays))


def mma_bound(n_spheres: int, n_rays: int, iters: int, prec: str, packed: bool,
              kept: int = 0) -> dict:
    """The larger of the products' flops the sweep needs over the TF32 rate
    (three products for 3xTF32) and the epilogue's FP32 operations (those
    of every pair, and the root's of the ``kept`` pairs a pass that have a
    real root: ``real_root_pairs``), or the bytes."""
    pairs = n_spheres * n_rays * iters
    mma_ms = pairs * MMA_FLOPS_PER_PAIR * (3 if prec == "3xtf32" else 1) / TF32_PEAK * 1e3
    epilogue_ms = (pairs * MMA_EPILOGUE_OPS + kept * iters * ROOT_OPS) / FP32_PEAK * 1e3
    return {**_bound(max(mma_ms, epilogue_ms), _sweep_bytes(n_spheres, n_rays, packed)),
            "mma_ms": mma_ms, "epilogue_ms": epilogue_ms}


def real_root_pairs(table: torch.Tensor, rays: torch.Tensor, chunk: int = 16) -> int:
    """The (sphere, ray) pairs of one pass with a real root, b^2 - cq > 0
    in float32 from the sweep table [n, 4] and the planes [6, R]: the pairs
    whose root sweep_mma's pre-test lets through (sweep.cu may_take) and
    sweep_fma takes (disc > 0)."""
    o, d = rays[0:3], rays[3:6]
    od = (o * d).sum(0)
    oo = (o * o).sum(0)
    n = 0
    for s in range(0, table.shape[0], chunk):
        c = table[s:s + chunk, :, None]
        b = c[:, 0] * d[0] + c[:, 1] * d[1] + c[:, 2] * d[2] - od
        cq = oo - 2 * (c[:, 0] * o[0] + c[:, 1] * o[1] + c[:, 2] * o[2]) + c[:, 3]
        n += int((b * b - cq > 0).sum())
    return n


def t_tolerance(table: torch.Tensor, rays: torch.Tensor, idx: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
    """How far float32 may move t of each ray against sphere idx: T_RTOL of
    t, plus the first-order propagation of T_EPS of each term into t = b -+
    sqrt(b^2 - cq) (float64 from the inputs): b = (c - o).d moves by db,
    cq = |o|^2 - 2 c.o + kq by dq, the discriminant by 2 |b| db + dq (and
    its own rounding), its root by that over 2 sqrt(disc) (at most the root
    of it). A grazing ray or a sphere far away (RTiOW's ground, 1000 away)
    allows more."""
    c = table[idx.long(), 0:3].double()
    kq = table[idx.long(), 3].double()
    o = rays[0:3].T.double()
    d = rays[3:6].T.double()
    b = ((c - o) * d).sum(1)
    cq = (o * o).sum(1) - 2 * (c * o).sum(1) + kq
    sq = (b * b - cq).clamp_min(0.0).sqrt()
    db = T_EPS * ((c * d).abs().sum(1) + (o * d).abs().sum(1))
    dd = 2 * b.abs() * db + T_EPS * ((o * o).sum(1) + 2 * (c * o).abs().sum(1) + kq.abs()
                                     + b * b)
    dsq = torch.minimum(dd / (2 * sq).clamp_min(1e-30), dd.sqrt())
    return T_RTOL * t.double().abs() + db + dsq


def hold_sweep(got, want, table: torch.Tensor, rays: torch.Tensor, what,
               wrong_share: float = 0.0) -> dict:
    """A sweep kernel against its twin: a ray parts if it hits where the
    twin's misses (or misses where it hits), hits another sphere, or hits
    the same one with t outside ``t_tolerance``; at most ``wrong_share`` of
    the rays may part. The kernel contracts products into FMAs and sums in
    another order, so over many rays one whose root choice sits at MIN_T,
    or a near tie, may part (FILL_WRONG_SHARE). Also reported: the share of
    rays whose mask agrees, of those both hit whose sphere agrees, and of
    those whose t does."""
    tk, ik = got
    tt, it = want
    hit_k, hit_t = ik >= 0, it >= 0
    mask = float((hit_k == hit_t).float().mean())
    both = hit_k & hit_t
    n_both = int(both.sum())
    same = both & (ik == it)
    n_same = int(same.sum())
    idx = n_same / n_both if n_both else 1.0
    parted = (hit_k != hit_t) | (both & (ik != it))
    if n_same:
        err = (tk[same] - tt[same]).abs()
        tol = t_tolerance(table, rays[:, same], it[same], tt[same])
        t_bad = err.double() > tol
        parted[same] |= t_bad
        t_ok = 1.0 - float(t_bad.float().mean())
        max_abs_err = float(err.max())
        p999 = float(err.double().quantile(0.999)) if n_same > 1 else max_abs_err
        rel_1e5 = float(torch.isclose(tk[same], tt[same], rtol=1e-5, atol=1e-5).float().mean())
    else:
        t_ok, max_abs_err, p999, rel_1e5 = 1.0, 0.0, 0.0, 1.0
    out = {"hit_share": float(hit_t.float().mean()), "mask_agree": mask, "idx_agree": idx,
           "t_agree": t_ok, "t_isclose_1e-5": rel_1e5, "max_abs_err": max_abs_err,
           "p999_abs_err": p999, "parted": float(parted.float().mean())}
    check(out["parted"] <= wrong_share, (what, wrong_share, out))
    return out


def _form_agree(a, b, tol: float) -> dict:
    """The TPU probe's comparison of two forms: t within tol (rtol and
    atol), t bit-identical, indices equal where t is a hit."""
    (ta, ia), (tb, ib) = a, b
    hit = ia >= 0
    return {f"t_agree_{tol:g}": float(torch.isclose(ta, tb, rtol=tol, atol=tol).float().mean()),
            "bit_identical": same_bits(ta, tb),
            "idx_agree": float(((ia == ib) | ~hit).float().mean())}


def _sweep_case(kernel, plain, bound: dict, pairs: int, table, rays, reps: int, device,
                what, wrong_share: float = 0.0) -> dict:
    """One sweep kernel: its result against the twin's (hold_sweep), its
    time beside the bound, Gtest/s, and the twin's time."""
    got = kernel()
    want, plain_ms = time_call(plain, device)
    sync(device)
    held = hold_sweep(got, want, table, rays, what, wrong_share)
    ms = time_mean(kernel, reps, device)
    return {"result": got, "ms": ms, "plain_ms": plain_ms, "gtest_per_s": pairs / ms / 1e6,
            "share": bound["bound_ms"] / ms, **bound, **held}


def _public(case: dict) -> dict:
    return {k: v for k, v in case.items() if k != "result"}


# --- the probes ----------------------------------------------------------

def _remap_case(x, reverse, affine, expect, library, reps, device) -> dict:
    out = sw.layout_remap(x, reverse, affine)
    plain = sw.remap_plain(x, reverse, affine)
    sync(device)
    check(same_bits(out.cpu(), expect), ("layout_remap against the probe", tuple(x.shape)))
    check(same_bits(out, plain), ("layout_remap against its twin", tuple(x.shape)))
    return {"ms": time_mean(lambda: sw.layout_remap(x, reverse, affine), reps, device),
            "plain_ms": time_mean(lambda: sw.remap_plain(x, reverse, affine), 2, device),
            "library_ms": time_mean(library, reps, device), "max_abs_err": 0.0,
            **_bound(0.0, 2 * x.numel() * 4)}


def p1(device="cuda", big: int = BIG, reps: int = 20) -> dict:
    """(32, 128) -> (1, 4096), y = 2x + 1, back (:61-76): bit for bit the
    probe's expectation and the twin; then 2^24 values, beside x * 2 + 1."""
    out = {}
    for label, shape in (("probe", (32, 128)), ("big", (big // 4096, 4096))):
        x = torch.arange(math.prod(shape), dtype=_F32, device=device).reshape(shape)
        expect = torch.from_numpy(x.cpu().numpy() * np.float32(2) + np.float32(1))
        out[label] = _remap_case(x, False, (2.0, 1.0), expect, lambda: x * 2 + 1, reps, device)
    b = out["big"]
    out["message"] = (f"reshape + 2x+1 (32,128): bit-exact, {out['probe']['ms'] * 1e3:.1f} us; "
                      f"{tuple((big // 4096, 4096))}: {b['ms']:.4f} ms (bound {b['bound_ms']:.4f}"
                      f", x*2+1 {b['library_ms']:.4f})")
    return out


def p2(device="cuda", big: int = BIG, reps: int = 20) -> dict:
    """Six (1, 4096) rows concatenated in reverse (:78-94), bit for bit;
    then 64 rows of 2^18, beside torch.flip."""
    out = {}
    for label, shape in (("probe", (6, 4096)), ("big", (64, big // 64))):
        a = torch.arange(math.prod(shape), dtype=_F32, device=device).reshape(shape)
        expect = torch.from_numpy(np.ascontiguousarray(a.cpu().numpy()[::-1]))
        out[label] = _remap_case(a, True, None, expect, lambda: torch.flip(a, [0]), reps,
                                 device)
    b = out["big"]
    out["message"] = (f"concat (1,4096)x6 reversed: bit-exact, {out['probe']['ms'] * 1e3:.1f} "
                      f"us; (64, {big // 64}): {b['ms']:.4f} ms (bound {b['bound_ms']:.4f}, "
                      f"flip {b['library_ms']:.4f})")
    return out


def dot_inputs(seed: int = 0):
    """p3's a [64, 8] (columns 6, 7 zero), b [8, 4096] and its FMA-order
    reference (:99-117), numpy float32."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((64, 8)).astype(np.float32)
    a[:, 6:] = 0.0
    b = rng.standard_normal((8, 4096)).astype(np.float32) * 3.0
    ref = np.zeros((64, 4096), np.float32)
    for kk in range(8):
        ref += a[:, kk:kk + 1] * b[kk:kk + 1, :]
    return a, b, ref


@contextlib.contextmanager
def _tf32_matmul(on: bool):
    """torch.matmul with TF32 on or off, the setting restored after."""
    keep = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep


def dot_ops_ms(m: int, n: int, prec: str) -> float:
    """The product's flops (depth 8) over the FP32 rate, or over the TF32
    rate once (tf32) or three times (3xtf32)."""
    flops = 2 * m * n * 8
    if prec == "fp32":
        return flops / FP32_PEAK * 1e3
    return flops * (3 if prec == "3xtf32" else 1) / TF32_PEAK * 1e3


def dot_fill_b(cols: int, seed: int = 1) -> np.ndarray:
    """B [8, cols] of p3's card-filling case, drawn as p3 draws its own."""
    return np.random.default_rng(seed).standard_normal((8, cols)).astype(np.float32) * 3.0


# torch.matmul with TF32 off and on: the library call beside each mode
# (off for fp32 and 3xtf32, on for tf32)
MATMULS = {"matmul_fp32": False, "matmul_tf32": True}


def _dot_case(a, b, ref, device, reps: int, device_reps: int) -> dict:
    """dot_mma at every precision on a [M, 8] . b [8, N]: FP32 bit for bit
    with its twin (and with ``ref``, the probe's FMA-order reference, where
    given), TF32 and 3xTF32 within DOT_TOL of sum_k |a_k| |b_k| of theirs;
    each mode and torch.matmul (MATMULS) timed in turns by CUDA events, by
    the host clock (``probes.host_ms``) and under the profiler."""
    m, n = a.shape[0], b.shape[1]
    with _tf32_matmul(False):
        mag = a.abs() @ b.abs()
    out = {}
    for prec in sw.PRECISIONS:
        got = sw.dot_mma(a, b, prec)
        plain, plain_ms = time_call(lambda: sw.dot_plain(a, b, prec), device)
        sync(device)
        if prec == "fp32":
            check(same_bits(got, plain), "dot_mma fp32 against its twin")
        diff = (got - plain).abs()
        check(bool((diff <= DOT_TOL * mag).all()), ("dot_mma against its twin", prec,
                                                    float((diff / mag.clamp_min(1e-30)).max())))
        out[prec] = {"max_abs_err": float(diff.max()), "plain_ms": plain_ms,
                     **_bound(dot_ops_ms(m, n, prec), (a.numel() + b.numel() + m * n) * 4)}
        if ref is not None:
            host, want = got.cpu(), torch.from_numpy(ref)
            err = (host - want).abs()
            out[prec].update(
                max_rel_err=float((err / want.abs().clamp_min(1e-6)).max()),
                bit_identical=same_bits(host, want),
                max_err_over_magnitude=float((err / mag.cpu().clamp_min(1e-30)).max()))
    check(ref is None or out["fp32"]["bit_identical"], "dot_mma fp32 against the reference")
    fns = {p: (lambda p=p: sw.dot_mma(a, b, p)) for p in sw.PRECISIONS}
    fns.update({k: (lambda: a @ b) for k in MATMULS})
    ms = _turns(fns, reps, device, tf32=MATMULS)
    host = {}
    for k, fn in fns.items():
        with _tf32_matmul(MATMULS.get(k, False)):
            host[k] = host_ms(fn, reps, device)
    timed = dict(fns, **{k: (lambda on=on: _matmul_as(a, b, on)) for k, on in MATMULS.items()})
    dev = device_times(timed, device_reps, device, several=tuple(MATMULS)) or {}
    for prec in sw.PRECISIONS:
        out[prec].update(ms=ms[prec], share=out[prec]["bound_ms"] / ms[prec],
                         host_ms=host[prec], **dev.get(prec, {}))
    out["library_ms"] = {"fp32": ms["matmul_fp32"], "tf32": ms["matmul_tf32"]}
    out["library_host_ms"] = {"fp32": host["matmul_fp32"], "tf32": host["matmul_tf32"]}
    # a library call's device time only where its trace kept every event
    out["library_device_ms"] = {p: dev[f"matmul_{p}"]["device_ms"] for p in ("fp32", "tf32")
                                if dev.get(f"matmul_{p}", {}).get("device_ms_by") == "profiler"}
    return out


def _matmul_as(a, b, tf32: bool):
    with _tf32_matmul(tf32):
        return a @ b


def dot_launches(reps: int = 20, device_reps: int = DOT_DEVICE_REPS) -> int:
    """dot_mma's launches in p3: per precision and shape (the probe's and
    the fill), a check, two timings in turns, a host timing and the
    profiler's calls."""
    return len(sw.PRECISIONS) * 2 * (1 + 2 * (reps + 1) + (reps + 1) + device_reps)


def p3(device="cuda", reps: int = 20, fill_cols: int = DOT_FILL_COLS,
       device_reps: int = DOT_DEVICE_REPS) -> dict:
    """The product at FP32 (k order), TF32 and 3xTF32 against the probe's
    FMA-order reference: max relative error, bit identity; FP32 equals its
    twin bit for bit, TF32 and 3xTF32 theirs within DOT_TOL of
    sum_k |a_k| |b_k|. Library: torch.matmul with TF32 off and on. Then
    the same at the card-filling shape, A[64, 8] . B[8, fill_cols] (FP32
    bit for bit with its twin)."""
    an, bn, ref = dot_inputs()
    a, b = _dev(an, device), _dev(bn, device)
    out = _dot_case(a, b, ref, device, reps, device_reps)
    out["fill"] = _dot_case(a, _dev(dot_fill_b(fill_cols), device), None, device, reps,
                            device_reps)
    out["fill"]["shape"] = [64, 8, fill_cols]
    f = out["fill"]
    out["message"] = "; ".join(
        f"{p}: max rel err {out[p]['max_rel_err']:.2e}, bit-identical to FMA order: "
        f"{out[p]['bit_identical']}, {out[p]['ms'] * 1e3:.1f} us" for p in sw.PRECISIONS) + (
        f"; matmul fp32 {out['library_ms']['fp32'] * 1e3:.1f} us, tf32 "
        f"{out['library_ms']['tf32'] * 1e3:.1f} us; B[8, {fill_cols}]: " + ", ".join(
            f"{p} {f[p]['ms']:.4f} ms ({f[p]['share']:.1%} of {f[p]['bound_ms']:.4f})"
            for p in sw.PRECISIONS) +
        f", matmul fp32 {f['library_ms']['fp32']:.4f}, tf32 {f['library_ms']['tf32']:.4f} ms")
    return out


def p4(device="cuda", big: int = BIG, reps: int = 20, steps: int = 256) -> dict:
    """256 steps of acc = acc * v + 1e-7 on the probe's shapes and a 2^24
    array, 1 and 4 chains a thread: Tops/s against the FP32 peak, each
    within CHAIN_RTOL of the twin."""
    out = {}
    for shape in CHAIN_SHAPES + ((big // 4096, 4096),):
        x = torch.full(shape, 0.999999, dtype=_F32, device=device)
        plain, plain_ms = time_call(lambda: sw.chain_plain(x, steps), device)
        row = {"plain_ms": plain_ms}
        for chains in (1, 4):
            got = sw.layout_chain(x, steps, chains)
            sync(device)
            err = float(((got - plain).abs() / plain.abs()).max())
            check(err <= CHAIN_RTOL, ("layout_chain against its twin", shape, chains, err))
            ms = time_mean(lambda: sw.layout_chain(x, steps, chains), reps, device)
            ops = 2 * steps * x.numel()
            row[f"chains{chains}"] = {"ms": ms, "tops": ops / ms / 1e9, "max_rel_err": err,
                                      **_bound(ops / FP32_PEAK * 1e3, 2 * x.numel() * 4)}
        out[str(shape)] = row
    out["message"] = "; ".join(
        f"{k}: {v['chains1']['ms'] * 1e3:.1f}/{v['chains4']['ms'] * 1e3:.1f} us, "
        f"{v['chains1']['tops']:.2f}/{v['chains4']['tops']:.2f} Tops/s (1/4 chains)"
        for k, v in out.items())
    return out


def _probe_sweep_inputs(n_spheres: int, n_rays: int, device):
    c, r, o, d = scene(n_spheres, n_rays)
    kq = sphere_kq(c, r)
    return c, kq, o, d, probe_table(c, kq, device), probe_planes(o, d, device)


def mma_inputs(name: str, device):
    """The inputs sweep_mma takes in the probe ``name`` ("p5_p7", "p8",
    "p8c16", "window" or "fill"), as the probe makes them: (amats, the sweep
    table, the planes, iters)."""
    if name == "fill":
        table, planes = fill_inputs(device)
        return sw.sphere_amats(table, FILL["cs"]), table, planes, FILL["iters"]
    if name == "p5_p7":
        c, kq, _, _, table, planes = _probe_sweep_inputs(PROBE["spheres"], PROBE["rays"], device)
        return _dev(probe_amat(c, kq).T[None], device), table, planes, PROBE["iters"]
    n_chunks, cs, rays, iters = {
        "p8": (P8["n_chunks"], P8["cs"], P8["rays"], P8["iters"]),
        "p8c16": (P8C16["n_chunks"], P8C16["cs"], P8["rays"], P8["iters"]),
        "window": (WINDOW["spheres"] // WINDOW["cs"], WINDOW["cs"], WINDOW["rays"], 1)}[name]
    c, kq, _, _, table, planes = _probe_sweep_inputs(n_chunks * cs, rays, device)
    return _dev(probe_amats(c, kq, n_chunks, cs), device), table, planes, iters


MMA_INPUTS = ("p5_p7", "p8", "p8c16", "window", "fill")  # mma_inputs' names


def _fill_sweeps(prec: str, packed: bool, device, rays: int, reps: int, fma: bool) -> dict:
    """The card-filling shape: the FMA sweep (``fma``) and the tensor-core
    sweep at ``prec`` from the planes or the packed B, each held against
    its twin and timed beside its bound."""
    table, planes = fill_inputs(device, rays)
    n, cs, iters = table.shape[0], FILL["cs"], FILL["iters"]
    pairs = n * rays * iters
    kept = real_root_pairs(table, planes)
    out = {"rays": rays}
    if fma:
        out["fma"] = _sweep_case(lambda: sw.sweep_fma(table, planes, cs, iters),
                                 lambda: sw.sweep_plain(table, planes, "fma"),
                                 fma_bound(n, rays, iters, kept), pairs, table, planes, reps,
                                 device,
                                 "sweep_fma at the card-filling shape", FILL_WRONG_SHARE)
    amats = sw.sphere_amats(table, cs)
    rays_in = sw.packed_b(planes) if packed else planes
    out["mma"] = _sweep_case(lambda: sw.sweep_mma(amats, rays_in, prec, iters),
                             lambda: sw.sweep_plain(amats, rays_in, prec),
                             mma_bound(n, rays, iters, prec, packed, kept), pairs, table, planes,
                             reps, device, f"sweep_mma {prec} at the card-filling shape",
                             FILL_WRONG_SHARE)
    if fma:
        out["speedup"] = out["fma"]["ms"] / out["mma"]["ms"]
        out["forms"] = _form_agree(out["fma"]["result"], out["mma"]["result"], 1e-4)
    return {k: (_public(v) if isinstance(v, dict) and "result" in v else v)
            for k, v in out.items()}


def _fill_message(fill: dict) -> str:
    m = fill["mma"]
    text = (f"fill {fill['rays']} rays x 496: mma {m['ms']:.4f} ms ({m['share']:.1%} of "
            f"{m['bound_ms']:.4f})")
    if "fma" in fill:
        f = fill["fma"]
        text = (f"fill {fill['rays']} rays x 496: FMA {f['ms']:.4f} ms ({f['share']:.1%} of "
                f"{f['bound_ms']:.4f}), mma {m['ms']:.4f} ms ({m['share']:.1%} of "
                f"{m['bound_ms']:.4f}), speedup x{fill['speedup']:.2f}")
    return text


def _prec(precision) -> str:
    return "3xtf32" if precision == "highest" else "tf32"


def p5(precision="highest", device="cuda", fill_rays: int = FILL["rays"],
       reps: int = PROBE["reps"]) -> dict:
    """The FMA sweep against the tensor-core sweep from the packed B
    (:246-316), 32 spheres x 4096 rays x 64 passes, then the card-filling
    shape."""
    prec = _prec(precision)
    s, n, iters = PROBE["spheres"], PROBE["rays"], PROBE["iters"]
    c, kq, o, d, table, planes = _probe_sweep_inputs(s, n, device)
    amats = _dev(probe_amat(c, kq).T[None], device)
    bmat = _dev(probe_bmat(o, d), device)
    pairs = s * n * iters
    kept = real_root_pairs(table, planes)
    v = _sweep_case(lambda: sw.sweep_fma(table, planes, s, iters),
                    lambda: sw.sweep_plain(table, planes, "fma"), fma_bound(s, n, iters, kept),
                    pairs, table, planes, reps, device, "p5 sweep_fma")
    m = _sweep_case(lambda: sw.sweep_mma(amats, bmat, prec, iters),
                    lambda: sw.sweep_plain(amats, bmat, prec),
                    mma_bound(s, n, iters, prec, True, kept), pairs,
                    table, planes, reps, device,
                    f"p5 sweep_mma {prec}")
    forms = _form_agree(v["result"], m["result"], 1e-5)
    fill = _fill_sweeps(prec, True, device, fill_rays, FILL["reps"], fma=True)
    return {"precision": prec, "fma": _public(v), "mma": _public(m), "forms": forms,
            "speedup": v["ms"] / m["ms"], "fill": fill,
            "message": (f"{prec}: FMA {v['ms'] * 1e3:.1f} us ({v['gtest_per_s']:.2f} Gtest/s), "
                        f"mma {m['ms'] * 1e3:.1f} us ({m['gtest_per_s']:.2f} Gtest/s) speedup "
                        f"x{v['ms'] / m['ms']:.2f}; t agree(1e-5) {forms['t_agree_1e-05']:.4f} "
                        f"bit-identical {forms['bit_identical']} idx agree "
                        f"{forms['idx_agree']:.4f}; " + _fill_message(fill))}


def numpy_closest(c, kq, o, d):
    """p7's numpy closest-hit reference (:403-418)."""
    cd = c @ d
    co = c @ o
    od = (o * d).sum(0)
    oo = (o * o).sum(0)
    b = cd - od[None]
    cq = oo[None] - 2 * co + kq[:, None]
    disc = b * b - cq
    sq = np.sqrt(np.maximum(disc, 0))
    t0 = b - sq
    t1 = b + sq
    ts = np.where(t0 > sw.MIN_T, t0, t1)
    valid = (disc > 0) & (ts > sw.MIN_T)
    return np.where(valid, ts, sw.MAX_T).min(0)


def p7(precision="highest", device="cuda", fill_rays: int = FILL["rays"],
       reps: int = PROBE["reps"]) -> dict:
    """The tensor-core sweep from the six SoA planes, no layout change
    (:376-423), against the probe's numpy reference at 1e-4; then the
    card-filling shape."""
    prec = _prec(precision)
    s, n, iters = PROBE["spheres"], PROBE["rays"], PROBE["iters"]
    c, kq, o, d, table, planes = _probe_sweep_inputs(s, n, device)
    amats = _dev(probe_amat(c, kq).T[None], device)
    m = _sweep_case(lambda: sw.sweep_mma(amats, planes, prec, iters),
                    lambda: sw.sweep_plain(amats, planes, prec),
                    mma_bound(s, n, iters, prec, False, real_root_pairs(table, planes)),
                    s * n * iters, table, planes, reps,
                    device, f"p7 sweep_mma {prec}")
    ref = torch.from_numpy(numpy_closest(c, kq, o, d))
    agree = float(torch.isclose(ref, m["result"][0].cpu(), rtol=1e-4, atol=1e-4).float().mean())
    fill = _fill_sweeps(prec, False, device, fill_rays, FILL["reps"], fma=False)
    return {"precision": prec, "mma": _public(m), "t_agree_numpy_1e-4": agree, "fill": fill,
            "message": (f"rowdot {prec}: {m['ms'] * 1e3:.1f} us ({m['gtest_per_s']:.2f} Gtest/s)"
                        f" t agree(1e-4) {agree:.4f}; " + _fill_message(fill))}


def p8(precision="highest", n_chunks: int = P8["n_chunks"], cs: int = P8["cs"], device="cuda",
       fill_rays: int = FILL["rays"], reps: int = P8["reps"]) -> dict:
    """The chunked FMA sweep against the chunked tensor-core sweep
    (:530-598), n_chunks x cs spheres x 4096 rays x 16 passes; then the
    card-filling shape."""
    prec = _prec(precision)
    n, iters = P8["rays"], P8["iters"]
    s = n_chunks * cs
    c, kq, o, d, table, planes = _probe_sweep_inputs(s, n, device)
    amats = _dev(probe_amats(c, kq, n_chunks, cs), device)
    pairs = s * n * iters
    kept = real_root_pairs(table, planes)
    v = _sweep_case(lambda: sw.sweep_fma(table, planes, cs, iters),
                    lambda: sw.sweep_plain(table, planes, "fma"), fma_bound(s, n, iters, kept),
                    pairs, table, planes, reps, device, "p8 sweep_fma")
    m = _sweep_case(lambda: sw.sweep_mma(amats, planes, prec, iters),
                    lambda: sw.sweep_plain(amats, planes, prec),
                    mma_bound(s, n, iters, prec, False, kept), pairs,
                    table, planes, reps, device,
                    f"p8 sweep_mma {prec}")
    forms = _form_agree(v["result"], m["result"], 1e-4)
    fill = _fill_sweeps(prec, False, device, fill_rays, FILL["reps"], fma=True)
    return {"precision": prec, "chunks": [n_chunks, cs], "fma": _public(v), "mma": _public(m),
            "forms": forms, "speedup": v["ms"] / m["ms"], "fill": fill,
            "message": (f"cs={cs} x {n_chunks} chunks, {prec}: FMA {v['ms'] * 1e3:.1f} us "
                        f"({v['gtest_per_s']:.2f} Gtest/s), mma {m['ms'] * 1e3:.1f} us "
                        f"({m['gtest_per_s']:.2f} Gtest/s) speedup x{v['ms'] / m['ms']:.2f}; "
                        f"t agree(1e-4) {forms['t_agree_0.0001']:.4f} idx agree "
                        f"{forms['idx_agree']:.4f}; " + _fill_message(fill))}


def p6(device="cuda", rows=TRANSPOSE_ROWS, reps: int = 20) -> dict:
    """The XLA-level pool transpose (:605-622) as a PyTorch yardstick:
    (R, 16, 128) -> (16, R, 128) and back, each copied into an array made
    once, beside the byte bound (each value read once and written once)."""
    out = {}
    for r in rows:
        x = torch.zeros((r, 16, 128), dtype=_F32, device=device)
        y = torch.empty((16, r, 128), dtype=_F32, device=device)
        ms = _turns({"to": lambda: y.copy_(x.permute(1, 0, 2)),
                     "back": lambda: x.copy_(y.permute(1, 0, 2))}, reps, device)
        mb = x.numel() * 4 / 1e6
        out[f"rows={r}"] = {"to_ms": ms["to"], "back_ms": ms["back"],
                            "gb_per_s": mb / ms["to"], **_bound(0.0, 2 * x.numel() * 4)}
    out["message"] = "; ".join(
        f"{k}: to comp-major {v['to_ms']:.4f} ms, back {v['back_ms']:.4f} ms "
        f"({v['gb_per_s']:.0f} GB/s, bound {v['bound_ms']:.4f} ms)" for k, v in out.items())
    return out


def _turns(fns: dict, reps: int, device, tf32=None) -> dict:
    """Each function's mean ms over ``reps`` calls, timed in order and then
    in reverse, the smaller of the two; a function named in ``tf32``
    ({name: on}) runs with torch.matmul's TF32 set so."""
    order = list(fns)
    tf32 = tf32 or {}
    times = {k: [] for k in order}
    for k in order + order[::-1]:
        with _tf32_matmul(tf32.get(k, torch.backends.cuda.matmul.allow_tf32)):
            times[k].append(time_mean(fns[k], reps, device))
    return {k: min(v) for k, v in times.items()}


def tile_control(idx: torch.Tensor, n_spheres: int) -> float:
    """The fewest rays, as a share of all, whose closest hit (``idx`` of the
    twin) lies in any one 16-sphere tile that holds a closest hit: what a
    sweep that lost that tile would move at least."""
    counts = torch.bincount(idx[idx >= 0].long() // sw.MMA_TILE,
                            minlength=-(-n_spheres // sw.MMA_TILE))
    return float(counts[counts > 0].min()) / idx.numel()


def fill(device="cuda", rays: int = FILL["rays"], reps: int = FILL["reps"]) -> dict:
    """The sweep's anatomy at the card-filling shape (RTiOW's 496 spheres in
    31 chunks of 16, one pass): the production sweep (``sweep_fma``,
    bounce.cuh's sweep_sphere) staged by chunks of 16 and in one chunk of
    496, and the tensor-core sweep from the planes at TF32 and 3xTF32. Each
    is held against its twin (``hold_sweep`` at FILL_WRONG_SHARE, which
    must lie below ``tile_control``), and all are timed in turns beside
    their bounds."""
    table, planes = fill_inputs(device, rays)
    n, cs, iters = table.shape[0], FILL["cs"], FILL["iters"]
    amats = sw.sphere_amats(table, cs)
    pairs = n * rays * iters
    kernels = {
        "fma": lambda: sw.sweep_fma(table, planes, cs, iters),
        "fma_one_chunk": lambda: sw.sweep_fma(table, planes, n, iters),
        "mma_tf32": lambda: sw.sweep_mma(amats, planes, "tf32", iters),
        "mma_3xtf32": lambda: sw.sweep_mma(amats, planes, "3xtf32", iters),
    }
    plain, plain_ms = {}, {}
    for prec in ("fma", "tf32", "3xtf32"):
        plain[prec], plain_ms[prec] = time_call(
            lambda: sw.sweep_plain(table if prec == "fma" else amats, planes, prec), device)
    control = tile_control(plain["fma"][1], n)
    check(control > FILL_WRONG_SHARE, ("the fill gate cannot see a lost tile", control))
    kept = real_root_pairs(table, planes)
    out = {"rays": rays, "spheres": n, "pairs": pairs, "wrong_share": FILL_WRONG_SHARE,
           "control": control, "real_root_pairs": kept}
    for name, fn in kernels.items():
        prec = "fma" if name.startswith("fma") else name.split("_")[1]
        got = fn()
        sync(device)
        held = hold_sweep(got, plain[prec], table, planes, f"fill {name}", FILL_WRONG_SHARE)
        bound = (fma_bound(n, rays, iters, kept) if prec == "fma"
                 else mma_bound(n, rays, iters, prec, False, kept))
        out[name] = {"plain_ms": plain_ms[prec], **bound, **held}
    for name, ms in _turns(kernels, reps, device).items():
        out[name].update(ms=ms, share=out[name]["bound_ms"] / ms,
                         gtest_per_s=pairs / ms / 1e6)
    out["census"] = survivor_census(amats, planes, device)
    out["message"] = "; ".join(f"{k} {out[k]['ms']:.4f} ms ({out[k]['share']:.1%} of "
                               f"{out[k]['bound_ms']:.4f})" for k in kernels) + (
        f"; gate {FILL_WRONG_SHARE:g} of rays, control (fewest rays a tile holds) {control:.3g}"
        "; survivors " + ", ".join(f"{p} {c['kept_share']:.3%} ({c['rounds_per_step']:.3f} "
                                   "rounds a step)" for p, c in out["census"].items()))
    return out


def survivor_census(amats, rays, device) -> dict:
    """sweep_mma's survivor census at each precision (``sweep_mma_census``,
    one launch each; the twin's census, ``survivor_plain``, on the CPU):
    the share of pairs whose pre-test kept them for a root, the survivor
    rounds a warp walked per (16-sphere tile, 8-ray tile) step, and the
    census launch's (t, index) equal to sweep_mma's in every bit."""
    out = {}
    for prec in ("tf32", "3xtf32"):
        got, census = sw.sweep_mma_census(amats, rays, prec)
        want = sw.sweep_mma(amats, rays, prec) if torch.device(device).type == "cuda" else got
        sync(device)
        check(same_bits(got[0], want[0]) and torch.equal(got[1], want[1]),
              ("the census launch's sweep is sweep_mma's", prec))
        out[prec] = {**census, "kept_share": census["kept"] / census["pairs"],
                     "rounds_per_step": census["rounds"] / census["steps"]}
    return out


def window(device="cuda", rays: int = WINDOW["rays"]) -> dict:
    """The tensor-core sweep past its first shared-memory window: the
    probe's scene with 1024 spheres in chunks of 32 (64 tiles: 3xTF32
    stages 24 a window, TF32 48) x ``rays`` rays, from the planes, each
    precision held against its twin on every ray."""
    s, cs = WINDOW["spheres"], WINDOW["cs"]
    c, kq, o, d, table, planes = _probe_sweep_inputs(s, rays, device)
    amats = _dev(probe_amats(c, kq, s // cs, cs), device)
    out = {}
    for prec in ("tf32", "3xtf32"):
        got = sw.sweep_mma(amats, planes, prec)
        want = sw.sweep_plain(amats, planes, prec)
        sync(device)
        out[prec] = hold_sweep(got, want, table, planes, f"window sweep_mma {prec}")
    out["message"] = "; ".join(
        f"{p}: {s} spheres x {rays} rays, mask/idx/t agree {v['mask_agree']:.4f}/"
        f"{v['idx_agree']:.4f}/{v['t_agree']:.4f}, hits {v['hit_share']:.3f}"
        for p, v in out.items())
    return out


def _variant(fn, **kw):
    def run(device="cuda", **more):
        return fn(device=device, **kw, **more)

    run.__doc__ = fn.__doc__
    return run


PROBES = [
    ("p1", p1), ("p2", p2), ("p3", p3), ("p4", p4),
    ("p5", _variant(p5, precision="highest")), ("p5bf16", _variant(p5, precision=None)),
    ("p6", p6),
    ("p7", _variant(p7, precision="highest")), ("p7bf16", _variant(p7, precision=None)),
    ("p8", _variant(p8, precision="highest")), ("p8bf16", _variant(p8, precision=None)),
    ("p8c16", _variant(p8, precision="highest", **P8C16)),
    ("fill", fill), ("window", window),
]


def warm_up(seconds: float = 1.0, device="cuda") -> None:
    """Keep the card busy for ``seconds`` before the first timing, so that
    its clocks have left idle (p1's first big remap took 16x its later time
    on a card straight from idle)."""
    x = torch.full((BIG,), 0.999999, dtype=_F32, device=device)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            sw.layout_chain(x, 256, 4)
        sync(device)


def run(name, fn, device="cuda", **kw) -> bool:
    """One probe, printed as the TPU probe prints it; True if it held."""
    try:
        out = fn(device, **kw)
        print(f"[ok]   {name}: {out['message']}", flush=True)
        return True
    except Exception as e:  # noqa: BLE001
        msg = " | ".join(str(e).splitlines()[:3])[:300]
        print(f"[FAIL] {name}: {type(e).__name__}: {msg}", flush=True)
        return False


def main(argv=None) -> int:
    only = (sys.argv[1:] if argv is None else argv) or None
    if not torch.cuda.is_available():
        print("probes.mxu_sweep: no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {card()}", flush=True)
    warm_up()
    ok = [run(name, fn) for name, fn in PROBES if not only or name in only]
    return 0 if all(ok) else 1


if __name__ == "__main__":
    raise SystemExit(main())
