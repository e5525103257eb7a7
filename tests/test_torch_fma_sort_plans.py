"""sweep_fma's work split and row_sort's thread layout, replicated in NumPy
on the CPU (the CUDA kernels run only on the card).

sweep_fma (csrc/sweep.cu) carries 4 rays a thread where the rays fill the
card and, where they leave it idle (the probes' 4,096), one ray a thread
with a ray group's (pass, sphere) pairs split over up to 32 warps
(``fma_plan``; each warp's slice as the kernel derives it,
``fma_slices``). Here every plan's slices cover each (pass, sphere) of a
ray group once, and a NumPy replica of the kernel's walk (each warp's
passes in order, its spheres in increasing index, a strict <), merged by
the least (t, index) as the kernel merges in shared memory, equals
``sweep_plain`` in every bit: on exact ties (duplicate spheres), rays that
miss everything, p5's and p8's sizes cut to a few hundred rays, RTiOW's
table and a table of more than one window.

row_sort (csrc/access.cu) holds a row in 8 threads of 16 consecutive keys:
its 28 stages are 22 within a thread's registers and 6 by shuffle, and a
thread holds a descending phase's keys in reverse, so every register stage
compares ascending. A NumPy replica of that layout (which registers each
stage pairs, in which direction, in registers or across lanes, and which
keys they hold) is the network of ``row_sort_plain`` (the probe's: key l
pairs with l ^ j, ascending where l & k is 0), equal to it in every bit on
edge keys (NaN payloads, both zeros, infinities, denormals, runs), and on
p3's input equal to benchmarks/probe_place.py's kernel in Pallas interpret
mode.
"""
import contextlib
import importlib.util
import io
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from weekend_raytracer_tpu_torch.ops.cuda import access as ac  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import sweep as sw  # noqa: E402
from weekend_raytracer_tpu_torch.probes import mxu_sweep as ms  # noqa: E402
from weekend_raytracer_tpu_torch.probes import place  # noqa: E402

_BENCH = pathlib.Path(__file__).resolve().parents[1] / "benchmarks"
_F32 = np.float32
_MIN_T = _F32(sw.MIN_T)
_MAX_T = _F32(sw.MAX_T)
H100_SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and (a.view(np.int32) == b.view(np.int32)).all()


# --- sweep_fma's plan -------------------------------------------------------

def fma_slices(plan: dict, n_spheres: int, iters: int) -> list:
    """Each warp's share of a ray group's work under ``plan``
    (``sw.fma_plan``), as sweep.cu's sweep_fma derives it, in the kernel's
    order of parts: (the passes it runs, the spheres it sweeps in each);
    its spheres are its run of each window of plan["window"] spheres."""
    splits, pass_parts, window = plan["splits"], plan["pass_parts"], plan["window"]
    sphere_parts = splits // pass_parts
    out = []
    for part in range(splits):
        pp, sp = divmod(part, sphere_parts)
        passes = range(pp * iters // pass_parts, (pp + 1) * iters // pass_parts)
        spheres = []
        for w0 in range(0, n_spheres, window):
            nw = min(window, n_spheres - w0)
            spheres.extend(range(w0 + sp * nw // sphere_parts, w0 + (sp + 1) * nw // sphere_parts))
        out.append((passes, spheres))
    return out


_PLAN_SHAPES = {  # (n_rays, n_spheres, iters)
    "p5": (4096, 32, 64), "p8": (4096, 320, 16), "window": (4096, 1024, 1),
    "fill": (2_097_152, 496, 1), "few_rays": (100, 5, 3), "one_ray": (1, 1, 1),
    "windows": (50_000, 3000, 2), "odd_passes": (700, 77, 5), "mid": (400_000, 496, 1),
}


@pytest.mark.parametrize("sms", [132, 114, 16])
@pytest.mark.parametrize("shape", list(_PLAN_SHAPES))
def test_fma_plan_slices_cover_every_pair_once(shape, sms):
    """Each warp of a ray group gets a run of passes and a run of each
    window's spheres; together they take every (pass, sphere) once. A
    split only at one ray a thread, a power of two no larger than a block's
    warps; the grid covers every ray group."""
    n_rays, n_spheres, iters = _PLAN_SHAPES[shape]
    plan = sw.fma_plan(n_rays, n_spheres, iters, sms)
    warps = plan["threads"] // 32
    assert (plan["rays"], plan["threads"]) in ((1, sw.FMA_NARROW_THREADS),
                                               (sw.FMA_RAYS, sw.FMA_THREADS))
    assert plan["splits"] & (plan["splits"] - 1) == 0
    assert plan["splits"] <= min(sw.FMA_MAX_SPLITS, warps)
    assert plan["splits"] == 1 or plan["rays"] == 1
    assert plan["pass_parts"] <= min(plan["splits"], iters)
    assert plan["window"] == min(n_spheres, sw.FMA_WINDOW)
    n_groups = -(-n_rays // (32 * plan["rays"]))
    assert plan["blocks"] * (warps // plan["splits"]) >= n_groups
    assert (plan["blocks"] - 1) * (warps // plan["splits"]) < n_groups
    seen = np.zeros((iters, n_spheres), np.int64)
    slices = fma_slices(plan, n_spheres, iters)
    assert len(slices) == plan["splits"]
    for passes, spheres in slices:
        assert len(passes) >= 1
        assert list(spheres) == sorted(set(spheres))  # increasing, each once
        seen[np.ix_(list(passes), list(spheres))] += 1
    assert (seen == 1).all()


def test_fma_plan_fills_the_card_where_the_rays_do_not():
    """The probes' 4,096 rays: one ray a thread and 32 warps a ray group
    (128 blocks of 1024 on 132 SMs); the fill: 4 rays a thread in blocks of
    256, no split."""
    assert sw.fma_plan(4096, 32, 64, H100_SMS) == {
        "rays": 1, "threads": 1024, "splits": 32, "pass_parts": 32, "window": 32,
        "blocks": 128}
    assert sw.fma_plan(4096, 320, 16, H100_SMS)["pass_parts"] == 16
    assert sw.fma_plan(4096, 1024, 1, H100_SMS)["pass_parts"] == 1
    assert sw.fma_plan(2_097_152, 496, 1, H100_SMS) == {
        "rays": 4, "threads": 256, "splits": 1, "pass_parts": 1, "window": 496,
        "blocks": 2048}


# --- sweep_fma's walk and merge, replicated ---------------------------------

def _walk(table, planes, passes, spheres):
    """One warp's share, as the kernel walks it: its passes in order, its
    spheres in increasing index, sweep_plain's arithmetic rounded apart,
    dx carrying the pass at zero weight, the running best taken on a strict
    <. Returns (t, index) of every ray."""
    o, d = planes[0:3], planes[3:6]
    od = o[0] * d[0] + o[1] * d[1] + o[2] * d[2]
    oo = o[0] * o[0] + o[1] * o[1] + o[2] * o[2]
    bt = np.full(planes.shape[1], _MAX_T, _F32)
    bi = np.full(planes.shape[1], -1, np.int32)
    with np.errstate(invalid="ignore"):
        for it in passes:
            dx = d[0] + _F32(it) * _F32(0.0)
            for s in spheres:
                cx, cy, cz, kq = table[s]
                cd = cx * dx + cy * d[1] + cz * d[2]
                co2 = (cx + cx) * o[0] + (cy + cy) * o[1] + (cz + cz) * o[2]
                bq = cd - od
                cq = oo - co2 + kq
                sq = np.sqrt(bq * bq - cq)
                t0, t1 = bq - sq, bq + sq
                ts = np.where(t0 > _MIN_T, t0, t1)
                take = (sq > 0) & (ts > _MIN_T) & (ts < bt)
                bt = np.where(take, ts, bt)
                bi = np.where(take, np.int32(s), bi)
    return bt, bi


def _split_sweep(table, planes, iters, sms=H100_SMS):
    """The kernel's split: each warp's walk of its slice, then the least
    (t, index) over the warps in part order (sweep.cu take_least)."""
    plan = sw.fma_plan(planes.shape[1], table.shape[0], iters, sms)
    t = i = None
    for passes, spheres in fma_slices(plan, table.shape[0], iters):
        pt, pi = _walk(table, planes, passes, spheres)
        if t is None:
            t, i = pt, pi
            continue
        take = (pt < t) | ((pt == t) & (pi < i))
        t, i = np.where(take, pt, t), np.where(take, pi, i)
    return plan, t, i


def _probe_inputs(n_spheres, n_rays, seed=0):
    c, r, o, d = ms.scene(n_spheres, n_rays, seed)
    kq = ms.sphere_kq(c, r)
    return np.concatenate([c, kq[:, None]], 1).astype(_F32), np.concatenate([o, d]).astype(_F32)


def _ties(n_rays=300):
    """A table whose spheres repeat (exact ties: the first index must win)
    and whose last rays point away from every sphere from far out."""
    table, planes = _probe_inputs(12, n_rays, seed=3)
    table = np.concatenate([table, table[::-1], table[:4]]).astype(_F32)
    planes = planes.copy()
    planes[0:3, -40:] = 500.0  # far from every sphere, heading further out
    planes[3:6, -40:] = np.float32(1.0 / np.sqrt(3.0))
    return table, planes


def _rtiow(n_rays=200):
    table, planes = ms.fill_inputs("cpu", n_rays)
    return table.numpy(), planes.numpy()


def _windows(n_rays=160):
    table, planes = _probe_inputs(sw.FMA_WINDOW + 90, n_rays, seed=7)
    return table, planes


_SPLIT_CASES = {"ties": (_ties, 3), "p5_cut": (lambda: _probe_inputs(32, 300), 64),
                "p8_cut": (lambda: _probe_inputs(320, 256), 16), "rtiow_cut": (_rtiow, 1),
                "two_windows": (_windows, 1)}


@pytest.mark.parametrize("case", list(_SPLIT_CASES))
def test_split_walks_merged_equal_the_sequential_sweep(case):
    """Merging the warps' walks of their slices by the least (t, index)
    gives sweep_plain's (t, index) in every bit: a later pass takes
    nothing, and the least index wins a tie."""
    make, iters = _SPLIT_CASES[case]
    table, planes = make()
    plan, t, i = _split_sweep(table, planes, iters)
    assert plan["splits"] > 1
    want_t, want_i = sw.sweep_plain(torch.from_numpy(table), torch.from_numpy(planes), "fma")
    assert _same_bits(t, want_t.numpy()) and (i == want_i.numpy()).all()
    if case == "ties":
        hit = i >= 0
        assert hit.any() and (i[hit] < 12).all()  # the first copy of each sphere
        assert (i[-40:] == -1).all() and (t[-40:] == _MAX_T).all()


def test_split_of_one_warp_is_the_plain_walk():
    """With the card full (no split), one warp's walk of every pass is the
    twin's sweep."""
    table, planes = _probe_inputs(40, 64, seed=11)
    t, i = _walk(table, planes, range(3), range(40))
    want_t, want_i = sw.sweep_plain(torch.from_numpy(table), torch.from_numpy(planes), "fma")
    assert _same_bits(t, want_t.numpy()) and (i == want_i.numpy()).all()


# --- row_sort's thread layout, replicated ------------------------------------

KEYS = 16  # csrc/access.cu kSortKeys: consecutive keys a thread


def kernel_stages(keys=KEYS, reverse=True):
    """row_sort's thread layout stage by stage, for ``keys`` keys a thread
    (key l = keys t + q, 128 / keys threads a row). Each thread holds a
    phase k's keys in reverse where that phase sorts them in descending
    order (``reverse``, as the kernel does; without it each register pair
    takes its phase's direction; from k = keys up, k < 128), flipping
    its registers at the phase's start. Yields (k, j, kind, moves, held):
    kind "registers" with moves [(t, q, q + j, desc)] (a thread's own
    registers, desc the compare's direction, fixed for every k but the
    phases a thread does not reverse), or "shuffle" with moves [(t, partner,
    keep_min)] (register q against lane ``partner``'s register q); held[t]
    whether thread t holds its keys in reverse."""
    threads = 128 // keys
    held = [False] * threads
    k = 2
    while k <= 128:
        desc = [k < 128 and ((keys * t) & k) != 0 for t in range(threads)]
        if reverse and k >= keys:
            held = list(desc)
        j = k // 2
        while j >= 1:
            if j >= keys:
                tj = j // keys
                moves = [(t, t ^ tj, ((t & tj) == 0) != desc[t]) for t in range(threads)]
                yield k, j, "shuffle", moves, list(held)
            else:
                moves = [(t, q, q + j, (bool(q & k) if k < keys else desc[t] and not held[t]))
                         for t in range(threads) for q in range(keys) if not q & j]
                yield k, j, "registers", moves, list(held)
            j //= 2
        k *= 2


def _key(keys, t, q, held):
    """The key thread t's register q holds."""
    return keys * t + (keys - 1 - q if held[t] else q)


def layout_sort(x, keys=KEYS, reverse=True):
    """The kernel's layout applied to rows x [rows, 128] float32, register
    by register: a register pair by a compare and two selects, a shuffled
    register by a select, each thread's registers flipped where it starts
    or stops holding its keys in reverse."""
    threads = 128 // keys
    v = x.reshape(x.shape[0], threads, keys).copy()  # [row, thread, register]
    held = [False] * threads
    for k, j, kind, moves, now in kernel_stages(keys, reverse):
        flip = [t for t in range(threads) if now[t] != held[t]]
        v[:, flip, :] = v[:, flip, ::-1]
        held = now
        if kind == "registers":
            for t, lo, hi, desc in moves:
                a, b = v[:, t, lo].copy(), v[:, t, hi].copy()
                swap = (a < b) if desc else (b < a)
                v[:, t, lo], v[:, t, hi] = np.where(swap, b, a), np.where(swap, a, b)
        else:
            nv = v.copy()
            for t, partner, keep_min in moves:
                own, pv = v[:, t, :], v[:, partner, :]
                swap = (pv < own) if keep_min else (own < pv)
                nv[:, t, :] = np.where(swap, pv, own)
            v = nv
    return v.reshape(x.shape[0], 128)


def test_layout_runs_22_stages_in_registers_and_6_by_shuffle():
    stages = list(kernel_stages())
    assert len(stages) == 28
    assert [kind for _, _, kind, _, _ in stages].count("registers") == 22
    assert [(k, j) for k, j, kind, _, _ in stages if kind == "shuffle"] == [
        (32, 16), (64, 32), (64, 16), (128, 64), (128, 32), (128, 16)]
    # held in reverse, every register stage compares ascending or at a
    # direction fixed by the register (k < 16): none takes a thread's own
    assert all(not desc for k, _, kind, moves, _ in stages if kind == "registers" and k >= KEYS
               for *_, desc in moves)


@pytest.mark.parametrize("reverse", [True, False])
@pytest.mark.parametrize("keys", [4, 8, 16, 32])
def test_layout_is_the_probe_network(keys, reverse):
    """Each stage of each layout pairs key l with l ^ j, every key once,
    and puts each pair in the probe's order (probe_place.py:88-99, as
    row_sort_plain states it): ascending where l & k is 0. A shuffled
    register meets the same register of its partner, which holds the key
    l ^ j: a row's threads reverse together within a phase."""
    for k, j, kind, moves, held in kernel_stages(keys, reverse):
        assert kind == ("shuffle" if j >= keys else "registers")
        if kind == "registers":
            pairs = {}
            for t, qa, qb, desc in moves:
                la, lb = _key(keys, t, qa, held), _key(keys, t, qb, held)
                lo, hi = min(la, lb), max(la, lb)
                # positions ascending on reversed keys compare the other way
                pairs[(lo, hi)] = desc if la < lb else not desc
            assert set(pairs) == {(l, l ^ j) for l in range(128) if not l & j}
            assert all(desc == bool(lo & k) for (lo, _), desc in pairs.items())
        else:
            for t, partner, keep_min in moves:
                assert held[t] == held[partner]
                for q in range(keys):
                    l = _key(keys, t, q, held)
                    assert _key(keys, partner, q, held) == l ^ j
                    assert keep_min == ((not l & j) == (not l & k))  # lower of an ascending pair


@pytest.mark.parametrize("reverse", [True, False])
@pytest.mark.parametrize("keys", [4, 8, 16, 32])
def test_layout_equals_the_twin_on_edge_keys(keys, reverse):
    """NaN payloads, both zeros, infinities, denormals and runs: every bit
    as row_sort_plain's, each row a permutation of its input."""
    x = place.edge_keys(96, seed=4)
    got = layout_sort(x, keys, reverse)
    want = ac.row_sort_plain(torch.from_numpy(x)).numpy()
    assert _same_bits(got, want)
    assert (np.sort(got.view(np.uint32), 1) == np.sort(x.view(np.uint32), 1)).all()


def test_edge_keys_hold_every_kind():
    x = place.edge_keys(64)
    bits = x.view(np.uint32)
    assert np.isnan(x).any() and len(set(bits[np.isnan(x)].tolist())) >= 4
    assert (bits == 0).any() and (bits == 0x80000000).any() and np.isinf(x).any()
    assert (((bits & 0x7F800000) == 0) & ((bits & 0x007FFFFF) != 0)).any()  # denormals
    assert all(np.diff(row.view(np.uint32)).tolist().count(0) >= 7 for row in x[::3])


@contextlib.contextmanager
def _interpreted(pl, calls):
    """pl.pallas_call in interpret mode, recording each call's inputs and
    output as numpy arrays."""
    real = pl.pallas_call

    def recording(*args, **kwargs):
        kwargs.pop("interpret", None)
        call = real(*args, interpret=True, **kwargs)

        def run(*inputs):
            out = call(*inputs)
            calls.append(([np.asarray(x) for x in inputs], np.asarray(out)))
            return out

        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", recording)
        yield


def test_layout_is_the_jax_probe_on_p3():
    """benchmarks/probe_place.py's p3 kernel in interpret mode on its own
    input: the layout's output in every bit."""
    pytest.importorskip("jax")
    from jax.experimental import pallas as pl

    import weekend_raytracer_tpu.utils.cache as cache

    spec = importlib.util.spec_from_file_location("_bench_probe_place",
                                                  _BENCH / "probe_place.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cache, "enable_persistent_cache", lambda *a, **k: None)
        with _interpreted(pl, calls), contextlib.redirect_stdout(io.StringIO()):
            module.main()
    (x,), out = calls[2]  # p1, p2, p3, p4
    assert x.shape == (8, 128)
    assert _same_bits(layout_sort(x.astype(_F32)), out)
    assert _same_bits(out, np.sort(x, 1))
