"""The index walks of two redesigned probe kernels, replicated in NumPy and
held against the plain twins on the CPU (the kernels are CUDA and run only
on the card; tests/test_torch_cuda.py holds them there).

table_gather (csrc/access.cu): a lane takes one modulo, its offset (idx -
span_base) mod W, W = span_rows * 128, then steps it by 37 and wraps it by
a compare; the address is the tile's row base (span_base's row mod
table_rows) times 128 plus the offset, less the table's words if it passes
them. A tile whose ints could overflow, or a span longer than the table,
takes the two floor modulos of every fetch in 32-bit int arithmetic. The
replica below makes the same choices per tile and must give the twin's
addresses, fetch by fetch, on adversarial inputs: spans longer than
the table, tables of 1, 3, 24 and 100 rows, negative indices, tiles at
the ends of the int range and spread over 2^31, n_fetch 0 and 1. The
"shared" route's staging steps its rows by the block's 2 mod table_rows.

sweep_mma (csrc/sweep.cu): ``survivor_plain``, the kernel's survivor walk
on the twin's products, equals ``sweep_plain`` in every bit at p5's size,
and merging any split of the tiles on (t, index) gives the same bits, as
the kernel's warps and windows merge.
"""
import numpy as np
import pytest
import torch

from weekend_raytracer_tpu_torch.ops.cuda import access as ac
from weekend_raytracer_tpu_torch.ops.cuda import sweep as sw
from weekend_raytracer_tpu_torch.probes import mxu_sweep as ms

INT_MAX = 2**31 - 1
THREADS = 256  # access.cu kGatherThreads
LANES = ac.TILE_ROWS * ac.WIDTH


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _int32(x):
    """Two's-complement wrap of int64 values to int32, as the kernel's ints."""
    return ((x + 2**31) % 2**32) - 2**31


def walk(idx: np.ndarray, span_rows: int, table_rows: int, n_fetch: int,
         route: str = "global"):
    """table_gather's addresses, fetch by fetch ([n_fetch, lanes] int64,
    row * 128 + col), as the kernel forms them; and the share of lanes whose
    tile stepped."""
    tiles = idx.reshape(-1, LANES).astype(np.int64)
    span_base = tiles.min(axis=1, keepdims=True) & ~(ac.WIDTH - 1)
    words = span_rows * ac.WIDTH
    d = (tiles - span_base) & 0xFFFFFFFF  # the unsigned difference
    last = ac.FETCH_STRIDE * max(n_fetch - 1, 0)
    general = np.broadcast_to(
        route != "shared" and (span_rows > table_rows or table_rows > INT_MAX // 256)
        or np.zeros_like(span_base, bool), tiles.shape)
    if route != "shared":
        general = general | (span_base > INT_MAX - words)
    general = general | (d > INT_MAX - last).any(axis=1, keepdims=True)
    off = d % words
    row_base = ((span_base >> 7) % table_rows) * ac.WIDTH
    out = []
    for k in range(n_fetch):
        if route == "shared":  # staged word off: test_shared_staging_steps_its_rows
            at = ((_int32(span_base + off) >> 7) % table_rows) * ac.WIDTH + (off & 127)
        else:
            at = row_base + off
            at = np.where(at >= table_rows * ac.WIDTH, at - table_rows * ac.WIDTH, at)
        off_k = _int32(d + ac.FETCH_STRIDE * k) % words  # the two modulos, int32
        flat = _int32(span_base + off_k)
        at_k = ((flat >> 7) % table_rows) * ac.WIDTH + (flat & (ac.WIDTH - 1))
        out.append(np.where(general, at_k, at))
        off = off + ac.FETCH_STRIDE
        off = np.where(off >= words, off - words, off)
    shape = (n_fetch, *idx.shape)
    return np.array(out, dtype=np.int64).reshape(shape), 1.0 - float(general.mean())


def twin_addresses(idx: np.ndarray, span_rows: int, table_rows: int, n_fetch: int):
    """The twin's addresses, fetch by fetch: the differences of its "arith"
    sums over k and k + 1 fetches (each sum an exact integer here)."""
    tab = torch.zeros((table_rows, ac.WIDTH))
    t_idx = torch.from_numpy(idx)
    sums = [np.zeros(idx.shape)] + [
        ac.table_gather_plain(tab, t_idx, span_rows, k, "arith").double().numpy()
        for k in range(1, n_fetch + 1)]
    diffs = [sums[k + 1] - sums[k] for k in range(n_fetch)]
    return np.array(diffs).astype(np.int64).reshape(n_fetch, *idx.shape)


def oracle_addresses(idx: np.ndarray, span_rows: int, table_rows: int, n_fetch: int,
                     wrap: bool = True):
    """The probe's numpy oracle's addresses, fetch by fetch, as
    ``twin_addresses`` takes the twin's: on the int32 indices (its ints
    wrap as the twin's), or with ``wrap=False`` on int64 ones (the rows the
    kernel before staged for "shared")."""
    from weekend_raytracer_tpu_torch.probes import gather_cost as gc

    tab = np.arange(table_rows * ac.WIDTH, dtype=np.float32).reshape(table_rows, ac.WIDTH)
    base = idx if wrap else idx.astype(np.int64)
    with np.errstate(over="ignore"):
        sums = [np.zeros(idx.shape)] + [gc.oracle(tab, base, span_rows, k).astype(np.float64)
                                        for k in range(1, n_fetch + 1)]
    diffs = [sums[k + 1] - sums[k] for k in range(n_fetch)]
    return np.array(diffs).astype(np.int64).reshape(n_fetch, *idx.shape)


def _tiles(rng, lo, hi, n_tiles=1):
    return rng.integers(lo, hi, size=(n_tiles * ac.TILE_ROWS, ac.WIDTH),
                        dtype=np.int64).astype(np.int32)


def _adversarial():
    """{name: indices}: the probe's draws, negative indices, tiles at the
    ends of the int range and one spread over 2^31."""
    rng = np.random.default_rng(7)
    from weekend_raytracer_tpu_torch.probes import gather_cost as gc

    spread = _tiles(rng, -2**31, 2**31 - 1, 1)
    spread[0, :2] = (-2**31, 2**31 - 1)
    return {"probe": gc.span_indices(rng, 128, 16, 1),
            "negative": _tiles(rng, -40 * 128, 40 * 128),
            "top": _tiles(rng, INT_MAX - 3000, INT_MAX),
            "bottom": _tiles(rng, -2**31, -2**31 + 3000),
            "spread": spread}


@pytest.mark.parametrize("table_rows", [1, 3, 24, 100])
def test_stepped_walk_is_the_twins_addresses(table_rows):
    """Every fetch's address of the kernel's walk equals the twin's, for
    spans shorter than, equal to and longer than the table, 0 to 16
    fetches; the walk steps wherever it can."""
    stepped, crossed = [], 0
    for name, idx in _adversarial().items():
        for span in sorted({1, 3, table_rows, table_rows + 7, 40}):
            every = twin_addresses(idx, span, table_rows, 16)  # fetch k's, whatever n_fetch
            for n_fetch in (0, 1, 5, 16):
                want = every[:n_fetch]
                for route in ("global", "shared"):
                    got, share = walk(idx, span, table_rows, n_fetch, route)
                    assert np.array_equal(got, want), (name, span, n_fetch, route)
                    stepped.append((name, span <= table_rows, route, share))
            if name == "top":  # a span past 2^31: the staged rows wrap, as the twin's
                crossed += not np.array_equal(
                    every, oracle_addresses(idx, span, table_rows, 16, wrap=False))
    # the probe's and the negative indices step wherever the span fits the
    # table ("shared" always); the tile spread over 2^31 never does
    for name, fits, route, share in stepped:
        if name in ("probe", "negative") and (fits or route == "shared"):
            assert share == 1.0, (name, route)
        if name == "spread":
            assert share == 0.0
    assert crossed > 0 or table_rows == 1  # one row: every flat is row 0


def test_stepped_walk_sums_are_the_twins():
    """The walk's fetches from a table, summed in k order, equal the twin's
    "global" sums in every bit."""
    rng = np.random.default_rng(11)
    tab = rng.standard_normal((24, ac.WIDTH)).astype(np.float32)
    idx = _adversarial()["negative"]
    for span in (3, 24, 40):
        at, _ = walk(idx, span, 24, 16)
        acc = np.zeros(idx.shape, np.float32)
        for k in range(16):
            acc = acc + tab.reshape(-1)[at[k]]
        want = ac.table_gather_plain(torch.from_numpy(tab), torch.from_numpy(idx), span)
        assert np.array_equal(acc.view(np.int32), want.numpy().view(np.int32)), span


@pytest.mark.parametrize("table_rows", [1, 3, 4, 5, 24, 128])
def test_shared_staging_steps_its_rows(table_rows):
    """Staged word i of "shared" holds table row (span_base's row + i >> 7)
    mod table_rows: thread t starts at row (row0 + t >> 7) mod rows and
    steps by the block's 256 threads / 128 = 2 mod rows with one compare,
    as the kernel does."""
    for row0 in (-7, 0, 5, 1000):
        span_words = 40 * ac.WIDTH
        want = [(row0 + (i >> 7)) % table_rows for i in range(span_words)]
        got = [0] * span_words
        for t in range(THREADS):
            row, step = (row0 + (t >> 7)) % table_rows, (THREADS // ac.WIDTH) % table_rows
            for i in range(t, span_words, THREADS):
                got[i] = row
                row += step
                if row >= table_rows:
                    row -= table_rows
        assert got == want, (table_rows, row0)


def _p5():
    c, r, o, d = ms.scene(ms.PROBE["spheres"], ms.PROBE["rays"])
    kq = ms.sphere_kq(c, r)
    return torch.from_numpy(ms.probe_amat(c, kq).T[None].copy()), ms.probe_planes(o, d, "cpu")


@pytest.mark.parametrize("prec", ["tf32", "3xtf32"])
@pytest.mark.parametrize("packed", [False, True])
def test_survivor_walk_is_the_twin(prec, packed):
    """At p5's size (32 spheres x 4,096 rays): the survivor walk's (t,
    index) equal sweep_plain's in every bit, the pre-test keeps exactly the
    pairs with a real root, and its census counts them."""
    amats, planes = _p5()
    rays = sw.packed_b(planes) if packed else planes
    (t, i), census = sw.survivor_plain(amats, rays, prec, iters=3)
    want = sw.sweep_plain(amats, rays, prec)
    assert torch.equal(t.view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(i, want[1])
    bm = sw.packed_b(planes)
    out = sw.dot_plain(amats[0].transpose(0, 1), bm, prec)
    od = bm[0] * bm[3] + bm[1] * bm[4] + bm[2] * bm[5]
    oo = bm[3] * bm[3] + bm[4] * bm[4] + bm[5] * bm[5]
    b = out[:32] - od
    disc = b * b - (oo + out[32:])
    assert torch.equal(torch.sqrt(disc) > 0.0, disc > 0.0)
    assert census["kept"] == 3 * int((disc > 0.0).sum()) > 0
    assert census["pairs"] == 3 * 32 * 4096 and census["steps"] == 3 * 2 * 4096 // 8
    assert census["kept"] / 32 <= census["rounds"] <= census["kept"]


def test_real_root_pairs_are_the_pairs_the_pre_test_keeps():
    """The bound's count of pairs with a real root (mxu_sweep.real_root_pairs,
    float32 from the sweep table) is the survivor census's kept pairs at
    p5's size, within 0.1% on 3xTF32's products and 5% on TF32's, which
    move a discriminant near 0 across it (742 kept against 726 here)."""
    c, r, o, d = ms.scene(32, 4096)
    kq = ms.sphere_kq(c, r)
    table, planes = ms.probe_table(c, kq, "cpu"), ms.probe_planes(o, d, "cpu")
    amats = torch.from_numpy(ms.probe_amats(c, kq, 1, 32))
    kept = ms.real_root_pairs(table, planes)
    assert kept == ms.real_root_pairs(table, planes, chunk=5) > 0
    for prec, tol in (("tf32", 0.05), ("3xtf32", 1e-3)):
        census = sw.survivor_plain(amats, planes, prec)[1]
        assert abs(census["kept"] - kept) <= tol * kept, (prec, census, kept)


def test_any_split_of_the_tiles_merges_to_the_same_bits():
    """Runs of 16-sphere tiles swept apart (as the kernel's warps and
    windows sweep them) and merged on (t, index), the first index winning,
    give sweep_plain's bits: p8c16's 20 tiles in uneven runs."""
    c, r, o, d = ms.scene(320, 2048)
    amats = torch.from_numpy(ms.probe_amats(c, ms.sphere_kq(c, r), 20, 16))
    planes = ms.probe_planes(o, d, "cpu")
    want = sw.sweep_plain(amats, planes, "tf32")
    for runs in ((0, 20), (0, 3, 8, 20), (0, 1, 2, 19, 20), tuple(range(21))):
        t = torch.full((2048,), sw.MAX_T)
        i = torch.full((2048,), -1, dtype=torch.int32)
        for lo, hi in zip(runs, runs[1:]):
            (rt, ri), _ = sw.survivor_plain(amats[lo:hi], planes, "tf32")
            ri = torch.where(ri >= 0, ri + 16 * lo, ri)
            take = (rt < t) | ((rt == t) & (ri < i))
            t, i = torch.where(take, rt, t), torch.where(take, ri, i)
        assert torch.equal(t.view(torch.int32), want[0].view(torch.int32)), runs
        assert torch.equal(i, want[1]), runs
