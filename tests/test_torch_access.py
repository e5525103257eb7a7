"""The port's indexed-access kernels against the JAX package's probes, on
the CPU.

benchmarks/probe_place.py's main and probe_mosaic.py's ten lowering probes
run as they are, with ``pl.pallas_call`` in Pallas interpret mode, each
kernel's inputs and output recorded; every probe passes its own check, and
the port's wrapper on CPU tensors (its plain twin) gives the recorded
output bit for bit from the recorded inputs (probe_mosaic.py:277 compared
as int32; probe_mosaic.py:231 on the one row its kernel writes: it never
writes the rest of its output). The port's probes
build the same inputs. probe_gather_cost.py's smoke run passes its own
oracle, and its ``make_fn`` in interpret mode at 8 tiles and spans 1, 2, 4,
8 and 16 equals ``table_gather``'s twin on every route, bit for bit (the
probe's table is an arange, so "arith" adds what "global" fetches).

Then the slice as a whole: every probe of ``probes/place.py``,
``probes/mosaic.py`` and ``probes/gather_cost.py`` on the CPU at reduced
sizes (its twins; each checks its own expectations), the twins' own
contracts (the sort permutes each row and sorts it in value, the scan is
within its stated tolerance of cumsum, a later scratch write wins), and
the wrappers: CPU tensors never reach the library, CUDA tensors launch and
count, a launch error raises, shapes the kernels do not take are refused.
The ``cuda`` tests hold every kernel and route against its twin on the
card, through the probes, with their launches counted; they import no JAX:

    python -m pytest tests/test_torch_access.py --noconftest -q

The module runs PyTorch on one thread and computes each JAX reference
once.
"""
import contextlib
import importlib.util
import io
import json
import pathlib
import types

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from weekend_raytracer_tpu_torch.ops.cuda import access as ac  # noqa: E402
from weekend_raytracer_tpu_torch import probes  # noqa: E402
from weekend_raytracer_tpu_torch.probes import gather_cost, mosaic, place  # noqa: E402

_BENCH = pathlib.Path(__file__).resolve().parents[1] / "benchmarks"
_F32, _I32 = torch.float32, torch.int32


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


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


def _t(x):
    return torch.from_numpy(np.array(x))


_PLACE = ("p1", "p2", "p3", "p4")
_MOSAIC = tuple(name for name, _ in mosaic.PROBES)


@pytest.fixture(scope="module")
def jax_probes():
    """probe_place.main and the ten probe_mosaic probes in interpret mode:
    {name: (what the probe printed, its inputs, its output)}."""
    pytest.importorskip("jax")
    from jax.experimental import pallas as pl

    import weekend_raytracer_tpu.utils.cache as cache

    out = {}
    calls = []
    printed = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cache, "enable_persistent_cache", lambda *a, **k: None)
        with _interpreted(pl, calls), contextlib.redirect_stdout(printed):
            _load("probe_place").main()
    lines = printed.getvalue().splitlines()
    assert len(calls) == len(lines) == 4
    out.update({name: (line, *call) for name, line, call in zip(_PLACE, lines, calls)})
    module = _load("probe_mosaic")
    for name, fn in module.PROBES:
        if name not in _MOSAIC:
            continue
        calls = []
        printed = io.StringIO()
        with _interpreted(pl, calls), contextlib.redirect_stdout(printed):
            module.run(name, fn)
        assert len(calls) == 1
        out[name] = (printed.getvalue(), *calls[0])
    return out


def _twin(name, ins):
    """The port's wrapper (its twin, on CPU tensors) on a JAX probe's
    recorded inputs, shaped as the probe's output."""
    if name == "p1":  # x, i = [j, r]
        x, i = _t(ins[0]), _t(ins[1])
        got = ac.lane_gather(x, i[0:1].repeat(128).reshape(1, 128), rows=i[1:2].contiguous())
        return got[0, :1]
    if name == "p2":  # the indices written at; read back rotated by one
        idx = _t(ins[0])
        return ac.smem_rw(torch.zeros((1, 128), dtype=_I32), idx[[1, 2, 3, 0]],
                          vals=torch.arange(100, 104, dtype=_I32).reshape(4, 1),
                          write_idx=idx).reshape(4)
    if name == "p3":
        return ac.row_sort(_t(ins[0]))
    if name == "p4":  # the shift is the first lane of each row, as int32
        return ac.lane_gather(_t(ins[0]), shift=_t(ins[1])[:, 0].to(_I32))
    if name == "take_along_sublane":
        return ac.lane_gather(_t(ins[0]), _t(ins[1]), axis=0)
    if name in ("take_along_lane", "take_along_lane_32"):
        return ac.lane_gather(_t(ins[0]), _t(ins[1]))
    if name == "take_along_lane_1row":
        return ac.lane_gather(_t(ins[0][:1]), _t(ins[1][:1]))
    if name == "gather_bit_preserving":  # int32 patterns in and out as float32
        return ac.lane_gather(_t(ins[0]).view(_F32), _t(ins[1])).view(_I32)
    if name == "cumsum_lanes":
        return ac.lane_scan(_t(ins[0]))
    tab, i = _t(ins[0]), _t(ins[1])
    if name == "scalar_dynamic_read":
        return ac.smem_rw(tab.reshape(1, -1), i * 128).reshape(1)
    if name == "dynamic_slice_sublane":
        return ac.smem_rw(tab.reshape(1, -1), i * 8 * 128, 8 * 128).reshape(8, 128)
    if name == "dynamic_read_leading_3d":
        return ac.smem_rw(tab.reshape(1, -1), (i * 4 + 2) * 128, 128).reshape(1, 128)
    assert name == "dynamic_store_leading"  # the row x at [i, 2, :] of (8, 4, 128)
    return ac.smem_rw(torch.zeros((1, 4096)), torch.zeros(1, dtype=_I32), 4096, vals=tab,
                      write_idx=(i * 4 + 2) * 128).reshape(8, 4, 128)


@pytest.mark.parametrize("name", _PLACE + _MOSAIC)
def test_probe_twin_matches_jax(name, jax_probes):
    """The JAX probe passes its own check, and the port's twin gives its
    output bit for bit on the same inputs."""
    printed, ins, out = jax_probes[name]
    assert printed.startswith(("ok", "[ok]")), printed
    before = ac.launch_counts()
    got = _twin(name, ins).numpy()
    assert ac.launch_counts() == before  # CPU tensors took the twins
    if name == "dynamic_store_leading":  # the probe writes only [5, 2, :]
        i = int(ins[1][0])
        got, out = got[i, 2], out[i, 2]
    assert _same_bits(got, out)


def test_port_probes_build_the_jax_inputs(jax_probes):
    """The port's probes draw the JAX probes' own inputs."""
    def ins(name):
        return jax_probes[name][1]

    assert _same_bits(mosaic.seeded_lanes(32), ins("take_along_lane_32")[1])
    assert _same_bits(mosaic.seeded_lanes(8)[:1], ins("take_along_lane_1row")[1][:1])
    rng = np.random.default_rng(0)
    assert _same_bits(mosaic.bit_patterns(8, rng), ins("gather_bit_preserving")[0])
    assert _same_bits(rng.integers(0, 128, size=(8, 128), dtype=np.int32),
                      ins("gather_bit_preserving")[1])
    for name in ("take_along_sublane", "take_along_lane_32", "scalar_dynamic_read",
                 "dynamic_slice_sublane"):
        assert _same_bits(mosaic._arange_np(32), ins(name)[0])
    for name, i in mosaic._INDEX.items():
        assert int(ins(name)[1][0]) == i
    x = np.random.default_rng(0).integers(0, 128, size=(8, 128)).astype(np.float32)
    assert _same_bits(x, ins("p3")[0])
    assert list(ins("p2")[0]) == [7, 93, 12, 64] and list(ins("p1")[1]) == [37, 5]


# --- probe_gather_cost.py ------------------------------------------------

_SPANS = (1, 2, 4, 8, 16)
_TILES = 8


def test_gather_cost_smoke_passes_its_oracle(monkeypatch):
    """probe_gather_cost.py's own smoke run (interpret mode, spans 1 and 4
    at 8 tiles, against its numpy oracle)."""
    pytest.importorskip("jax")
    monkeypatch.setenv("WRT_PROBE_SMOKE", "1")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        assert _load("probe_gather_cost").main() == 0
    lines = [json.loads(line) for line in printed.getvalue().splitlines()]
    assert lines == [{"span_rows": 1, "smoke": "ok"}, {"span_rows": 4, "smoke": "ok"}]


@pytest.fixture(scope="module")
def make_fn_runs():
    """make_fn (:20) in interpret mode with main's in_specs at 8 tiles, the
    probe's (128, 128) arange table and its draws for spans 1-16 in order:
    {span: (table, indices, output)}."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    probe = _load("probe_gather_cost")
    tab = np.arange(128 * 128, dtype=np.float32).reshape(128, 128)
    rng = np.random.default_rng(0)
    out = {}
    for span in _SPANS:
        idx = gather_cost.span_indices(rng, 128, span, _TILES)
        call = pl.pallas_call(
            probe.make_fn(span, ac.N_FETCH, 128), grid=(_TILES,),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                      pl.BlockSpec((32, 128), lambda g: (g, 0), memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((32, 128), lambda g: (g, 0), memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((_TILES * 32, 128), jnp.float32), interpret=True)
        out[span] = (tab, idx, np.asarray(call(jnp.asarray(tab), jnp.asarray(idx))))
    return out


@pytest.mark.parametrize("span", _SPANS)
def test_table_gather_twin_matches_make_fn(span, make_fn_runs):
    """Every route's twin equals make_fn in interpret mode, bit for bit,
    and the probe's numpy oracle."""
    tab, idx, want = make_fn_runs[span]
    assert _same_bits(gather_cost.oracle(tab, idx, span), want)
    for route in ac.GATHER_ROUTES:
        got = ac.table_gather(_t(tab), _t(idx), span, route=route)
        assert _same_bits(got.numpy(), want), route


def test_table_gather_twin_wraps_as_jax_does():
    """Negative indices and spans that run past the table's end take jnp's
    floor modulo: the twin against the probe's numpy oracle (Python's %
    floors too) on a 24-row table."""
    rng = np.random.default_rng(3)
    tab = rng.standard_normal((24, 128)).astype(np.float32)
    idx = (rng.integers(-40 * 128, 40 * 128, size=(2 * 32, 128))).astype(np.int32)
    for span in (3, 24, 40):
        got = ac.table_gather(_t(tab), _t(idx), span, n_fetch=5)
        assert _same_bits(got.numpy(), gather_cost.oracle(tab, idx, span, n_fetch=5))


# --- the twins' own contracts ---------------------------------------------

def test_row_sort_twin_sorts_in_value_and_permutes():
    """On keys with repeats and both zeros, each row comes out as np.sort
    has it in value and holds the same multiset of bit patterns."""
    keys = place.fill_keys(16, seed=5)
    got = ac.row_sort(_t(keys)).numpy()
    assert (got == np.sort(keys, axis=1)).all()
    assert (np.sort(got.view(np.int32), axis=1) == np.sort(keys.view(np.int32), axis=1)).all()


def test_lane_scan_twin_is_cumsum_on_bits_and_near_it_on_floats():
    rng = np.random.default_rng(2)
    bits = (rng.random((16, 128)) < 0.5).astype(np.float32)
    assert _same_bits(ac.lane_scan(_t(bits)).numpy(), np.cumsum(bits, axis=1))
    x = _t(rng.standard_normal((16, 128)).astype(np.float32))
    assert mosaic.within_cumsum(x)(ac.lane_scan(x))
    assert not mosaic.within_cumsum(x)(ac.lane_scan(x) * (1 + 1e-3))


def test_smem_rw_twin_later_write_wins():
    base = torch.zeros((2, 64), dtype=_I32)
    vals = torch.tensor([[1, 2, 3], [7, 8, 9]], dtype=_I32)
    out = ac.smem_rw(base, torch.tensor([62], dtype=_I32), 5, vals=vals,
                     write_idx=torch.tensor([62, 63], dtype=_I32))
    assert out.tolist() == [[[1, 7, 8, 9, 0]]] * 2  # offsets wrap modulo 64


def direct_rule_np(base, read_idx, read_width, vals=None, write_idx=None):
    """smem_rw's function word by word, as the "direct" route computes it:
    output (b, m, w) is word a = (read_idx[m] + w) mod words of scratch b,
    the value of the last write k whose window write_idx[k] + [0, width)
    (mod words) covers a, else base[b, a]."""
    batch, words = base.shape
    out = np.empty((batch, len(read_idx), read_width), base.dtype)
    for m, r in enumerate(read_idx):
        for w in range(read_width):
            a = (int(r) + w) % words
            col = base[:, a]
            for k in range(0 if write_idx is None else len(write_idx) - 1, -1, -1):
                if write_idx is None:
                    break
                d = (a - int(write_idx[k])) % words
                if d < vals.shape[1]:
                    col = np.full(batch, vals[k, d], base.dtype)
                    break
            out[:, m, w] = col
    return out


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(st.data())
def test_smem_rw_direct_rule_is_the_twin(data):
    """The per-word rule of the "direct" route equals the twin's writes
    then reads, bit for bit, on seeded scratches: offsets beyond the
    scratch and negative (they wrap), overlapping writes (the later wins),
    and reads that wrap or cover the scratch more than once."""
    words = data.draw(st.integers(1, 40))
    batch = data.draw(st.integers(1, 3))
    n_writes = data.draw(st.integers(0, 5))
    width = data.draw(st.integers(1, words))
    read_width = data.draw(st.integers(1, 2 * words + 3))
    at = st.integers(-3 * words, 3 * words)
    read_idx = np.asarray(data.draw(st.lists(at, min_size=1, max_size=5)), np.int32)
    rng = np.random.default_rng(data.draw(st.integers(0, 2 ** 16)))
    base = rng.integers(-(1 << 31), 1 << 31, size=(batch, words), dtype=np.int64).astype(np.int32)
    vals = write_idx = None
    if n_writes:
        vals = rng.integers(-(1 << 31), 1 << 31, size=(n_writes, width),
                            dtype=np.int64).astype(np.int32)
        write_idx = np.asarray(data.draw(st.lists(at, min_size=n_writes, max_size=n_writes)),
                               np.int32)
    twin = ac.smem_rw_plain(_t(base), _t(read_idx), read_width,
                            None if vals is None else _t(vals),
                            None if write_idx is None else _t(write_idx))
    assert _same_bits(twin.numpy(), direct_rule_np(base, read_idx, read_width, vals, write_idx))


# --- the slice as a whole ------------------------------------------------

_CPU_SIZES = {"place": dict(fill_rows=64, reps=1), "mosaic": dict(fill_rows=64, reps=1),
              "gather_cost": dict(n_tiles=_TILES, reps=1)}
_MODULES = {"place": place, "mosaic": mosaic, "gather_cost": gather_cost}


@pytest.mark.parametrize("module,name", [(m, n) for m, mod in _MODULES.items()
                                         for n, _ in mod.PROBES])
def test_probe_runs_on_the_cpu(module, name, capsys):
    mod = _MODULES[module]
    kw = dict(_CPU_SIZES[module], **({"n_tiles": 2} if name == "texture" else {}))
    before = ac.launch_counts()
    assert mod.run(name, dict(mod.PROBES)[name], "cpu", **kw)
    line = json.loads(capsys.readouterr().out)
    assert line["ok"] and line["probe"] == name and line["row"]
    assert ac.launch_counts() == before  # the twins ran


@pytest.mark.parametrize("module,name", [(m, n) for m, mod in _MODULES.items()
                                         for n, _ in mod.PROBES])
def test_launch_table_counts_the_calls_a_probe_makes(module, name, monkeypatch, capsys):
    """Each wrapper counted on every call, as on the card: a probe run on
    the CPU makes exactly the calls its ``launches`` table counts, less the
    profiler's, which need the card."""
    for fn in ac._WRAPPERS:
        def counted(*a, _fn=fn, **k):
            _fn.launches += 1
            return _fn(*a, **k)

        monkeypatch.setattr(ac, fn.__name__, counted)
    mod = _MODULES[module]
    kw = dict(_CPU_SIZES[module], **({"n_tiles": 2} if name == "texture" else {}))
    ac.zero_launch_counts()
    assert mod.run(name, dict(mod.PROBES)[name], "cpu", **kw), capsys.readouterr().out
    assert ac.launch_counts() == mod.launches(name, reps=1, device_reps=0)
    ac.zero_launch_counts()


def test_launch_tables_name_every_kernel():
    for mod in _MODULES.values():
        for name, _ in mod.PROBES:
            counts = mod.launches(name)
            assert set(counts) == set(ac.KERNELS) and sum(counts.values()) > 0
    total = {k: sum(mod.launches(n)[k] for mod in _MODULES.values() for n, _ in mod.PROBES)
             for k in ac.KERNELS}
    assert all(total.values())


def test_fill_patterns_are_permutations_on_the_banks_they_name():
    pats = place.rw_fill_patterns()
    for pattern in pats.values():
        assert sorted(pattern) == list(range(place.RW_FILL_WORDS))
    warp = np.arange(32)
    assert len(set(pats["rotate"][warp] % 32)) == 32
    assert len(set(pats["stride32"][warp] % 32)) == 1


_MIB = 2**20


@pytest.mark.parametrize("base_mib,call_mib,copies", [
    (64, 32, 4),  # 10e's fill: 16 MiB read and 16 MiB written a call
    (64, 4, 25),  # 10i's: one 128-word row of each scratch
    (64, 128, 1),  # p2's: every word read and written, past the L2 alone
    (64, 1 / 32, 1),  # 10d's: one word a scratch, too few bytes to leave the L2
    (2048, 4, 1),  # 25 copies of 2 GiB: over ROTATE_LIMIT
])
def test_rotation_outgrows_the_l2_where_it_can(base_mib, call_mib, copies):
    call = int(call_mib * _MIB)
    got = place.rotation(int(base_mib * _MIB), call)
    assert got == copies
    if got > 1:  # the fewest copies whose round reaches ROTATE_BYTES
        assert got * call >= place.ROTATE_BYTES > (got - 1) * call


def test_rw_case_rotates_over_copies_of_the_base(monkeypatch):
    """With a round of calls smaller than ROTATE_BYTES, each call of the
    library and of every route goes to the next copy of the base, each case
    holds the twin's bits and the probe's expectation, and says how many
    copies it rotated over."""
    monkeypatch.setattr(place, "ROTATE_BYTES", 4096)
    base = torch.arange(8 * 64, dtype=_F32).reshape(8, 64)
    seen = []

    def library(b):
        seen.append(b.data_ptr())
        return b.index_select(1, torch.arange(3, 7))

    res = place.rw_case(base, torch.tensor([3], dtype=_I32),
                        place.equal_to(base.numpy()[:, None, 3:7]), "cpu", 2, 0, "rotate",
                        read_width=4, routes=("smem", "direct"), library=library)
    # a call: 8 scratches x 4 words read and written, and the index
    assert all(v["copies"] == 16 and not v["warm_l2"] for v in res.values())
    assert len(seen) == 9 and len(set(seen)) == 9 and base.data_ptr() in seen


@pytest.mark.parametrize("us,per_call,want", [
    ([1.0, 2.0] * 3, 2, 3e-3),  # every event: a call's sum
    ([1.0, 2.0, 1.0, 2.0, 1.0], 2, None),  # one lost: the sum would read low
    ([1.0, 2.0] * 3, 1, None),  # more events than one traced call had
    ([], 0, None),  # the traced call recorded none
])
def test_library_device_ms_needs_every_event(us, per_call, want):
    assert probes.library_device_ms(us, 3, per_call) == pytest.approx(want)


def test_host_parts_need_the_card():
    assert place.host_parts("cpu") is None


def test_device_times_is_none_off_the_card():
    """The profiler's device times need the card: on the CPU no function is
    called and there is no result."""
    calls = []
    assert probes.device_times({"f": lambda: calls.append(1)}, 3, "cpu") is None
    assert calls == []


def test_the_port_never_imports_jax():
    for module in (ac, place, mosaic, gather_cost):
        text = pathlib.Path(module.__file__).read_text()
        assert "import jax" not in text and "weekend_raytracer_tpu." not in text


# --- the wrappers: CPU tensors take the twins, CUDA tensors launch or raise


class _Stub:
    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


_C_FUNCTIONS = ("wrt_table_gather", "wrt_lane_gather", "wrt_smem_rw", "wrt_row_sort",
                "wrt_lane_scan")
_PLAINS = ("table_gather_plain", "lane_gather_plain", "smem_rw_plain", "row_sort_plain",
           "lane_scan_plain")


def _no_plain(*a, **k):
    raise AssertionError("the plain version ran for a CUDA tensor")


@pytest.fixture
def stub_library(monkeypatch):
    stubs = {name: _Stub() for name in _C_FUNCTIONS}

    class _Built:
        lib = types.SimpleNamespace(**stubs)

    monkeypatch.setattr(ac, "_device_type", lambda t: "cuda")
    monkeypatch.setattr(ac, "_library", lambda: _Built())
    monkeypatch.setattr(ac, "_stream_handle", lambda device: 77)
    for name in _PLAINS:
        monkeypatch.setattr(ac, name, _no_plain)
    return stubs


def _calls_of_each():
    """One call of each wrapper on small CPU tensors."""
    tab = torch.zeros((4, 128))
    idx = torch.zeros((32, 128), dtype=_I32)
    x = torch.zeros((32, 128))
    return [lambda: ac.table_gather(tab, idx, 2, route="shared"),
            lambda: ac.lane_gather(x, idx, axis=0, route="local"),
            lambda: ac.smem_rw(torch.zeros((2, 128), dtype=_I32), torch.zeros(3, dtype=_I32),
                               route="shfl"),
            lambda: ac.row_sort(x), lambda: ac.lane_scan(x)]


def test_cpu_tensors_never_reach_the_library(monkeypatch):
    def no_library():
        raise AssertionError("a CPU tensor reached the CUDA library")

    monkeypatch.setattr(ac, "_library", no_library)
    before = ac.launch_counts()
    for call in _calls_of_each():
        call()
    assert ac.launch_counts() == before


def test_wrappers_launch_for_cuda_tensors(stub_library):
    ac.zero_launch_counts()
    calls = _calls_of_each()
    for call in calls:
        call()
    assert ac.launch_counts() == dict.fromkeys(ac.KERNELS, 1)
    (tg,) = stub_library["wrt_table_gather"].calls
    assert tg[1:7] == (4, tg[2], 1, 2, ac.N_FETCH, 1) and tg[-1] == 77
    (lg,) = stub_library["wrt_lane_gather"].calls
    assert lg[1] == 32 and lg[3] is None and lg[4] is None and lg[5:8] == (32, 0, 2)
    (rw,) = stub_library["wrt_smem_rw"].calls
    assert rw[1:3] == (2, 128) and rw[3] is None and rw[5:7] == (0, 1) and rw[8:11] == (3, 1, 0)
    ac.lane_gather(torch.zeros((8, 128)), shift=torch.zeros(3, dtype=_I32),
                   rows=torch.zeros(3, dtype=_I32), route="smem")
    lg = stub_library["wrt_lane_gather"].calls[-1]
    assert lg[2] is None and lg[3] is not None and lg[4] is not None and lg[5:8] == (3, 1, 1)
    ac.zero_launch_counts()
    assert ac.launch_counts() == dict.fromkeys(ac.KERNELS, 0)


def test_smem_rw_direct_reaches_the_library(stub_library):
    """Route "direct" passes index 2, the writes and the reads as the other
    routes do, and counts its launch."""
    ac.zero_launch_counts()
    base = torch.zeros((3, 4096), dtype=_I32)
    vals = torch.zeros((2, 128), dtype=_I32)
    out = ac.smem_rw(base, torch.zeros(5, dtype=_I32), 1024, vals=vals,
                     write_idx=torch.zeros(2, dtype=_I32), route="direct")
    (rw,) = stub_library["wrt_smem_rw"].calls
    assert rw[0] == base.data_ptr() and rw[1:3] == (3, 4096) and rw[3] == vals.data_ptr()
    assert rw[5:7] == (2, 128) and rw[8:11] == (5, 1024, ac.RW_ROUTES.index("direct")) == \
        (5, 1024, 2) and rw[11] == out.data_ptr() and rw[12] == 77
    assert out.shape == (3, 5, 1024) and ac.launch_counts()["smem_rw"] == 1
    ac.zero_launch_counts()


@pytest.mark.parametrize("which", range(len(_C_FUNCTIONS)))
def test_wrappers_raise_on_launch_error(which, stub_library):
    stub_library[_C_FUNCTIONS[which]].rc = 700
    before = ac.launch_counts()
    with pytest.raises(RuntimeError, match="launch failed: CUDA error 700"):
        _calls_of_each()[which]()
    assert ac.launch_counts() == before


@pytest.mark.parametrize("bad", ["table_width", "tile_rows", "span", "shared_span", "route",
                                 "lane_both", "lane_axis0_rows", "lane_rows_len", "lane_dtype",
                                 "rw_shfl_words", "rw_smem_words", "rw_write_width",
                                 "rw_vals_alone", "sort_width", "devices",
                                 "rw_direct_writes", "rw_direct_output"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    tab, x = torch.zeros((4, 128)), torch.zeros((32, 128))
    idx = torch.zeros((32, 128), dtype=_I32)
    at = torch.zeros(3, dtype=_I32)
    with pytest.raises(ValueError):
        if bad == "table_width":
            ac.table_gather(torch.zeros((4, 64)), idx, 1)
        elif bad == "tile_rows":
            ac.table_gather(tab, idx[:8].contiguous(), 1)
        elif bad == "span":
            ac.table_gather(tab, idx, 0)
        elif bad == "shared_span":
            ac.table_gather(tab, idx, ac.MAX_SHARED_SPAN + 1, route="shared")
        elif bad == "route":
            ac.lane_gather(x, idx, route="texture")
        elif bad == "lane_both":
            ac.lane_gather(x, idx, shift=at)
        elif bad == "lane_axis0_rows":
            ac.lane_gather(x, idx, rows=torch.zeros(32, dtype=_I32), axis=0)
        elif bad == "lane_rows_len":
            ac.lane_gather(x, idx, rows=at)
        elif bad == "lane_dtype":
            ac.lane_gather(x.double(), idx)
        elif bad == "rw_shfl_words":
            ac.smem_rw(torch.zeros((1, 96)), at, route="shfl")
        elif bad == "rw_smem_words":
            ac.smem_rw(torch.zeros((1, ac.MAX_SHARED_BYTES // 4 + 1)), at)
        elif bad == "rw_write_width":
            ac.smem_rw(torch.zeros((1, 32)), at, vals=torch.zeros((1, 33)),
                       write_idx=at[:1].contiguous())
        elif bad == "rw_vals_alone":
            ac.smem_rw(torch.zeros((1, 32)), at, vals=torch.zeros((1, 3)))
        elif bad == "sort_width":
            ac.row_sort(torch.zeros((4, 64)))
        elif bad == "rw_direct_writes":
            n = ac.MAX_DIRECT_WRITES + 1
            ac.smem_rw(torch.zeros((1, 32)), at, vals=torch.zeros((n, 1)),
                       write_idx=torch.zeros(n, dtype=_I32), route="direct")
        elif bad == "rw_direct_output":  # 2 x 3 x 2^30 output words
            ac.smem_rw(torch.zeros((2, 32)), at, 1 << 30, route="direct")
        else:
            ac.lane_gather(x, idx.to("meta"))


# --- on the card ---------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


_CUDA_SIZES = {"place": dict(fill_rows=4096, reps=2), "mosaic": dict(fill_rows=4096, reps=2),
               "gather_cost": dict(reps=2)}


@pytest.mark.cuda
@pytest.mark.parametrize("module,name", [(m, n) for m, mod in _MODULES.items()
                                         for n, _ in mod.PROBES])
def test_probe_holds_every_route_on_the_card(module, name, cuda, capsys):
    """Each probe on the card: every route of its kernel equal to its twin
    in every bit at the probe's shape and a reduced fill, with exactly the
    launches the probe's table counts."""
    mod = _MODULES[module]
    kw = _CUDA_SIZES[module]
    ac.zero_launch_counts()
    assert mod.run(name, dict(mod.PROBES)[name], cuda, **kw), capsys.readouterr().out
    torch.cuda.synchronize()
    assert ac.launch_counts() == mod.launches(name, reps=kw["reps"])


class _NoDeviceEvents:
    """A profiler whose trace recorded no device event, though it kept its
    primer kernels (utils.metrics.Trace)."""

    complete = True

    def events(self):
        return []


@pytest.mark.cuda
@pytest.mark.parametrize("recorded", [True, False])
def test_device_times_calls_each_function_reps_times(recorded, cuda, monkeypatch):
    """Each function is called ``reps`` times and no more, whether the
    profiler recorded its device events (their mean) or none of them (the
    CUDA events of the same calls)."""
    if not recorded:
        @contextlib.contextmanager
        def empty_trace(log_dir):
            yield _NoDeviceEvents()

        monkeypatch.setattr("weekend_raytracer_tpu_torch.utils.metrics.profiler_trace",
                            empty_trace)
    x = place.arange_table(8, cuda)
    idx = torch.zeros((8, 128), dtype=_I32, device=cuda)
    fns = {route: (lambda route=route: ac.lane_gather(x, idx, route=route))
           for route in ac.LANE_ROUTES}
    ac.zero_launch_counts()
    out = probes.device_times(fns, 4, cuda)
    torch.cuda.synchronize()
    assert ac.launch_counts()["lane_gather"] == 4 * len(fns)
    by = "profiler" if recorded else "cuda_events"
    assert all(v["device_ms_by"] == by and v["device_ms"] > 0 for v in out.values()), out
