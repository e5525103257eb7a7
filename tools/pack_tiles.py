#!/usr/bin/env python3
"""Time regroup's PACK (csrc/regroup.cu ``regroup_pack``) at other tile
sizes and load depths than the ones it is built with, on one CUDA card.

    python3 tools/pack_tiles.py [--baseline NAME=CSRC_DIR ...]

Builds regroup.cu once per variant, with ``kPackItems`` (a tile is 1024
slots per item) and ``kPackDepth`` (planes whose loads are in flight at
once) set to other values, and once per tile size with a grid of one block,
so that the tiles run one after another and the time per tile is one
tile's latency. Each ``--baseline`` adds, under its name, the regroup.cu
of another checkout's csrc/ directory whose ``wrt_regroup_pack`` takes the
same arguments (the scratch sized for the smallest tile here), e.g. an
older PACK. Each variant is held against ``pack_plain`` bit for bit and
timed on the three PACK inputs of an RTiOW frame (K0, then PACK and K1 at
each cut) and on a one-tile input, at 480x270 x 4 spp and 1920x1080 x 32
spp. Each launch is timed alone with CUDA events, after the L2 cache is
flushed, and the least of a few launches kept. Prints the card's name and
power limit, then one JSON line per shape: ms per launch for each input and
variant, in two turns (variants in order, then reversed; the one-block
variants once).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from chip_smoke import _CUTS, _case, _nvidia_smi  # noqa: E402
from variants import build_all, copy_csrc  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import build  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import megakernel as mk  # noqa: E402
from weekend_raytracer_tpu_torch.ops.cuda import regroup as rg  # noqa: E402

OUT = build.BUILD_DIR / "pack_tiles"
L2_FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2
SHAPES = ((480, 270, 4), (1920, 1080, 32))
# name: (items, depth, one block)
VARIANTS = {"i4d1": (4, 1, False), "i4d2": (4, 2, False), "i2d1": (2, 1, False),
            "i2d2": (2, 2, False), "i1d2": (1, 2, False), "i4d2_grid1": (4, 2, True),
            "i2d2_grid1": (2, 2, True), "i1d2_grid1": (1, 2, True)}
GRID = "std::max(1LL, std::min(static_cast<long long>(per_sm) * sms, tiles))"


def _variant(name: str, items: int, depth: int, grid1: bool) -> pathlib.Path:
    """A copy of csrc/ whose regroup.cu has this variant's constants."""
    path = copy_csrc(ROOT, OUT / name, "regroup.cu", {"kPackItems": items, "kPackDepth": depth})
    if grid1:
        src = path.read_text()
        if GRID not in src:
            raise RuntimeError("regroup.cu's PACK grid expression has changed")
        path.write_text(src.replace(GRID, "1LL"))
    return path


def _build(sources: dict) -> dict:
    """One nvcc per variant, all at once; {name: (wrt_regroup_pack, registers)}."""
    out = {}
    for name, (lib, log) in build_all(sources).items():
        fn = lib.wrt_regroup_pack
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        regs = [u.get("registers") for k, u in build.parse_ptxas(log).items() if "pack" in k]
        out[name] = (fn, regs)
    return out


def _inputs(w: int, h: int, spp: int):
    """The tiling and the three PACK inputs of an RTiOW frame: (pool, count)."""
    dev = torch.device("cuda")
    inp = mk.kernel_inputs(*_case("rtiow", w, h, "cuda"))
    t = rg.plan(w, h, spp, 8, _CUTS)[0]
    pool = torch.empty((rg.N_COMP, t.cap), device=dev)
    rg.launch_k0(inp, pool, torch.empty((3, t.cap), device=dev), t, 0, _CUTS[0])
    counts = torch.tensor([t.cap, 0, 0, 0], dtype=torch.int32, device=dev)
    r8 = torch.empty((3, t.cap), device=dev)
    inputs = []
    for k, b_lo in enumerate(_CUTS, 1):
        inputs.append((pool, int(counts[k - 1])))
        dense = torch.empty_like(pool)
        rg.launch_pack(pool, dense, torch.empty((t.cap,), dtype=torch.int32, device=dev),
                       counts, k, rg.pack_scratch(t.cap, dev))
        rg.launch_k1(inp, dense, r8, counts, k, t, 0, b_lo,
                     _CUTS[k] if k < len(_CUTS) else 8)
        pool = dense
    return t, inputs


def _launcher(fn, src, dst, inv, scratch, n_in: int):
    dev = src.device
    counts = torch.tensor([n_in, 0], dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        err = fn(src.data_ptr(), dst.data_ptr(), inv.data_ptr(), counts.data_ptr(),
                 counts.data_ptr() + 4, scratch.data_ptr(), src.shape[1], stream)
        if err:
            raise RuntimeError(f"PACK variant failed: CUDA error {err}")

    return launch, counts


def _agrees(fn, src, n_in: int, dst, inv, scratch) -> bool:
    """The variant's count, inverse map and dense pool (up to its padded
    last row) against pack_plain's, in every bit."""
    ref = [torch.tensor([n_in, 0], dtype=torch.int32, device=src.device),
           torch.full_like(dst, 7.0), torch.full_like(inv, -7)]
    rg.pack_plain(src, ref[1], ref[2], ref[0], 1)
    dst.fill_(7.0)
    inv.fill_(-7)
    launch, counts = _launcher(fn, src, dst, inv, scratch, n_in)
    launch()
    torch.cuda.synchronize()
    n = int(ref[0][1])
    end = -(-n // 128) * 128
    return (int(counts[1]) == n and torch.equal(inv[:n_in], ref[2][:n_in])
            and torch.equal(dst[:, :end].view(torch.int32), ref[1][:, :end].view(torch.int32)))


def _ms(launch, reps: int, flush) -> float:
    """The least device time of one launch, each launch timed by CUDA events
    of its own after ``flush`` is overwritten (so that the L2 cache holds
    none of the input, as in a frame, where K1 runs between two PACKs)."""
    launch()
    best = float("inf")
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", action="append", default=[], metavar="NAME=CSRC_DIR",
                    help="another checkout's csrc/ directory, its regroup.cu timed too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pack_tiles: no CUDA device", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {name: _variant(name, *v) for name, v in VARIANTS.items()}
    for spec in args.baseline:
        name, _, path = spec.partition("=")
        sources[name] = copy_csrc(pathlib.Path(path).resolve(), OUT / name, "regroup.cu")
    libs = _build(sources)
    print(_nvidia_smi(), flush=True)
    print(json.dumps({"registers": {k: v[1] for k, v in libs.items()}}), flush=True)
    dev = torch.device("cuda")
    ok = True
    for w, h, spp in SHAPES:
        t, inputs = _inputs(w, h, spp)
        cases = {f"pack{k}": x for k, x in enumerate(inputs, 1)}
        cases["one_tile"] = (inputs[0][0], 1024 * max(v[0] for v in VARIANTS.values()))
        dst = torch.empty((rg.N_COMP, t.cap), device=dev)
        inv = torch.empty((t.cap,), dtype=torch.int32, device=dev)
        scratch = torch.zeros((t.cap // 1024 + 1,), dtype=torch.int64, device=dev)
        bad = [f"{c}:{v}" for c, (src, n) in cases.items() for v, (fn, _) in libs.items()
               if not _agrees(fn, src, n, dst, inv, scratch)]
        ok = ok and not bad
        reps = 20 if t.cap < 1 << 23 else 5
        flush = torch.empty((L2_FLUSH_BYTES // 4,), device=dev)
        ms = {f"{c}:{v}": [] for c in cases for v in libs}
        for v in list(libs) + list(reversed(libs)):
            if v.endswith("grid1") and len(ms[f"pack1:{v}"]):
                continue  # one turn: a grid of one block is slow at 1080p
            for c, (src, n) in cases.items():
                launch, _ = _launcher(libs[v][0], src, dst, inv, scratch, n)
                ms[f"{c}:{v}"].append(_ms(launch, 1 if v.endswith("grid1") else reps, flush))
        print(json.dumps({"shape": f"rtiow {w}x{h} spp{spp}", "cap": t.cap,
                          "n_in": [n for _, n in inputs], "bit_exact": not bad, "differs": bad,
                          "ms": ms}), flush=True)
        del inputs, cases, dst, inv, scratch, flush
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
