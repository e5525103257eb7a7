"""benchmarks/probe_binned.py on the port: does sorting the live records of a
cut by direction and origin make K1 cheaper, and what does the reorder cost?

Runs the port's regroup K0 and PACK to a cut (frame 0), keys each live
(dense) record by a bin scheme on the device, sorts each key stably, applies
the order to the SoA dense pool with ``record_gather`` (the last dense row
keeps PACK's dead records, so the count is unchanged), and times K1 over
[cut, bounces) on each permutation, then reads K1-stats' cull counters on
it. Keys (probe_binned.py:225-272; origin cell = quantized hit position,
octant = sign pattern of the outgoing direction):

    home        no permutation (baseline)
    oct         direction octant only (8 bins)
    cell64      8x1x8 origin cells
    cell16xoct / cell64xoct / cell256xoct   4x1x4 / 8x1x8 / 16x1x16 cells x octant
    chunk       the chunk whose AABB lies nearest the origin
    chunkxoct   that chunk x octant

K1 re-derives each record's RNG from its home slot, so a record's result
does not depend on where it sits: after K1 on a permuted pool,
``record_scatter`` puts the records and their radiance back in home order,
and they must equal the home-order K1's in every bit (a failure raises).
The probe's own check, the live records' throughput sum before K1, is kept
as ``in_sum_rel_err``.

    python -m weekend_raytracer_tpu_torch.probes.binned [cut] [rtiow|random10k] [quick] [dump]

Defaults as the probe's: cut 3, 8 bounces, 4 spp, RTiOW at 1920x1080 or
random_spheres(10000) at 3840x2160; ``quick`` runs five schemes and three
K1 repetitions instead of eight and five; ``dump`` saves the live records
and the scene's chunk and sphere arrays to the temporary directory and
stops. One JSON line per scheme. It runs on the CUDA device; ``run(...,
device="cpu")`` runs the kernels' plain twins.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np
import torch

from ..models.camera import CameraBasis
from ..models.scenes import SCENES
from ..models.sky import SkyParams, to_sky_state
from ..ops.cuda import megakernel as mk
from ..ops.cuda import regroup as rg
from ..ops.cuda import reorder as ro
from . import card, same_bits, time_call

QUICK_SCHEMES = ("home", "oct", "cell16xoct", "cell64xoct", "chunkxoct")
SCHEMES = QUICK_SCHEMES + ("cell64", "cell256xoct", "chunk")
SHAPES = {"rtiow": (1920, 1080), "random10k": (3840, 2160)}
SPP, BOUNCES, CUT = 4, 8, 3
CHUNK_BATCH = 1 << 18  # records per batch of the nearest-chunk search
_LANES = rg.TILE_RECORDS  # records of a dense TPU tile, the counters' row


def scene_inputs(scene: str, width: int, height: int, device):
    """The probe's scene, camera and default sky on ``device``: (kernel
    inputs, camera basis)."""
    build, camera = SCENES[scene]
    basis = CameraBasis.create(camera(), (width, height), device=device)
    inp = mk.kernel_inputs(build().build(device=device), to_sky_state(SkyParams(), device=device),
                           basis)
    return inp, basis


def _kernels(device):
    """K0, PACK and K1: the CUDA wrappers, or their twins on the CPU."""
    if torch.device(device).type == "cuda":
        return rg.launch_k0, rg.launch_pack, rg.launch_k1
    return rg.k0_plain, rg.pack_plain, rg.k1_plain


def dense_pool(inp: mk.KernelInputs, t: rg.Tiling, cut: int, device):
    """K0 (bounces [0, cut), frame 0) and PACK: the dense pool [16, cap],
    its counts [cap, live] and the live record count."""
    k0, pack, _ = _kernels(device)
    pool = torch.empty((rg.N_COMP, t.cap), device=device)
    k0(inp, pool, torch.empty((3, t.cap), device=device), t, 0, cut)
    dense = torch.empty_like(pool)
    counts = torch.tensor([t.cap, 0], dtype=torch.int32, device=device)
    pack(pool, dense, torch.empty((t.cap,), dtype=torch.int32, device=device), counts, 1,
         rg.pack_scratch(t.cap, device))
    return dense, counts, int(counts[1])


def _chunk_bounds(inp: mk.KernelInputs) -> torch.Tensor:
    if not inp.n_chunks:
        raise ValueError("the chunk keys need a scene with a chunk hierarchy")
    return inp.chunk_bounds[:, :inp.n_tests]


def nearest_chunk(o, bounds: torch.Tensor) -> torch.Tensor:
    """Index of the chunk AABB nearest each origin (0 inside it; the first
    on ties), in batches of CHUNK_BATCH (probe_binned.py:244-260)."""
    ox, oy, oz = o
    n = ox.numel()
    out = torch.empty((n,), dtype=torch.int64, device=ox.device)
    for lo in range(0, n, CHUNK_BATCH):
        hi = min(lo + CHUNK_BATCH, n)
        d2 = None
        for axis, p in enumerate((ox[lo:hi, None], oy[lo:hi, None], oz[lo:hi, None])):
            q = torch.minimum(torch.maximum(p, bounds[axis]), bounds[axis + 3]) - p
            d2 = q * q if d2 is None else d2 + q * q
        out[lo:hi] = d2.argmin(1)
    return out


def bin_keys(dense: torch.Tensor, n: int, inp: mk.KernelInputs, schemes=SCHEMES) -> dict:
    """Each scheme's int64 key of the n live records of ``dense``, on its
    device (None for home), as probe_binned.py:225-272 computes them."""
    if n <= 0:
        raise ValueError("no live records at the cut")
    rec = dense[:, :n]
    ox, oy, oz = rec[rg._OX], rec[rg._OY], rec[rg._OZ]
    octant = ((rec[rg._DX] >= 0).long() * 4 + (rec[rg._DY] >= 0).long() * 2
              + (rec[rg._DZ] >= 0).long())
    lo = torch.stack([ox.min(), oy.min(), oz.min()])
    span = torch.clamp(torch.stack([ox.max(), oy.max(), oz.max()]) - lo, min=1e-6)

    def cell(nx, ny, nz):
        c = [torch.clamp(((v - lo[a]) / span[a] * m).long(), max=m - 1)
             for a, (v, m) in enumerate(((ox, nx), (oy, ny), (oz, nz)))]
        return (c[0] * ny + c[1]) * nz + c[2]

    chunk = None
    if any(s.startswith("chunk") for s in schemes):
        chunk = nearest_chunk((ox, oy, oz), _chunk_bounds(inp))
    make = {
        "home": lambda: None,
        "oct": lambda: octant,
        "cell16xoct": lambda: cell(4, 1, 4) * 8 + octant,
        "cell64xoct": lambda: cell(8, 1, 8) * 8 + octant,
        "chunkxoct": lambda: chunk * 8 + octant,
        "cell64": lambda: cell(8, 1, 8),
        "cell256xoct": lambda: cell(16, 1, 16) * 8 + octant,
        "chunk": lambda: chunk,
    }
    return {s: make[s]() for s in schemes}


def stable_order(key: torch.Tensor) -> torch.Tensor:
    """The stable ascending order of ``key``, int32."""
    return torch.sort(key, stable=True).indices.to(torch.int32)


def with_tail(order: torch.Tensor, n: int, end: int) -> torch.Tensor:
    """``order`` followed by the positions [n, end): a gather by it moves
    the live records and leaves the dead records that close the last dense
    row where PACK put them."""
    return torch.cat([order, torch.arange(n, end, dtype=torch.int32, device=order.device)])


def permute(dense: torch.Tensor, index: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """record_gather of the dense pool's columns ``index`` into ``out``."""
    return ro.record_gather(dense, index, out, dim=1)


def counters(st: torch.Tensor, n: int, inp: mk.KernelInputs) -> dict:
    """probe_binned.py:304-317's summary of K1-stats' table over the dense
    tiles holding the n live records."""
    st = st[:-(-n // _LANES)].double().cpu()
    iters, live, chunks = st[:, 0], st[:, 1], st[:, 2]
    return {
        "segments": float(live.sum()),  # live lanes summed over the loop's iterations
        "iters_mean": float(iters.mean()),
        "live_frac": float((live / (iters * _LANES + 1e-9)).mean()),
        "chunk_entry": float((chunks / (iters * inp.n_chunks + 1e-9)).mean()),
        "tests_per_seg": float((chunks * inp.chunk_size * _LANES).sum()
                               / max(float(live.sum()), 1.0)),
    }


def _dump(dense, n, inp, basis, scene, cut) -> str:
    path = os.path.join(tempfile.gettempdir(), f"pool_{scene}_cut{cut}.npz")
    np.savez_compressed(
        path, recs=dense[:, :n].T.cpu().numpy(),
        chunk_bounds=_chunk_bounds(inp).cpu().numpy(), s_attrs=inp.attrs[:4].cpu().numpy(),
        kq=inp.sweep[:, 3].cpu().numpy(), chunk_size=inp.chunk_size,
        eye=basis.eye.cpu().numpy())
    return path


def run(cut: int = CUT, scene: str = "rtiow", quick: bool = False, dump: bool = False, *,
        device="cuda", width: int = None, height: int = None, bounces: int = BOUNCES,
        reps: int = None, on_scheme=None, emit=None) -> list:
    """The probe; returns its per-scheme rows (each also passed to
    ``emit``). ``on_scheme(name, pool, counts, n, t, inp, stats)`` is called
    with each permuted pool (before K1) and its K1-stats table."""
    emit = emit or (lambda row: None)
    w, h = SHAPES[scene]
    w, h = width or w, height or h
    schemes = QUICK_SCHEMES if quick else SCHEMES
    reps = reps or (3 if quick else 5)
    on_card = torch.device(device).type == "cuda"
    where = card() if on_card else "cpu"
    _, _, k1 = _kernels(device)

    inp, basis = scene_inputs(scene, w, h, device)
    t, _ = rg.plan(w, h, SPP, bounces, (cut,))
    dense, counts, n = dense_pool(inp, t, cut, device)
    end = -(-n // 128) * 128
    emit({"phase": "pool", "cut": cut, "scene": scene, "size": [w, h], "spp": SPP,
          "live_rows": end // 128, "of": t.cap // 128, "device": where})
    emit({"phase": "live_records", "n": n})
    if dump:
        emit({"phase": "dump", "path": _dump(dense, n, inp, basis, scene, cut)})
        return []

    keys = bin_keys(dense, n, inp, schemes)
    pool = torch.empty_like(dense)
    work = torch.empty_like(dense)
    r8 = torch.empty((3, t.cap), device=device)
    # warm K1, the sort and the gather, so that no scheme's time holds a
    # first launch's set-up
    k1(inp, work.copy_(dense), r8, counts, 1, t, 0, cut, bounces)
    first = next((k for k in keys.values() if k is not None), None)
    if first is not None:
        permute(dense, with_tail(stable_order(first), n, end), pool)
    base_sum = ref = None
    rows = []
    for name in schemes:
        key = keys[name]
        sort_ms = permute_ms = None
        if key is None:
            src = dense
        else:
            order, sort_ms = time_call(lambda: stable_order(key), device)
            index = with_tail(order, n, end)
            src, permute_ms = time_call(lambda: permute(dense, index, pool), device)
        in_sum = float(src[rg._TR, :n].double().sum())
        base_sum = in_sum if base_sum is None else base_sum

        # K1 over [cut, bounces), each repetition on a distinct frame and a
        # fresh copy of the pool (copies not timed)
        k1_ms = []
        for r in range(reps):
            work.copy_(src)
            k1_ms.append(time_call(lambda: k1(inp, work, r8, counts, 1, t, r, cut, bounces),
                                    device)[1])
            if r == 0:
                out, out_r8 = work[:, :n].clone(), r8[:, :n].clone()
        if key is None:
            ref = (out, out_r8)
        else:
            # the exact gate: scattered back, K1's records and radiance are
            # the home-order K1's in every bit
            back = ro.record_scatter(out, order, torch.empty_like(out), dim=1)
            back_r8 = ro.record_scatter(out_r8, order, torch.empty_like(out_r8), dim=1)
            if not (same_bits(back, ref[0]) and same_bits(back_r8, ref[1])):
                raise AssertionError(
                    f"binned K1 ({name}) scattered back differs from home-order K1 in "
                    f"{int((back != ref[0]).any(0).sum())} records and "
                    f"{int((back_r8 != ref[1]).any(0).sum())} radiance values")
        st = torch.zeros((t.cap // _LANES, 8), device=device)
        k1(inp, work.copy_(src), r8, counts, 1, t, 0, cut, bounces, stats=st)
        if on_scheme is not None:
            on_scheme(name, src, counts, n, t, inp, st)
        row = {"scheme": name, "cut": cut, "k1_ms": sum(k1_ms) / reps, **counters(st, n, inp),
               "in_sum_rel_err": abs(in_sum - base_sum) / max(abs(base_sum), 1e-9),
               "sort_ms": sort_ms, "permute_ms": permute_ms, "k1_ms_reps": k1_ms,
               "scatter_back": "home" if key is None else "bit-exact", "device": where}
        rows.append(row)
        emit(row)
    return rows


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    if not torch.cuda.is_available():
        print("probes.binned: no CUDA device", file=sys.stderr)
        return 2
    cut = int(args[0]) if args and args[0].isdigit() else CUT
    scene = next((a for a in args if a in SHAPES), "rtiow")
    run(cut, scene, "quick" in args, "dump" in args,
        emit=lambda row: print(json.dumps(row), flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
