#!/usr/bin/env python3
"""How many device events a torch.profiler trace of the port's kernels keeps.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    python3 tools/trace_events.py [--traces N] [--variants NAME ...] [--jobs J]
                                  [--out DIR]

Each variant runs in a process of its own, which takes N traces through
``utils.metrics.profiler_trace`` of each of three things, in turns: (a) one
``regroup_k0`` launch, (b) a whole regroup frame (K0, PACK and K1 at each
cut, COMBINE: 8 kernels of the port), both at chip_smoke.py's ``[timing]``
shape (RTiOW 480x270, 4 spp, 8 bounces, cuts (2, 4, 6)), and (c) one
PyTorch kernel (``torch.add`` on 2^20 floats). Each trace pads its calls
with ``probes.TRACE_PAD_S`` of idle host time on both sides, as the
smoke's traces do, and marks them with a ``record_function`` range. For
each trace the script counts the device events kept, through
``prof.events()`` and through ``key_averages()``, the port's among them,
the CPU-side launch calls the profiler saw, and where the first device
event starts after the marked range starts (``offset_us``; a device event
cannot start before the call that launched it, so a falling offset is a
drift of the converted device clock).

Variants (by default ``DEFAULT_VARIANTS``: the first five, and the first
two with ``child_exits``; ``teardown_on`` hung a process on torch
2.11 with CUDA 12.8, so the ``teardown_on*`` variants run only with
``--allow-hang``):

- ``shipped``: ``profiler_trace`` as it is, which opens each session with
  primer kernels that take the events a session loses, and leaves them
  out (``primers_lost`` counts those lost);
- ``parent``: the profiler_trace that had no primers (``_parent_trace``);
- ``acc_events``: that one with ``acc_events=True``;
- ``cudart_shared``: the libraries built with ``-cudart shared`` (nvcc's
  default is the static runtime);
- ``sync_inside``: a ``torch.cuda.synchronize()`` inside the traced block;
- ``no_pad``: no idle host time around the calls (``long_pad``: 0.5 s);
- ``aged``: 0.5 s of idle host time between traces, so that its last
  traces are minutes after its first;
- ``teardown_off``: ``TEARDOWN_CUPTI=0`` in the environment before torch
  is imported, so that the profiler keeps CUPTI set up between traces;
- ``teardown_py``: the same variable set by the process after torch is
  imported and its kernels launched, before its first trace;
- ``teardown_on``: ``TEARDOWN_CUPTI=1`` before torch is imported, so that
  kineto finalizes CUPTI after every trace (``teardown_on_py``: set before
  the first trace; ``teardown_on_late``: after the first round);
- ``launches``: 100,000 small PyTorch launches before the first trace
  (as a cull census makes in the smoke);
- ``child_exits``: a child process that starts CUDA and exits, before
  every 20th round of traces (``child_python``: one that starts Python
  and no CUDA; ``child_smi``: ``nvidia-smi``);
- ``nccl``: a one-process NCCL group set up (and one all_reduce) before
  the first trace, as the smoke's ``[parallel]`` does;
- ``full_size``: K0 and the frame at the main path's 1920x1080 x 32 spp;
- ``all_libraries``: all six of the port's libraries loaded first.

Variants combine with ``+`` (``child_exits+teardown_on``). A variant
named more than once in ``--variants`` runs once for each time, each in
its own process (with ``--jobs`` above 1, at once on the card).

Prints one JSON line per variant and thing: traces, events expected per
trace, events kept (min, median, the first trace that lost one, traces
that lost any), the same through key_averages(), launch calls seen and
offsets, and the longest time between two of its traces (a trace that
waits on the profiler shows there). ``--out DIR`` also writes every trace's record as
``DIR/trace_events_<variant>.jsonl`` and the summary as
``DIR/trace_events.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = ("shipped", "parent", "acc_events", "cudart_shared", "sync_inside", "no_pad",
            "long_pad", "aged",
            "teardown_off", "teardown_py", "teardown_on", "teardown_on_py", "teardown_on_late",
            "launches", "child_exits", "child_python", "child_smi", "nccl", "full_size",
            "all_libraries")
DEFAULT_VARIANTS = ("shipped", "parent", "acc_events", "cudart_shared", "sync_inside",
                    "shipped+child_exits", "parent+child_exits")
# the child process each child_* variant starts before every 20th round
CHILDREN = {"child_exits": [sys.executable, "-c", "import torch; torch.ones(1, device='cuda'); "
                            "torch.cuda.synchronize()"],
            "child_python": [sys.executable, "-c", "pass"],
            "child_smi": ["nvidia-smi", "--query-gpu=name", "--format=csv,noheader"]}
THINGS = ("k0", "frame", "torch_add")
MARK = "trace_events.calls"
AGED_GAP_S = 0.5


def _things(cs, mk, rg, dev, full_size: bool = False) -> dict:
    """{name: (fn, {port kernel: launches a call}, PyTorch kernels a call)}."""
    import torch

    tm = dict(cs._MAIN, scene="rtiow") if full_size else cs._TIMING
    w, h, spp, bounces = tm["width"], tm["height"], tm["spp"], tm["bounces"]
    inp = mk.kernel_inputs(*cs._case(tm["scene"], w, h, dev))
    t, cuts = rg.plan(w, h, spp, bounces, cs._CUTS)
    ws = rg._workspace(dev, t.cap, len(cuts))
    accum = torch.zeros((w * h, 3), device=dev)
    x = torch.rand(1 << 20, device=dev)
    return {
        "k0": (lambda: rg.launch_k0(inp, ws.pools[0], ws.contrib, t, 0, cuts[0]),
               {"regroup_k0": 1}, 0),
        # and 4 more device events: the workspace's fill (counts) and the
        # memset of PACK's scratch before each of its 3 launches
        "frame": (lambda: rg.launch_regrouped(accum, inp, 0, True, width=w, height=h, spp=spp,
                                              num_bounces=bounces, cuts=cs._CUTS),
                  cs._frame_kernels("regroup"), 4),
        "torch_add": (lambda: torch.add(x, x), {}, 1),
    }


@contextlib.contextmanager
def _parent_trace(log_dir: str, acc_events: bool = False):
    """utils.metrics.profiler_trace as it was before its primer kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=acc_events) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _one_trace(fn, port: dict, flags: set, log_dir: str, profiler_trace, pad_s: float):
    import torch
    from torch.autograd import DeviceType

    import chip_smoke as cs
    from weekend_raytracer_tpu_torch.utils.metrics import LAUNCH_CALLS

    parent = flags & {"parent", "acc_events"}
    torch.cuda.synchronize()
    with (_parent_trace(log_dir, "acc_events" in flags) if parent
          else profiler_trace(log_dir)) as prof:
        time.sleep(pad_s)
        with torch.profiler.record_function(MARK):
            fn()
        if "sync_inside" in flags:
            torch.cuda.synchronize()
        time.sleep(pad_s)
    events = prof.events()
    # the device's events, the marked range's own device span (a user
    # annotation) aside
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False) and e.name != MARK]
    mark = [e for e in events if e.name == MARK]
    ours = sum(1 for e in device if cs._kernel_name(e.name) in port)
    averaged = sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.key != MARK)
    launches = sum(1 for e in events if e.name in LAUNCH_CALLS)
    offset = (min(e.time_range.start for e in device) - mark[0].time_range.start
              if device and mark else None)
    return {"device": len(device), "port": ours, "torch": len(device) - ours,
            "key_averages": averaged, "launch_calls": launches, "offset_us": offset,
            "kept": [cs._kernel_name(e.name)[:24] for e in sorted(
                device, key=lambda e: e.time_range.start)],
            "primers_lost": getattr(prof, "primers_lost", None)}


def _child(variant: str, traces: int) -> None:
    """A variant's traces, one JSON line per trace, then a summary line."""
    sys.path.insert(0, ROOT)
    flags = set(variant.split("+"))
    if flags & {"teardown_off", "teardown_on"}:
        os.environ["TEARDOWN_CUPTI"] = "1" if "teardown_on" in flags else "0"
    if "cudart_shared" in flags:
        from weekend_raytracer_tpu_torch.ops.cuda import build

        build.NVCC_FLAGS = build.NVCC_FLAGS + ("-cudart", "shared")
    import torch

    import chip_smoke as cs
    from weekend_raytracer_tpu_torch.ops.cuda import megakernel as mk
    from weekend_raytracer_tpu_torch.ops.cuda import regroup as rg
    from weekend_raytracer_tpu_torch.probes import TRACE_PAD_S
    from weekend_raytracer_tpu_torch.utils.metrics import profiler_trace

    dev = torch.device("cuda")
    if "all_libraries" in flags:
        from weekend_raytracer_tpu_torch.ops.cuda import access, build, reorder, sweep, wavefront

        build.load_libraries([m.LIBRARY for m in (mk, rg, wavefront, reorder, sweep, access)])
    things = _things(cs, mk, rg, dev, full_size="full_size" in flags)
    for fn, _, _ in things.values():  # warm: build, load, first launch
        fn()
    if "launches" in flags:
        x = torch.ones(32, device=dev)
        for _ in range(100_000):
            x.add_(0.0)
    if "nccl" in flags:
        import torch.distributed as dist

        dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                                world_size=1, rank=0)
        dist.all_reduce(torch.ones(1024, device=dev))
    torch.cuda.synchronize()
    if flags & {"teardown_py", "teardown_on_py"}:
        os.environ["TEARDOWN_CUPTI"] = "1" if "teardown_on_py" in flags else "0"
    pad_s = 0.0 if "no_pad" in flags else 0.5 if "long_pad" in flags else TRACE_PAD_S
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as log_dir:
        for i in range(traces):
            if i == 1 and "teardown_on_late" in flags:
                os.environ["TEARDOWN_CUPTI"] = "1"
            for child in flags & set(CHILDREN):
                if i % 20 == 0:
                    subprocess.run(CHILDREN[child], check=True, timeout=300,
                                   stdout=subprocess.DEVNULL)
            for name, (fn, port, torch_kernels) in things.items():
                rec = _one_trace(fn, port, flags, log_dir, profiler_trace, pad_s)
                rec.update(variant=variant, thing=name, trace=i,
                           seconds=round(time.perf_counter() - t0, 3),
                           expected=sum(port.values()) + torch_kernels,
                           expected_port=sum(port.values()))
                print(json.dumps(rec), flush=True)
            if "aged" in flags:
                time.sleep(AGED_GAP_S)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _summary(records: list) -> dict:
    """One thing's traces of one variant: events expected and kept."""
    expected = records[0]["expected"]
    kept = [r["device"] for r in records]
    lost = [r["trace"] for r in records if r["device"] < r["expected"]
            or r["port"] < r["expected_port"]]
    offsets = [r["offset_us"] for r in records if r["offset_us"] is not None]
    return {"traces": len(records), "expected": expected,
            "expected_port": records[0]["expected_port"],
            "kept_min": min(kept), "kept_median": statistics.median(kept),
            "port_min": min(r["port"] for r in records),
            "key_averages_min": min(r["key_averages"] for r in records),
            "key_averages_median": statistics.median(r["key_averages"] for r in records),
            "first_lost": lost[0] if lost else None, "traces_lost": len(lost),
            "launch_calls_median": statistics.median(r["launch_calls"] for r in records),
            "offset_us_first": offsets[0] if offsets else None,
            "offset_us_last": offsets[-1] if offsets else None,
            "offset_us_min": min(offsets) if offsets else None,
            "primers_lost_max": max((r["primers_lost"] or 0) for r in records),
            "seconds": records[-1]["seconds"],
            "longest_gap_s": max((b["seconds"] - a["seconds"]
                                  for a, b in zip(records, records[1:])), default=0.0)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--traces", type=int, default=200)
    ap.add_argument("--variants", nargs="+", default=list(DEFAULT_VARIANTS))
    ap.add_argument("--jobs", type=int, default=1,
                    help="variants run at once, each in its own process")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds a variant's process may take; past it, it is "
                    "stopped and its traces so far are summed up")
    ap.add_argument("--out", default=None)
    ap.add_argument("--allow-hang", action="store_true",
                    help="run the teardown_on* variants, which can hang their process")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    for v in args.variants + [args.child or "shipped"]:
        if not set(v.split("+")) <= set(VARIANTS):
            ap.error(f"unknown variant {v!r}: each part one of {', '.join(VARIANTS)}")
        if not args.allow_hang and any(f.startswith("teardown_on") for f in v.split("+")):
            ap.error(f"variant {v!r} can hang its process: give --allow-hang to run it")
    if args.child:
        _child(args.child, args.traces)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the traces need the card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda}), flush=True)
    summary = {"card": smi, "torch": torch.__version__, "variants": {}}
    runs = [(v if args.variants.count(v) == 1 else f"{v}#{i}", v)
            for i, v in enumerate(args.variants)]
    failed = []
    while runs:
        batch, runs = runs[:args.jobs], runs[args.jobs:]
        procs = {run: subprocess.Popen([sys.executable, os.path.abspath(__file__), "--child", v,
                                        "--traces", str(args.traces)]
                                       + ["--allow-hang"] * args.allow_hang, cwd=ROOT, text=True,
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE)
                 for run, v in batch}
        deadline = time.monotonic() + args.timeout
        results = {}
        try:
            for variant, proc in procs.items():
                try:
                    out = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    proc.kill()
                    out = proc.communicate()
                    out = (out[0], out[1] + f"\nstopped after {args.timeout} s")
                results[variant] = (out, proc.returncode)
        finally:  # stop every child, also when this process fails
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for variant, ((out, err), returncode) in results.items():
            records = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
            if returncode:
                failed.append(variant)
                print(f"[{variant}] failed ({returncode}) after {len(records)} traces:\n"
                      f"{err[-3000:]}", flush=True)
                if not records:
                    continue
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                with open(os.path.join(args.out, f"trace_events_{variant}.jsonl"), "w") as f:
                    f.write("\n".join(json.dumps(r) for r in records) + "\n")
            summary["variants"][variant] = {}
            for thing in THINGS:
                if not any(r["thing"] == thing for r in records):
                    continue
                s = _summary([r for r in records if r["thing"] == thing])
                summary["variants"][variant][thing] = s
                print(json.dumps({"variant": variant, "thing": thing, **s}), flush=True)
    if args.out:
        with open(os.path.join(args.out, "trace_events.json"), "w") as f:
            json.dump(summary, f, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
