"""Variant builds of the port's CUDA sources, for the step tools
(tools/megakernel_steps.py, wavefront_steps.py, sweep_steps.py,
pack_tiles.py): copies of a csrc/ tree with some constants set, each built
by its own nvcc with the package's flags, all started at once.

    from variants import build_all, copy_csrc
    src = copy_csrc(ROOT, OUT / "blocks3", "sweep.cu", {"kMmaBlocks3x": 3})
    libs = build_all({"blocks3": src})  # {name: (ctypes.CDLL, nvcc log)}
"""
from __future__ import annotations

import ctypes
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from weekend_raytracer_tpu_torch.ops.cuda import build  # noqa: E402

LIB = "lib.so"  # each build's library, beside its source


def set_constant(src: str, name: str, value) -> str:
    """``src`` with ``constexpr int name = ...;`` set to ``value``."""
    head = f"constexpr int {name} = "
    at = src.index(head) + len(head)
    return src[:at] + str(value) + src[src.index(";", at):]


def csrc_of(root: pathlib.Path) -> pathlib.Path:
    """The csrc/ of ``root``: a repository root, or a csrc/ directory."""
    root = pathlib.Path(root)
    tree = root / "weekend_raytracer_tpu_torch" / "csrc"
    return tree if tree.is_dir() else root


def copy_csrc(root: pathlib.Path, dest: pathlib.Path, source: str, edits=None) -> pathlib.Path:
    """A fresh copy of ``root``'s csrc/ at ``dest`` whose ``source`` has the
    constants of ``edits`` ({name: value}) set; the path of that source."""
    dest = pathlib.Path(dest)
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(csrc_of(root), dest)
    path = dest / source
    if edits:
        src = path.read_text()
        for name, value in edits.items():
            src = set_constant(src, name, value)
        path.write_text(src)
    return path


def start(sources: dict) -> dict:
    """One nvcc per source ({name: path}), all started at once, each into
    LIB beside its source: {name: process}."""
    return {name: subprocess.Popen(
        [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(src.parent / LIB), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in sources.items()}


def finish(sources: dict, procs: dict) -> dict:
    """{name: (CDLL, nvcc log)} once every build of ``procs`` is done;
    raises with the log's end if one failed."""
    out = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed building {sources[name]}:\n{log[-4000:]}")
        out[name] = (ctypes.CDLL(str(sources[name].parent / LIB)), log)
    return out


def build_all(sources: dict) -> dict:
    """``finish`` of ``start``: every source built, in parallel."""
    return finish(sources, start(sources))
