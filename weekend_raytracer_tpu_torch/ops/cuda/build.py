"""Build the package's CUDA sources into plain C-ABI shared libraries.

Each library is compiled by ``nvcc`` for Hopper (``sm_90a``) with a plain C
interface and loaded with ctypes; no PyTorch header is compiled, so a build
takes seconds. Builds land in ``weekend_raytracer_tpu_torch/_build/``, one
directory per hash of the sources and flags, so a changed source or flag
rebuilds and an unchanged one loads the library already built. Nothing
here runs at import time.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# No --use_fast_math: the kernels rely on IEEE sqrt of a negative being NaN
# and on accurate sinf/cosf/expf/powf. -Xptxas -v reports registers and
# spills into the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class BuiltLibrary:
    lib: ctypes.CDLL
    path: pathlib.Path
    build_seconds: float  # 0.0 when an earlier build was loaded
    log: str  # nvcc's command line and output

    def ptxas_usage(self) -> dict:
        """Registers and spill bytes per kernel, from ptxas -v."""
        return parse_ptxas(self.log)


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (pathlib.Path(root) / "bin" / "nvcc").exists():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def parse_ptxas(log: str) -> dict:
    """{kernel symbol: {"registers": n, "spill_stores": b, "spill_loads": b}}."""
    out = {}
    current = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
            out[current] = {}
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[current]["spill_stores"] = int(m.group(1))
            out[current]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[current]["registers"] = int(m.group(1))
    return out


_LOADED: dict = {}


def load_library(name: str, sources: tuple) -> BuiltLibrary:
    """Build (if needed) and load ``lib<name>.so`` from ``sources``, paths
    relative to the package's csrc/ directory. Raises if nvcc fails."""
    paths = [CSRC_DIR / s for s in sources]
    digest = hashlib.sha256()
    for p in paths:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    key = f"{name}-{digest.hexdigest()[:16]}"
    if key in _LOADED:
        return _LOADED[key]
    out_dir = BUILD_DIR / key
    so_path = out_dir / f"lib{name}.so"
    log_path = out_dir / "build.log"
    seconds = 0.0
    if not so_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f".lib{name}.{os.getpid()}.so"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {name}:\n{log[-4000:]}")
        log_path.write_text(log)
        os.replace(tmp, so_path)
    built = BuiltLibrary(lib=ctypes.CDLL(str(so_path)), path=so_path,
                         build_seconds=seconds, log=log_path.read_text())
    _LOADED[key] = built
    return built
