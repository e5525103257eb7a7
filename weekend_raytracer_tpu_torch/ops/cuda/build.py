"""Build the package's CUDA sources into plain C-ABI shared libraries.

Each library is compiled by ``nvcc`` for Hopper (``sm_90a``) with a plain C
interface and loaded with ctypes; no PyTorch header is compiled, so a build
takes seconds. Builds land in ``weekend_raytracer_tpu_torch/_build/``, one
directory per hash of the sources, every header under csrc/ and the
flags, so a changed source, header or flag rebuilds and an unchanged one
loads the library already built. Several libraries build in parallel, one nvcc
each. Nothing here runs at import time.
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


_LOADED: dict = {}  # (name, sources) -> BuiltLibrary, per process
HEADER_SUFFIXES = (".cuh", ".h", ".hpp")


def build_key(name: str, sources: tuple) -> str:
    """The build directory's name: a hash of the compiled sources, of every
    header under csrc/ and of the flags. All headers are hashed, whether a
    source includes them or not, so no list of includes has to be kept and
    a changed header rebuilds every library."""
    headers = sorted(p.relative_to(CSRC_DIR).as_posix() for p in CSRC_DIR.rglob("*")
                     if p.suffix in HEADER_SUFFIXES)
    digest = hashlib.sha256()
    for rel in (*sources, *headers):
        digest.update(rel.encode())
        digest.update((CSRC_DIR / rel).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return f"{name}-{digest.hexdigest()[:16]}"


def load_library(name: str, sources: tuple) -> BuiltLibrary:
    """Build (if needed) and load ``lib<name>.so`` from ``sources``, paths
    relative to the package's csrc/ directory. A process loads each library
    once and keeps it. Raises if nvcc fails."""
    return load_libraries([(name, sources)])[0]


def load_libraries(specs) -> list:
    """``load_library`` for each (name, sources) of ``specs``; the libraries
    not built yet are built by one nvcc each, all started at once."""
    specs = [(name, tuple(sources)) for name, sources in specs]
    running = []
    for spec in specs:
        if spec in _LOADED:
            continue
        name, sources = spec
        out_dir = BUILD_DIR / build_key(*spec)
        so_path = out_dir / f"lib{name}.so"
        proc = tmp = None
        if not so_path.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / f".lib{name}.{os.getpid()}.so"
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *[str(CSRC_DIR / s) for s in sources]]
            with open(out_dir / "build.log", "w") as log:
                log.write(" ".join(cmd) + "\n")
                log.flush()
                proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        running.append((spec, out_dir, so_path, proc, tmp, time.perf_counter()))
    for spec, out_dir, so_path, proc, tmp, t0 in running:
        seconds = 0.0
        if proc is not None:
            rc = proc.wait()
            seconds = time.perf_counter() - t0
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}) building {spec[0]}:\n"
                                   f"{(out_dir / 'build.log').read_text()[-4000:]}")
            os.replace(tmp, so_path)
        _LOADED[spec] = BuiltLibrary(lib=ctypes.CDLL(str(so_path)), path=so_path,
                                     build_seconds=seconds,
                                     log=(out_dir / "build.log").read_text())
    return [_LOADED[spec] for spec in specs]
