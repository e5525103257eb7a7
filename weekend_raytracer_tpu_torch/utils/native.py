"""ctypes bindings for the native host runtime (csrc/wrt_host.cpp).

Counterpart of weekend_raytracer_tpu/utils/native.py. The host library is
backend-neutral C++, so this module loads the same repository-root
``csrc/libwrt_host.so``, building it with ``csrc/Makefile`` on first use
when a toolchain is available. Every entry point keeps a NumPy/PyTorch
route for when the library is missing, on the host: this is host code, not
a device path.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_CSRC = os.path.join(os.path.dirname(__file__), "..", "..", "csrc")
_LIB_PATH = os.path.abspath(os.path.join(_CSRC, "libwrt_host.so"))
_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    if not os.path.exists(_LIB_PATH) and os.path.exists(
        os.path.join(_CSRC, "Makefile")
    ):
        try:
            subprocess.run(
                ["make", "-s"], cwd=os.path.abspath(_CSRC), check=True,
                capture_output=True, timeout=120,
            )
        except (OSError, subprocess.SubprocessError):
            return None
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")

    lib.wrt_tonemap_u8.argtypes = [f32p, ctypes.c_int64, u8p]
    lib.wrt_tonemap_u8.restype = None
    lib.wrt_halfblock_bound.argtypes = [ctypes.c_int32, ctypes.c_int32]
    lib.wrt_halfblock_bound.restype = ctypes.c_int64
    lib.wrt_halfblock_render.argtypes = [u8p, ctypes.c_int32, ctypes.c_int32,
                                         ctypes.c_char_p]
    lib.wrt_halfblock_render.restype = ctypes.c_int64
    lib.wrt_morton_codes.argtypes = [f32p, f32p, f32p, ctypes.c_int64, f32p,
                                     f32p, u32p]
    lib.wrt_morton_codes.restype = None
    lib.wrt_radix_argsort_u32.argtypes = [u32p, ctypes.c_int64, i32p]
    lib.wrt_radix_argsort_u32.restype = None
    lib.wrt_write_ppm.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int32,
                                  ctypes.c_int32]
    lib.wrt_write_ppm.restype = ctypes.c_int32
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def tonemap_u8(mean_rgb: np.ndarray) -> np.ndarray:
    """uncharted2 + sRGB quantization on host ([..., 3] f32 -> u8)."""
    lib = _load()
    flat = np.ascontiguousarray(mean_rgb, dtype=np.float32)
    if lib is None:
        import torch

        from ..ops.tonemap import to_srgb_u8

        return to_srgb_u8(torch.from_numpy(flat)).numpy()
    out = np.empty(flat.shape, dtype=np.uint8)
    lib.wrt_tonemap_u8(flat.reshape(-1, 3), flat.size // 3, out.reshape(-1, 3))
    return out


def halfblock_render(img_u8: np.ndarray) -> str:
    """[H, W, 3] uint8 -> ANSI half-block frame string."""
    lib = _load()
    img = np.ascontiguousarray(img_u8, dtype=np.uint8)
    h, w, _ = img.shape
    if lib is None:
        from ..interactive.viewer import _halfblock_frame

        return _halfblock_frame(img)
    buf = ctypes.create_string_buffer(int(lib.wrt_halfblock_bound(w, h)))
    n = lib.wrt_halfblock_render(img, w, h, buf)
    return buf.raw[:n].decode("utf-8")


def morton_argsort(centers: np.ndarray) -> np.ndarray:
    """Morton-order argsort of [N, 3] float32 centers (robust bounds)."""
    c = np.ascontiguousarray(centers, dtype=np.float32)
    lo = np.percentile(c, 5, axis=0).astype(np.float32)
    hi = np.percentile(c, 95, axis=0).astype(np.float32)
    lib = _load()
    if lib is None:
        import torch

        from ..ops.bvh import morton_codes

        t = torch.from_numpy(c)
        codes = morton_codes(t[:, 0], t[:, 1], t[:, 2], torch.from_numpy(lo),
                             torch.from_numpy(hi)).numpy().astype(np.uint32)
        return np.argsort(codes).astype(np.int32)
    codes = np.empty(c.shape[0], dtype=np.uint32)
    cx = np.ascontiguousarray(c[:, 0])
    cy = np.ascontiguousarray(c[:, 1])
    cz = np.ascontiguousarray(c[:, 2])
    lib.wrt_morton_codes(cx, cy, cz, c.shape[0], lo, hi, codes)
    order = np.empty(c.shape[0], dtype=np.int32)
    lib.wrt_radix_argsort_u32(codes, c.shape[0], order)
    return order


def write_ppm(path: str, img_u8: np.ndarray) -> None:
    lib = _load()
    img = np.ascontiguousarray(img_u8, dtype=np.uint8)
    h, w, _ = img.shape
    if lib is None:
        from .image import save_ppm

        save_ppm(path, img)
        return
    rc = lib.wrt_write_ppm(path.encode(), img, w, h)
    if rc != 0:
        raise IOError(f"wrt_write_ppm failed with code {rc} for {path}")
