"""Image IO helpers: PNG/PPM output for rendered frames."""
from __future__ import annotations

import numpy as np


def save_png(path: str, rgb_u8: np.ndarray) -> None:
    """Write an [H, W, 3] uint8 array as PNG (PIL when available, else a
    minimal pure-Python PNG encoder so the framework has no hard deps)."""
    rgb_u8 = np.ascontiguousarray(rgb_u8)
    assert rgb_u8.dtype == np.uint8 and rgb_u8.ndim == 3 and rgb_u8.shape[2] == 3
    try:
        from PIL import Image

        Image.fromarray(rgb_u8, mode="RGB").save(path)
        return
    except ImportError:
        pass
    _save_png_pure(path, rgb_u8)


def _save_png_pure(path: str, rgb: np.ndarray) -> None:
    import struct
    import zlib

    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def save_ppm(path: str, rgb_u8: np.ndarray) -> None:
    h, w, _ = rgb_u8.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(rgb_u8).tobytes())
