"""Textures: host images and the flattened device texture pool.

Capability parity with the reference's ``Texture`` (src/raytracer/texture.rs:9-78:
JPEG -> normalized float RGB rows, or a 1x1 solid color) and the global
flattened texture pool + (width, height, offset) descriptors that
``GpuMaterial::append_to_global_texture_data`` builds (src/raytracer/mod.rs:815-830).

The pool is a single ``[P, 3]`` f32 array; the fused kernel samples a packed
RGB8 copy of it (ops/cuda/megakernel.py build_kernel_texture_pool).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Texture:
    """A host-side RGB float image, shape [height, width, 3] in [0, 1]."""

    data: np.ndarray  # f32 [h, w, 3]

    def __post_init__(self):
        assert self.data.ndim == 3 and self.data.shape[2] == 3, self.data.shape

    @staticmethod
    def from_color(rgb: Tuple[float, float, float]) -> "Texture":
        """1x1 solid color (reference texture.rs:48-54 new_from_color)."""
        return Texture(np.asarray(rgb, dtype=np.float32).reshape(1, 1, 3))

    @staticmethod
    def from_image(path: str) -> "Texture":
        """Load an image file to normalized float RGB (texture.rs:21-46).

        Requires PIL; any format PIL can decode (the reference decodes JPEG).
        """
        from PIL import Image

        with Image.open(path) as im:
            arr = np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0
        return Texture(arr)

    @staticmethod
    def from_array(arr: np.ndarray) -> "Texture":
        """Integer arrays are treated as 8-bit-range and normalized;
        float arrays are assumed already in [0, 1]."""
        src = np.asarray(arr)
        a = src.astype(np.float32)
        if np.issubdtype(src.dtype, np.integer):
            a = a / 255.0
        return Texture(a)

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def height(self) -> int:
        return self.data.shape[0]

    @property
    def is_solid(self) -> bool:
        return self.width == 1 and self.height == 1

    @property
    def mean_rgb(self) -> np.ndarray:
        return self.data.reshape(-1, 3).mean(axis=0)


class TexturePool:
    """Builds the flat global texture pool (reference mod.rs:815-830).

    ``add`` returns a descriptor (width, height, offset) indexing the pool;
    identical Texture objects are deduplicated by content.
    """

    def __init__(self):
        self._rows: List[np.ndarray] = []
        self._offset = 0
        self._cache = {}

    def add(self, tex: Texture) -> Tuple[int, int, int]:
        key = (tex.data.shape, tex.data.tobytes())
        if key in self._cache:
            return self._cache[key]
        desc = (tex.width, tex.height, self._offset)
        flat = tex.data.reshape(-1, 3).astype(np.float32)
        self._rows.append(flat)
        self._offset += flat.shape[0]
        self._cache[key] = desc
        return desc

    def build(self) -> np.ndarray:
        """Return the pool as an [P, 3] f32 array (P >= 1)."""
        if not self._rows:
            return np.zeros((1, 3), dtype=np.float32)
        return np.concatenate(self._rows, axis=0)
