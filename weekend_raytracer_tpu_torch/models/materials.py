"""Material model: tagged variants lowered to SoA tensor tables.

Counterpart of weekend_raytracer_tpu/models/materials.py: four physical
variants (lambertian / metal / dielectric / checkerboard), the emissive area
light, and the aggressive-pink error material for unknown ids
(raytracer.wgsl:309-314). The table is SoA: one int32 id tensor, two [M, 3]
int32 texture-descriptor tensors, one f32 extra-scalar tensor, the f32
texture pool and the derived constant albedos.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .textures import Texture, TexturePool

# Material ids (reference raytracer.wgsl:174-202 switch arms).
LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
CHECKERBOARD = 3
# Beyond-reference: a diffuse area light — paths terminate on hit and pick
# up x * albedo radiance.
EMISSIVE = 4

# Unknown-material signal color (raytracer.wgsl:312).
ERROR_PINK = (0.9921, 0.24705, 0.57254)

_WHITE = Texture.from_color((1.0, 1.0, 1.0))


@dataclasses.dataclass(frozen=True)
class Material:
    """One material variant; use the constructors below."""

    id: int
    tex1: Texture
    tex2: Texture
    x: float

    @staticmethod
    def lambertian(albedo: Texture | Tuple[float, float, float]) -> "Material":
        return Material(LAMBERTIAN, _as_tex(albedo), _WHITE, 0.0)

    @staticmethod
    def metal(albedo: Texture | Tuple[float, float, float], fuzz: float) -> "Material":
        return Material(METAL, _as_tex(albedo), _WHITE, float(fuzz))

    @staticmethod
    def dielectric(refraction_index: float) -> "Material":
        return Material(DIELECTRIC, _WHITE, _WHITE, float(refraction_index))

    @staticmethod
    def checkerboard(
        even: Texture | Tuple[float, float, float],
        odd: Texture | Tuple[float, float, float],
    ) -> "Material":
        return Material(CHECKERBOARD, _as_tex(even), _as_tex(odd), 0.0)

    @staticmethod
    def emissive(
        color: Texture | Tuple[float, float, float], intensity: float = 1.0
    ) -> "Material":
        return Material(EMISSIVE, _as_tex(color), _WHITE, float(intensity))


def _as_tex(t) -> Texture:
    return t if isinstance(t, Texture) else Texture.from_color(t)


@dataclasses.dataclass(frozen=True)
class MaterialTable:
    """SoA material table + flattened texture pool.

    ``tex_meta`` (the static (w, h, offset) descriptor pair per material)
    and ``all_solid`` are derived from the descriptor tensors, so a table
    rebuilt from bare arrays (``from_numpy``) lays out the kernel's texture
    LUT exactly as one built from Material objects.
    """

    ids: torch.Tensor  # i32 [M]
    tex1: torch.Tensor  # i32 [M, 3]  (width, height, offset)
    tex2: torch.Tensor  # i32 [M, 3]
    x: torch.Tensor  # f32 [M]    (fuzz for metal, ior for dielectric)
    pool: torch.Tensor  # f32 [P, 3]  global texture pool
    albedo1: torch.Tensor  # f32 [M, 3]  constant albedo of tex1 (mean for images)
    albedo2: torch.Tensor  # f32 [M, 3]
    tex_meta: tuple = ()
    all_solid: bool = False

    @property
    def num_materials(self) -> int:
        return int(self.ids.shape[0])

    @staticmethod
    def from_numpy(ids, tex1, tex2, x, pool, albedo1, albedo2, *,
                   device) -> "MaterialTable":
        """Table from numpy arrays (the JAX package's MaterialTable leaves,
        in field order) placed on ``device``."""
        t1 = np.asarray(tex1, dtype=np.int32).reshape(-1, 3)
        t2 = np.asarray(tex2, dtype=np.int32).reshape(-1, 3)
        tex_meta = tuple((tuple(int(v) for v in d1), tuple(int(v) for v in d2))
                         for d1, d2 in zip(t1, t2))
        all_solid = bool(((t1[:, 0] * t1[:, 1]) <= 1).all()
                         and ((t2[:, 0] * t2[:, 1]) <= 1).all())

        def put(a, dtype):
            return torch.as_tensor(np.array(a, dtype=dtype), device=device)

        return MaterialTable(
            ids=put(ids, np.int32),
            tex1=put(t1, np.int32),
            tex2=put(t2, np.int32),
            x=put(x, np.float32),
            pool=put(pool, np.float32),
            albedo1=put(albedo1, np.float32),
            albedo2=put(albedo2, np.float32),
            tex_meta=tex_meta,
            all_solid=all_solid,
        )

    @staticmethod
    def build(materials: List[Material], pool: Optional[TexturePool] = None,
              *, device) -> "MaterialTable":
        """Lower a material list to tensors (reference mod.rs:757-830)."""
        pool = pool or TexturePool()
        ids, t1, t2, xs, a1, a2 = [], [], [], [], [], []
        for m in materials:
            ids.append(m.id)
            t1.append(pool.add(m.tex1))
            t2.append(pool.add(m.tex2))
            xs.append(m.x)
            a1.append(m.tex1.mean_rgb)
            a2.append(m.tex2.mean_rgb)
        return MaterialTable.from_numpy(
            ids, t1, t2, xs, pool.build(),
            np.stack(a1).astype(np.float32), np.stack(a2).astype(np.float32),
            device=device,
        )
