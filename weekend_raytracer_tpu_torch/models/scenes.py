"""Scene descriptions: declarative builder + the benchmark scene ladder.

Counterpart of weekend_raytracer_tpu/models/scenes.py: the same six scenes
with the same seeds, so every scene function gives the same arrays as the JAX
package's; only ``SceneDesc.build`` differs, returning tensors on a device.

The reference hardcodes one demo scene in the binary (src/main.rs:515-547)
and a second one inside the CPU layer (src/raytracer/layer.rs:90-123); the
rebuild makes scenes a declarative, buildable description (SURVEY.md §5
config recommendation) and adds the BASELINE.md config ladder: single-sphere,
three-sphere, RTiOW final (~480 spheres), textured earth/moon, and 10k-sphere
scenes.

Image assets: the reference ships earthmap/moon JPEGs; this framework loads
any image via PIL when a path is supplied and otherwise generates procedural
stand-ins so it is fully standalone.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional

import numpy as np

from .camera import Camera
from .materials import Material, MaterialTable
from .spheres import Sphere, SphereSoA
from .textures import Texture


@dataclasses.dataclass
class SceneDesc:
    """Host-side declarative scene (reference Scene, mod.rs:413-416)."""

    materials: List[Material]
    spheres: List[Sphere]

    def build(self, pad_spheres_to: int | None = None, *, device):
        """Lower to tensors on ``device``; returns ops.tracer.Scene.

        Raises ValueError for out-of-range material indices (the reference
        silently renders unknown materials pink at runtime, wgsl:309-314 —
        that path still exists for corrupted device data, but host-side
        construction errors are caught here).
        """
        from ..ops.tracer import Scene

        if not self.spheres:
            raise ValueError("scene has no spheres")
        if not self.materials:
            raise ValueError("scene has no materials")
        bad = [i for i, s in enumerate(self.spheres)
               if not (0 <= s.material_idx < len(self.materials))]
        if bad:
            raise ValueError(
                f"spheres {bad[:5]} reference material indices outside "
                f"[0, {len(self.materials)})"
            )
        return Scene(
            spheres=SphereSoA.build(self.spheres, pad_to=pad_spheres_to,
                                    device=device),
            materials=MaterialTable.build(self.materials, device=device),
        )

    @property
    def num_spheres(self) -> int:
        return len(self.spheres)


# ---------------------------------------------------------------------------
# Procedural stand-in textures (standalone replacement for assets/*.jpeg)
# ---------------------------------------------------------------------------

def _value_noise(w: int, h: int, cells: int, seed: int) -> np.ndarray:
    """Tileable-in-x value noise in [0, 1] via bilinear-interpolated lattice."""
    rs = np.random.RandomState(seed)
    lat = rs.rand(cells + 1, cells + 1)
    lat[:, -1] = lat[:, 0]  # wrap horizontally
    ys = np.linspace(0, cells, h, endpoint=False)
    xs = np.linspace(0, cells, w, endpoint=False)
    yi = ys.astype(int)
    xi = xs.astype(int)
    fy = (ys - yi)[:, None]
    fx = (xs - xi)[None, :]
    v00 = lat[yi][:, xi]
    v01 = lat[yi][:, np.minimum(xi + 1, cells)]
    v10 = lat[np.minimum(yi + 1, cells)][:, xi]
    v11 = lat[np.minimum(yi + 1, cells)][:, np.minimum(xi + 1, cells)]
    return (
        v00 * (1 - fy) * (1 - fx)
        + v01 * (1 - fy) * fx
        + v10 * fy * (1 - fx)
        + v11 * fy * fx
    )


def procedural_earth(w: int = 512, h: int = 256) -> Texture:
    """Blue-marble stand-in for assets/earthmap.jpeg: noise continents."""
    n = (
        0.55 * _value_noise(w, h, 8, 7)
        + 0.30 * _value_noise(w, h, 16, 11)
        + 0.15 * _value_noise(w, h, 32, 13)
    )
    lat = np.abs(np.linspace(-1, 1, h))[:, None]
    land = n > 0.52
    ice = lat > 0.92
    img = np.empty((h, w, 3), dtype=np.float32)
    img[..., 0] = np.where(land, 0.22 + 0.3 * n, 0.05)
    img[..., 1] = np.where(land, 0.38 + 0.3 * n, 0.12 + 0.1 * n)
    img[..., 2] = np.where(land, 0.18 + 0.1 * n, 0.35 + 0.3 * n)
    img[ice.repeat(w, 1)] = 0.9
    return Texture(np.clip(img, 0.0, 1.0))


def procedural_moon(w: int = 512, h: int = 256) -> Texture:
    """Gray cratered stand-in for assets/moon.jpeg."""
    n = (
        0.6 * _value_noise(w, h, 6, 3)
        + 0.25 * _value_noise(w, h, 18, 5)
        + 0.15 * _value_noise(w, h, 48, 9)
    )
    g = np.clip(0.25 + 0.6 * n, 0.0, 1.0).astype(np.float32)
    return Texture(np.stack([g, g, 0.98 * g], axis=-1))


def _load_or_procedural(path: Optional[str], fallback) -> Texture:
    if path and os.path.exists(path):
        return Texture.from_image(path)
    return fallback()


# ---------------------------------------------------------------------------
# The reference demo scene (src/main.rs:515-547)
# ---------------------------------------------------------------------------

def reference_demo(assets_dir: Optional[str] = None) -> SceneDesc:
    """5 materials / 5 spheres, exactly the reference's hardcoded scene."""
    earth = _load_or_procedural(
        assets_dir and os.path.join(assets_dir, "earthmap.jpeg"), procedural_earth
    )
    moon = _load_or_procedural(
        assets_dir and os.path.join(assets_dir, "moon.jpeg"), procedural_moon
    )
    materials = [
        Material.checkerboard((0.5, 0.7, 0.8), (0.9, 0.9, 0.9)),
        Material.lambertian(moon),
        Material.metal((1.0, 0.85, 0.57), fuzz=0.4),
        Material.dielectric(1.5),
        Material.lambertian(earth),
    ]
    spheres = [
        Sphere((0.0, -500.0, -1.0), 500.0, 0),
        Sphere((0.0, 1.0, 0.0), 1.0, 3),
        Sphere((-5.0, 1.0, 0.0), 1.0, 2),
        Sphere((5.0, 0.8, 1.5), 0.8, 1),
        Sphere((5.0, 1.2, -1.5), 1.2, 4),
    ]
    return SceneDesc(materials=materials, spheres=spheres)


def reference_demo_camera() -> Camera:
    """The reference's default fly-camera pose (fly_camera.rs:24-50):
    position (-10, 2, -4), yaw 25 deg, pitch -10 deg, vfov 30, aperture 0.8,
    focus distance |(0,1,0) - (-10,2,-4)|."""
    yaw = math.radians(25.0)
    pitch = math.radians(-10.0)
    forward = (
        math.cos(yaw) * math.cos(pitch),
        math.sin(pitch),
        math.sin(yaw) * math.cos(pitch),
    )
    look_from = np.array([-10.0, 2.0, -4.0])
    look_at = np.array([0.0, 1.0, 0.0])
    focus = float(np.linalg.norm(look_at - look_from))
    # up from the fly-camera orientation (fly_camera.rs:228-241)
    f = np.asarray(forward)
    right = np.cross(f, [0.0, 1.0, 0.0])
    up = np.cross(right, f)
    from .angle import Angle

    return Camera(
        eye_pos=tuple(look_from),
        eye_dir=tuple(f),
        up=tuple(up / np.linalg.norm(up)),
        vfov=Angle.degrees(30.0),
        aperture=0.8,
        focus_distance=focus,
    )


# ---------------------------------------------------------------------------
# Benchmark ladder (BASELINE.md configs)
# ---------------------------------------------------------------------------

def single_sphere() -> SceneDesc:
    """Config 1: one lambertian sphere + ground, for CPU-oracle parity."""
    materials = [
        Material.lambertian((0.5, 0.5, 0.5)),
        Material.lambertian((0.7, 0.3, 0.3)),
    ]
    spheres = [
        Sphere((0.0, -100.5, -1.0), 100.0, 0),
        Sphere((0.0, 0.0, -1.0), 0.5, 1),
    ]
    return SceneDesc(materials=materials, spheres=spheres)


def single_sphere_camera() -> Camera:
    return Camera.look_at(
        (0.0, 0.0, 1.0), (0.0, 0.0, -1.0), vfov_degrees=60.0, aperture=0.0
    )


def three_spheres() -> SceneDesc:
    """Config 2: lambertian / metal / dielectric + ground."""
    materials = [
        Material.lambertian((0.8, 0.8, 0.0)),
        Material.lambertian((0.1, 0.2, 0.5)),
        Material.dielectric(1.5),
        Material.metal((0.8, 0.6, 0.2), fuzz=0.0),
    ]
    spheres = [
        Sphere((0.0, -100.5, -1.0), 100.0, 0),
        Sphere((0.0, 0.0, -1.0), 0.5, 1),
        Sphere((-1.0, 0.0, -1.0), 0.5, 2),
        Sphere((-1.0, 0.0, -1.0), -0.45, 2),  # hollow-glass inner shell
        Sphere((1.0, 0.0, -1.0), 0.5, 3),
    ]
    return SceneDesc(materials=materials, spheres=spheres)


def three_spheres_camera() -> Camera:
    return Camera.look_at(
        (-2.0, 2.0, 1.0), (0.0, 0.0, -1.0), vfov_degrees=20.0, aperture=0.0
    )


def rtiow_final(seed: int = 42) -> SceneDesc:
    """Config 3: the Ray Tracing in One Weekend final scene (~480 spheres)."""
    rs = np.random.RandomState(seed)
    materials: List[Material] = [
        Material.checkerboard((0.2, 0.3, 0.1), (0.9, 0.9, 0.9)),  # ground
        Material.dielectric(1.5),
        Material.lambertian((0.4, 0.2, 0.1)),
        Material.metal((0.7, 0.6, 0.5), fuzz=0.0),
    ]
    spheres: List[Sphere] = [
        Sphere((0.0, -1000.0, 0.0), 1000.0, 0),
        Sphere((0.0, 1.0, 0.0), 1.0, 1),
        Sphere((-4.0, 1.0, 0.0), 1.0, 2),
        Sphere((4.0, 1.0, 0.0), 1.0, 3),
    ]
    for a in range(-11, 11):
        for b in range(-11, 11):
            choose = rs.rand()
            center = (
                a + 0.9 * rs.rand(),
                0.2,
                b + 0.9 * rs.rand(),
            )
            if np.linalg.norm(np.asarray(center) - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose < 0.8:
                albedo = tuple((rs.rand(3) * rs.rand(3)).tolist())
                materials.append(Material.lambertian(albedo))
            elif choose < 0.95:
                albedo = tuple((0.5 * (1.0 + rs.rand(3))).tolist())
                materials.append(Material.metal(albedo, fuzz=0.5 * rs.rand()))
            else:
                materials.append(Material.dielectric(1.5))
            spheres.append(Sphere(center, 0.2, len(materials) - 1))
    return SceneDesc(materials=materials, spheres=spheres)


def rtiow_final_camera() -> Camera:
    return Camera.look_at(
        (13.0, 2.0, 3.0),
        (0.0, 0.0, 0.0),
        vfov_degrees=20.0,
        aperture=0.1,
        focus_distance=10.0,
    )


def textured_spheres(assets_dir: Optional[str] = None) -> SceneDesc:
    """Config 4: textured earth/moon spheres over a checkerboard ground."""
    earth = _load_or_procedural(
        assets_dir and os.path.join(assets_dir, "earthmap.jpeg"), procedural_earth
    )
    moon = _load_or_procedural(
        assets_dir and os.path.join(assets_dir, "moon.jpeg"), procedural_moon
    )
    materials = [
        Material.checkerboard((0.3, 0.3, 0.35), (0.9, 0.9, 0.9)),
        Material.lambertian(earth),
        Material.lambertian(moon),
        Material.metal((0.9, 0.9, 0.95), fuzz=0.05),
        Material.emissive((1.0, 0.85, 0.6), intensity=12.0),
    ]
    spheres = [
        Sphere((0.0, -1000.0, 0.0), 1000.0, 0),
        Sphere((0.0, 2.0, 0.0), 2.0, 1),
        Sphere((3.0, 1.0, 2.0), 1.0, 2),
        Sphere((-3.5, 1.5, -1.0), 1.5, 3),
        Sphere((2.5, 5.0, -3.0), 0.8, 4),  # emissive area light
    ]
    return SceneDesc(materials=materials, spheres=spheres)


def textured_spheres_camera() -> Camera:
    return Camera.look_at(
        (0.0, 3.0, 12.0), (0.0, 2.0, 0.0), vfov_degrees=30.0, aperture=0.02
    )


def random_spheres(n: int = 10000, seed: int = 7, extent: float = 50.0) -> SceneDesc:
    """Config 5: n-sphere stress scene for LBVH/culling benchmarks."""
    rs = np.random.RandomState(seed)
    materials: List[Material] = [
        Material.checkerboard((0.2, 0.2, 0.25), (0.85, 0.85, 0.9)),
        Material.dielectric(1.5),
        Material.metal((0.8, 0.8, 0.85), fuzz=0.1),
    ]
    palette = [
        Material.lambertian(tuple(rs.rand(3) * rs.rand(3))) for _ in range(61)
    ]
    materials.extend(palette)
    spheres: List[Sphere] = [Sphere((0.0, -10000.0, 0.0), 10000.0, 0)]
    xy = rs.uniform(-extent, extent, size=(n - 1, 2))
    r = rs.uniform(0.1, 0.35, size=(n - 1,))
    kind = rs.rand(n - 1)
    for i in range(n - 1):
        if kind[i] < 0.05:
            m = 1
        elif kind[i] < 0.15:
            m = 2
        else:
            m = 3 + int(rs.randint(len(palette)))
        spheres.append(
            Sphere((float(xy[i, 0]), float(r[i]), float(xy[i, 1])), float(r[i]), m)
        )
    return SceneDesc(materials=materials, spheres=spheres)


def random_spheres_camera(extent: float = 50.0) -> Camera:
    return Camera.look_at(
        (0.0, 6.0, extent * 1.2),
        (0.0, 0.5, 0.0),
        vfov_degrees=35.0,
        aperture=0.02,
    )


SCENES = {
    "demo": (reference_demo, reference_demo_camera),
    "single": (single_sphere, single_sphere_camera),
    "three": (three_spheres, three_spheres_camera),
    "rtiow": (rtiow_final, rtiow_final_camera),
    "textured": (textured_spheres, textured_spheres_camera),
    "random10k": (random_spheres, random_spheres_camera),
}
