"""Fly-camera controller: WASD/QE translation + drag-look, pure math.

Counterpart of weekend_raytracer_tpu/interactive/fly_camera.py (numpy and
``Camera`` only, so the same code). Capability parity with the reference's
``FlyCameraController`` (src/fly_camera.rs:5-241): yaw/pitch orientation
from spherical angles, camera-local spherical-delta mouse look (fly_camera.rs:125-173), axis
translation along the camera frame (fly_camera.rs:175-189), and the
renderer camera derivation (fly_camera.rs:53-64). The windowing-event
plumbing of the reference (winit) is replaced by explicit methods the host
loop calls (works for terminals, notebooks, or a GUI shell).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

from ..models.angle import Angle
from ..models.camera import Camera


@dataclasses.dataclass
class Orientation:
    forward: np.ndarray
    right: np.ndarray
    up: np.ndarray


def camera_orientation(yaw: Angle, pitch: Angle) -> Orientation:
    """Orientation frame from yaw/pitch (fly_camera.rs:228-241)."""
    cy, sy = math.cos(yaw.as_radians()), math.sin(yaw.as_radians())
    cp, sp = math.cos(pitch.as_radians()), math.sin(pitch.as_radians())
    forward = np.array([cy * cp, sp, sy * cp])
    forward /= np.linalg.norm(forward)
    world_up = np.array([0.0, 1.0, 0.0])
    right = np.cross(forward, world_up)
    # |cross(forward, world_up)| = cos(pitch): normalize so translation
    # speed and the drag-look local basis don't shrink at steep pitch
    # (Camera.look_at normalizes the identical construction). At pitch
    # = +/-90 deg the cross is zero; fall back to a horizontal right
    # vector from yaw alone instead of dividing by ~0 (drag clamps pitch
    # to +/-89 deg, but pitch is a public field).
    n = np.linalg.norm(right)
    if n < 1e-6:
        right = np.array([-sy, 0.0, cy])
    else:
        right /= n
    up = np.cross(right, forward)
    return Orientation(forward=forward, right=right, up=up)


@dataclasses.dataclass
class FlyCameraController:
    """Interactive camera state. Defaults match fly_camera.rs:24-50."""

    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([-10.0, 2.0, -4.0])
    )
    yaw: Angle = dataclasses.field(default_factory=lambda: Angle.degrees(25.0))
    pitch: Angle = dataclasses.field(default_factory=lambda: Angle.degrees(-10.0))
    vfov_degrees: float = 30.0
    aperture: float = 0.8
    focus_distance: float = dataclasses.field(
        default_factory=lambda: float(
            np.linalg.norm(np.array([0.0, 1.0, 0.0]) - np.array([-10.0, 2.0, -4.0]))
        )
    )

    # key state (the reference's *_pressed booleans)
    forward_pressed: bool = False
    backward_pressed: bool = False
    left_pressed: bool = False
    right_pressed: bool = False
    up_pressed: bool = False
    down_pressed: bool = False
    look_pressed: bool = False
    previous_mouse_pos: Optional[Tuple[float, float]] = None
    mouse_pos: Tuple[float, float] = (0.0, 0.0)

    # -- the reference's public surface ---------------------------------------

    def renderer_camera(self) -> Camera:
        """Produce the render camera (fly_camera.rs:53-64)."""
        o = camera_orientation(self.yaw, self.pitch)
        return Camera(
            eye_pos=tuple(self.position),
            eye_dir=tuple(o.forward),
            up=tuple(o.up),
            vfov=Angle.degrees(self.vfov_degrees),
            aperture=self.aperture,
            focus_distance=self.focus_distance,
        )

    def set_key(self, key: str, pressed: bool) -> None:
        """WASD/QE key handling (fly_camera.rs:66-118). 'q' is up, 'e' down."""
        attr = {
            "w": "forward_pressed",
            "s": "backward_pressed",
            "a": "left_pressed",
            "d": "right_pressed",
            "q": "up_pressed",
            "e": "down_pressed",
        }.get(key.lower())
        if attr:
            setattr(self, attr, pressed)

    def set_mouse(self, pos: Tuple[float, float], look_pressed: bool) -> None:
        if look_pressed and not self.look_pressed:
            # new drag: forget the previous drag's release point, or the
            # first press applies a spurious full-screen look delta
            # (terminal mouse mode only reports motion while pressed)
            self.previous_mouse_pos = None
        self.mouse_pos = pos
        self.look_pressed = look_pressed

    def after_events(self, viewport_size: Tuple[int, int], translation_scale: float) -> None:
        """Apply look + translation for this frame (fly_camera.rs:120-192)."""
        if self.look_pressed and self.previous_mouse_pos is not None:
            o = camera_orientation(self.yaw, self.pitch)
            c1, c2 = o.right, o.forward
            c3 = np.cross(c1, c2)
            c3 /= np.linalg.norm(c3)
            from_local = np.stack([c1, c2, c3], axis=1)
            to_local = np.linalg.inv(from_local)

            cur = to_local @ self.generate_camera_ray_dir(self.mouse_pos, viewport_size)
            prev = to_local @ self.generate_camera_ray_dir(
                self.previous_mouse_pos, viewport_size
            )
            x1, y1, z1 = cur
            x2, y2, z2 = prev
            p1 = math.acos(max(-1.0, min(1.0, z1)))
            p2 = math.acos(max(-1.0, min(1.0, z2)))
            a1 = math.copysign(1.0, y1) * math.acos(
                max(-1.0, min(1.0, x1 / math.sqrt(x1 * x1 + y1 * y1)))
            )
            a2 = math.copysign(1.0, y2) * math.acos(
                max(-1.0, min(1.0, x2 / math.sqrt(x2 * x2 + y2 * y2)))
            )
            self.yaw = self.yaw + Angle.from_radians(a1 - a2)
            self.pitch = (self.pitch + Angle.from_radians(p1 - p2)).clamp(
                Angle.degrees(-89.0), Angle.degrees(89.0)
            )

        v = lambda b: 1.0 if b else 0.0
        tx = translation_scale * (v(self.right_pressed) - v(self.left_pressed))
        ty = translation_scale * (v(self.up_pressed) - v(self.down_pressed))
        tz = translation_scale * (v(self.forward_pressed) - v(self.backward_pressed))
        o = camera_orientation(self.yaw, self.pitch)
        self.position = self.position + o.right * tx + o.up * ty + o.forward * tz
        self.previous_mouse_pos = self.mouse_pos

    def generate_camera_ray_dir(
        self, mouse_pos: Tuple[float, float], viewport_size: Tuple[int, int]
    ) -> np.ndarray:
        """Unit ray through a screen point (fly_camera.rs:195-219)."""
        w, h = viewport_size
        aspect = w / h
        half_h = self.focus_distance * math.tan(
            0.5 * Angle.degrees(self.vfov_degrees).as_radians()
        )
        half_w = aspect * half_h
        x = mouse_pos[0] / w
        y = mouse_pos[1] / h
        o = camera_orientation(self.yaw, self.pitch)
        point = (
            self.position
            + self.focus_distance * o.forward
            + (2.0 * x - 1.0) * half_w * o.right
            + (1.0 - 2.0 * y) * half_h * o.up
        )
        d = point - self.position
        return d / np.linalg.norm(d)
