"""Angle newtype: degrees/radians with arithmetic and clamping.

Capability parity with the reference's ``Angle`` (src/raytracer/angle.rs:1-50),
the only unit-tested component of the reference. Stored internally in radians.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Angle:
    """An angle stored in radians, constructible from degrees or radians."""

    radians: float

    @staticmethod
    def degrees(value: float) -> "Angle":
        return Angle(math.radians(value))

    @staticmethod
    def from_radians(value: float) -> "Angle":
        return Angle(float(value))

    def as_degrees(self) -> float:
        return math.degrees(self.radians)

    def as_radians(self) -> float:
        return self.radians

    def __add__(self, other: "Angle") -> "Angle":
        return Angle(self.radians + other.radians)

    def __sub__(self, other: "Angle") -> "Angle":
        return Angle(self.radians - other.radians)

    def clamp(self, lo: "Angle", hi: "Angle") -> "Angle":
        """Clamp into [lo, hi] (reference: angle.rs clamp semantics)."""
        return Angle(min(max(self.radians, lo.radians), hi.radians))
