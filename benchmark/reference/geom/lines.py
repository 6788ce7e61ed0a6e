"""2D lines with unit displacement, the workhorse of BSP traversal and
trigger tests.

Reference behavior: rust-doom's math/src/line.rs (Line2). Host-side
(scalar) version here; the vectorized device version lives in
tpu_doom_torch.sim.triggers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class Line2:
    origin: tuple[float, float]
    displace: tuple[float, float]  # unit (or zero)
    length: float

    @classmethod
    def from_origin_and_displace(cls, origin, displace) -> "Line2":
        length = math.hypot(displace[0], displace[1])
        if abs(length) >= 1e-16:
            return cls(
                (float(origin[0]), float(origin[1])),
                (displace[0] / length, displace[1] / length),
                length,
            )
        return cls((float(origin[0]), float(origin[1])), (0.0, 0.0), 0.0)

    @classmethod
    def from_two_points(cls, origin, towards) -> "Line2":
        return cls.from_origin_and_displace(
            origin, (towards[0] - origin[0], towards[1] - origin[1])
        )

    def inverted_halfspaces(self) -> "Line2":
        return Line2(self.origin, (-self.displace[0], -self.displace[1]), self.length)

    def signed_distance(self, to) -> float:
        """perp_dot(to, d) + perp_dot(d, origin) (ref line.rs:41-43)."""
        d = self.displace
        o = self.origin
        return (to[0] * d[1] - to[1] * d[0]) + (d[0] * o[1] - d[1] * o[0])

    def intersect_offset(self, other: "Line2") -> float | None:
        denom = self.displace[0] * other.displace[1] - self.displace[1] * other.displace[0]
        if abs(denom) < 1e-16:
            return None
        dx = other.origin[0] - self.origin[0]
        dy = other.origin[1] - self.origin[1]
        return (dx * other.displace[1] - dy * other.displace[0]) / denom

    def at_offset(self, offset: float) -> tuple[float, float]:
        return (
            self.origin[0] + self.displace[0] * offset,
            self.origin[1] + self.displace[1] * offset,
        )

    def intersect_point(self, other: "Line2") -> tuple[float, float] | None:
        off = self.intersect_offset(other)
        return None if off is None else self.at_offset(off)

    def offset_at(self, point) -> float:
        if abs(self.displace[0]) > abs(self.displace[1]):
            return (point[0] - self.origin[0]) / self.displace[0]
        return (point[1] - self.origin[1]) / self.displace[1]

    def segment_intersect_offset(self, other: "Line2") -> float | None:
        """Offset along self where the two *segments* intersect, else None
        (ref line.rs:45-58)."""
        offset = self.intersect_offset(other)
        if offset is None or offset < 0.0 or offset >= self.length:
            return None
        other_offset = other.offset_at(self.at_offset(offset))
        if other_offset < 0.0 or other_offset >= other.length:
            return None
        return offset
