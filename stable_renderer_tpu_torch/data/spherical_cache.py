"""Spherical view-point cache (host-only numpy).

Counterpart of stable_renderer_tpu/data/spherical_cache.py, copied: the
capability match for the reference's experimental spherical cache
(reference: common_utils/spherical_cache/spherical_cache.py:16-120 ViewPoint/
SphereCache, view_point.py — view directions binned on a sphere with a
view-normal threshold; unused by the reference engine but part of its surface).

Stores per-viewpoint payloads keyed by quantized spherical coordinates; lookup
returns the nearest cached viewpoint within an angular threshold.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class ViewPoint:
    """A direction on the unit sphere in spherical coordinates (degrees):
    theta = polar angle from +Y in [0, 180], phi = azimuth in [0, 360)."""

    theta: float
    phi: float

    @classmethod
    def from_direction(cls, direction) -> "ViewPoint":
        d = np.asarray(direction, np.float64)
        d = d / max(np.linalg.norm(d), 1e-12)
        theta = math.degrees(math.acos(np.clip(d[1], -1.0, 1.0)))
        phi = math.degrees(math.atan2(d[2], d[0])) % 360.0
        return cls(theta=theta, phi=phi)

    def direction(self) -> np.ndarray:
        t, p = math.radians(self.theta), math.radians(self.phi)
        return np.asarray(
            [math.sin(t) * math.cos(p), math.cos(t), math.sin(t) * math.sin(p)],
            np.float32,
        )

    def angle_to(self, other: "ViewPoint") -> float:
        cos = float(np.clip(np.dot(self.direction(), other.direction()), -1.0, 1.0))
        return math.degrees(math.acos(cos))


@dataclass
class SphereCache:
    """View-binned payload cache: directions quantize into an
    (n_theta x n_phi) grid; get() returns the nearest entry within
    ``angle_threshold`` degrees."""

    n_theta: int = 6
    n_phi: int = 12
    angle_threshold: float = 30.0
    _entries: Dict[Tuple[int, int], Tuple[ViewPoint, Any]] = field(default_factory=dict)

    def _bin(self, vp: ViewPoint) -> Tuple[int, int]:
        ti = min(int(vp.theta / 180.0 * self.n_theta), self.n_theta - 1)
        pi = int(vp.phi / 360.0 * self.n_phi) % self.n_phi
        return ti, pi

    def put(self, direction, value: Any) -> Tuple[int, int]:
        vp = ViewPoint.from_direction(direction)
        key = self._bin(vp)
        self._entries[key] = (vp, value)
        return key

    def get(self, direction) -> Optional[Any]:
        vp = ViewPoint.from_direction(direction)
        best, best_angle = None, self.angle_threshold
        for stored_vp, value in self._entries.values():
            a = vp.angle_to(stored_vp)
            if a <= best_angle:
                best, best_angle = value, a
        return best

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def view_points(self) -> List[ViewPoint]:
        return [vp for vp, _ in self._entries.values()]
