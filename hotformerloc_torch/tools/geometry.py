"""Dependency-free 2-D split geometry (replaces shapely in the
reference's tuple-generation scripts, e.g. its
datasets/WildPlaces/utils.py:1-62).

Counterpart of hotformerloc_tpu/tools/geometry.py. Implements exactly
what the generators need: point-in-polygon containment (ray casting),
point-to-polygon distance (for buffer zones), and circles.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np

from hotformerloc_torch.data import native


class Polygon:
    """Simple 2-D polygon over (x, y) vertex pairs."""

    def __init__(self, points: Sequence[Tuple[float, float]]):
        self.pts = np.asarray(points, dtype=np.float64)
        assert self.pts.ndim == 2 and self.pts.shape[1] == 2 \
            and len(self.pts) >= 3

    @property
    def exterior_xy(self) -> Tuple[np.ndarray, np.ndarray]:
        closed = np.vstack([self.pts, self.pts[:1]])
        return closed[:, 0], closed[:, 1]

    def contains(self, x: float, y: float) -> bool:
        """Ray-casting even-odd rule. Boundary points count as inside
        (matches shapely `covers`; `contains` differs only on exact
        boundary hits, which never occur for survey coordinates)."""
        px, py = self.pts[:, 0], self.pts[:, 1]
        qx, qy = np.roll(px, -1), np.roll(py, -1)
        crosses = ((py > y) != (qy > y))
        with np.errstate(divide="ignore", invalid="ignore"):
            xint = px + (y - py) * (qx - px) / (qy - py)
        inside = np.count_nonzero(crosses & (x < xint)) % 2 == 1
        return bool(inside) or self.distance(x, y) == 0.0

    def distance(self, x: float, y: float) -> float:
        """Euclidean distance from (x, y) to the polygon (0 inside)."""
        p = np.array([x, y])
        a = self.pts
        b = np.roll(a, -1, axis=0)
        ab = b - a
        t = np.clip(np.einsum("ij,ij->i", p - a, ab)
                    / np.maximum(np.einsum("ij,ij->i", ab, ab), 1e-30),
                    0.0, 1.0)
        proj = a + t[:, None] * ab
        d = float(np.min(np.linalg.norm(proj - p, axis=1)))
        return 0.0 if self._inside_ray(x, y) else d

    def _inside_ray(self, x: float, y: float) -> bool:
        px, py = self.pts[:, 0], self.pts[:, 1]
        qx, qy = np.roll(px, -1), np.roll(py, -1)
        crosses = ((py > y) != (qy > y))
        with np.errstate(divide="ignore", invalid="ignore"):
            xint = px + (y - py) * (qx - px) / (qy - py)
        return bool(np.count_nonzero(crosses & (x < xint)) % 2 == 1)

    def buffer_contains(self, x: float, y: float, radius: float) -> bool:
        """Inside the polygon dilated by `radius` (shapely
        `poly.buffer(r).contains(pt)` equivalent)."""
        return self.distance(x, y) <= radius


class Circle:
    """Circle region (replaces shapely Point().buffer(r))."""

    def __init__(self, x: float, y: float, radius: float):
        self.c = np.array([x, y], dtype=np.float64)
        self.r = float(radius)

    def contains(self, x: float, y: float) -> bool:
        return float(np.hypot(x - self.c[0], y - self.c[1])) <= self.r

    @property
    def exterior_xy(self):
        t = np.linspace(0, 2 * np.pi, 65)
        return self.c[0] + self.r * np.cos(t), self.c[1] + self.r * np.sin(t)


def make_circle(x: float, y: float, radius: float = 30.0) -> Circle:
    return Circle(x, y, radius)


def any_contains(regions: Iterable, x: float, y: float) -> bool:
    return any(r.contains(x, y) for r in regions)


def radius_query(points: np.ndarray, queries: np.ndarray,
                 radius: float) -> List[np.ndarray]:
    """Sorted indices of `points` within `radius` of each query row.

    sklearn KDTree equivalent used by the tuple generators; kept here so
    the generators run even without sklearn.
    """
    if len(points) == 0 or len(queries) == 0:
        return [np.array([], dtype=np.int64) for _ in range(len(queries))]
    if points.shape[1] == 2:
        # native grid-hashed search (native/pointops.cpp, built at first
        # use into hotformerloc_torch/build/) beats the sklearn KDTree on
        # the tuple-generation workloads. Centre the coordinates first:
        # the native path is fp32 and raw UTM eastings/northings (~1e6 m)
        # would quantise at ~0.1-1 m.
        if native.load_library() is not None:
            mid = points.mean(axis=0)
            offsets, idx = native.radius_search_2d(points - mid,
                                                   queries - mid, radius)
            return [np.sort(idx[offsets[q]:offsets[q + 1]])
                    for q in range(len(queries))]
    try:
        from sklearn.neighbors import KDTree
        tree = KDTree(points)
        out = tree.query_radius(queries, r=radius)
        return [np.sort(ix) for ix in out]
    except ImportError:
        d2 = ((queries[:, None, :] - points[None, :, :]) ** 2).sum(-1)
        return [np.where(row <= radius * radius)[0] for row in d2]
