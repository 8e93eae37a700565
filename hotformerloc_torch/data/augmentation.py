"""Point-cloud augmentations in numpy.

Own copy of hotformerloc_tpu/data/augmentation.py (the port imports
nothing of the JAX package): the same transforms, in the same order of
random draws, so a seeded batch is bitwise equal in both packages.

All transforms take/return (N, 3) float32 arrays and draw randomness
from an explicit numpy Generator for reproducibility.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np


def _rotation_matrix(axis: np.ndarray, theta: float) -> np.ndarray:
    """Rodrigues rotation about `axis` by `theta` radians."""
    axis = axis / np.linalg.norm(axis)
    a = math.cos(theta / 2.0)
    b, c, d = -axis * math.sin(theta / 2.0)
    return np.array([
        [a*a+b*b-c*c-d*d, 2*(b*c+a*d), 2*(b*d-a*c)],
        [2*(b*c-a*d), a*a+c*c-b*b-d*d, 2*(c*d+a*b)],
        [2*(b*d+a*c), 2*(c*d-a*b), a*a+d*d-b*b-c*c]],
        dtype=np.float32)


class RandomRotation:
    """Rotation about a fixed or random axis by +-max_theta degrees
    (coords @ R convention)."""

    def __init__(self, axis=None, max_theta: float = 180.0,
                 max_theta2: Optional[float] = None):
        self.axis = None if axis is None else np.asarray(axis, np.float32)
        self.max_theta = max_theta
        self.max_theta2 = max_theta2

    @staticmethod
    def _apply(coords: np.ndarray, R: np.ndarray) -> np.ndarray:
        # column-expanded coords @ R: numpy's (N,3)x(3,3) matmul path is
        # ~5-10x slower than three fused axpy passes at loader shapes
        # (tools/loader_bench.py profile)
        x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]
        out = np.empty_like(coords)
        for j in range(3):
            out[:, j] = x * R[0, j] + y * R[1, j] + z * R[2, j]
        return out

    def __call__(self, coords: np.ndarray, rng: np.random.Generator):
        axis = self.axis if self.axis is not None else rng.random(3) - 0.5
        theta = (np.pi * self.max_theta / 180.0) * 2.0 * (rng.random() - 0.5)
        coords = self._apply(coords, _rotation_matrix(axis, theta))
        if self.max_theta2 is not None:
            t2 = (np.pi * self.max_theta2 / 180.0) * 2.0 * (rng.random()
                                                            - 0.5)
            coords = self._apply(coords,
                                 _rotation_matrix(rng.random(3) - 0.5, t2))
        return coords.astype(np.float32, copy=False)


class RandomFlip:
    """Flip each axis with probability p[i]."""

    def __init__(self, p: Sequence[float]):
        assert len(p) == 3 and 0 < sum(p) <= 1
        self.p_cum = np.cumsum(p)

    def __call__(self, coords, rng):
        r = rng.random()
        for ax in range(3):
            if r <= self.p_cum[ax]:
                coords = coords.copy()
                coords[..., ax] = -coords[..., ax]
                break
        return coords


class RandomTranslation:
    def __init__(self, max_delta: float = 0.05):
        self.max_delta = max_delta

    def __call__(self, coords, rng):
        return coords + (self.max_delta
                         * rng.standard_normal((1, 3))).astype(np.float32)


class JitterPoints:
    """Per-point Gaussian jitter with inclusion prob p."""

    def __init__(self, sigma: float = 0.001, clip: Optional[float] = None,
                 p: float = 1.0):
        self.sigma, self.clip, self.p = sigma, clip, p

    def __call__(self, e, rng):
        # float32 draws: ~2x the throughput of the default float64 path
        # on the 2-core loader host (tools/loader_bench.py profile)
        if self.p < 1.0:
            m = rng.random(e.shape[0]) < self.p
            jitter = self.sigma * rng.standard_normal(
                (int(m.sum()), 3), dtype=np.float32)
            if self.clip is not None:
                jitter = np.clip(jitter, -self.clip, self.clip)
            e = e.copy()
            e[m] += jitter
            return e
        jitter = self.sigma * rng.standard_normal(e.shape,
                                                  dtype=np.float32)
        if self.clip is not None:
            jitter = np.clip(jitter, -self.clip, self.clip)
        return e + jitter


class RemoveRandomPoints:
    """Zero out a random fraction r in [r_min, r_max] of points."""

    def __init__(self, r):
        if isinstance(r, (tuple, list)):
            self.r_min, self.r_max = float(r[0]), float(r[1])
        else:
            self.r_min, self.r_max = None, float(r)

    def __call__(self, e, rng):
        n = len(e)
        r = self.r_max if self.r_min is None \
            else rng.uniform(self.r_min, self.r_max)
        mask = rng.choice(n, size=int(n * r), replace=False)
        e = e.copy()
        e[mask] = 0.0
        return e


class RemoveRandomBlock:
    """Zero a random fronto-parallel cuboid."""

    def __init__(self, p=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3)):
        self.p, self.scale, self.ratio = p, scale, ratio

    def __call__(self, coords, rng):
        if rng.random() >= self.p:
            return coords
        mn, mx = coords.min(0), coords.max(0)
        span = mx - mn
        area = span[0] * span[1]
        erase = rng.uniform(*self.scale) * area
        ar = rng.uniform(*self.ratio)
        h, w = math.sqrt(erase * ar), math.sqrt(erase / ar)
        x = mn[0] + rng.random() * (span[0] - w)
        y = mn[1] + rng.random() * (span[1] - h)
        m = ((x < coords[..., 0]) & (coords[..., 0] < x + w)
             & (y < coords[..., 1]) & (coords[..., 1] < y + h))
        coords = coords.copy()
        coords[m] = 0.0
        return coords


class Normalize:
    """Box / unit-sphere normalisation into [-range, range]."""

    def __init__(self, norm_range: Optional[float] = None,
                 scale_factor: Optional[float] = None,
                 unit_sphere_norm: bool = False, zero_mean: bool = True):
        assert not (norm_range is not None and scale_factor is not None)
        self.norm_range = norm_range if norm_range is not None else 1.0
        self.scale_factor = scale_factor
        if scale_factor is not None:
            self.norm_range = None
        self.unit_sphere_norm = unit_sphere_norm
        self.zero_mean = zero_mean

    def __call__(self, coords, rng=None):
        if not self.unit_sphere_norm:
            bbmin, bbmax = coords.min(0), coords.max(0)
            if self.zero_mean:
                coords = coords - (bbmin + bbmax) * 0.5
            if self.scale_factor is not None:
                return (coords / self.scale_factor).astype(np.float32)
            box = (bbmax - bbmin).max() + 1e-6
            return (coords * (2.0 * self.norm_range / box)) \
                .astype(np.float32)
        if self.zero_mean:
            coords = coords - coords.mean(0)
        if self.scale_factor is not None:
            maxd = self.scale_factor
        else:
            maxd = np.linalg.norm(coords, axis=1).max() / self.norm_range
        return (coords / max(maxd, 1e-12)).astype(np.float32)


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, coords, rng):
        for t in self.transforms:
            coords = t(coords, rng)
        return coords


def make_train_transform(aug_mode: int, normalize_points: bool = False,
                         scale_factor: Optional[float] = None,
                         unit_sphere_norm: bool = False,
                         zero_mean: bool = True,
                         random_rot_theta: float = 5.0) -> Compose:
    """Per-sample train pipeline ~ TrainTransform
    (pnv_train.py:19-55 / CSWildPlaces_train.py:19-55).

    aug_mode 1: jitter/remove/translate/block (no z-rot);
    aug_mode 2: adds +-theta z-rotation per sample."""
    t = []
    if normalize_points or scale_factor is not None:
        t.append(Normalize(scale_factor=scale_factor,
                           unit_sphere_norm=unit_sphere_norm,
                           zero_mean=zero_mean))
    if aug_mode == 1:
        t += [JitterPoints(sigma=0.001, clip=0.002),
              RemoveRandomPoints(r=(0.0, 0.1)),
              RandomTranslation(max_delta=0.01),
              RemoveRandomBlock(p=0.4)]
    elif aug_mode == 2:
        t += [JitterPoints(sigma=0.001, clip=0.002),
              RemoveRandomPoints(r=(0.0, 0.1)),
              RandomRotation(max_theta=random_rot_theta,
                             axis=np.array([0., 0., 1.])),
              RandomTranslation(max_delta=0.01),
              RemoveRandomBlock(p=0.4)]
    elif aug_mode != 0:
        raise NotImplementedError(f"Unknown aug_mode: {aug_mode}")
    return Compose(t)


def make_val_transform(normalize_points: bool = False,
                       scale_factor: Optional[float] = None,
                       unit_sphere_norm: bool = False,
                       zero_mean: bool = True) -> Compose:
    t = []
    if normalize_points or scale_factor is not None:
        t.append(Normalize(scale_factor=scale_factor,
                           unit_sphere_norm=unit_sphere_norm,
                           zero_mean=zero_mean))
    return Compose(t)


def make_set_transform(set_aug_mode: int,
                       random_rot_theta: float = 5.0) -> Optional[Compose]:
    """Batch-level transform applied to all merged clouds
    (TrainSetTransform, augmentation.py:11-29)."""
    if set_aug_mode == 1:
        return Compose([RandomRotation(max_theta=random_rot_theta,
                                       axis=np.array([0., 0., 1.])),
                        RandomFlip([0.25, 0.25, 0.0])])
    if set_aug_mode == 2:
        return Compose([RandomFlip([0.25, 0.25, 0.0])])
    if set_aug_mode == 0:
        return None
    raise NotImplementedError(f"Unknown set_aug_mode: {set_aug_mode}")


class CylindricalCoordinates:
    """(x, y, z) -> scaled (rho, phi, z) for cylindrical octrees
    (datasets/coordinate_utils.py:64-131). Assumes input in [-1, 1]."""

    def __call__(self, coords, rng=None):
        rho = np.linalg.norm(coords[:, :2], axis=1)
        phi = np.arctan2(coords[:, 1], coords[:, 0]) / np.pi   # [-1, 1]
        rho = rho * 2.0 - 1.0     # [0, 1] -> [-1, 1]
        out = np.stack([rho, phi, coords[:, 2]], axis=1)
        return np.clip(out, -1.0, 1.0).astype(np.float32)
