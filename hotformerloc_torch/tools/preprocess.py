"""Point-cloud preprocessing: ground removal, downsampling, outlier
removal, PNV normalisation, multiprocessing map.

Counterpart of hotformerloc_tpu/tools/preprocess.py: NumPy
re-implementations of the reference's open3d/CSF-based utilities (its
datasets/CSWildPlaces/processing_utils.py:63-290):
  * remove_ground_csf — cloth-simulation ground filter (CSF): an
    inverted rigid cloth grid settles onto the flipped cloud; points
    within `threshold` of the relaxed cloth are ground.
  * voxel_down_sample — voxel-centroid downsample (open3d semantics).
  * pnvlad_down_sample — iterative voxel-size search to hit a target
    point count, padded with random points.
  * remove_outliers — statistical outlier removal (kNN mean-distance
    z-score), nb_neighbors=20, std_ratio=3.0.
  * normalise_pcl — PointNetVLAD [-1,1] normalisation (centroid shift,
    0.5/mean-distance scale, clip, random refill to target count).
  * multiprocessing_func — worker-pool map with progress.
"""
from __future__ import annotations

import multiprocessing as mp
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from hotformerloc_torch.data import native

RANDOM_SEED = 42
VOXEL_STEP = 0.01

# CSF parameters (processing_utils.py:14-20 defaults)
CSF_RESOLUTION = 0.5
CSF_RIGIDNESS = 3
CSF_THRESHOLD = 0.5
CSF_ITERATIONS = 500
CSF_TIME_STEP = 0.65


def remove_ground_csf(pts: np.ndarray,
                      resolution: float = CSF_RESOLUTION,
                      threshold: float = CSF_THRESHOLD,
                      rigidness: int = CSF_RIGIDNESS,
                      iterations: int = CSF_ITERATIONS) -> np.ndarray:
    """Cloth Simulation Filter ground removal (Zhang et al. 2016).

    The cloud is inverted (z -> -z); a cloth grid of spacing
    `resolution` falls from above under gravity, each node clamped by
    the highest inverted point beneath it ("collision"), with
    neighbour-averaging internal forces whose strength grows with
    `rigidness`. Points within `threshold` of the settled cloth are
    ground; the rest are returned.
    """
    pts = np.asarray(pts, dtype=np.float64)
    if len(pts) == 0:
        return pts
    inv_z = -pts[:, 2]
    xy = pts[:, :2]
    mn = xy.min(0) - resolution
    mx = xy.max(0) + resolution
    nx = max(int(np.ceil((mx[0] - mn[0]) / resolution)) + 1, 2)
    ny = max(int(np.ceil((mx[1] - mn[1]) / resolution)) + 1, 2)

    ix = np.clip(((xy[:, 0] - mn[0]) / resolution).astype(np.int64),
                 0, nx - 1)
    iy = np.clip(((xy[:, 1] - mn[1]) / resolution).astype(np.int64),
                 0, ny - 1)
    cell = ix * ny + iy
    # ceiling per cell = max inverted height (i.e., lowest real point)
    ceiling = np.full(nx * ny, -np.inf)
    np.maximum.at(ceiling, cell, inv_z)
    has_pts = np.isfinite(ceiling)
    # empty cells: nearest-filled approximation via global max so the
    # cloth can drop freely there
    ceiling[~has_pts] = inv_z.max()
    ceiling = ceiling.reshape(nx, ny)

    cloth = np.full((nx, ny), inv_z.max() + 1.0)  # start above everything
    movable = np.ones((nx, ny), dtype=bool)
    dt2 = CSF_TIME_STEP * CSF_TIME_STEP
    prev = cloth.copy()
    for _ in range(iterations):
        # gravity (Verlet integration, unit mass)
        nxt = cloth + (cloth - prev) * 0.99 - dt2
        prev, cloth = cloth, np.where(movable, nxt, cloth)
        # collision: cloth cannot fall below the point ceiling
        hit = cloth <= ceiling
        cloth = np.where(hit, ceiling, cloth)
        movable &= ~hit
        # internal rigidness: pull movable nodes toward neighbour mean
        for _ in range(rigidness):
            nb = (np.roll(cloth, 1, 0) + np.roll(cloth, -1, 0)
                  + np.roll(cloth, 1, 1) + np.roll(cloth, -1, 1)) / 4.0
            cloth = np.where(movable, cloth + 0.5 * (nb - cloth), cloth)
            under = cloth <= ceiling
            cloth = np.where(under, ceiling, cloth)
            movable &= ~under
        if not movable.any():
            break

    cloth_at_pt = cloth[ix, iy]
    ground = np.abs(inv_z - cloth_at_pt) <= threshold
    return pts[~ground]


def voxel_down_sample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Voxel-centroid downsample (open3d `voxel_down_sample` semantics:
    one output point per occupied voxel = mean of its points)."""
    points = np.asarray(points, dtype=np.float64)
    if len(points) == 0:
        return points
    mn = points.min(0)
    # native hashed-grid path (native/pointops.cpp, built at first use
    # into hotformerloc_torch/build/); clouds are local lidar coords so
    # the fp32 round-trip is exact to ~1e-5 m
    if native.load_library() is not None:
        out = native.voxel_downsample(
            (points - mn).astype(np.float32), float(voxel_size))
        return out.astype(np.float64) + mn
    idx = np.floor((points - mn) / voxel_size).astype(np.int64)
    # lexicographic voxel key
    key = (idx[:, 0] * 73856093) ^ (idx[:, 1] * 19349663) \
        ^ (idx[:, 2] * 83492791)
    order = np.argsort(key, kind="stable")
    k = key[order]
    starts = np.flatnonzero(np.concatenate([[True], k[1:] != k[:-1]]))
    sums = np.add.reduceat(points[order], starts, axis=0)
    counts = np.diff(np.concatenate([starts, [len(k)]]))
    return sums / counts[:, None]


def random_down_sample(points: np.ndarray, downsample_number: int,
                       random_seed: int = RANDOM_SEED) -> np.ndarray:
    """Random choice with replacement (processing_utils.py:89-100)."""
    rng = np.random.default_rng(seed=random_seed)
    return rng.choice(points, downsample_number)


def pnvlad_down_sample(points: np.ndarray, downsample_number: int,
                       random_seed: int = RANDOM_SEED) -> np.ndarray:
    """PointNetVLAD-style downsample: search a voxel size whose
    centroid count just undershoots the target, pad with random points
    (processing_utils.py:101-140)."""
    rng = np.random.default_rng(seed=random_seed)
    voxel_size = 3.001
    down = voxel_down_sample(points, voxel_size)
    while len(down) < downsample_number:
        voxel_size -= VOXEL_STEP
        assert voxel_size > 0, (
            f"Cloud size {len(down)} smaller than {downsample_number} "
            "with 1cm voxels")
        down = voxel_down_sample(points, voxel_size)
    while len(down) > downsample_number:
        voxel_size += VOXEL_STEP / 5
        down = voxel_down_sample(points, voxel_size)
    extra = downsample_number - len(down)
    if extra > 0:
        down = np.concatenate([down, rng.choice(points, size=extra)])
    return down


def remove_outliers(points: np.ndarray,
                    points_timestamps: Optional[np.ndarray] = None,
                    nb_neighbors: int = 20, std_ratio: float = 3.0
                    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Statistical outlier removal (open3d semantics): drop points whose
    mean kNN distance exceeds global mean + std_ratio * std."""
    points = np.asarray(points, dtype=np.float64)
    if len(points) <= nb_neighbors:
        return points, points_timestamps
    from sklearn.neighbors import KDTree
    tree = KDTree(points)
    dist, _ = tree.query(points, k=nb_neighbors + 1)
    mean_d = dist[:, 1:].mean(axis=1)
    thr = mean_d.mean() + std_ratio * mean_d.std()
    keep = mean_d <= thr
    ts = points_timestamps[keep] if points_timestamps is not None else None
    return points[keep], ts


def normalise_pcl(points_downsampled: np.ndarray, points: np.ndarray,
                  downsample_number: Optional[int],
                  random_seed: int = RANDOM_SEED) -> np.ndarray:
    """PointNetVLAD [-1, 1] normalisation (processing_utils.py:171-228):
    shift to centroid, scale s = 0.5 / mean distance, drop out-of-box
    points, refill with random transformed points to the target count."""
    rng = np.random.default_rng(seed=random_seed)
    pd = np.asarray(points_downsampled, dtype=np.float64)
    centroid = pd.mean(0)
    d = np.linalg.norm(pd - centroid, axis=1).mean()
    s = 0.5 / d
    scaled = (pd - centroid) * s
    final = scaled[np.all(np.abs(scaled) <= 1, axis=1)]
    if downsample_number is not None:
        while len(final) < downsample_number:
            cand = rng.choice(points, size=downsample_number - len(final))
            cand = (cand - centroid) * s
            cand = cand[np.all(np.abs(cand) <= 1, axis=1)]
            final = np.concatenate([final, cand])
        assert len(final) == downsample_number, \
            f"normalisation error, size {len(final)}"
    assert final.min() >= -1 and final.max() <= 1, "normalisation error"
    return final


def multiprocessing_func(function: Callable, inputs: Sequence,
                         num_workers: int = 1) -> List:
    """Pool map with ordered results (processing_utils.py:277-290)."""
    if num_workers <= 1:
        return [function(x) for x in inputs]
    with mp.Pool(num_workers) as pool:
        return pool.map(function, inputs)


def quaternion_to_rot(q: np.ndarray) -> np.ndarray:
    """(qx, qy, qz, qw) -> 3x3 rotation (processing_utils.py:22-32)."""
    qx, qy, qz, qw = q
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
         2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
         1 - 2 * (qx * qx + qy * qy)],
    ])


def rot_to_quaternion(R: np.ndarray) -> np.ndarray:
    """3x3 rotation -> (qx, qy, qz, qw)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[3] = (R[k, j] - R[j, k]) / s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        qx, qy, qz, qw = q
    return np.array([qx, qy, qz, qw])
