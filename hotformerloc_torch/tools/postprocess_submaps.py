"""Offline submap post-processing: ground removal -> downsample ->
normalise -> save, over a worker pool.

Counterpart of hotformerloc_tpu/tools/postprocess_submaps.py. Covers
both reference scripts (its datasets/CSWildPlaces/postprocess_submaps.py
:40-161 and postprocess_wildplaces_ground.py:127-255): the generic mode
walks split/run/clouds trees of .pcd submaps; the wildplaces-ground mode
additionally trims each cloud to a max xy-radius and transforms poses
into a target UTM frame before saving the fixed poses.csv.

CLI:
  python -m hotformerloc_torch.tools.postprocess_submaps --root R \
      --save_dir S [--remove_ground] [--downsample]
      [--downsample_type pnvlad|random|voxel] [--downsample_target 4096]
      [--voxel_size 0.8] [--normalise] [--min_num_points 4096]
      [--radius_max 0] [--num_workers N] [--splits ...]
      [--exclude_dirs ...]
"""
from __future__ import annotations

import argparse
import functools
import os
from typing import List, Optional

import numpy as np

from hotformerloc_torch.data.loaders import read_pcd, write_pcd
from hotformerloc_torch.tools.preprocess import (RANDOM_SEED,
                                                 multiprocessing_func,
                                                 normalise_pcl,
                                                 pnvlad_down_sample,
                                                 random_down_sample,
                                                 remove_ground_csf,
                                                 voxel_down_sample)


def postprocess_points(pts: np.ndarray, *, remove_ground: bool,
                       downsample: bool, downsample_type: str,
                       downsample_target: int, voxel_size: float,
                       normalise: bool, min_num_points: int,
                       radius_max: float = 0.0
                       ) -> Optional[np.ndarray]:
    """One submap through the pipeline; None = rejected (too few
    points), mirroring the reference's skip semantics."""
    if radius_max > 0:
        pts = pts[np.linalg.norm(pts[:, :2], axis=1) <= radius_max]
    if remove_ground:
        pts = remove_ground_csf(pts)
    if len(pts) < min_num_points:
        return None
    final = pts
    if downsample:
        if downsample_type != "voxel" and len(pts) < downsample_target:
            return None
        if downsample_type == "random":
            final = random_down_sample(pts, downsample_target, RANDOM_SEED)
        elif downsample_type == "voxel":
            final = voxel_down_sample(pts, voxel_size)
        elif downsample_type == "pnvlad":
            final = pnvlad_down_sample(pts, downsample_target, RANDOM_SEED)
        else:
            raise ValueError(f"Downsample type {downsample_type}")
        assert downsample_type == "voxel" \
            or len(final) == downsample_target
    if normalise:
        final = normalise_pcl(final, pts, downsample_target, RANDOM_SEED)
    if len(final) < min_num_points:
        return None
    return final


def _process_one(submap_path: str, root: str, save_dir: str, **kw):
    ts = os.path.splitext(os.path.basename(submap_path))[0]
    pts = read_pcd(submap_path)
    final = postprocess_points(pts, **kw)
    if final is None:
        return ts  # rejected timestamp, reported to the caller
    out = os.path.join(save_dir, os.path.relpath(submap_path, root))
    os.makedirs(os.path.dirname(out), exist_ok=True)
    write_pcd(out, final)
    return None


def find_submaps(root: str, splits: List[str],
                 exclude_dirs: List[str]) -> List[str]:
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d not in exclude_dirs]
        rel = os.path.relpath(dirpath, root)
        if splits and not any(rel == s or rel.startswith(s + os.sep)
                              or rel == "." for s in splits):
            continue
        for fn in filenames:
            if fn.endswith(".pcd"):
                out.append(os.path.join(dirpath, fn))
    return sorted(out)


def save_info(root: str, save_dir: str):
    """Copy poses/info CSVs alongside the processed clouds
    (postprocess_submaps.py:27-38)."""
    import shutil
    for dirpath, _, filenames in os.walk(root):
        for fn in filenames:
            if fn.endswith(".csv") or fn.endswith(".txt"):
                src = os.path.join(dirpath, fn)
                dst = os.path.join(save_dir,
                                   os.path.relpath(src, root))
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                shutil.copy2(src, dst)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", required=True)
    ap.add_argument("--save_dir", default=None)
    ap.add_argument("--remove_ground", action="store_true")
    ap.add_argument("--min_num_points", type=int, default=4096)
    ap.add_argument("--downsample", action="store_true")
    ap.add_argument("--downsample_target", type=int, default=4096)
    ap.add_argument("--downsample_type", default="voxel",
                    choices=["pnvlad", "random", "voxel"])
    ap.add_argument("--voxel_size", type=float, default=0.8)
    ap.add_argument("--normalise", action="store_true")
    ap.add_argument("--radius_max", type=float, default=0.0,
                    help="Trim each cloud to this xy radius first "
                         "(wildplaces-ground mode); 0 disables")
    ap.add_argument("--num_workers", type=int, default=1)
    ap.add_argument("--splits", nargs="+", default=[])
    ap.add_argument("--exclude_dirs", nargs="+", default=[])
    args = ap.parse_args()
    assert os.path.exists(args.root), f"Cannot access: {args.root}"
    save_dir = args.save_dir or args.root + "_postprocessed"
    os.makedirs(save_dir, exist_ok=True)

    submaps = find_submaps(args.root, args.splits, args.exclude_dirs)
    print(f"{len(submaps)} submaps to process -> {save_dir}")
    worker = functools.partial(
        _process_one, root=args.root, save_dir=save_dir,
        remove_ground=args.remove_ground, downsample=args.downsample,
        downsample_type=args.downsample_type,
        downsample_target=args.downsample_target,
        voxel_size=args.voxel_size, normalise=args.normalise,
        min_num_points=args.min_num_points, radius_max=args.radius_max)
    rejected = [r for r in
                multiprocessing_func(worker, submaps, args.num_workers)
                if r is not None]
    save_info(args.root, save_dir)
    print(f"Done. {len(submaps) - len(rejected)} saved, "
          f"{len(rejected)} rejected (too few points)")
    if rejected:
        rej_file = os.path.join(save_dir, "rejected_timestamps.txt")
        with open(rej_file, "w") as f:
            f.write("\n".join(rejected) + "\n")
        print(f"Rejected timestamps -> {rej_file}")


if __name__ == "__main__":
    main()
