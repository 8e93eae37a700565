"""Visualise the octree window partition (OctFormer-style).

Counterpart of hotformerloc_tpu/tools/visualise_windows.py, on this
package's octree (``octree/build.py``): build the octree from a cloud,
take the z-order
node coords per depth, assign each node its attention-window id
(contiguous blocks of `patch_size` slots, with the dilation transpose),
and scatter-plot the rescaled node centres coloured by window — one
subplot per depth, 4 depths max.

Usage:
  python -m hotformerloc_torch.tools.visualise_windows \
      --clouds_path DIR --max_depth 7 [--min_depth 4] [--patch_size 32]
      [--dilation 1] [--normalize] [--out_dir figs/]
"""
from __future__ import annotations

import argparse
import os
from glob import glob

import numpy as np

from hotformerloc_torch.data.augmentation import Normalize
from hotformerloc_torch.data.loaders import (CSWildPlacesPointCloudLoader,
                                             PNVPointCloudLoader)

SKIP_INCREMENT = 20


def load_cloud(path: str) -> np.ndarray:
    ext = os.path.splitext(path)[-1]
    if ext == ".bin":
        return PNVPointCloudLoader().read_pc(path)
    if ext == ".pcd":
        return CSWildPlacesPointCloudLoader().read_pc(path)
    raise ValueError("Invalid point cloud type, must be .bin or .pcd")


def window_ids(num_slots: int, patch_size: int, dilation: int) -> np.ndarray:
    """Window id per z-order node slot, including the dilation transpose
    (ops/window.py data_to_windows)."""
    ids = np.arange(num_slots) // patch_size          # (N,) window per slot
    ids = ids.reshape(-1, patch_size)                  # (W, K)
    if dilation > 1:
        ids = ids.reshape(-1, dilation, patch_size)
        ids = np.swapaxes(ids, 1, 2)                   # undo window gather
    return ids.reshape(-1)


def octree_window_points(points: np.ndarray, max_depth: int,
                         min_depth: int, patch_size: int, dilation: int):
    """Per depth: (rescaled node centres (N,3), window id (N,)) for the
    valid nodes, windows assigned over the padded z-order slots."""
    import torch

    from hotformerloc_torch.octree import morton
    from hotformerloc_torch.octree.build import build_batched_octree

    pts = torch.as_tensor(points[None, :, :3], dtype=torch.float32)
    pmask = torch.ones((1, points.shape[0]), dtype=torch.bool)
    octree = build_batched_octree(pts, pmask, max_depth, min(min_depth, 2))
    out = {}
    for d in range(max_depth, min_depth - 1, -1):
        valid = octree.node_valid(d)[0].numpy()
        xyz = octree.xyz(d)[0]
        centres = morton.grid_to_points(xyz.to(torch.float32) + 0.5,
                                        d).numpy()
        wids = window_ids(len(valid), patch_size, dilation)
        out[d] = (centres[valid], wids[valid])
    return out


def plot_cloud(path: str, depth_data, cmap: str, out_path=None):
    import matplotlib
    if out_path:
        matplotlib.use("Agg")
    import matplotlib.colors as mcolors
    import matplotlib.pyplot as plt
    ncolors = 20 if cmap == "tab20" else 10
    fig = plt.figure(figsize=(11, 9))
    fig.suptitle(os.path.basename(path))
    for i, (depth, (pts, wids)) in enumerate(sorted(depth_data.items(),
                                                    reverse=True)):
        if i >= 4:
            print("[WARNING]: plot limited to 4 depths; skipping deeper")
            break
        colours = [mcolors.to_hex(plt.get_cmap(cmap)(w % ncolors))
                   for w in wids]
        ax = fig.add_subplot(2, 2, i + 1, projection="3d")
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=colours, s=2)
        ax.set_xlabel("x"), ax.set_ylabel("y"), ax.set_zlabel("z")
        ax.set_aspect("equal", adjustable="box")
        ax.set_title(f"depth {depth} - {int(wids.max()) + 1} windows")
    plt.tight_layout()
    if out_path:
        plt.savefig(out_path, dpi=120)
        plt.close(fig)
        print(f"saved {out_path}")
    else:
        plt.show()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clouds_path", required=True)
    ap.add_argument("--normalize", action="store_true")
    ap.add_argument("--scale_factor", type=float, default=None)
    ap.add_argument("--unit_sphere_norm", action="store_true")
    ap.add_argument("--max_depth", type=int, required=True)
    ap.add_argument("--min_depth", type=int, default=2)
    ap.add_argument("--patch_size", type=int, default=32)
    ap.add_argument("--dilation", type=int, default=1)
    ap.add_argument("--cmap", choices=["tab10", "tab20"], default="tab20")
    ap.add_argument("--out_dir", default=None,
                    help="save PNGs here instead of showing windows")
    args = ap.parse_args(argv)
    assert os.path.isdir(args.clouds_path), "Invalid directory"
    assert 2 <= args.min_depth <= args.max_depth

    clouds = sorted(glob(f"{args.clouds_path}/*.pcd")
                    + glob(f"{args.clouds_path}/*.bin"))[::SKIP_INCREMENT]
    assert clouds, "No valid point cloud files found"
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)

    for path in clouds:
        pc = load_cloud(path).astype(np.float32)
        if args.normalize or args.scale_factor is not None:
            pc = Normalize(scale_factor=args.scale_factor,
                           unit_sphere_norm=args.unit_sphere_norm)(pc, None)
        pc = pc[np.all(np.abs(pc) <= 1.0, axis=1)]
        depth_data = octree_window_points(pc, args.max_depth,
                                          args.min_depth, args.patch_size,
                                          args.dilation)
        out = os.path.join(
            args.out_dir,
            os.path.splitext(os.path.basename(path))[0] + "_windows.png") \
            if args.out_dir else None
        plot_cloud(path, depth_data, args.cmap, out)


if __name__ == "__main__":
    main()
