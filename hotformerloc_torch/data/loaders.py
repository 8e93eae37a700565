"""Point-cloud file loaders: PNV .bin and .pcd, dependency-free.

Own copy of hotformerloc_tpu/data/loaders.py, without the open3d
dependency: the PCD reader below parses ASCII and binary PCD headers
directly.
"""
from __future__ import annotations

import os
import struct
from typing import Optional

import numpy as np


class PointCloudLoader:
    """Base loader: read, drop zero points, optionally drop ground plane
    (base_datasets.py:139-173)."""
    remove_zero_points = True
    remove_ground_plane = True
    ground_plane_level: Optional[float] = None

    def __call__(self, file_pathname: str) -> np.ndarray:
        assert os.path.exists(file_pathname), \
            f"Cannot open point cloud: {file_pathname}"
        pc = self.read_pc(file_pathname)
        assert pc.shape[1] == 3
        if self.remove_zero_points:
            pc = pc[~np.all(np.isclose(pc, 0), axis=1)]
        if self.remove_ground_plane and self.ground_plane_level is not None:
            pc = pc[pc[:, 2] > self.ground_plane_level]
        return pc

    def read_pc(self, file_pathname: str) -> np.ndarray:
        raise NotImplementedError


class PNVPointCloudLoader(PointCloudLoader):
    """PointNetVLAD format: float64 binary, 4096 points already
    normalised to [-1, 1] (pnv_raw.py:7-23). Ground already removed."""
    remove_zero_points = False
    remove_ground_plane = False

    def read_pc(self, file_pathname: str) -> np.ndarray:
        pc = np.fromfile(file_pathname, dtype=np.float64)
        assert pc.size % 3 == 0, f"bad .bin size: {pc.size}"
        return pc.reshape(-1, 3).astype(np.float32)


def read_pcd(path: str) -> np.ndarray:
    """Minimal PCD v0.7 reader (ascii / binary), x,y,z fields."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if not line or line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key.upper()] = val
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"].split()
        sizes = [int(s) for s in header["SIZE"].split()]
        types = header["TYPE"].split()
        counts = [int(c) for c in header.get("COUNT",
                                             " ".join(["1"] * len(fields))
                                             ).split()]
        n = int(header["POINTS"])
        mode = header["DATA"]
        idx = {f: i for i, f in enumerate(fields)}
        assert all(k in idx for k in "xyz"), f"PCD missing xyz: {fields}"
        if mode == "ascii":
            data = np.loadtxt(f, dtype=np.float64, max_rows=n)
            data = np.atleast_2d(data)
            cols = []
            col_of = []
            c0 = 0
            for fval, cnt in zip(fields, counts):
                col_of.append(c0)
                c0 += cnt
            return np.stack([data[:, col_of[idx[k]]] for k in "xyz"],
                            axis=1).astype(np.float32)
        elif mode == "binary":
            np_types = {("F", 4): "f4", ("F", 8): "f8", ("I", 4): "i4",
                        ("I", 2): "i2", ("I", 1): "i1", ("U", 4): "u4",
                        ("U", 2): "u2", ("U", 1): "u1"}
            dt = []
            for fval, s, t, cnt in zip(fields, sizes, types, counts):
                base = np_types[(t, s)]
                dt.append((fval, base, (cnt,)) if cnt > 1 else (fval, base))
            arr = np.frombuffer(f.read(), dtype=np.dtype(dt), count=n)
            return np.stack([arr[k].astype(np.float32) for k in "xyz"],
                            axis=1)
        raise NotImplementedError(f"PCD DATA mode {mode}")


def write_pcd(path: str, points: np.ndarray):
    """Minimal binary PCD v0.7 writer (x,y,z float32), round-trips with
    `read_pcd`. Used by the offline preprocessing tools in place of
    open3d's writer."""
    pts = np.ascontiguousarray(np.asarray(points, dtype=np.float32))
    assert pts.ndim == 2 and pts.shape[1] == 3
    n = len(pts)
    header = ("# .PCD v0.7 - Point Cloud Data file format\n"
              "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
              f"COUNT 1 1 1\nWIDTH {n}\nHEIGHT 1\n"
              "VIEWPOINT 0 0 0 1 0 0 0\n"
              f"POINTS {n}\nDATA binary\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(pts.tobytes())


class CSWildPlacesPointCloudLoader(PointCloudLoader):
    """Wild-Places / CS-Wild-Places .pcd submaps
    (CSWildPlaces_raw.py:8-24). Preprocessing (ground removal etc.) is
    done offline, so no filtering here."""
    remove_zero_points = False
    remove_ground_plane = False

    def read_pc(self, file_pathname: str) -> np.ndarray:
        return read_pcd(file_pathname)


def get_pointcloud_loader(dataset_name: str) -> PointCloudLoader:
    """Loader factory (dataset_utils.py:27-31)."""
    if dataset_name and ("CSWildPlaces" in dataset_name
                         or "WildPlaces" in dataset_name):
        return CSWildPlacesPointCloudLoader()
    return PNVPointCloudLoader()
