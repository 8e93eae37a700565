"""PointNetVLAD (Oxford RobotCar + in-house) tuple generation.

Counterpart of hotformerloc_tpu/tools/pnv_tuples.py; both re-implement
the reference's datasets/pointnetvlad/
generate_training_tuples_baseline.py, _refine.py and
generate_test_sets.py: KDTree radius queries over (northing, easting)
centroids, 150 m test exclusion squares, pos 10 m (baseline) /
12.5 m (refined), non-neg 50 m, eval 25 m.

CLI:
  python -m hotformerloc_torch.tools.pnv_tuples train --dataset_root R
      [--refined]
  python -m hotformerloc_torch.tools.pnv_tuples test-sets --dataset_root R
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from hotformerloc_torch.data.tuples import TrainingTuple
from hotformerloc_torch.tools.geometry import radius_query

# Test-region centre points (generate_test_sets.py:11-31). These are
# published dataset constants, not code.
X_WIDTH = 150
Y_WIDTH = 150
P1 = [5735712.768124, 620084.402381]
P2 = [5735611.299219, 620540.270327]
P3 = [5735237.358209, 620543.094379]
P4 = [5734749.303802, 619932.693364]
P5 = [363621.292362, 142864.19756]
P6 = [364788.795462, 143125.746609]
P7 = [363597.507711, 144011.414174]
P8 = [360895.486453, 144999.915143]
P9 = [362357.024536, 144894.825301]
P10 = [361368.907155, 145209.663042]
P_DICT = {"oxford": [P1, P2, P3, P4], "university": [P5, P6, P7],
          "residential": [P8, P9, P10], "business": []}

RUNS_FOLDER = "oxford/"
FILENAME = "pointcloud_locations_20m_10overlap.csv"
POINTCLOUD_FOLS = "/pointcloud_20m_10overlap/"


def check_in_test_set(northing: float, easting: float, points) -> bool:
    for p in points:
        if (p[0] - X_WIDTH < northing < p[0] + X_WIDTH
                and p[1] - Y_WIDTH < easting < p[1] + Y_WIDTH):
            return True
    return False


def _read_locations(csv_path: str):
    """Rows of (timestamp, northing, easting) from a locations CSV."""
    import csv
    rows = []
    with open(csv_path) as f:
        r = csv.DictReader(f)
        for row in r:
            rows.append((row["timestamp"], float(row["northing"]),
                         float(row["easting"])))
    return rows


def construct_query_dict(entries, base_path: str, filename: str,
                         ind_nn_r: float, ind_r_r: float = 50.0):
    """entries: list of (rel_file, northing, easting).
    Mirrors generate_training_tuples_baseline.py:24-58."""
    coords = np.array([[n, e] for _, n, e in entries], dtype=np.float64)
    ind_nn = radius_query(coords, coords, ind_nn_r)
    ind_r = radius_query(coords, coords, ind_r_r)
    queries = {}
    for anchor_ndx, (rel_file, northing, easting) in enumerate(entries):
        scan_filename = os.path.split(rel_file)[1]
        assert os.path.splitext(scan_filename)[1] == ".bin", \
            f"Expected .bin file: {scan_filename}"
        timestamp = int(os.path.splitext(scan_filename)[0])
        positives = ind_nn[anchor_ndx]
        positives = np.sort(positives[positives != anchor_ndx])
        non_negatives = np.sort(ind_r[anchor_ndx])
        queries[anchor_ndx] = TrainingTuple(
            id=anchor_ndx, timestamp=timestamp, rel_scan_filepath=rel_file,
            positives=positives, non_negatives=non_negatives,
            position=np.array([northing, easting]))
    with open(os.path.join(base_path, filename), "wb") as f:
        pickle.dump(queries, f, protocol=pickle.HIGHEST_PROTOCOL)
    print("Done", filename, f"({len(queries)} queries)")


def generate_training_tuples(base_path: str, refined: bool = False):
    all_folders = sorted(os.listdir(os.path.join(base_path, RUNS_FOLDER)))
    folders = [all_folders[i] for i in range(len(all_folders) - 1)]
    print(f"Number of runs: {len(folders)}")
    train, test = [], []
    for folder in folders:
        csv_path = os.path.join(base_path, RUNS_FOLDER, folder, FILENAME)
        for ts, northing, easting in _read_locations(csv_path):
            rel = RUNS_FOLDER + folder + POINTCLOUD_FOLS + ts + ".bin"
            if check_in_test_set(northing, easting, P_DICT["oxford"]):
                test.append((rel, northing, easting))
            else:
                train.append((rel, northing, easting))
    print(f"Training submaps: {len(train)}  test submaps: {len(test)}")
    # baseline: pos 10 m; refined: pos 12.5 m (original PNV params)
    r = 12.5 if refined else 10.0
    suffix = "refine2" if refined else "baseline2"
    construct_query_dict(train, base_path,
                         f"training_queries_{suffix}.pickle", ind_nn_r=r)
    construct_query_dict(test, base_path,
                         f"test_queries_{suffix}.pickle", ind_nn_r=r)


def construct_query_and_database_sets(base_path, runs_folder, folders,
                                      pointcloud_fols, filename, p,
                                      output_name,
                                      eval_thresh: float = 25.0):
    """Per-run database dicts + cross-run ground-truth query dicts
    (generate_test_sets.py:50-108)."""
    database_sets, test_sets = [], []
    for folder in folders:
        database, test = {}, {}
        csv_path = os.path.join(base_path, runs_folder, folder, filename)
        for ts, northing, easting in _read_locations(csv_path):
            rel = runs_folder + folder + pointcloud_fols + ts + ".bin"
            rec = {"query": rel, "northing": northing, "easting": easting}
            if output_name == "business" or \
                    check_in_test_set(northing, easting, p):
                test[len(test)] = dict(rec)
            database[len(database)] = dict(rec)
        database_sets.append(database)
        test_sets.append(test)

    for i, database in enumerate(database_sets):
        coords = np.array([[v["northing"], v["easting"]]
                           for v in database.values()])
        for j, test in enumerate(test_sets):
            if i == j:
                continue
            q = np.array([[test[k]["northing"], test[k]["easting"]]
                          for k in range(len(test))]).reshape(-1, 2)
            if len(q) == 0:
                continue
            hits = radius_query(coords, q, eval_thresh)
            for k in range(len(test)):
                test[k][i] = hits[k].tolist()

    for tag, obj in [("database", database_sets), ("query", test_sets)]:
        out = os.path.join(base_path,
                           f"{output_name}_evaluation_{tag}.pickle")
        with open(out, "wb") as f:
            pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)
        print("Done", out)


def generate_test_sets(base_path: str):
    """The four PNV evaluation regions (generate_test_sets.py:112-166)."""
    all_ox = sorted(os.listdir(os.path.join(base_path, "oxford/")))
    ox_idx = [5, 6, 7, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 22, 24,
              31, 32, 33, 38, 39, 43, 44]
    construct_query_and_database_sets(
        base_path, "oxford/", [all_ox[i] for i in ox_idx],
        "/pointcloud_20m/", "pointcloud_locations_20m.csv",
        P_DICT["oxford"], "oxford")
    all_ih = sorted(os.listdir(os.path.join(base_path,
                                            "inhouse_datasets/")))
    for name, rng in [("university", range(10, 15)),
                      ("residential", range(5, 10)),
                      ("business", range(5))]:
        construct_query_and_database_sets(
            base_path, "inhouse_datasets/", [all_ih[i] for i in rng],
            "/pointcloud_25m_25/", "pointcloud_centroids_25.csv",
            P_DICT[name], name)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("train")
    t.add_argument("--dataset_root", required=True)
    t.add_argument("--refined", action="store_true")
    s = sub.add_parser("test-sets")
    s.add_argument("--dataset_root", required=True)
    args = ap.parse_args()
    assert os.path.exists(args.dataset_root), \
        f"Cannot access dataset root folder: {args.dataset_root}"
    if args.cmd == "train":
        generate_training_tuples(args.dataset_root, args.refined)
    else:
        generate_test_sets(args.dataset_root)


if __name__ == "__main__":
    main()
