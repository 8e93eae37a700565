"""Split-level PNV evaluation: per-(db-run, query-run) stats keyed by
split name, plus per-location and global averages.

Counterpart of hotformerloc_tpu/evaluation/evaluate_splits.py: the
same retrieval protocol as `evaluate.py` but reporting each split
separately, so CS-Wild-Places Baseline (Karawatha/Venman) vs Unseen
(QCAT/Samford) and CSCampus3D's aerial-only database (run idx 1) can
be read off directly.

CLI (on the card unless --device cpu):
  python -m hotformerloc_torch.evaluation.evaluate_splits \
      --config C --model_config M --weights ckpt [--log] [--device cpu]
"""
from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np

from hotformerloc_torch.evaluation.evaluate import (NUM_NEIGHBORS,
                                                  get_latent_vectors,
                                                  get_query_database_splits,
                                                  get_recall)


def evaluate_dataset_splits(embed_fn, params, database_sets, query_sets,
                            debug: bool = False, log: bool = False,
                            model_name: str = "model",
                            device="cuda") -> Dict:
    """Per-split stats for one location."""
    database_embeddings = [get_latent_vectors(embed_fn, s, params, debug)
                           for s in database_sets]
    query_embeddings = [get_latent_vectors(embed_fn, s, params, debug)
                        for s in query_sets]
    recall = np.zeros(NUM_NEIGHBORS)
    stats: Dict = {}
    count = 0
    oprs, mrrs = [], []
    for i in range(len(database_sets)):
        for j in range(len(query_sets)):
            if i == j and params.skip_same_run:
                continue
            if "CSCampus3D" in (params.dataset_name or ""):
                # aerial-only database rule
                if i != 1:
                    continue
                split_name = os.path.split(os.path.split(
                    database_sets[i][0]["query"])[0])[0] + f"_idx{i}"
            else:
                if len(query_sets[j]) == 0:
                    continue
                split_name = os.path.split(os.path.split(
                    query_sets[j][0]["query"])[0])[0]
            r, opr, mrr = get_recall(i, j, database_embeddings,
                                     query_embeddings, query_sets,
                                     database_sets, log=log,
                                     model_name=model_name, device=device)
            recall += r
            count += 1
            oprs.append(opr)
            mrrs.append(mrr)
            stats[split_name] = {"ave_one_percent_recall": opr,
                                 "ave_recall": r, "ave_mrr": mrr}
    if count > 1:
        stats["average"] = {
            "ave_one_percent_recall": float(np.mean(oprs)),
            "ave_recall": recall / count,
            "ave_mrr": float(np.mean(mrrs)),
        }
    return stats


def evaluate_splits(embed_fn, params, debug: bool = False,
                    log: bool = False, model_name: str = "model",
                    device="cuda") -> Dict:
    """All locations, split-level."""
    db_files, q_files = get_query_database_splits(params.dataset_name)
    stats: Dict = {}
    oprs, recalls, mrrs = [], [], []
    for dbf, qf in zip(db_files, q_files):
        if "CSWildPlaces" in (params.dataset_name or ""):
            loc, qloc = dbf.split("_")[1], qf.split("_")[1]
        else:
            loc, qloc = dbf.split("_")[0], qf.split("_")[0]
        assert loc == qloc, f"Database {dbf} does not match query {qf}"
        with open(os.path.join(params.dataset_folder, dbf), "rb") as f:
            database_sets = pickle.load(f)
        with open(os.path.join(params.dataset_folder, qf), "rb") as f:
            query_sets = pickle.load(f)
        s = evaluate_dataset_splits(embed_fn, params, database_sets,
                                    query_sets, debug, log, model_name,
                                    device)
        stats[loc] = s
        key = "average" if "average" in s else next(iter(s))
        oprs.append(s[key]["ave_one_percent_recall"])
        recalls.append(s[key]["ave_recall"])
        mrrs.append(s[key]["ave_mrr"])
    stats["average"] = {"average": {
        "ave_one_percent_recall": float(np.mean(oprs)),
        "ave_recall": np.mean(recalls, axis=0),
        "ave_mrr": float(np.mean(mrrs)),
    }}
    return stats


def print_split_stats(stats: Dict):
    for loc, splits in stats.items():
        print(f"Location: {loc}")
        for split, s in splits.items():
            print(f"  {split}: AR@1 {s['ave_recall'][0]:.2f}  "
                  f"AR@1% {s['ave_one_percent_recall']:.2f}  "
                  f"MRR {s['ave_mrr']:.2f}")


def main(argv=None):
    import argparse

    from hotformerloc_torch.config.params import parse_train_config
    from hotformerloc_torch.evaluation.pnv_evaluate import \
        load_model_embed_fn

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--model_config", required=True)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--log", action="store_true",
                    help="Log false positives / top-5 to txt")
    ap.add_argument("--debug", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    params = parse_train_config(args.config, args.model_config,
                                debug=args.debug)
    embed_fn, model_name = load_model_embed_fn(params, args.weights,
                                               args.device)
    stats = evaluate_splits(embed_fn, params, debug=args.debug,
                            log=args.log, model_name=model_name,
                            device=args.device)
    print_split_stats(stats)
    return stats


if __name__ == "__main__":
    main()
