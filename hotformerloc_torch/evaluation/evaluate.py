"""PointNetVLAD-protocol evaluation: AR@N, AR@1%, MRR.

Counterpart of hotformerloc_tpu/evaluation/evaluate.py: retrieval is a
device matmul (query x database distances) + top-k (``retrieval_topk``),
on one card or with the database sharded over the ranks of a process
group (``group``). The protocol is the JAX package's: skip_same_run,
top-25 neighbours, AR@1% threshold = max(round(N_db/100), 1), MRR over
first-hit ranks, and the CSCampus3D aerial-only database rule.
"""
from __future__ import annotations

import os
import pickle
from typing import Callable, Dict

import numpy as np
import torch

from hotformerloc_torch.data.augmentation import (CylindricalCoordinates,
                                                  make_val_transform)
from hotformerloc_torch.data.loaders import get_pointcloud_loader
from hotformerloc_torch.data.pipeline import clip_to_unit_box, pack_clouds
from hotformerloc_torch.parallel import dist

NUM_NEIGHBORS = 25


def get_query_database_splits(dataset_name: str):
    """Eval split filenames per dataset."""
    if dataset_name == "Oxford":
        dbs = ["oxford_evaluation_database.pickle",
               "university_evaluation_database.pickle",
               "residential_evaluation_database.pickle",
               "business_evaluation_database.pickle"]
        qs = [f.replace("database", "query") for f in dbs]
    elif dataset_name == "MulRan":
        dbs = ["DCC_database.pickle", "Sejong_database.pickle"]
        qs = ["DCC_queries.pickle", "Sejong_queries.pickle"]
    elif "CSWildPlaces" in (dataset_name or ""):
        locs = ["Karawatha", "Venman", "QCAT", "Samford"]
        dbs = [f"CSWildPlaces_{l}_evaluation_database.pickle" for l in locs]
        qs = [f"CSWildPlaces_{l}_evaluation_query.pickle" for l in locs]
    elif "WildPlaces" in (dataset_name or ""):
        locs = ["Karawatha", "Venman"]
        dbs = [f"{l}_evaluation_database.pickle" for l in locs]
        qs = [f"{l}_evaluation_query.pickle" for l in locs]
    elif dataset_name == "CSCampus3D":
        dbs = ["umd_evaluation_database.pickle"]
        qs = ["umd_evaluation_query_v2.pickle"]
    else:
        raise NotImplementedError(
            f"Dataset {dataset_name} has no splits implemented")
    return dbs, qs


def _dist2(q: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    sim = q @ d.T
    qn = (q * q).sum(dim=1, keepdim=True)
    dn = (d * d).sum(dim=1)[None, :]
    return torch.clamp(qn + dn - 2.0 * sim, min=0.0)


def retrieval_topk(queries, database, k: int = NUM_NEIGHBORS,
                   device="cuda", group=None):
    """(Q, C) queries and (D, C) database embeddings -> (dist (Q, k),
    idx (Q, k)) numpy arrays, nearest first by L2 distance.

    Over ``group`` (every rank passes the same arrays) the database rows
    are sharded as in the JAX package's mesh version: rank r scores rows
    r·s .. (r+1)·s, s = ceil(D / n), padded rows at +inf distance, keeps
    its top min(k, s) with global indices, and the all-gathered
    candidates are merged into the top k on every rank. The result
    equals one card's up to distance ties."""
    q = torch.as_tensor(np.asarray(queries), dtype=torch.float32,
                        device=device)
    d = torch.as_tensor(np.asarray(database), dtype=torch.float32,
                        device=device)
    D = d.shape[0]
    k = min(k, D)
    with torch.inference_mode():
        if group is None:
            neg, idx = torch.topk(-_dist2(q, d), k, dim=1)
        else:
            n, r = dist.world(group), dist.rank(group)
            shard = -(-D // n)
            lo = r * shard
            part = _dist2(q, d[lo:lo + shard])
            pad = shard - part.shape[1]
            if pad:
                part = torch.cat([part, part.new_full((q.shape[0], pad),
                                                      float("inf"))], 1)
            neg, idx = torch.topk(-part, min(k, shard), dim=1)
            # (n·Q, kl) rank-major -> (Q, n·kl), then the merged top k
            negs = dist.all_gather_rows(neg, group)
            gidx = dist.all_gather_rows(idx + lo, group)
            Q = q.shape[0]
            negs = negs.view(n, Q, -1).transpose(0, 1).reshape(Q, -1)
            gidx = gidx.view(n, Q, -1).transpose(0, 1).reshape(Q, -1)
            neg, pos = torch.topk(negs, k, dim=1)
            idx = torch.gather(gidx, 1, pos)
        dist_k = torch.sqrt(torch.clamp(-neg, min=0.0))
    return dist_k.cpu().numpy(), idx.cpu().numpy()


def get_latent_vectors(embed_fn: Callable, data_set: Dict, params,
                       debug: bool = False) -> np.ndarray:
    """Embeddings (N, D) fp32 of one run set, in key order.

    embed_fn: (points (B, P, 3), pmask (B, P)) CPU tensors -> (B, D)
    tensor or array. Clouds go in chunks of at most
    ``params.val_batch_size``; the last chunk is not padded (the JAX
    package pads it to keep one static shape for XLA)."""
    output_dim = params.model_params.config.output_dim
    if debug:
        return np.random.rand(len(data_set), output_dim).astype(np.float32)
    pc_loader = get_pointcloud_loader(params.dataset_name)
    transform = make_val_transform(params.normalize_points,
                                   params.scale_factor,
                                   params.unit_sphere_norm, params.zero_mean)
    cyl = params.model_params.coordinates == "cylindrical"
    coord = CylindricalCoordinates() if cyl else None
    P = params.model_params.config.num_points
    bs = params.val_batch_size

    embeddings = np.zeros((len(data_set), output_dim), dtype=np.float32)
    clouds = []
    keys = sorted(data_set.keys()) if isinstance(data_set, dict) \
        else range(len(data_set))
    start = 0
    for i, ndx in enumerate(keys):
        path = os.path.join(params.dataset_folder, data_set[ndx]["query"])
        pc = pc_loader(path).astype(np.float32)
        pc = transform(pc, None)
        pc = clip_to_unit_box(pc, cyl)
        if coord is not None:
            pc = coord(pc)
        clouds.append(pc)
        if len(clouds) >= bs or i == len(keys) - 1:
            pts, msk = pack_clouds(clouds, P)
            emb = embed_fn(torch.from_numpy(pts), torch.from_numpy(msk))
            if torch.is_tensor(emb):
                emb = emb.detach().float().cpu().numpy()
            embeddings[start:start + len(clouds)] = emb
            start += len(clouds)
            clouds = []
    return embeddings


def _log_forensics(model_name: str, query_details: Dict, db_set: Dict,
                   dist_row: np.ndarray, idx_row: np.ndarray,
                   true_neighbors) -> None:
    """Retrieval forensics: append the top-1 false positive (with the
    first true positive for contrast) and the top-5 matches to per-model
    txt logs in the working directory."""

    def world_dist(a, b):
        return float(np.hypot(a["northing"] - b["northing"],
                              a["easting"] - b["easting"]))

    tn = set(true_neighbors)
    if idx_row[0] not in tn:
        fp = db_set[int(idx_row[0])]
        tp, tp_emb = None, 0.0
        for k in range(len(idx_row)):
            if idx_row[k] in tn:
                tp, tp_emb = db_set[int(idx_row[k])], float(dist_row[k])
                break
        with open(f"{model_name}_log_fp.txt", "a") as f:
            s = (f"{query_details['query']}, {fp['query']}, "
                 f"{dist_row[0]:0.2f}, "
                 f"{world_dist(query_details, fp):0.2f}")
            s += ", 0, 0, 0\n" if tp is None else (
                f", {tp['query']}, {tp_emb:0.2f}, "
                f"{world_dist(query_details, tp):0.2f}\n")
            f.write(s)
    s = (f"{query_details['query']}, {query_details['northing']}, "
         f"{query_details['easting']}")
    for k in range(min(len(idx_row), 5)):
        e = db_set[int(idx_row[k])]
        s += (f", {e['query']}, {dist_row[k]:0.2f}, , "
              f"{world_dist(query_details, e):0.2f}, "
              f"{1 if idx_row[k] in tn else 0}, ")
    with open(f"{model_name}_log_search_results.txt", "a") as f:
        f.write(s + "\n")


def get_recall(m: int, n: int, database_vectors, query_vectors, query_sets,
               database_sets, log: bool = False,
               model_name: str = "model", device="cuda", group=None):
    """AR@N / AR@1% / MRR for one (database run m, query run n) pair.
    log=True appends false-positive and top-5 forensics to
    <model_name>_log_*.txt. Retrieval runs on ``device``, sharded over
    ``group`` when given."""
    db = database_vectors[m]
    qv = query_vectors[n]
    threshold = max(int(round(len(db) / 100.0)), 1)
    dists, indices = retrieval_topk(qv, db, NUM_NEIGHBORS, device=device,
                                    group=group)

    recall = np.zeros(NUM_NEIGHBORS)
    recall_idx = []
    one_percent_retrieved = 0
    num_evaluated = 0
    for i in range(len(qv)):
        true_neighbors = query_sets[n][i].get(m, [])
        if len(true_neighbors) == 0:
            continue
        num_evaluated += 1
        tn = set(true_neighbors)
        if log:
            _log_forensics(model_name, query_sets[n][i],
                           database_sets[m], dists[i], indices[i],
                           true_neighbors)
        for j in range(min(NUM_NEIGHBORS, indices.shape[1])):
            if indices[i, j] in tn:
                recall[j] += 1
                recall_idx.append(j + 1)
                break
        if tn.intersection(indices[i, :threshold].tolist()):
            one_percent_retrieved += 1
    if num_evaluated == 0:
        return np.zeros(NUM_NEIGHBORS), 0.0, 0.0
    one_percent_recall = one_percent_retrieved / num_evaluated * 100
    recall = np.cumsum(recall) / num_evaluated * 100
    mrr = float(np.mean(1.0 / np.asarray(recall_idx)) * 100) \
        if recall_idx else 0.0
    return recall, one_percent_recall, mrr


def evaluate_dataset(embed_fn, params, database_sets, query_sets,
                     debug: bool = False, log: bool = False,
                     model_name: str = "model", device="cuda",
                     group=None) -> Dict:
    """One location: embed all runs, score all (db-run, query-run)
    pairs (retrieval sharded over ``group`` when given)."""
    database_embeddings = [get_latent_vectors(embed_fn, s, params, debug)
                           for s in database_sets]
    query_embeddings = [get_latent_vectors(embed_fn, s, params, debug)
                        for s in query_sets]
    recall = np.zeros(NUM_NEIGHBORS)
    count = 0
    oprs, mrrs = [], []
    for i in range(len(database_sets)):
        for j in range(len(query_sets)):
            if i == j and params.skip_same_run:
                continue
            if "CSCampus3D" in (params.dataset_name or "") and i != 1:
                continue            # aerial-only database rule
            r, opr, mrr = get_recall(i, j, database_embeddings,
                                     query_embeddings, query_sets,
                                     database_sets, log=log,
                                     model_name=model_name, device=device,
                                     group=group)
            recall += r
            count += 1
            oprs.append(opr)
            mrrs.append(mrr)
    count = max(count, 1)
    return {"ave_one_percent_recall": float(np.mean(oprs)) if oprs else 0.0,
            "ave_recall": recall / count,
            "ave_mrr": float(np.mean(mrrs)) if mrrs else 0.0}


def evaluate(embed_fn, params, debug: bool = False, log: bool = False,
             model_name: str = "model", device="cuda", group=None) -> Dict:
    """All locations of the configured dataset, and their average. Over
    ``group`` every rank embeds every cloud and the retrieval is sharded
    over the ranks; every rank returns the same stats."""
    db_files, q_files = get_query_database_splits(params.dataset_name)
    stats = {}
    aggr = {"opr": [], "recall": [], "mrr": []}
    for dbf, qf in zip(db_files, q_files):
        loc = dbf.split("_")[1] if "CSWildPlaces" in params.dataset_name \
            else dbf.split("_")[0]
        with open(os.path.join(params.dataset_folder, dbf), "rb") as f:
            database_sets = pickle.load(f)
        with open(os.path.join(params.dataset_folder, qf), "rb") as f:
            query_sets = pickle.load(f)
        s = evaluate_dataset(embed_fn, params, database_sets, query_sets,
                             debug, log=log, model_name=model_name,
                             device=device, group=group)
        stats[loc] = s
        aggr["opr"].append(s["ave_one_percent_recall"])
        aggr["recall"].append(s["ave_recall"])
        aggr["mrr"].append(s["ave_mrr"])
    stats["average"] = {
        "ave_one_percent_recall": float(np.mean(aggr["opr"])),
        "ave_recall": np.mean(aggr["recall"], axis=0),
        "ave_mrr": float(np.mean(aggr["mrr"])),
    }
    return stats


def print_eval_stats(stats: Dict):
    for name, s in stats.items():
        print(f"Dataset: {name}")
        print(f"Avg. top 1% recall: {s['ave_one_percent_recall']:.2f}   "
              f"Avg. MRR: {s['ave_mrr']:.2f}   Avg. recall @N:")
        print(s["ave_recall"])


def write_eval_stats(file_name: str, prefix: str, stats: Dict):
    """Append one result line per split."""
    with open(file_name, "a") as f:
        s = prefix
        for ds in stats:
            s += f", {stats[ds]['ave_one_percent_recall']:.2f}" \
                 f", {stats[ds]['ave_recall'][0]:.2f}" \
                 f", {stats[ds]['ave_mrr']:.2f}"
        f.write(s + "\n")
