"""t-SNE visualisation of query/positive embedding groups.

Counterpart of hotformerloc_tpu/evaluation/visualise_embeddings.py, over
this package's ``make_embed_fn`` (through ``pnv_evaluate``'s
``load_model_embed_fn``): sample well-separated queries from the first
eval split, gather their database positives, embed everything, project
with t-SNE (cosine metric), and plot anchor stars + positive dots per
colour group. It embeds on the card unless ``--device cpu``.

CLI:
  python -m hotformerloc_torch.evaluation.visualise_embeddings \
      --config C --model_config M --weights ckpt [--num_queries 20]
      [--query_min_distance 50] [--out tsne.png] [--device cpu]
"""
from __future__ import annotations

import os
import pickle
import random
from typing import Dict, List

import numpy as np


def query_distance(query: Dict, query_list: List[Dict]) -> float:
    """Min world distance from `query` to already chosen queries."""
    if not query_list:
        return float("inf")
    q = np.array([query["northing"], query["easting"]])
    d = [np.linalg.norm(q - np.array([o["northing"], o["easting"]]))
         for o in query_list]
    return float(min(d))


def select_queries(query_sets, num_queries: int, min_distance: float,
                   rng: random.Random):
    """Sample spatially separated queries."""
    query_sets = [dict(s) for s in query_sets]
    chosen: List[Dict] = []
    for _ in range(num_queries):
        while query_sets:
            si = rng.randint(0, len(query_sets) - 1)
            if not query_sets[si]:
                query_sets.pop(si)
                continue
            key = rng.choice(list(query_sets[si].keys()))
            cand = query_sets[si].pop(key)
            if query_distance(cand, chosen) >= min_distance:
                chosen.append(cand)
                break
        if not query_sets:
            print(f"[WARNING] no more queries at this distance; "
                  f"continuing with {len(chosen)}")
            break
    return chosen


def gather_groups(query_list, database_sets):
    """[[anchor, positive...], ...] rel-paths per query."""
    samples = [[q["query"]] for q in query_list]
    for i, q in enumerate(query_list):
        for j, dset in enumerate(database_sets):
            if j in q:
                samples[i].extend(dset[p]["query"] for p in q[j])
    return samples


def embed_paths(embed_fn, paths: List[str], params):
    """Embed a flat list of rel-paths with the shared eval loader."""
    from hotformerloc_torch.evaluation.evaluate import get_latent_vectors
    data_set = {i: {"query": p} for i, p in enumerate(paths)}
    return get_latent_vectors(embed_fn, data_set, params)


def tsne_project(embeddings: np.ndarray, seed: int = 42) -> np.ndarray:
    from sklearn.manifold import TSNE
    perplexity = min(30.0, max(2.0, len(embeddings) / 4))
    tsne = TSNE(random_state=seed, max_iter=2000, metric="cosine",
                perplexity=perplexity)
    return tsne.fit_transform(embeddings)


def plot_groups(proj: np.ndarray, group_sizes: List[int], title: str,
                out_path: str):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.colors as cm
    import matplotlib.pyplot as plt
    colors = [cm.to_hex(plt.get_cmap("tab20")(i)) for i in range(20)]
    fig, ax = plt.subplots(1, 1)
    off = 0
    for idx, n in enumerate(group_sizes):
        g = proj[off:off + n]
        off += n
        c = colors[idx % 20]
        ax.scatter(g[1:, 0], g[1:, 1], s=35, c=c, alpha=0.3,
                   label="Positives" if idx == 0 else None)
        ax.scatter(g[0, 0], g[0, 1], s=70, c=c, marker="*",
                   edgecolors="black",
                   label="Anchor" if idx == 0 else None)
    ax.legend()
    ax.set_title(title)
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    print(f"Saved {out_path}")


def visualise_embeddings(embed_fn, params, num_queries: int = 20,
                         query_min_distance: float = 50.0,
                         out_path: str = "tsne.png", seed: int = 42):
    """Embed the groups with ``embed_fn`` and write the t-SNE figure to
    ``out_path``; returns the projection."""
    from hotformerloc_torch.evaluation.evaluate import \
        get_query_database_splits
    db_files, q_files = get_query_database_splits(params.dataset_name)
    with open(os.path.join(params.dataset_folder, db_files[0]),
              "rb") as f:
        database_sets = pickle.load(f)
    with open(os.path.join(params.dataset_folder, q_files[0]),
              "rb") as f:
        query_sets = pickle.load(f)
    rng = random.Random(seed)
    queries = select_queries(query_sets, num_queries,
                             query_min_distance, rng)
    groups = gather_groups(queries, database_sets)
    flat = [p for g in groups for p in g]
    emb = embed_paths(embed_fn, flat, params)
    proj = tsne_project(emb, seed)
    plot_groups(proj, [len(g) for g in groups],
                f"TSNE of {params.model_params.config.model} embeddings "
                f"on {params.dataset_name}", out_path)
    return proj


def main(argv=None):
    import argparse

    from hotformerloc_torch.config.params import parse_train_config
    from hotformerloc_torch.evaluation.pnv_evaluate import \
        load_model_embed_fn
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--model_config", required=True)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--num_queries", type=int, default=20)
    ap.add_argument("--query_min_distance", type=float, default=50.0)
    ap.add_argument("--out", default="tsne.png")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    params = parse_train_config(args.config, args.model_config)
    embed_fn, _ = load_model_embed_fn(params, args.weights, args.device)
    visualise_embeddings(embed_fn, params, args.num_queries,
                         args.query_min_distance, args.out)


if __name__ == "__main__":
    main()
