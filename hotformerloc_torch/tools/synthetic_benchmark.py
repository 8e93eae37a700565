"""Self-contained synthetic place-recognition benchmark generator.

This package's own copy of hotformerloc_tpu/tools/synthetic_benchmark.py
(numpy only): with the same arguments it writes the same clouds, byte
for byte, and the same tuples, evaluation pickles and INI files, but its
train pickle holds this package's ``data.tuples.TrainingTuple``.

It fabricates a complete miniature benchmark with the on-disk layout of
the PointNetVLAD/Oxford protocol (train pickle of ``TrainingTuple``s + 4
locations x {database,query} evaluation pickles) from procedurally
generated "places". Training on it must converge to near-100% AR@1,
which exercises the trainer -> eval-hook -> best-checkpoint path end to
end (tools/convergence_run.py).

Each place is a distinctive random arrangement of geometric primitives
(ground plane + boxes + spheres); every variant of a place is an
independent resampling under a small random rigid motion + jitter, so
retrieval requires invariance, not memorising point coordinates.

Usage:
    python -m hotformerloc_torch.tools.synthetic_benchmark --out DIR \
        [--places-per-loc 8] [--num-points 1024] [--seed 0]

Writes: clouds/*.bin (PNV float64 format), train_tuples.pickle,
{oxford,university,residential,business}_evaluation_{database,query}.pickle,
train.txt + model.txt INI configs ready for training.train.
"""
from __future__ import annotations

import argparse
import os
import pickle
from typing import Dict, List, Tuple

import numpy as np

from hotformerloc_torch.data.tuples import TrainingTuple

LOCATIONS = ("oxford", "university", "residential", "business")
TRAIN_VARIANTS = 2          # variants per place in the train split
EVAL_RUNS = 2               # db/query runs per location (disjoint variants)


def _sample_place(rng: np.random.Generator, n: int) -> np.ndarray:
    """A distinctive scene: ground plane + 4-8 boxes/spheres whose
    layout is the place's identity."""
    k = int(rng.integers(4, 9))
    parts: List[np.ndarray] = []
    n_ground = n // 3
    parts.append(np.stack([rng.uniform(-1, 1, n_ground),
                           rng.uniform(-1, 1, n_ground),
                           rng.normal(-0.75, 0.01, n_ground)], 1))
    remaining = n - n_ground
    per = remaining // k
    for i in range(k):
        m = per if i < k - 1 else remaining - per * (k - 1)
        c = rng.uniform(-0.7, 0.7, 3) * np.array([1, 1, 0.3])
        if rng.random() < 0.5:                       # box shell
            ext = rng.uniform(0.05, 0.25, 3)
            face = rng.integers(0, 3, m)
            p = rng.uniform(-1, 1, (m, 3)) * ext
            sign = rng.choice([-1.0, 1.0], m)
            p[np.arange(m), face] = ext[face] * sign
        else:                                        # sphere shell
            r = rng.uniform(0.05, 0.2)
            v = rng.normal(size=(m, 3))
            p = v / np.linalg.norm(v, axis=1, keepdims=True) * r
        parts.append(c + p)
    return np.concatenate(parts, 0)


def _variant(base_fn, rng: np.random.Generator, n: int) -> np.ndarray:
    """Independent resample of the place under a small rigid motion."""
    pc = base_fn(n)
    ang = rng.uniform(-np.pi / 12, np.pi / 12)
    c, s = np.cos(ang), np.sin(ang)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    pc = pc @ R.T + rng.uniform(-0.05, 0.05, 3)
    pc += rng.normal(0, 0.005, pc.shape)
    return np.clip(pc, -0.999, 0.999)


def _place_factory(place_seed: int):
    """Resampling closure: same layout (seeded), fresh surface points."""
    def sample(n: int, salt: int = 0) -> np.ndarray:
        layout_rng = np.random.default_rng(place_seed)
        # layout identity comes from place_seed; point noise from salt
        pts = _sample_place(layout_rng, n)
        noise_rng = np.random.default_rng((place_seed, salt))
        return pts + noise_rng.normal(0, 0.002, pts.shape)
    return sample


def generate(out: str, places_per_loc: int = 8, num_points: int = 1024,
             seed: int = 0,
             train_variants: int = TRAIN_VARIANTS) -> Dict[str, object]:
    os.makedirs(os.path.join(out, "clouds"), exist_ok=True)
    rng = np.random.default_rng(seed)
    n_places = places_per_loc * len(LOCATIONS)

    def write_cloud(place: int, variant: int) -> str:
        fac = _place_factory(seed * 10_000 + place)
        vr = np.random.default_rng((seed, place, variant))
        pc = _variant(lambda n: fac(n, salt=variant), vr, num_points)
        rel = f"clouds/p{place:03d}_v{variant}.bin"
        pc.astype(np.float64).tofile(os.path.join(out, rel))
        return rel

    # -- train split: train_variants variants of every place ------------
    TV = train_variants
    queries: Dict[int, TrainingTuple] = {}
    for p in range(n_places):
        for v in range(TV):
            i = p * TV + v
            rel = write_cloud(p, v)
            sibs = [p * TV + u for u in range(TV) if u != v]
            queries[i] = TrainingTuple(
                i, i, rel, np.sort(np.array(sibs)),
                np.sort(np.array(sibs + [i])),
                np.array([float(p) * 50.0, 0.0]))
    with open(os.path.join(out, "train_tuples.pickle"), "wb") as f:
        pickle.dump(queries, f)

    # -- eval split: per location, EVAL_RUNS runs over its places -------
    for li, loc in enumerate(LOCATIONS):
        places = range(li * places_per_loc, (li + 1) * places_per_loc)
        db_sets, q_sets = [], []
        for run in range(EVAL_RUNS):
            db_run, q_run = {}, {}
            for i, p in enumerate(places):
                rel = write_cloud(p, TV + run)
                entry = {"query": rel, "northing": float(p) * 50.0,
                         "easting": 0.0}
                db_run[i] = dict(entry)
                # true neighbours: same place (= same index) in each
                # other run's database
                q_run[i] = {**entry,
                            **{m: [i] for m in range(EVAL_RUNS)}}
            db_sets.append(db_run)
            q_sets.append(q_run)
        with open(os.path.join(
                out, f"{loc}_evaluation_database.pickle"), "wb") as f:
            pickle.dump(db_sets, f)
        with open(os.path.join(
                out, f"{loc}_evaluation_query.pickle"), "wb") as f:
            pickle.dump(q_sets, f)

    # -- ready-to-train configs -----------------------------------------
    batch = min(4 * TV * places_per_loc, 32)
    with open(os.path.join(out, "train.txt"), "w") as f:
        f.write(f"""[DEFAULT]
dataset_folder = {out}

[TRAIN]
dataset_name = Oxford
train_file = train_tuples.pickle
validation = False
num_workers = 0
batch_size = {batch}
val_batch_size = {batch}
lr = 1e-3
epochs = 60
warmup_epochs = 5
scheduler = CosineAnnealingLR
min_lr = 1e-5
weight_decay = 1e-4
loss = TruncatedSmoothAP
tau1 = 0.01
positives_per_query = {TV - 1}
aug_mode = 1
set_aug_mode = 1
octree_depth = 6
eval_freq = 10
save_freq = 0
""")
    with open(os.path.join(out, "model.txt"), "w") as f:
        f.write("""[MODEL]
model = HOTFormerLoc
coordinates = cartesian
channels = 32,64
num_blocks = 2,2
num_heads = 2,4
num_pyramid_levels = 2
num_octf_levels = 1
patch_size = 16
dilation = 2
drop_path = 0.2
num_input_downsamples = 1
downsample_input_embeddings = True
ct_size = 1
pooling = PyramidAttnPoolMixer
k_pooled_tokens = 12,4
feature_size = 64
output_dim = 64
normalize_embeddings = True
input_features = P
conv_norm = layernorm
""")
    return {"n_places": n_places, "train_tuples": len(queries),
            "locations": list(LOCATIONS)}


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True)
    ap.add_argument("--places-per-loc", type=int, default=8)
    ap.add_argument("--num-points", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    info = generate(args.out, args.places_per_loc, args.num_points,
                    args.seed)
    print(info)


if __name__ == "__main__":
    main()
