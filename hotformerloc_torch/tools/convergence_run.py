"""Train the model to convergence on the synthetic benchmark and write
the loss / AR@1 trajectory: the evidence that octree -> attention ->
loss -> optimiser learns.

Counterpart of hotformerloc_tpu/tools/convergence_run.py, with the same
flags and the same written INI files, on this package's ``Trainer``. It
generates the synthetic place-recognition benchmark
(tools/synthetic_benchmark.py), trains a flagship-shaped HOTFormerLoc
(channels 128/256, 4+10 blocks, patch 48, 3 pyramid levels; with
``--exact`` the production Oxford shapes: octree depth 9, 4096 points,
the production capacities, microbatch 8) with the TruncatedSmoothAP
recipe, runs the PNV evaluation every ``eval_freq`` epochs, and writes
the summary JSON (``summarize``). Success bar: model AR@1 >= 95 on the
synthetic evaluation. The model INI leaves ``remat_policy`` at its
default ('save_hot') with ``grad_checkpoint = True``, as users run it.

Run on the card:
    python -m hotformerloc_torch.tools.convergence_run --exact \\
        --json_out docs/CONVERGENCE_torch_flagship.json
On the CPU (a tiny run: the generated benchmark's own small model):
    python -m hotformerloc_torch.tools.convergence_run --device cpu \\
        --tiny --places_per_loc 2 --num_points 256 --epochs 2 \\
        --eval_freq 1 --out DIR --json_out DIR/summary.json
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional


def model_cfg(exact: bool) -> str:
    """Model INI: ``exact`` = the production Oxford recipe (octree depth
    9, 4096 points, occupancy-tuned capacities); otherwise the
    reduced-shape variant (depth 7, 1024 points)."""
    caps = ("2688,4224,4224,4224,4096,4096" if exact
            else "192,384,576,1152,1024,1024")
    return f"""[MODEL]
model = HOTFormerLoc
coordinates = cartesian
channels = 128,256
num_blocks = 4,10
num_heads = 8,16
num_pyramid_levels = 3
num_octf_levels = 1
patch_size = 48
dilation = 4
drop_path = 0.2
num_input_downsamples = 2
downsample_input_embeddings = True
ct_size = 1
ADaPE_mode = cov
pooling = PyramidAttnPoolMixer
k_pooled_tokens = 74,36,18
feature_size = 256
output_dim = 256
normalize_embeddings = True
input_features = P
conv_norm = layernorm
grad_checkpoint = True
capacities = {caps}
"""


def train_cfg(out: str, args, depth: int) -> str:
    """Train INI (the JAX tool's text)."""
    split = (f"batch_split_size = {args.batch_split_size}\n"
             if args.batch_split_size else "")
    return f"""[DEFAULT]
dataset_folder = {out}

[TRAIN]
dataset_name = Oxford
train_file = train_tuples.pickle
validation = False
num_workers = 4
batch_size = {args.batch}
{split}val_batch_size = {args.batch}
lr = {args.lr}
epochs = {args.epochs}
warmup_epochs = 5
scheduler = CosineAnnealingLR
min_lr = 1e-5
weight_decay = 1e-4
loss = TruncatedSmoothAP
tau1 = 0.01
positives_per_query = 3
aug_mode = 1
set_aug_mode = 1
octree_depth = {depth}
eval_freq = {args.eval_freq}
save_freq = 0
"""


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=".chip_tmp/synth_bench_flagship")
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--places_per_loc", type=int, default=16)
    ap.add_argument("--num_points", type=int, default=1024)
    ap.add_argument("--train_variants", type=int, default=4)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--batch_split_size", type=int, default=0,
                    help="microbatch size (0 = single pass)")
    ap.add_argument("--eval_freq", type=int, default=10)
    ap.add_argument("--lr", type=float, default=7e-4)
    ap.add_argument("--json_out", default="docs/CONVERGENCE_torch.json")
    ap.add_argument("--exact", action="store_true",
                    help="flagship-EXACT shapes: octree depth 9, 4096 "
                         "points, production Oxford capacities; implies "
                         "--num_points 4096 and microbatch 8 unless "
                         "overridden")
    ap.add_argument("--run_name", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--weights_dir", default="weights")
    ap.add_argument("--tiny", action="store_true",
                    help="train the generated benchmark's own small "
                         "model.txt / train.txt instead (CPU checks)")
    args = ap.parse_args(argv)
    if args.exact:
        if args.num_points == 1024:
            args.num_points = 4096
        if args.batch_split_size == 0:
            args.batch_split_size = 8
        if args.json_out == "docs/CONVERGENCE_torch.json":
            args.json_out = "docs/CONVERGENCE_torch_flagship.json"
    return args


def summarize(log_path: str, args: argparse.Namespace,
              skip: int = 0) -> Dict:
    """The summary JSON of a run from the trainer's JSONL log, past its
    first ``skip`` lines (an earlier run's: the trainer appends): the JAX
    tool's keys, plus each epoch's seconds (``epoch_time_s``)."""
    losses, evals, times = [], [], []
    with open(log_path) as f:
        for line in f.readlines()[skip:]:
            r = json.loads(line)
            if r.get("phase") == "train":
                losses.append({"epoch": r["epoch"],
                               "loss": round(r.get("loss", -1), 4),
                               "ap": round(r.get("ap", -1), 4),
                               "recall_at_1": round(
                                   r.get("recall_at_1", -1), 4)})
                times.append(round(r.get("time", -1), 3))
            elif r.get("phase") == "eval":
                evals.append({"epoch": r["epoch"],
                              "avg_AR1": round(r["avg_AR1"], 2)})
    if args.tiny:
        config = "the benchmark's own model.txt (32/64ch, 2+2 blocks)"
    else:
        config = ("flagship-EXACT (128/256ch, 4+10 blocks, patch 48, "
                  "3 pyramid levels, 4096 pts, octree depth 9, "
                  "production capacities, microbatch "
                  f"{args.batch_split_size})" if args.exact else
                  "flagship-shaped (128/256ch, 4+10 blocks, patch 48, "
                  f"3 pyramid levels, {args.num_points} pts, depth 7)")
    return {
        "config": config,
        "dataset": f"synthetic benchmark, {args.places_per_loc * 4} "
                   f"places x {args.train_variants} train variants",
        "epochs": args.epochs,
        "final_loss": losses[-1]["loss"] if losses else None,
        "best_avg_AR1": max((e["avg_AR1"] for e in evals), default=None),
        "eval_trajectory": evals,
        "train_trajectory": losses,
        "epoch_time_s": times,
    }


def run(argv: Optional[List[str]] = None) -> Dict:
    """Generate (if absent), train, evaluate, write and return the
    summary."""
    args = parse_args(argv)
    run_name = args.run_name or ("ConvergenceFlagship" if args.exact
                                 else "ConvergenceRun")
    from hotformerloc_torch.tools.synthetic_benchmark import generate
    out = args.out
    if not os.path.exists(os.path.join(out, "train_tuples.pickle")):
        info = generate(out, places_per_loc=args.places_per_loc,
                        num_points=args.num_points,
                        train_variants=args.train_variants)
        print("generated:", info, flush=True)

    if args.tiny:
        train_path = os.path.join(out, "train.txt")
        model_path = os.path.join(out, "model.txt")
    else:
        depth = 9 if args.exact else 7
        train_path = os.path.join(out, "train_flagship.txt")
        model_path = os.path.join(out, "model_flagship.txt")
        with open(model_path, "w") as f:
            f.write(model_cfg(args.exact))
        with open(train_path, "w") as f:
            f.write(train_cfg(out, args, depth))

    from hotformerloc_torch.config.params import parse_train_config
    from hotformerloc_torch.training.trainer import Trainer
    from hotformerloc_torch.utils.seed import set_seed

    set_seed(42)
    params = parse_train_config(train_path, model_path,
                                num_points=args.num_points)
    if args.tiny:
        params.epochs = args.epochs
        params.eval_freq = args.eval_freq
    trainer = Trainer(params, weights_dir=args.weights_dir,
                      model_name=run_name, device=args.device, seed=42)
    log_path = os.path.join(trainer.weights_dir, f"{run_name}_log.jsonl")
    skip = 0
    if os.path.exists(log_path):
        with open(log_path) as f:
            skip = len(f.readlines())
    try:
        trainer.train()
    finally:
        trainer.close()
    summary = summarize(log_path, args, skip)
    summary["device"] = str(trainer.device)
    if os.path.dirname(args.json_out):
        os.makedirs(os.path.dirname(args.json_out), exist_ok=True)
    with open(args.json_out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items()
                      if k != "train_trajectory"}, indent=1))
    print("wrote", args.json_out)
    return summary


def main():
    run()


if __name__ == "__main__":
    main()
