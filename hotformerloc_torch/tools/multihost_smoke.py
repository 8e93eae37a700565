"""Multi-process smoke run of the data-parallel train step.

Counterpart of hotformerloc_tpu/tools/multihost_smoke.py. Every rank
builds the same seeded sampler over a synthetic PNV dataset, loads only
its rows of the global batch in the train step's microbatch layout
(``DataLoader(process_index=rank, process_count=world,
micro_batches=accum)``: its share of each of the ``--accum`` global
microbatches), and runs one train step over the process group
(``parallel/dist.py``); ``--processes 1`` runs the whole batch in one
process. The shards reproduce the one-process batch exactly, and the
norms' batch statistics are summed over the ranks, so the loss,
``grad_norm``, gradients and running statistics agree with a
``--processes 1`` run of the same ``--accum`` up to the order of fp32
sums, for every model (``--conv_norm``, ``--pooling``), and the
parameters after the step are bitwise equal on every rank
(``param_checksum``); tests/test_torch_dist.py and
tests/test_torch_dist_stats.py hold both.

Each rank writes ``<out>/rank<r>.json`` (loss, grad_norm, parameter
checksum, launches of the model kernels, step seconds, peak memory) and,
with ``--tensors``, ``<out>/rank<r>.pt`` (gradients, parameters and
buffers after the step). Ranks start under ``torchrun``, or with ``--processes N``
this tool starts them under torchrun (``dist.torchrun``). NCCL ranks
take a card each; gloo ranks (``--backend gloo``) may share one.

    python -m hotformerloc_torch.tools.multihost_smoke --data DIR \\
        --make-dataset --processes 2 --device cpu --out OUT
    torchrun --nproc_per_node 2 -m hotformerloc_torch.tools.multihost_smoke \\
        --data DIR --config oxford --batch 32 --dtype bfloat16 --out OUT
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import pickle
import sys
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from hotformerloc_torch.parallel import dist

TOOL = "hotformerloc_torch.tools.multihost_smoke"
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
POINTS = {"tiny": 256, "oxford": 4096}      # points per cloud per config
TIMEOUT = 900                  # seconds the ranks this tool starts may take


def make_synthetic_dataset(path: str, n: int = 16, points: int = 256,
                           seed: int = 0) -> None:
    """PNV-format .bin clouds + a training pickle: i is positive with
    i^1, non-negative with {i, i^1, (i+2) % n} (the JAX tool's)."""
    from hotformerloc_torch.data.tuples import TrainingTuple
    os.makedirs(os.path.join(path, "clouds"), exist_ok=True)
    rng = np.random.default_rng(seed)
    queries = {}
    for i in range(n):
        c = rng.uniform(-0.9, 0.9, (points, 3)).astype(np.float64)
        c.tofile(os.path.join(path, "clouds", f"{i:03d}.bin"))
        queries[i] = TrainingTuple(
            i, i, f"clouds/{i:03d}.bin", np.array([i ^ 1]),
            np.sort(np.array([i, i ^ 1, (i + 2) % n])),
            np.array([float(i), 0.0]))
    with open(os.path.join(path, "train_tuples.pickle"), "wb") as f:
        pickle.dump(queries, f)


def model_config(name: str, drop_path: Optional[float] = None,
                 **over):
    """``tiny_test_config`` or ``oxford_config`` (without activation
    checkpointing) at POINTS[name], with ``drop_path`` when given and
    the other fields ``over`` names."""
    from hotformerloc_torch.models.config import (oxford_config,
                                                  tiny_test_config)
    kw = dict(over) if drop_path is None else dict(over,
                                                   drop_path=drop_path)
    if name == "tiny":
        return tiny_test_config(num_points=POINTS[name], **kw)
    return oxford_config(num_points=POINTS[name], grad_checkpoint=False,
                         **kw)


def load_batch(data: str, num_points: int, batch: int, rank: int = 0,
               world: int = 1, transforms: bool = False, accum: int = 1
               ) -> Dict[str, np.ndarray]:
    """Rank ``rank``'s rows of the first global batch of ``batch``
    clouds (sampler seed 7, loader seed 3, as the JAX tool), in the
    layout of ``accum`` microbatches."""
    from hotformerloc_torch.data.loaders import PNVPointCloudLoader
    from hotformerloc_torch.data.pipeline import DataLoader, TrainingDataset
    from hotformerloc_torch.data.sampler import BatchSampler
    tr = st = None
    if transforms:
        from hotformerloc_torch.data.augmentation import (
            make_set_transform, make_train_transform)
        tr = make_train_transform(2, random_rot_theta=180.0)
        st = make_set_transform(1)
    ds = TrainingDataset(data, "train_tuples.pickle", PNVPointCloudLoader(),
                         transform=tr, set_transform=st)
    sampler = BatchSampler(ds.queries, batch_size=batch, seed=7,
                           max_batches=1)
    loader = DataLoader(ds, sampler, num_points, seed=3,
                        process_index=rank, process_count=world,
                        micro_batches=accum)
    try:
        return next(iter(loader))
    finally:
        loader.close()


REORDERS = ("reverse", "roll")


def reorder_micro(host: Dict[str, np.ndarray], accum: int, how: str
                  ) -> Dict[str, np.ndarray]:
    """The batch with the rows of each of its ``accum`` microbatches
    reversed, or rolled by half a microbatch (``how``; mask rows and
    columns alike): at DropPath 0 the same step in exact arithmetic, so
    its distance from the batch as loaded is the rounding spread of the
    step's sums."""
    B = len(host["points"])
    mb = B // accum
    order = (np.arange(mb)[::-1] if how == "reverse"
             else np.roll(np.arange(mb), mb // 2))
    idx = np.concatenate([i * mb + order for i in range(accum)])
    out = {k: v[idx] for k, v in host.items()}
    for k in ("positives_mask", "negatives_mask"):
        out[k] = out[k][:, idx]
    return out


def param_checksum(model: torch.nn.Module) -> str:
    """sha256 of every parameter's bytes, in order."""
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def config_of(args):
    """The model configuration the arguments name."""
    over = {k: v for k, v in (("conv_norm", args.conv_norm),
                              ("pooling", args.pooling)) if v is not None}
    return model_config(args.config, args.drop_path, **over)


def run(args, group, device) -> Tuple[Dict, Dict]:
    """One train step of this rank over ``group`` (None: one process).
    Returns (the rank's result, {'grads', 'params'} on the CPU)."""
    from hotformerloc_torch.losses.losses import make_loss
    from hotformerloc_torch.models.hotformerloc import HOTFormerLoc
    from hotformerloc_torch.ops import kernels
    from hotformerloc_torch.training.optim import lr_schedule, make_optimizer
    from hotformerloc_torch.training.step import StepConfig, make_train_step

    device = torch.device(device)
    r, n = dist.rank(group), dist.world(group)
    cfg = config_of(args)
    host = load_batch(args.data, cfg.num_points, args.batch, r, n,
                      args.transforms, args.accum)
    if args.reorder:
        host = reorder_micro(host, args.accum, args.reorder)
    model = HOTFormerLoc(cfg, device=device, dtype=DTYPES[args.dtype],
                         generator=torch.Generator().manual_seed(0))
    if args.weights:      # parameters, and buffers when the file has them
        state = torch.load(args.weights, map_location="cpu",
                           weights_only=True)
        res = model.load_state_dict(state, strict=False)
        bad = res.unexpected_keys + [
            k for k in res.missing_keys
            if k not in dict(model.named_buffers())]
        if bad:
            raise KeyError(f"{args.weights}: {bad[:8]}")
    dist.broadcast_module_(model, 0, group)
    opt = make_optimizer(model.parameters(), "adam",
                         lr_schedule(1e-3, 10, 10, warmup_epochs=2),
                         weight_decay=1e-4)
    step = make_train_step(
        model, opt, make_loss("truncatedsmoothap", positives_per_query=1),
        StepConfig(accum_steps=args.accum), group)
    batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    stats = step(batch, 1)
    if cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.LAUNCHES.items()
                if not k.startswith(("take_rows", "dwconv_resident",
                                     "construct_"))}
    res = {"processes": n, "rank": r, "global_batch": n * len(host["points"]),
           "rows": len(host["points"]), "accum_steps": args.accum,
           "config": args.config, "dtype": args.dtype,
           "conv_norm": cfg.conv_norm, "pooling": cfg.pooling,
           "device": (torch.cuda.get_device_name(device) if cuda
                      else "cpu"),
           "backend": None if group is None else
           torch.distributed.get_backend(group),
           "loss": float(stats["loss"]),
           "grad_norm": float(stats["grad_norm"]),
           "octree_overflow": int(stats["octree_overflow"]),
           "param_checksum": param_checksum(model), "launches": launches,
           "step_s": seconds,
           "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                           if cuda else None)}
    tensors = {"grads": {k: p.grad.detach().cpu()
                         for k, p in model.named_parameters()},
               "params": {k: p.detach().cpu()
                          for k, p in model.named_parameters()},
               "buffers": {k: b.detach().cpu()
                           for k, b in model.named_buffers()}}
    return res, tensors


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", required=True, help="synthetic PNV dataset")
    ap.add_argument("--make-dataset", action="store_true",
                    help="write the dataset first (--batch * 2 clouds)")
    ap.add_argument("--transforms", action="store_true",
                    help="per-cloud and batch-level augmentation on")
    ap.add_argument("--processes", type=int, default=None,
                    help="ranks this tool starts (default: torchrun's "
                         "WORLD_SIZE, else 1)")
    ap.add_argument("--config", choices=tuple(POINTS), default="tiny")
    ap.add_argument("--batch", type=int, default=8, help="global batch")
    ap.add_argument("--accum", type=int, default=2,
                    help="global microbatches (each split over the ranks)")
    ap.add_argument("--drop_path", type=float, default=None)
    ap.add_argument("--conv_norm", default=None,
                    help="layernorm (the configs'), batchnorm or powernorm")
    ap.add_argument("--pooling", default=None,
                    help="pooling head (default: the config's)")
    ap.add_argument("--reorder", choices=REORDERS, default=None,
                    help="one process: reverse or roll the rows within "
                         "each microbatch (reorder_micro)")
    ap.add_argument("--dtype", choices=tuple(DTYPES), default="float32")
    ap.add_argument("--device", default="cuda",
                    help="cuda (a card per NCCL rank) or cpu (gloo)")
    ap.add_argument("--backend", default=None,
                    help="nccl on the card, gloo on the CPU by default")
    ap.add_argument("--weights", default=None,
                    help="state_dict to start from (default: seed 0)")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--tensors", action="store_true",
                    help="also save gradients and parameters per rank")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    """Run this rank, or (with --processes N outside torchrun) start N
    ranks and wait for them. Returns the results it ran or read."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    n = args.processes or dist.env_world()
    if "RANK" not in os.environ:
        if args.make_dataset:
            make_synthetic_dataset(args.data, n=2 * args.batch,
                                   points=POINTS[args.config])
        if n > 1:
            dist.torchrun(["-m", TOOL, *[a for a in argv
                                         if a != "--make-dataset"]],
                          n, log_dir=args.out, timeout=TIMEOUT)
            results = []
            for r in range(n):
                with open(os.path.join(args.out, f"rank{r}.json")) as f:
                    results.append(json.load(f))
                print(json.dumps(results[-1]), flush=True)
            return results
    group, device = None, args.device
    if dist.env_world() > 1:
        group, device = dist.init_from_env(args.device, args.backend)
    try:
        if args.make_dataset and "RANK" in os.environ:
            if dist.rank(group) == 0:           # under torchrun
                make_synthetic_dataset(args.data, n=2 * args.batch,
                                       points=POINTS[args.config])
            dist.barrier(group)
        res, tensors = run(args, group, device)
        r = res["rank"]
        if args.tensors:
            torch.save(tensors, os.path.join(args.out, f"rank{r}.pt"))
        with open(os.path.join(args.out, f"rank{r}.json"), "w") as f:
            json.dump(res, f)
        print(json.dumps(res), flush=True)
        dist.barrier(group)
    finally:
        dist.close(group)
    return [res]


if __name__ == "__main__":
    main()
