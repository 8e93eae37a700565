"""Bisect the train step's time on the card, stage by stage.

Counterpart of hotformerloc_tpu/tools/bisect_step.py, with the JAX
tool's stages on the port's modules (oxford_config with activation
checkpointing, bf16 compute on the card, fp32 on the CPU):

  1. null         - one trivial tensor op (launch and sync floor)
  2. octree       - the octree build alone, then octree+plan (every
                    gather table and tap list) of one microbatch
  3. forward      - embed forward of one microbatch (eval mode, no
                    gradients), octree included
  4. loss_fwd     - forward + TruncatedSmoothAP loss value
  5. grad         - forward + loss + backward of one microbatch (train
                    mode, as the step's stage 3)
  6. multistage   - the production step: batch / micro microbatches

Each stage runs ``--iters`` calls between two ``torch.cuda.synchronize()``
(``wall_ms``, host clock), with CUDA events around the same calls
(``event_ms``), then sums its kernels' time under torch.profiler over
``--device_iters`` calls (``device_ms``; ``seconds`` is the stage's own
run time, the profiler's included): ``host_ms`` = wall - device is where the card waited
for the host, ``idle_share`` its share of the wall time
(``utils/profiling.wall_and_device_ms``). On the CPU (``--device cpu``)
the host clock alone. One JSON line per stage.

    python -m hotformerloc_torch.tools.bisect_step [--stages null,grad]
        [--iters 5] [--batch 32] [--micro 8] [--device cpu --tiny]
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

STAGES = ("null", "octree", "forward", "loss_fwd", "grad", "multistage")


def pair_batch(B: int, num_points: int, device) -> Dict[str, torch.Tensor]:
    """B clouds as B/2 pairs of one uniform cloud with small jitter, and
    the pairs' masks (the JAX tool's batch)."""
    rng = np.random.default_rng(0)
    base = rng.uniform(-0.9, 0.9, (B // 2, num_points, 3)).astype(
        np.float32)
    pts = np.repeat(base, 2, axis=0)
    pts += rng.normal(0, 0.01, pts.shape).astype(np.float32)
    groups = np.repeat(np.arange(B // 2), 2)
    same = groups[:, None] == groups[None]
    return {"points": torch.from_numpy(pts).to(device),
            "pmask": torch.ones((B, num_points), dtype=torch.bool,
                                device=device),
            "positives_mask": torch.from_numpy(
                same & ~np.eye(B, dtype=bool)).to(device),
            "negatives_mask": torch.from_numpy(~same).to(device)}


def run(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    """Time the stages ``--stages`` names; returns one dict per line."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stages", default=",".join(STAGES))
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device_iters", type=int, default=2,
                    help="calls profiled for the device time")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--micro", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny_test_config at 256 points (CPU checks)")
    args = ap.parse_args(argv)
    stages = args.stages.split(",")
    unknown = set(stages) - set(STAGES)
    if unknown:
        raise ValueError(f"unknown stages {sorted(unknown)}")

    from hotformerloc_torch.evaluation.embed import compute_dtype
    from hotformerloc_torch.losses.losses import make_loss
    from hotformerloc_torch.models.config import (oxford_config,
                                                  tiny_test_config)
    from hotformerloc_torch.models.hotformerloc import (HOTFormerLoc,
                                                        build_model_plan)
    from hotformerloc_torch.octree.build import build_batched_octree
    from hotformerloc_torch.training.optim import lr_schedule, make_optimizer
    from hotformerloc_torch.training.step import StepConfig, make_train_step
    from hotformerloc_torch.utils.profiling import wall_and_device_ms

    dev = torch.device(args.device)
    B, MB = args.batch, args.micro
    cfg = (tiny_test_config(num_points=256, grad_checkpoint=True)
           if args.tiny else oxford_config(grad_checkpoint=True))
    dtype = compute_dtype(dev)
    model = HOTFormerLoc(cfg, device=dev, dtype=dtype,
                         generator=torch.Generator().manual_seed(0))
    loss_fn = make_loss("truncatedsmoothap",
                        positives_per_query=1 if args.tiny else 4)
    batch = pair_batch(B, cfg.num_points, dev)
    mpts, mmask = batch["points"][:MB], batch["pmask"][:MB]
    pm = batch["positives_mask"][:MB, :MB]
    nm = batch["negatives_mask"][:MB, :MB]
    lines = []

    def report(stage, fn, iters=args.iters, **extra):
        t0 = time.perf_counter()
        split = wall_and_device_ms(fn, iters=iters,
                                   device_iters=args.device_iters)
        line = {"stage": stage, **split,
                "seconds": time.perf_counter() - t0,
                "batch": MB if stage != "multistage" else B,
                "device": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"), **extra}
        lines.append(line)
        print(json.dumps(line), flush=True)

    if "null" in stages:
        x = torch.ones((8, 128), device=dev)
        report("null", lambda: x + 1.0, iters=20)
    if "octree" in stages:
        caps = cfg.resolve_capacities()
        report("octree", lambda: build_batched_octree(
            mpts, mmask, cfg.octree_depth, cfg.min_depth, caps).counts)
        report("octree+plan", lambda: build_model_plan(
            cfg, mpts, mmask).neighs)

    def embed():
        with torch.no_grad():
            return model(mpts, mmask)["global"]

    def loss_value():
        return loss_fn(embed(), pm, nm)[0]

    def grad():
        model.zero_grad(set_to_none=True)
        model.train()
        try:
            loss = loss_fn(model(mpts, mmask)["global"], pm, nm)[0]
            loss.backward()
        finally:
            model.eval()
        return [p.grad for p in model.parameters() if p.grad is not None]

    if "forward" in stages:
        report("forward", embed)
    if "loss_fwd" in stages:
        report("loss_fwd", loss_value)
    if "grad" in stages:
        report("grad", grad)
    if "multistage" in stages:
        opt = make_optimizer(model.parameters(), "adam",
                             lr_schedule(5e-4, steps_per_epoch=100,
                                         epochs=150, warmup_epochs=5,
                                         milestones=[100]),
                             weight_decay=1e-4)
        step = make_train_step(model, opt, loss_fn,
                               StepConfig(accum_steps=B // MB))
        seeds = iter(range(1 << 30))
        report("multistage", lambda: step(batch, next(seeds)),
               accum_steps=B // MB)
        model.eval()
    return lines


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
