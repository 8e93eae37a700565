"""Where the time of the Oxford train step, or of a served batch, goes,
on the card.

    python -m hotformerloc_torch.tools.profile_step [--mode train|embed]
        [--steps 2] [--out DIR]

``--mode train`` (the default) builds the step chip_smoke.py times
(oxford_config, batch 32 as 4 microbatches of 8, bf16 compute on fp32
parameters, no activation checkpointing, Adam, DropPath 0.5, seeded
random weights and bench.py's
synthetic clouds); ``--mode embed`` the serving call chip_smoke.py
times (``make_embed_fn`` in bf16, batch 32 of the same clouds, the same
weights). It warms the call up and traces ``--steps`` calls with
torch.profiler. Prints one JSON line: the host-clock time per call, the
device busy time (sum of kernel durations; one stream, so kernels do
not overlap) and idle share, and the device time per call by kernel
class (the six hand-written kernels by name, then cuDNN convolutions,
cuBLAS GEMMs, elementwise, reductions, gathers/scatters, copies, norms,
the rest), with the 25 longest kernels; then the device time, kernel
launches and idle time per call by the program's innermost ``hfl.*``
span (``utils/profiling.py`` ``span_summary``; ``unattributed``: device
work launched outside every span), the ten longest idle gaps named
``span > host op``, and the blocks' valid nodes as a share of the slots
they process (``valid_node_share``, from ``profiling.counting``).
Device events are kernels, copies and fills: the ranges kineto draws on
a stream for a ``record_function`` are left out. ``--out`` also writes
the key_averages table there (profile_<mode>.txt). Exits 1 without a
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from hotformerloc_torch.utils import profiling

# (class, substrings of the CUDA kernel name), first match wins. The
# forward bodies also run the dx of K4/K6 (dwconv_fwd_kernel,
# conv_fwd_tc_kernel / conv_fwd_kernel), which therefore count under K3/K5
# here.
CLASSES = [
    ("K1 window_attn_fwd", ("window_attn_fwd_",)),
    ("K2 window_attn_bwd", ("window_attn_bwd_",)),
    ("K3 dwconv_fwd (+ K4 dx)", ("dwconv_fwd_kernel",)),
    ("K4 dwconv dw", ("dwconv_dw_taps_kernel",)),
    ("K5 conv_fwd (+ K6 dx)", ("conv_fwd_tc_kernel", "conv_fwd_kernel")),
    ("K6 conv dw", ("conv_dw_tc_kernel", "conv_dw_partial_kernel")),
    ("K4/K6 partial sums", ("sum_segments_kernel", "sum_parts_kernel")),
    # cuDNN's convolution kernels (a dense-grid CPE's conv3d; the path
    # should show none)
    ("conv3d (cuDNN)", ("convolve", "conv3d", "cudnn", "fprop", "dgrad",
                        "wgrad")),
    ("gemm", ("gemm", "cutlass", "xmma", "cublas", "sm90_", "sm80_")),
    ("norm", ("layer_norm", "layernorm")),
    ("softmax", ("softmax",)),
    ("gather/scatter/index", ("gather", "scatter", "index")),
    ("reduce", ("reduce",)),
    ("copy/cat", ("copy", "cat", "catarray")),
    ("elementwise", ("elementwise",)),
]


def classify(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k.lower() in low for k in keys):
            return cls
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("train", "embed"), default="train")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from hotformerloc_torch.evaluation.embed import make_embed_fn
    from hotformerloc_torch.losses.losses import make_loss
    from hotformerloc_torch.models.config import oxford_config
    from hotformerloc_torch.models.hotformerloc import HOTFormerLoc
    from hotformerloc_torch.training.optim import lr_schedule, make_optimizer
    from hotformerloc_torch.training.step import StepConfig, make_train_step

    B, dev = 32, torch.device("cuda")
    cfg = oxford_config(grad_checkpoint=False)
    rng = np.random.default_rng(0)
    base = rng.uniform(-0.9, 0.9, (B // 2, cfg.num_points, 3))
    pts = np.repeat(base.astype(np.float32), 2, axis=0)
    pts += rng.normal(0, 0.01, pts.shape).astype(np.float32)
    groups = np.repeat(np.arange(B // 2), 2)
    same = groups[:, None] == groups[None]
    batch = {"points": torch.from_numpy(pts).to(dev),
             "pmask": torch.ones(B, cfg.num_points, dtype=torch.bool,
                                 device=dev),
             "positives_mask": torch.from_numpy(
                 same & ~np.eye(B, dtype=bool)).to(dev),
             "negatives_mask": torch.from_numpy(~same).to(dev)}
    if args.mode == "embed":
        model = HOTFormerLoc(cfg, device=dev,
                             generator=torch.Generator().manual_seed(0))
        embed = make_embed_fn(model, torch.bfloat16)

        def call(i):
            embed(batch["points"], batch["pmask"])
    else:
        model = HOTFormerLoc(cfg, device=dev, dtype=torch.bfloat16,
                             generator=torch.Generator().manual_seed(0))
        opt = make_optimizer(model.parameters(), "adam",
                             lr_schedule(5e-4, steps_per_epoch=100,
                                         epochs=150, warmup_epochs=5,
                                         milestones=[100]),
                             weight_decay=1e-4)
        step = make_train_step(model, opt, make_loss(
            "truncatedsmoothap", positives_per_query=4),
            StepConfig(accum_steps=4))

        def call(i):
            step(batch, i)
    for i in range(3):
        call(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            profiling.counting() as counts:
        t0 = time.perf_counter()
        for i in range(args.steps):
            call(3 + i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    kernels = [e for e in prof.key_averages() if profiling.device_work(e)]
    spans = profiling.span_summary(prof)
    totals = counts.totals()

    def per_call(d, scale=1e3):
        return {k: v * scale / args.steps
                for k, v in sorted(d.items(), key=lambda kv: -kv[1])}
    by_class, top = {}, []
    for e in kernels:
        us = profiling.device_us(e) / args.steps
        by_class[classify(e.key)] = by_class.get(classify(e.key), 0.0) + us
        top.append((us, e.count // args.steps, e.key[:120]))
    busy_ms = sum(by_class.values()) / 1e3
    top.sort(reverse=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    report = {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "mode": args.mode, "batch": B,
        "steps_traced": args.steps, "step_ms_host_traced": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "ms_by_class": {k: v / 1e3 for k, v in sorted(
            by_class.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"ms": us / 1e3, "calls": n, "name": name}
                        for us, n, name in top[:25]],
        "span_ms": per_call(spans["span_s"]),
        "span_kernels": per_call(spans["span_kernels"], 1),
        "idle_span_ms": per_call(spans["idle_span_s"]),
        "idle_gaps_ms": [[n, s * 1e3] for n, s in spans["idle_gaps"]],
        "valid_node_share": (100.0 * totals["hfl.block.valid"]
                             / totals["hfl.block.slots"]
                             if totals.get("hfl.block.slots") else None),
    }
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        key = ("self_device_time_total" if kernels and hasattr(
            kernels[0], "self_device_time_total") else "self_cuda_time_total")
        path = os.path.join(args.out, f"profile_{args.mode}.txt")
        with open(path, "w") as f:
            f.write(prof.key_averages().table(sort_by=key, row_limit=80))
    print(json.dumps(report), flush=True)
    return 0 if busy_ms > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
