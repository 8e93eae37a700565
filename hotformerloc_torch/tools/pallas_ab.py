"""Window attention at module level: the kernel route (K1 forward, K2
backward, csrc/window_attn.cu) against the einsum route.

Counterpart of hotformerloc_tpu/tools/pallas_ab.py, which times the
fused Pallas kernel against the XLA einsum path. This tool times the
port's whole ``WindowAttention`` module (qkv and proj included, the same
parameters on both routes) at the shapes the Oxford train step runs,
forward and forward+backward, and holds the kernel route's output
against the einsum route's on the valid query rows. The einsum route
(``use_kernels = False``) is the one the model takes under attention
dropout.

Shapes (Oxford, microbatch 8 of the multistage step):
  * H-OSA/HAT: (B*W=704, T=49, C=256, H=16), G=1 relay slot, dilation 1
  * OctFormer: (B*W=704, T=48, C=128, H=8),  G=0, dilation 1 and 4
JAX's (window_tile, pack) combos are TPU tiling knobs with no
counterpart here. A build or launch error raises; no case is skipped.

Run: python -m hotformerloc_torch.tools.pallas_ab [--out PATH]
Writes docs/PALLAS_AB_torch.json with nvidia-smi's name and power limit
of the card.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from hotformerloc_torch.models.attention import WindowAttention
from hotformerloc_torch.models.layers import init_weights
from hotformerloc_torch.ops import kernels
from hotformerloc_torch.utils.profiling import device_ms, smi_line

RESULTS_PATH = "docs/PALLAS_AB_torch.json"
# (name, B*W, K, G, C, H, dilation): JAX's three cases
CASES = (("hosa_hat", 704, 48, 1, 256, 16, 1),
         ("octf_d1", 704, 48, 0, 128, 8, 1),
         ("octf_d4", 704, 48, 0, 128, 8, 4))
ROUTES = (("kernel", True), ("einsum", False))
COUNTS = ("window_attn", "window_attn_tc", "window_attn_bwd",
          "window_attn_bwd_tc")


def make_inputs(BW: int, K: int, G: int, C: int, depth: int = 7,
                seed: int = 0):
    """The JAX tool's inputs, drawn in its order from
    ``default_rng(seed)``: x (B, W, T, C) float32 normal (the caller
    rounds it to its dtype), the key mask (B, W, T) with a ragged tail
    on the last 6 windows of each sample, and integer node coordinates
    (B, W, K, 3) below 2^depth; B = 8 samples."""
    T = K + G
    B, W = 8, BW // 8
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, W, T, C)).astype(np.float32)
    valid = np.ones((B, W, T), bool)
    tail = rng.integers(1, T, B)
    for b in range(B):
        valid[b, -6:, -tail[b]:] = False
    xyz = rng.integers(0, 2 ** depth, (B, W, K, 3)).astype(np.int32)
    return x, valid, xyz


def _time(fn, device: torch.device, iters: int):
    """(ms, host ms) per call of ``fn`` over ``iters`` calls after one
    warm-up call and a synchronize. On the card ms is CUDA-event time
    and host ms the host's time to issue the calls (the loop before the
    closing synchronize): where the two are equal, the card waited on
    the host. On the CPU both are the host clock."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host = time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters, host / iters * 1e3
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) / iters * 1e3
    return ms, ms


def bench_case(name: str, BW: int, K: int, G: int, C: int, H: int,
               dilation: int, depth: int = 7, iters: int = 30,
               seed: int = 0, device="cuda",
               dtype: torch.dtype = torch.bfloat16,
               profile: bool = True) -> dict:
    """One case on both routes: forward ms, forward+backward ms (the
    loss is sum(out^2), differentiated in the parameters and x), the
    host's time to issue each, on the card with ``profile`` the
    forward's device time (the summed time of its kernels,
    torch.profiler; else None), and the kernel
    launches of each route; the max |kernel - einsum| of the output on
    valid query rows, and of the gradient of each leaf (x and every
    parameter, the RPE table's included) under the loss over valid rows
    only (invalid rows' outputs differ by design: the kernel zeroes
    them), each beside the einsum route's max |value|."""
    device = torch.device(device)
    x_np, valid_np, xyz_np = make_inputs(BW, K, G, C, depth, seed)
    x = torch.from_numpy(x_np).to(device=device, dtype=dtype)
    key_mask = torch.from_numpy(valid_np).to(device)
    xyz = torch.from_numpy(xyz_np).to(device)
    rows = key_mask[..., None]
    mod = WindowAttention(C, H, K, dilation, G, True, 0.0, 0.0,
                          device=device)
    init_weights(mod, torch.Generator().manual_seed(seed))
    names, params = zip(*mod.named_parameters())
    names, params = names + ("x",), list(params)
    coord_range = 2 ** depth

    def fwd():
        with torch.no_grad():
            return mod(x, key_mask, xyz, coord_range)

    def fwd_bwd(valid_only=False):
        xg = x.detach().requires_grad_(True)
        out = mod(xg, key_mask, xyz, coord_range).float()
        loss = ((out * rows) ** 2 if valid_only else out ** 2).sum()
        return torch.autograd.grad(loss, params + [xg])

    result = {"case": name, "BW": BW, "T": K + G, "C": C, "H": H,
              "dilation": dilation, "dtype": str(dtype).split(".")[-1],
              "iters": iters}
    outs, grads = {}, {}
    for route, use in ROUTES:
        mod.use_kernels = use
        kernels.reset_launches()
        fwd_ms, fwd_host_ms = _time(fwd, device, iters)
        fwd_bwd_ms, fwd_bwd_host_ms = _time(fwd_bwd, device, iters)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        launches = {k: kernels.LAUNCHES[k] for k in COUNTS}
        outs[route] = fwd().float()
        grads[route] = [g.float() for g in fwd_bwd(valid_only=True)]
        result[route] = {"fwd_ms": fwd_ms, "fwd_bwd_ms": fwd_bwd_ms,
                         "fwd_host_ms": fwd_host_ms,
                         "fwd_bwd_host_ms": fwd_bwd_host_ms,
                         "fwd_device_ms": (device_ms(fwd, iters=iters)
                                           if profile and device.type
                                           == "cuda" else None),
                         "launches": launches}
    ref, gref = outs["einsum"], grads["einsum"]
    result.update(
        maxdiff_vs_einsum=float(((outs["kernel"] - ref).abs() * rows).max()),
        einsum_max_abs=float((ref.abs() * rows).max()),
        grad_maxdiff_vs_einsum={
            n: float((g - r).abs().max())
            for n, g, r in zip(names, grads["kernel"], gref)},
        einsum_grad_max_abs={n: float(r.abs().max())
                             for n, r in zip(names, gref)},
        finite=bool(all(torch.isfinite(t).all() for t in (
            *outs.values(), *grads["kernel"], *gref))))
    return result


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=RESULTS_PATH)
    args = ap.parse_args(argv)
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}")
    cases = [bench_case(*case) for case in CASES]
    out = {"device": name, "nvidia_smi": smi_line(),
           "torch": torch.__version__, "cases": cases}
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    for c in cases:
        print(json.dumps(c))
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
