"""Per-component time budget of the Oxford train step on the card.

Counterpart of hotformerloc_tpu/tools/component_profile.py: times each
component family at its Oxford microbatch-8 shape, forward and
forward+backward, on the port's modules (bf16 activations on the card,
fp32 on the CPU), so that work on the step is chosen by measurement.

Experiments (--exp, comma list or 'all'):
  band      the octree-conv kernels against the port's plain flat-gather
            path (ops/conv.py) on a real Oxford level (depth 6, 8
            clouds): K3 forward and K3+K4 forward+backward at C 256 and
            128, K5 forward at 128 -> 128; each kernel's output is held
            against its plain version (the tolerances of chip_smoke.py)
            and a disagreement raises
  cpe       the CPE's depthwise conv through K3/K4, forward and
            forward+backward, at C 256 and 128
  dense     K3 at depths 5 and 4 against the dense-grid depthwise conv
            (``ops/conv.octree_dwconv_dense``: cuDNN's grouped conv3d on
            the (B, C, D, D, D) grid) and the bare conv3d
  rtsa      the relay-token attention (TokenAttention, 232 tokens, C 256,
            16 heads)
  pool      the PyramidAttnPool head (three levels of C 256)
  noremat   one microbatch's gradient without activation checkpointing
            against 'save_hot' (the shipped policy), with peak memory

Times are CUDA events around each call (``utils/profiling.time_fn``,
median over --iters), the host clock on the CPU. Every line printed is
one entry of ``--out`` (default docs/COMPONENT_PROFILE_torch.json,
merged across invocations), with the card and ``nvidia-smi``'s name and
power limit.

    python -m hotformerloc_torch.tools.component_profile --exp band,cpe
        [--out PATH] [--device cpu --tiny]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from hotformerloc_torch.utils.profiling import smi_line

RESULTS_PATH = "docs/COMPONENT_PROFILE_torch.json"
# kernel against plain version: forward relative to max(1, max |plain|)
# at bf16 (one bf16 rounding of the output on each side), absolute at
# fp32; backward activations and weights relative to max(1, max |plain|)
TOL_FWD = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
TOL_BWD = {torch.float32: {"act": 1e-5, "weight": 1e-4},
           torch.bfloat16: {"act": 1e-2, "weight": 1e-4}}
EXPERIMENTS = ("band", "cpe", "dense", "rtsa", "pool", "noremat")


class Shapes:
    """The experiments' shapes: Oxford's, or a tiny set for the CPU."""

    def __init__(self, tiny: bool):
        self.tiny = tiny
        self.B = 2 if tiny else 8
        self.depth = 4 if tiny else 6          # the band/cpe level
        self.channels = (32,) if tiny else (256, 128)
        self.conv = 32 if tiny else 128        # K5's C = O
        self.dense_depths = (4, 3) if tiny else (5, 4)
        self.rtsa = (2, 16, 32, 2) if tiny else (8, 232, 256, 16)
        self.pool = (((64, 64), 32, (12, 4)) if tiny
                     else ((4224, 4224, 2688), 256, (74, 36, 18)))

    def cfg(self, **over):
        from hotformerloc_torch.models.config import (oxford_config,
                                                      tiny_test_config)
        if self.tiny:
            return tiny_test_config(num_points=256, **over)
        return oxford_config(**over)


def _ms(fn, iters: int) -> float:
    from hotformerloc_torch.utils.profiling import time_fn
    return float(time_fn(fn, iters=iters)["median_ms"])


def _check(what: str, out, ref, tol: float, scale: bool = True) -> float:
    """max |out - ref|; raises when it is above ``tol`` (times max(1, max
    |ref|) when ``scale``) or ``out`` is not finite."""
    err = float((out.float() - ref.float()).abs().max())
    lim = tol * (max(1.0, float(ref.float().abs().max())) if scale else 1.0)
    if not (err <= lim and bool(torch.isfinite(out.float()).all())):
        raise AssertionError(f"{what}: max |kernel - plain| = {err} > {lim}")
    return err


class Profiler:
    """Runs experiments and records their lines in ``results``."""

    def __init__(self, shapes: Shapes, device, iters: int, results: Dict):
        self.s, self.dev, self.iters = shapes, torch.device(device), iters
        self.dtype = (torch.bfloat16 if self.dev.type == "cuda"
                      else torch.float32)
        self.results = results
        self.lines = []

    def record(self, name: str, **kw) -> None:
        self.results[name] = kw
        self.lines.append({name: kw})
        print(json.dumps({name: kw}), flush=True)

    def plan(self, depth_use: Optional[int] = None):
        """(neigh of the level at ``depth_use``, the plan) of a uniform
        Oxford microbatch built on the device."""
        from hotformerloc_torch.models.hotformerloc import build_model_plan
        cfg = self.s.cfg()
        rng = np.random.default_rng(0)
        pts = torch.from_numpy(rng.uniform(
            -0.9, 0.9, (self.s.B, cfg.num_points, 3)).astype(
                np.float32)).to(self.dev)
        msk = torch.ones(pts.shape[:2], dtype=torch.bool, device=self.dev)
        plan = build_model_plan(cfg, pts, msk)
        d = self.s.depth if depth_use is None else depth_use
        return plan.neighs[plan.octree.level(d)], plan

    def rand(self, rng, *shape, scale=1.0):
        return torch.from_numpy((rng.normal(0, scale, shape)).astype(
            np.float32)).to(self.dev)

    # -- experiments ------------------------------------------------------
    def band(self):
        from hotformerloc_torch.ops import conv as plain
        from hotformerloc_torch.ops.kernels import octree_conv as kconv
        neigh, plan = self.plan()
        taps = plan.taps[plan.octree.level(self.s.depth)]
        B, N, _ = neigh.shape
        rng = np.random.default_rng(1)
        tb = TOL_BWD[self.dtype]
        for C in self.s.channels:
            x = self.rand(rng, B, N, C).to(self.dtype)
            w = self.rand(rng, 27, C, scale=0.2)
            wc = w.to(self.dtype)
            out = kconv.octree_dwconv(x, neigh, w, taps)
            ref = plain.octree_dwconv(x, neigh, wc)
            err = _check(f"K3 C{C}", out, ref, TOL_FWD[self.dtype],
                         self.dtype != torch.float32)
            self.record(
                f"band_dw_fwd_C{C}", maxdiff=err,
                ms=_ms(lambda: kconv.octree_dwconv(x, neigh, w, taps),
                       self.iters),
                flat_ms=_ms(lambda: plain.octree_dwconv(x, neigh, wc),
                            self.iters))
            dy = self.rand(rng, B, N, C).to(self.dtype)
            dx, dw = kconv.octree_dwconv_bwd(x, neigh, wc, dy, True, taps)
            rdx, rdw = plain.octree_dwconv_bwd(x, neigh, wc, dy, True)
            err = max(_check(f"K4 dx C{C}", dx, rdx, tb["act"]),
                      _check(f"K4 dw C{C}", dw, rdw, tb["weight"]))

            def fb(fn, x=x, w=w):
                xg = x.detach().requires_grad_(True)
                wg = w.detach().requires_grad_(True)
                (fn(xg, wg).float() ** 2).sum().backward()
                return xg.grad, wg.grad

            self.record(
                f"band_dw_bwd_C{C}", maxdiff=err,
                ms=_ms(lambda: fb(lambda a, b: kconv.octree_dwconv(
                    a, neigh, b, taps)), self.iters),
                flat_ms=_ms(lambda: fb(lambda a, b: plain.octree_dwconv(
                    a, neigh, b.to(a.dtype))), self.iters))
        C = O = self.s.conv
        x = self.rand(rng, B, N, C).to(self.dtype)
        w2 = self.rand(rng, 27, C, O, scale=0.1)
        b2 = torch.zeros(O, device=self.dev)
        out = kconv.octree_conv(x, neigh, w2, b2, taps)
        ref = plain.octree_conv(x, neigh, w2.to(self.dtype),
                                b2.to(self.dtype))
        err = _check(f"K5 C{C} O{O}", out, ref, TOL_FWD[self.dtype],
                     self.dtype != torch.float32)
        self.record(
            f"band_conv_fwd_C{C}_O{O}", maxdiff=err,
            ms=_ms(lambda: kconv.octree_conv(x, neigh, w2, b2, taps),
                   self.iters),
            flat_ms=_ms(lambda: plain.octree_conv(
                x, neigh, w2.to(self.dtype), b2.to(self.dtype)),
                self.iters))

    def cpe(self):
        from hotformerloc_torch.ops.kernels import octree_conv as kconv
        neigh, plan = self.plan()
        taps = plan.taps[plan.octree.level(self.s.depth)]
        B, N, _ = neigh.shape
        rng = np.random.default_rng(2)
        for C in self.s.channels:
            x = self.rand(rng, B, N, C).to(self.dtype)
            w = self.rand(rng, 27, C, scale=0.2)

            def fb():
                xg = x.detach().requires_grad_(True)
                wg = w.detach().requires_grad_(True)
                (kconv.octree_dwconv(xg, neigh, wg, taps).float()
                 ** 2).sum().backward()
                return xg.grad, wg.grad
            self.record(f"cpe_flat_fwd_C{C}", ms=_ms(
                lambda: kconv.octree_dwconv(x, neigh, w, taps), self.iters))
            self.record(f"cpe_flat_fwdbwd_C{C}", ms=_ms(fb, self.iters))

    def dense(self):
        import torch.nn.functional as F

        from hotformerloc_torch.ops import conv as plain
        from hotformerloc_torch.ops.kernels import octree_conv as kconv
        _, plan = self.plan()
        oc = plan.octree
        rng = np.random.default_rng(3)
        C = self.s.channels[0]
        for d in self.s.dense_depths:
            neigh = plan.neighs[oc.level(d)]
            taps = plan.taps[oc.level(d)]
            B, N, _ = neigh.shape
            x = self.rand(rng, B, N, C).to(self.dtype)
            w = self.rand(rng, 27, C, scale=0.2)
            D = 2 ** d
            vox = plain.dense_voxel_index(oc.key(d), oc.count(d), d)
            xyz, valid = oc.xyz(d), oc.node_valid(d)

            def dense_fn(a, b):
                return plain.octree_dwconv_dense(a, xyz, valid, b, d, vox)

            def k3_fn(a, b):
                return kconv.octree_dwconv(a, neigh, b, taps)

            def fb(fn):
                xg = x.detach().requires_grad_(True)
                wg = w.detach().requires_grad_(True)
                (fn(xg, wg).float() ** 2).sum().backward()
                return xg.grad, wg.grad

            grid = plain._gather_rows(x, vox).reshape(
                B, D, D, D, C).permute(0, 4, 1, 2, 3).contiguous()
            wk = w.t().reshape(C, 1, 3, 3, 3).to(self.dtype)
            err = float((dense_fn(x, w).float() - k3_fn(x, w).float())
                        .abs().max())
            self.record(
                f"dense_cpe_fwd_d{d}", k3_ms=_ms(lambda: k3_fn(x, w),
                                                 self.iters),
                dense_ms=_ms(lambda: dense_fn(x, w), self.iters),
                conv3d_ms=_ms(lambda: F.conv3d(grid, wk, padding=1,
                                               groups=C), self.iters),
                dense_vs_k3_maxdiff=err)
            self.record(f"dense_cpe_fwdbwd_d{d}",
                        k3_ms=_ms(lambda: fb(k3_fn), self.iters),
                        dense_ms=_ms(lambda: fb(dense_fn), self.iters))

    def rtsa(self):
        from hotformerloc_torch.models.attention import TokenAttention
        B, M, C, H = self.s.rtsa
        rng = np.random.default_rng(4)
        mod = TokenAttention(C, H, device=self.dev)
        x = self.rand(rng, B, M, C).to(self.dtype)
        mask = torch.ones((B, M), dtype=torch.bool, device=self.dev)

        def fb():
            xg = x.detach().requires_grad_(True)
            (mod(xg, mask).float() ** 2).sum().backward()
            return xg.grad
        with torch.no_grad():
            fwd = _ms(lambda: mod(x, mask), self.iters)
        self.record("rtsa_fwd", ms=fwd)
        self.record("rtsa_fwdbwd", ms=_ms(fb, self.iters))

    def pool(self):
        from hotformerloc_torch.models.pooling import PyramidAttnPool
        Ns, C, ks = self.s.pool
        rng = np.random.default_rng(5)
        mod = PyramidAttnPool(C, C, (C,) * len(Ns), ks, "mixer",
                              device=self.dev)
        toks = [self.rand(rng, self.s.B, n, C).to(self.dtype) for n in Ns]
        masks = [torch.ones((self.s.B, n), dtype=torch.bool,
                            device=self.dev) for n in Ns]

        def fb():
            ts = [t.detach().requires_grad_(True) for t in toks]
            (mod(ts, masks).float() ** 2).sum().backward()
            return [t.grad for t in ts]
        with torch.no_grad():
            fwd = _ms(lambda: mod(toks, masks), self.iters)
        self.record("pool_fwd", ms=fwd)
        self.record("pool_fwdbwd", ms=_ms(fb, self.iters))

    def noremat(self):
        from hotformerloc_torch.losses.losses import make_loss
        from hotformerloc_torch.models.hotformerloc import HOTFormerLoc
        from hotformerloc_torch.tools.bisect_step import pair_batch
        loss_fn = make_loss("truncatedsmoothap",
                            positives_per_query=1 if self.s.tiny else 4)
        for tag, ckpt in (("noremat", False), ("save_hot", True)):
            cfg = self.s.cfg(grad_checkpoint=ckpt, remat_policy="save_hot")
            model = HOTFormerLoc(cfg, device=self.dev, dtype=self.dtype,
                                 generator=torch.Generator().manual_seed(0))
            model.train()
            b = pair_batch(self.s.B, cfg.num_points, self.dev)

            def grad():
                model.zero_grad(set_to_none=True)
                loss = loss_fn(model(b["points"], b["pmask"])["global"],
                               b["positives_mask"],
                               b["negatives_mask"])[0]
                loss.backward()
                return [p.grad for p in model.parameters()
                        if p.grad is not None]
            cuda = self.dev.type == "cuda"
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(self.dev)
            ms = _ms(grad, max(2, self.iters // 4))
            self.record(f"grad_mb{self.s.B}_{tag}", ms=ms,
                        peak_mem_gb=(torch.cuda.max_memory_allocated(
                            self.dev) / 1e9 if cuda else None))
            del model
            if cuda:
                torch.cuda.empty_cache()


def run(argv: Optional[Sequence[str]] = None):
    """Run the experiments; returns (the printed lines, all results)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--exp", default="all")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=RESULTS_PATH)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny shapes (CPU checks)")
    args = ap.parse_args(argv)
    want = list(EXPERIMENTS) if args.exp == "all" else args.exp.split(",")
    if set(want) - set(EXPERIMENTS):
        raise ValueError(f"unknown experiments "
                         f"{sorted(set(want) - set(EXPERIMENTS))}")
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    dev = torch.device(args.device)
    results["device"] = (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu")
    results["nvidia_smi"] = smi_line() if dev.type == "cuda" else None
    results["shapes"] = "tiny" if args.tiny else "oxford microbatch 8"
    prof = Profiler(Shapes(args.tiny), dev, args.iters, results)
    for name in want:
        getattr(prof, name)()
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return prof.lines, results


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
