"""LayerNorm on the card: layer_norm_rows_kernel at the serving forward's
shapes, against its plain version, aten's kernel and its bytes bound, on
its serving path (a direct launch) and its training path (the op
``hotformerloc::layer_norm`` with its statistics, and ``LayerNormFn``'s
backward on them).

    python -m hotformerloc_torch.tools.norm_bench [--device cuda|cpu]
        [--reps 30] [--out DIR]

For each served configuration (``oxford_config`` at batch 32 and
``cs_wild_places_config`` at batch 128; with ``--device cpu``,
``tiny_test_config`` at batch 2) one bf16 serving forward
(``make_embed_fn`` on uniform clouds, 4096 points) records the input
shape of every LayerNorm it calls, and the tool prints, as JSON lines:

  head      the device, nvidia-smi's name and power limit, torch
  shape     one per distinct (M rows, C) of a configuration, in bf16 and
            in fp32, on inputs x ~ N(1, 9), w ~ N(1, .25), b ~ N(0, .25):
            ``calls`` per forward. Serving: ``err_ulp``, the largest
            difference of the kernel's output from the fp32-statistics
            result (F.layer_norm of the fp32 inputs) in bf16 ulps of that
            result, the ulp floored at 2^-10's (fp32 rounding in the
            statistics moves a result near 0 by more than its own ulp),
            or ``err_abs`` at fp32. Training, against aten on the same
            inputs: ``y_stats_same``, the op's y equal to the serving
            launch's bit for bit; ``mean_err``, the op's mean off
            ``torch.native_layer_norm``'s by at most this many of the
            row's standard deviations (|d mean| * rstd); ``rstd_err``,
            its rstd off by at most this share; ``dx_err``, ``dw_err``,
            ``db_err``, LayerNormFn's gradients for one N(0, 1) output
            gradient off autograd of F.layer_norm's by at most this share
            of the largest reference value. Time: ``device_ms``
            (torch.profiler, the kernel alone) beside ``aten_device_ms``
            (F.layer_norm, aten's kernel, same inputs), ``bound_ms`` (x
            read once and y written once at 3.35 TB/s) and ``roofline`` =
            bound / time. Each timed call reads another of a ring of
            input copies (more than 100 MB in all), so x comes from
            device memory and not from the 50 MB L2, as for the forward's
            larger norms.
  summary   per configuration: the forward's LayerNorm bound over the
            kernel's time, summed over its calls (``roofline_all``), and
            at the widest rows (``roofline_widest``)

A check that fails raises, and the tool exits non-zero: bf16 within one
ulp, fp32 within ``FP32_TOL``; the op's y equal to the serving launch's,
its statistics within ``STATS_TOL`` and the gradients within
``GRAD_TOL`` of aten's. On the CPU every path runs aten (the plain
version): the lines hold the checks, and every device number is None.
The tool writes a file only under ``--out`` (norm_bench.json).
"""
from __future__ import annotations

import argparse
import json
import os
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

from hotformerloc_torch.ops.kernels import norm as knorm
from hotformerloc_torch.tools.gather_bench import device_name, parse_device
from hotformerloc_torch.utils import profiling

EPS = 1e-5
RING_BYTES = 100 * 2 ** 20
FP32_TOL = 1e-5
# The training path's limits, set from the worst readings over both
# served configurations' shapes on an H100 (NVIDIA H100 80GB HBM3, 700 W):
# mean 2.1e-7 and rstd 2.5e-7 (the two fp32 reductions' rounding); dx, dw
# 2.7e-7 at fp32; .0024 in bf16, where the backward's output rounds to
# bf16 and one ulp of the largest value is at most 2^-7 of it.
STATS_TOL = 2e-6
GRAD_TOL = {torch.float32: 2e-6, torch.bfloat16: 2.0 ** -7}


def configs(dev: torch.device):
    """(name, ModelConfig, batch) of the served configurations."""
    from hotformerloc_torch.models import config as mcfg
    if dev.type == "cpu":
        return [("tiny_test_config", mcfg.tiny_test_config(), 2)]
    return [("oxford", mcfg.oxford_config(), 32),
            ("cs-wild-places", mcfg.cs_wild_places_config(), 128)]


def bf16_ulps(y, ref) -> float:
    """max |y - ref| in bf16 ulps of ref, the ulp floored at 2^-10's."""
    mag = ref.abs().clamp_min(2.0 ** -10)
    ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
    return float(((y.float() - ref).abs() / ulp).max())


def device_ms(fn, dev, reps) -> float | None:
    return profiling.device_ms(fn, iters=reps) if dev.type == "cuda" \
        else None


def train_readings(x, w, b, y_serve, gen) -> dict:
    """The training path at one shape against aten: the op's (y, mean,
    rstd) against torch.native_layer_norm's, LayerNormFn's (dx, dw, db)
    against autograd of F.layer_norm's."""
    C = x.shape[-1]
    y, mean, rstd = knorm.layer_norm_op(x, w, b, EPS)
    _, mean_ref, rstd_ref = (t.float() for t in torch.native_layer_norm(
        x, (C,), w, b, EPS))
    out = {"y_stats_same": bool(torch.equal(y, y_serve)),
           "mean_err": float(((mean.float() - mean_ref).abs()
                              * rstd_ref).max()),
           "rstd_err": float(((rstd.float() - rstd_ref).abs()
                              / rstd_ref).max())}
    del y, mean, rstd, mean_ref, rstd_ref
    g = torch.randn(x.shape, generator=gen).to(x.device, x.dtype)
    ins, refs = ([t.detach().requires_grad_() for t in (x, w, b)]
                 for _ in range(2))
    knorm.LayerNormFn.apply(*ins, EPS).backward(g)
    F.layer_norm(refs[0], (C,), refs[1], refs[2], EPS).backward(g)
    for name, t, r in zip(("dx", "dw", "db"), ins, refs):
        out[f"{name}_err"] = float((t.grad - r.grad).abs().max()
                                   / r.grad.abs().max())
    return out


def shape_line(name, M, C, calls, dtype, dev, reps, gen):
    x32 = torch.randn(M, C, generator=gen).mul_(3).add_(1).to(dev)
    w32 = (1 + 0.5 * torch.randn(C, generator=gen)).to(dev)
    b32 = (0.5 * torch.randn(C, generator=gen)).to(dev)
    x, w, b = (t.to(dtype) for t in (x32, w32, b32))
    ref = F.layer_norm(x.float(), (C,), w.float(), b.float(), EPS)
    y = knorm.layer_norm(x, w, b, EPS)
    line = {"config": name, "shape": [M, C], "dtype": str(dtype)[6:],
            "calls": calls}
    if dtype == torch.bfloat16:
        line["err_ulp"] = bf16_ulps(y, ref)
        line["differs_from_aten"] = int(
            (y != F.layer_norm(x, (C,), w, b, EPS)).sum())
        bad = line["err_ulp"] > 1.0
    else:
        line["err_abs"] = float((y - ref).abs().max())
        bad = line["err_abs"] > FP32_TOL
    del ref, x32
    line.update(train_readings(x, w, b, y, gen))
    del y
    bad |= not line["y_stats_same"]
    bad |= max(line["mean_err"], line["rstd_err"]) > STATS_TOL
    bad |= max(line[f"{k}_err"] for k in ("dx", "dw", "db")) > GRAD_TOL[dtype]
    if bad:
        raise AssertionError(f"layer_norm off its limits: {line}")
    nbytes = 2 * M * C * x.element_size() + 2 * C * x.element_size()
    ring = [x] + [x.clone() for _ in range(min(
        15, RING_BYTES // (M * C * x.element_size())))]
    turn = iter(range(1 << 62))

    def kernel():
        return knorm.layer_norm(ring[next(turn) % len(ring)], w, b, EPS)

    def aten():
        return F.layer_norm(ring[next(turn) % len(ring)], (C,), w, b, EPS)

    with torch.inference_mode():
        line["device_ms"] = device_ms(kernel, dev, reps)
        line["aten_device_ms"] = device_ms(aten, dev, reps)
    line["bound_ms"] = profiling.bound_ms(nbytes, 8 * M * C, "fp32")[0]
    for k, t in (("roofline", "device_ms"), ("aten_roofline",
                                             "aten_device_ms")):
        line[k] = None if line[t] is None else \
            100 * line["bound_ms"] / line[t]
    return line


def forward_shapes(cfg, batch, dev) -> Counter:
    """{(M rows, C): calls} of the LayerNorms one bf16 serving forward
    calls."""
    from hotformerloc_torch.evaluation.embed import make_embed_fn
    from hotformerloc_torch.models.hotformerloc import HOTFormerLoc
    from hotformerloc_torch.models.layers import LayerNorm

    model = HOTFormerLoc(cfg, device=dev,
                         generator=torch.Generator().manual_seed(0))
    model.to(torch.bfloat16)
    embed = make_embed_fn(model, torch.bfloat16, graphs=False)   # hooks
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.uniform(-0.9, 0.9, (
        batch, cfg.num_points, 3)).astype(np.float32)).to(dev)
    pmask = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
    shapes = Counter()
    for m in model.modules():
        if isinstance(m, LayerNorm):
            m.register_forward_pre_hook(lambda mod, args: shapes.update(
                [(args[0].numel() // args[0].shape[-1], args[0].shape[-1])]))
    embed(pts, pmask)
    profiling.block(pts)
    return shapes


def summary_line(name, lines) -> dict:
    bf = [ln for ln in lines if ln["dtype"] == "bfloat16"]
    out = {"summary": name}
    if bf[0]["device_ms"] is None:
        return out
    widest = max(ln["shape"][1] for ln in bf)
    for key, sel in (("all", bf), ("widest",
                                   [ln for ln in bf
                                    if ln["shape"][1] == widest])):
        bound = sum(ln["calls"] * ln["bound_ms"] for ln in sel)
        for side in ("", "aten_"):
            t = sum(ln["calls"] * ln[f"{side}device_ms"] for ln in sel)
            out[f"{side}roofline_{key}"] = 100 * bound / t
            out[f"{side}ms_{key}"] = t
        out[f"bound_ms_{key}"] = bound
    return out


def run(argv=None) -> list:
    """The tool's work: prints its lines and returns them."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = parse_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lines = [{"head": device_name(dev), "nvidia_smi": profiling.smi_line()
              if dev.type == "cuda" else None, "torch": torch.__version__}]
    print(json.dumps(lines[0]), flush=True)
    gen = torch.Generator().manual_seed(1)
    for name, cfg, batch in configs(dev):
        calls = forward_shapes(cfg, batch, dev)
        shapes = []
        for (M, C), n in sorted(calls.items(),
                                key=lambda kv: -kv[0][0] * kv[0][1]):
            for dt in (torch.bfloat16, torch.float32):
                shapes.append(shape_line(name, M, C, n, dt, dev, args.reps,
                                         gen))
                print(json.dumps(shapes[-1]), flush=True)
        lines += [*shapes, summary_line(name, shapes)]
        print(json.dumps(lines[-1]), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, "norm_bench.json")
        with open(path, "w") as fh:
            json.dump(lines, fh, indent=1)
        print(f"wrote {path}", flush=True)
    return lines


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
