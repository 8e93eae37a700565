#!/usr/bin/env python3
"""Smoke run of hotformerloc_torch on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases, each printed as a JSON line; any failed check raises and the
script exits non-zero without the final line:

1. device: the card's name and, as nvidia-smi reports them, name and
   power limit. No CUDA device -> exit 1.
2. build: nvcc builds every kernel source of the package (seconds).
3. kernels: each CUDA kernel of the serving path (K1 window attention,
   K3 depthwise octree conv, K5 full octree conv) at every shape the
   oxford_config forward gives it, batch 32, on real neighbour tables and
   window coordinates from the package's own octree build: kernel vs its
   plain PyTorch version on the card at fp32 and bf16 (tolerances in
   TOL), and CUDA-event times (median of REPS launches after warm-up) of
   the kernel, the plain version and, for K1, scaled_dot_product_attention
   given a materialised bias (a yardstick the package never calls).
4. slice: oxford_config with seeded random weights embeds 32 synthetic
   clouds (16 uniform clouds of 4096 points, each twice with sigma 0.01
   noise) through make_embed_fn in bf16 and fp32. The launch counters,
   zeroed just before the bf16 run and read just after, must show K1=34,
   K3=24, K5=3; descriptors must be finite and unit-norm with no octree
   overflow; the fp32 kernel descriptors must match the plain path on
   the same card (cos >= 0.9999, max abs <= 1e-4). Retrieval recall@1 of
   the noisy copies against the originals is printed for information
   (the weights are random), with bf16 ms/batch and submaps/s.
5. the kernels line {"kernels": [...]}, then {"ok": true, "device": ...}.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# fp32: kernel and plain version sum the same products in fp32; K5 sums
# up to 27*128 of them. bf16: both accumulate in fp32 and round the
# output once, so they differ by about one bf16 ulp of the output.
TOL = {"fp32": {"window_attn": 1e-5, "octree_dwconv": 1e-5,
                "octree_conv": 1e-4},
       "bf16_rel": 1e-2}
REPS = 20
BATCH = 32
HBM_BYTES_S = 3.35e12                                # H100 SXM
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}         # CUDA cores / tensor
REPLACES = {
    "window_attn": "hotformerloc_tpu/ops/pallas/window_attn.py:147",
    "octree_dwconv": "hotformerloc_tpu/ops/pallas/band_conv.py:193",
    "octree_conv": "hotformerloc_tpu/ops/pallas/band_conv.py:242",
}
SOURCES = {"window_attn": "hotformerloc_torch/csrc/window_attn.cu",
           "octree_dwconv": "hotformerloc_torch/csrc/octree_conv.cu",
           "octree_conv": "hotformerloc_torch/csrc/octree_conv.cu"}


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        f"nvidia-smi failed: {r.stderr.strip()}"


def time_ms(torch, fn, reps=REPS):
    """Median CUDA-event time of one call, after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def clouds(seed=0):
    """bench.py's synthetic batch: 16 uniform(-0.9, 0.9) clouds of 4096
    points, each twice with N(0, 0.01) noise (pairs 2i, 2i+1)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-0.9, 0.9, (BATCH // 2, 4096, 3)).astype(np.float32)
    pts = np.repeat(base, 2, axis=0)
    pts += rng.normal(0, 0.01, pts.shape).astype(np.float32)
    return pts


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from hotformerloc_torch.ops import kernels
    except ImportError as e:
        print(f"chip_smoke: hotformerloc_torch not found ({e})",
              file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from hotformerloc_torch.evaluation.embed import make_embed_fn
    from hotformerloc_torch.evaluation.evaluate import retrieval_topk
    from hotformerloc_torch.models.config import oxford_config
    from hotformerloc_torch.models.hotformerloc import HOTFormerLoc
    from hotformerloc_torch.models.layers import rpe_pos_bnd
    from hotformerloc_torch.octree.build import build_batched_octree
    from hotformerloc_torch.ops import conv as plain
    from hotformerloc_torch.ops import window as ow
    from hotformerloc_torch.ops.kernels import build
    from hotformerloc_torch.ops.kernels import octree_conv as kconv
    from hotformerloc_torch.ops.kernels import window_attn as kattn
    from hotformerloc_torch.ops.plan import build_plan
    from hotformerloc_torch.ops.rpe import rpe_bias_reference

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.time()

    # ---- 1. device -----------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(smi, flush=True)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---- 2. build ------------------------------------------------------
    t0 = time.time()
    build.build_all()
    ptxas = {k: [ln.strip() for ln in v.splitlines() if "Used" in ln
                 or "spill" in ln] for k, v in build.PTXAS_LOG.items()}
    emit({"phase": "build", "seconds": round(time.time() - t0, 2),
          "ptxas": ptxas})

    # ---- 3. kernels at the main path's shapes ----------------------------
    cfg = oxford_config()
    pts = torch.from_numpy(clouds()).to(dev)
    pmask = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
    octree = build_batched_octree(pts, pmask, cfg.octree_depth,
                                  cfg.min_depth, cfg.resolve_capacities())
    plan = build_plan(octree, cfg.dense_depths())
    g = torch.Generator().manual_seed(1)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    P = cfg.patch_size
    nb_octf, nb_hotf = cfg.num_blocks[0], cfg.num_blocks[-1]
    octf_c, octf_h = cfg.channels[0], cfg.num_heads[0]
    _, pyr_c = cfg.stage_channels()
    _, pyr_h = cfg.stage_heads()
    td = cfg.transformer_depth
    # (label, depth, C, H, dilation, G, launches per forward)
    attn_cases = [("octf_dil1", td, octf_c, octf_h, 1, 0,
                   (nb_octf + 1) // 2),
                  ("octf_dil%d" % cfg.dilation, td, octf_c, octf_h,
                   cfg.dilation, 0, nb_octf // 2)]
    attn_cases += [(f"hosa_d{d}", d, pyr_c[j], pyr_h[j], 1, 1, nb_hotf)
                   for j, d in enumerate(cfg.pyramid_depths)]
    dw_cases = [(f"cpe_d{td}", td, octf_c, nb_octf)]
    dw_cases += [(f"cpe_d{d}", d, pyr_c[j], nb_hotf)
                 for j, d in enumerate(cfg.pyramid_depths)
                 if d > cfg.dense_cpe_max_depth]
    chans = [int(octf_c * 2**i) for i in range(-cfg.stem_down, 1)]
    conv_cases = [(f"stem_conv{i}_d{cfg.octree_depth - i}",
                   cfg.octree_depth - i, 3 if i == 0 else chans[i],
                   chans[i], 1) for i in range(cfg.stem_down)]
    conv_cases.append((f"stem_proj_d{td}", td, chans[-1], chans[-1], 1))

    def bound(nbytes, flops, dt):
        tb, tf = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dt]
        return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"

    def compare(out, ref, kernel, dt):
        err = float((out.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        lim = (TOL["fp32"][kernel] if dt == "fp32"
               else TOL["bf16_rel"] * max(1.0, scale))
        if not (err <= lim and torch.isfinite(out.float()).all()):
            raise AssertionError(f"{kernel} {dt}: max |kernel - plain| = "
                                 f"{err} > {lim}")
        return err

    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    results = {"window_attn": [], "octree_dwconv": [], "octree_conv": []}

    for label, d, C, H, D, G, per_fwd in attn_cases:
        ctx = plan.level_ctx(d)
        K = P
        T = K + G
        xyz_w = ow.data_to_windows(ctx.xyz, K, D)           # (B, W, K, 3)
        B, W = xyz_w.shape[:2]
        BW = B * W
        xyz = xyz_w.permute(0, 1, 3, 2).reshape(BW, 3, K).to(
            torch.int32).contiguous()
        nmask = ow.window_key_mask(ctx.node_valid, K, D)
        kmask = torch.cat([nmask.any(-1, keepdim=True), nmask], -1) \
            if G else nmask
        mask = kmask.reshape(BW, T).to(torch.int32).contiguous()
        bnd = rpe_pos_bnd(P, D)
        table = rnd(3 * (2 * bnd + 1), H, scale=0.5).float()
        qkv32 = [rnd(BW, T, C) for _ in range(3)]
        row = {"case": label, "shape": [BW, T, C], "heads": H, "bnd": bnd,
               "per_forward": per_fwd}
        for dt, tdt in dtypes.items():
            q, k, v = (t.to(tdt) for t in qkv32)
            args = (q, k, v, xyz, mask, table, H, bnd)
            out = kattn.window_attention(*args)
            ref = kattn.window_attention_reference(*args)
            row[f"err_{dt}"] = compare(out, ref, "window_attn", dt)
            row[f"ms_{dt}"] = time_ms(torch, lambda: kattn.window_attention(
                *args))
            row[f"plain_ms_{dt}"] = time_ms(
                torch, lambda: kattn.window_attention_reference(*args))
            # yardstick: SDPA with the bias and key mask materialised
            hd = C // H
            qh, kh, vh = (t.reshape(BW, T, H, hd).transpose(1, 2)
                          for t in (q, k, v))
            bias = torch.zeros(BW, H, T, T, device=dev)
            xyz_f = xyz.transpose(1, 2)[None]
            bias[:, :, G:, G:] = rpe_bias_reference(table.t(), xyz_f,
                                                    bnd)[0]
            bias = bias + torch.where(mask > 0, 0.0, -1e9)[:, None, None, :]
            bias = bias.to(tdt)
            row[f"library_ms_{dt}"] = time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=bias))
            esz = q.element_size()
            nbytes = (4 * BW * T * C * esz + xyz.numel() * 4
                      + mask.numel() * 4 + table.numel() * 4)
            flops = 4 * BW * T * T * C
            row[f"bound_ms_{dt}"], row[f"bound_by_{dt}"] = bound(
                nbytes, flops, dt)
            del bias
        results["window_attn"].append(row)
        emit({"phase": "kernel", "kernel": "window_attn", **row})

    for label, d, C, per_fwd in dw_cases:
        neigh = plan.neighs[octree.level(d)]
        B, N, _ = neigh.shape
        taps = int((neigh >= 0).sum())
        x32, w32 = rnd(B, N, C), rnd(27, C, scale=(27 * C) ** -0.5)
        row = {"case": label, "shape": [B, N, C], "valid_taps": taps,
               "per_forward": per_fwd}
        for dt, tdt in dtypes.items():
            x, w = x32.to(tdt), w32.to(tdt)
            out = kconv.octree_dwconv(x, neigh, w)
            ref = plain.octree_dwconv(x, neigh, w)
            row[f"err_{dt}"] = compare(out, ref, "octree_dwconv", dt)
            row[f"ms_{dt}"] = time_ms(torch, lambda: kconv.octree_dwconv(
                x, neigh, w))
            row[f"plain_ms_{dt}"] = time_ms(
                torch, lambda: plain.octree_dwconv(x, neigh, w))
            row[f"library_ms_{dt}"] = None
            nbytes = (2 * B * N * C * x.element_size() + neigh.numel() * 4
                      + w.numel() * w.element_size())
            row[f"bound_ms_{dt}"], row[f"bound_by_{dt}"] = bound(
                nbytes, 2 * taps * C, dt)
        results["octree_dwconv"].append(row)
        emit({"phase": "kernel", "kernel": "octree_dwconv", **row})

    for label, d, C, O, per_fwd in conv_cases:
        neigh = plan.neighs[octree.level(d)]
        B, N, _ = neigh.shape
        taps = int((neigh >= 0).sum())
        x32 = rnd(B, N, C)
        w32, b32 = rnd(27, C, O, scale=(27 * C) ** -0.5), rnd(O, scale=0.1)
        row = {"case": label, "shape": [B, N, C, O], "valid_taps": taps,
               "per_forward": per_fwd}
        for dt, tdt in dtypes.items():
            x, w, b = x32.to(tdt), w32.to(tdt), b32.to(tdt)
            out = kconv.octree_conv(x, neigh, w, b)
            ref = plain.octree_conv(x, neigh, w, b)
            row[f"err_{dt}"] = compare(out, ref, "octree_conv", dt)
            row[f"ms_{dt}"] = time_ms(torch, lambda: kconv.octree_conv(
                x, neigh, w, b))
            row[f"plain_ms_{dt}"] = time_ms(
                torch, lambda: plain.octree_conv(x, neigh, w, b))
            row[f"library_ms_{dt}"] = None
            esz = x.element_size()
            nbytes = (B * N * (C + O) * esz + neigh.numel() * 4
                      + (w.numel() + O) * esz)
            row[f"bound_ms_{dt}"], row[f"bound_by_{dt}"] = bound(
                nbytes, 2 * taps * C * O, dt)
        results["octree_conv"].append(row)
        emit({"phase": "kernel", "kernel": "octree_conv", **row})
    torch.cuda.synchronize()
    del octree, plan

    # ---- 4. the slice: embed 32 clouds ---------------------------------
    model = HOTFormerLoc(cfg, device="cuda",
                         generator=torch.Generator().manual_seed(0))
    embed_bf16 = make_embed_fn(model, torch.bfloat16)
    embed_fp32 = make_embed_fn(model, torch.float32)
    plain_model = HOTFormerLoc(cfg, device="cuda",
                               generator=torch.Generator().manual_seed(0))
    plain_model.set_use_kernels(False)
    embed_plain = make_embed_fn(plain_model, torch.float32)

    kernels.reset_launches()
    out_bf16 = embed_bf16(pts, pmask)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    want = {k: sum(r["per_forward"] for r in rows)
            for k, rows in results.items()}
    if want != {"window_attn": 34, "octree_dwconv": 24, "octree_conv": 3}:
        raise AssertionError(f"main-path shape table is off: {want}")
    if launches != want:
        raise AssertionError(f"launches {launches} != expected {want}")

    kernels.reset_launches()
    out_fp32 = embed_fp32(pts, pmask)
    if dict(kernels.LAUNCHES) != want:
        raise AssertionError(f"fp32 launches {kernels.LAUNCHES}")
    kernels.reset_launches()
    out_plain = embed_plain(pts, pmask)
    if any(kernels.LAUNCHES.values()):
        raise AssertionError(f"plain path launched {kernels.LAUNCHES}")

    checks = {}
    for tag, out in (("bf16", out_bf16), ("fp32", out_fp32),
                     ("plain_fp32", out_plain)):
        gdesc = out["global"]
        if gdesc.shape != (BATCH, cfg.output_dim):
            raise AssertionError(f"{tag}: descriptor shape {gdesc.shape}")
        if not torch.isfinite(gdesc).all():
            raise AssertionError(f"{tag}: non-finite descriptors")
        norm_err = float((gdesc.norm(dim=1) - 1).abs().max())
        if norm_err > 1e-4:
            raise AssertionError(f"{tag}: descriptors not unit norm "
                                 f"({norm_err})")
        if int(out["octree_overflow"]) != 0 or int(out["band_overflow"]):
            raise AssertionError(f"{tag}: overflow "
                                 f"{int(out['octree_overflow'])}")
    gk, gp = out_fp32["global"], out_plain["global"]
    cos = float((gk * gp).sum(1).min())
    maxabs = float((gk - gp).abs().max())
    if not (cos >= 0.9999 and maxabs <= 1e-4):
        raise AssertionError(f"fp32 kernel vs plain descriptors: cos {cos}, "
                             f"max abs {maxabs}")
    cos_bf16 = float((out_bf16["global"] * gp).sum(1).min())
    checks.update(fp32_kernel_vs_plain_min_cos=cos,
                  fp32_kernel_vs_plain_max_abs=maxabs,
                  bf16_vs_fp32_plain_min_cos=cos_bf16)

    desc = out_bf16["global"].cpu().numpy()
    _, idx = retrieval_topk(desc[1::2], desc[0::2], k=1)
    recall1 = float(np.mean(idx[:, 0] == np.arange(BATCH // 2)))

    def run():
        embed_bf16(pts, pmask)
        torch.cuda.synchronize()

    run()
    host_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        run()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(host_ms)

    def octree_and_plan():
        with torch.inference_mode():
            oc = build_batched_octree(pts, pmask, cfg.octree_depth,
                                      cfg.min_depth, cfg.resolve_capacities())
            build_plan(oc, cfg.dense_depths())
        torch.cuda.synchronize()

    octree_and_plan()
    plan_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        octree_and_plan()
        plan_ms.append((time.perf_counter() - t0) * 1e3)
    emit({"phase": "slice", "config": "oxford_config", "batch": BATCH,
          "launches_per_forward": launches, **checks,
          "recall_at_1_random_weights": recall1,
          "embed_bf16_ms_per_batch": ms,
          "embed_bf16_ms_all": host_ms,
          "octree_plan_ms": statistics.median(plan_ms),
          "submaps_per_s_bf16": BATCH / (ms / 1e3),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})

    # ---- 5. kernels line + result --------------------------------------
    line = []
    for kname, rows in results.items():
        def per_fwd(key):
            vals = [r[key] for r in rows]
            if any(v is None for v in vals):
                return None
            return sum(v * r["per_forward"] for v, r in zip(vals, rows))
        bound_ms = per_fwd("bound_ms_bf16")
        by = {r["bound_by_bf16"] for r in rows}
        line.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": launches[kname],
            "max_abs_err": max(r["err_fp32"] for r in rows),
            "max_abs_err_bf16": max(r["err_bf16"] for r in rows),
            "ms": per_fwd("ms_bf16"), "plain_ms": per_fwd("plain_ms_bf16"),
            "bound_ms": bound_ms,
            "bound_by": "bytes" if by == {"bytes"} else "operations",
            "library_ms": per_fwd("library_ms_bf16"),
            "ms_fp32": per_fwd("ms_fp32"),
            "plain_ms_fp32": per_fwd("plain_ms_fp32"),
            "bound_ms_fp32": per_fwd("bound_ms_fp32"),
            "units": "ms per forward of batch 32 (bf16 unless _fp32), "
                     "summed over the main path's launches"})
    emit({"phase": "done", "seconds": round(time.time() - t_start, 1)})
    print(smi, flush=True)
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
