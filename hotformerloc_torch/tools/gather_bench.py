"""A/B of octree depthwise-conv gather formulations on the card.

    python -m hotformerloc_torch.tools.gather_bench [--device cuda|cpu]
        [--batch 8] [--reps 20] [--out DIR]

Counterpart of hotformerloc_tpu/tools/gather_bench.py, at its shape: the
hosa0 CPE (B=8, N=4224, C=256, K=27, bf16) on real neighbour tables from
the port's own octree build and plan of ``oxford_config`` (the same
clouds: ``default_rng(0)`` uniform in +-0.9, 4096 points). Prints the
device, the locality census of the tables (|neigh - node| over valid
taps) and one JSON line per variant:

  flat_gather     ops/conv._gather_rows, (B, N, 27, C) materialised
  dw_current      the depthwise conv as the model runs it: K3
                  (ops/kernels/octree_conv.octree_dwconv); and at fp32
                  (dw_current_fp32)
  sorted_gather   flat_gather on the same indices, sorted
  rowsize_x4/x16  N*K/f random rows of f*C: is the cost per index?
  pl_take         take_rows, the counterpart of the TPU's k_take: tap 0
                  of every node, a missing tap read as row 0
  pl_dw           dwconv_resident, the counterpart of the TPU's k_dw:
                  the depthwise conv with x resident in the shared memory
                  of a thread-block cluster, on its default plan;
                  pl_dw_alt_cluster on the other cluster size of
                  RESIDENT_CLUSTERS, pl_dw_fp32 at fp32 (default plan).
                  Each line gives its plan (cluster, slice, rows,
                  clusters_per_sample, smem) and, on the card, how many
                  of its clusters the card runs at once (active_clusters)
  onehot_window   the banded one-hot formulation (plain einsums, as it
                  was plain XLA on the TPU); its escape fraction printed

The oracle is ``ops/conv.octree_dwconv`` (plain flat gather), the
counterpart of the JAX tool's ``_dwconv_fwd_impl``. dw_current and
pl_dw are held against it (one bf16 ulp, 1e-5 at fp32), pl_take
against its plain version bit for bit; a failed check raises and the
tool exits non-zero. On the card ``ms`` is the median CUDA-event time of
one call, the host's launch included, and ``device_ms`` the call's
kernel time under torch.profiler; with ``--device cpu`` the line gives
``cpu_ms`` on the host clock instead, which is no device number. The
kernel lines (pl_*) also give their plain version's time (``plain_*``),
torch.index_select's for pl_take (``library_*``), and ``bound_ms``, the
least time an H100 could take for the same bytes and operations. The
tool writes a file only under ``--out`` (gather_bench.json).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from hotformerloc_torch.utils.profiling import bound_ms, device_ms, time_fn

K_TAPS = 27
C_CHANNELS = 256
LOCALITY_WINDOWS = (48, 128, 256, 512, 1024, 2048)
ONEHOT_TILE, ONEHOT_HALO = 128, 256


def real_tables(B: int = 8, num_points: int = 4096, depth_use: int = 6,
                device="cpu") -> torch.Tensor:
    """(B, N, 27) int32 neighbour table at ``depth_use`` from the port's
    octree build and plan of oxford_config on the JAX tool's clouds."""
    from hotformerloc_torch.models.config import oxford_config
    from hotformerloc_torch.octree.build import build_batched_octree
    from hotformerloc_torch.ops.plan import build_plan

    cfg = oxford_config()
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.9, 0.9, (B, num_points, 3)).astype(np.float32)
    octree = build_batched_octree(
        torch.from_numpy(pts).to(device),
        torch.ones((B, num_points), dtype=torch.bool, device=device),
        cfg.octree_depth, cfg.min_depth, cfg.resolve_capacities())
    plan = build_plan(octree)
    return plan.neighs[octree.level(depth_use)]


def locality(neigh: np.ndarray) -> dict:
    """Share of valid taps within w rows of their node, per window w."""
    node = np.arange(neigh.shape[1])[None, :, None]
    off = np.abs(neigh - node)
    valid = neigh >= 0
    return {f"<= {w}": round(float((off[valid] <= w).mean()), 4)
            for w in LOCALITY_WINDOWS}


def bf16_ulps(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| in bf16 ulps of max(|out|, |ref|), after an
    absolute allowance of 1e-5 max |ref| for fp32 sums taken in another
    order (which near zero move a rounded bf16 result by more than one
    of its ulps)."""
    o, r = out.float(), ref.float()
    mag = torch.maximum(o.abs(), r.abs())
    _, exp = torch.frexp(mag)
    ulp = torch.ldexp(torch.ones_like(mag), exp - 8)
    slack = 1e-5 * float(r.abs().max())
    excess = ((o - r).abs() - slack).clamp(min=0)
    return float((excess / ulp).max())


def check_close(name: str, out: torch.Tensor, ref: torch.Tensor) -> float:
    """Hold ``out`` against ``ref``: within 1e-5 at fp32, within one bf16
    ulp (``bf16_ulps``) at bf16. Returns max |out - ref|; raises on a
    miss or a non-finite value."""
    err = float((out.float() - ref.float()).abs().max())
    ok = bool(torch.isfinite(out.float()).all())
    if ref.dtype == torch.bfloat16:
        ok &= bf16_ulps(out, ref) <= 1.0
    else:
        ok &= err <= 1e-5
    if not ok:
        raise AssertionError(f"{name}: max |out - oracle| = {err} "
                             f"({ref.dtype}) is off")
    return err


def check_equal(name: str, out: torch.Tensor, ref: torch.Tensor) -> float:
    """Hold a copy ``out`` against ``ref`` bit for bit; returns 0.0."""
    if out.shape != ref.shape or not torch.equal(out, ref):
        raise AssertionError(f"{name}: differs from its oracle")
    return 0.0


def timing(dev: torch.device, fn, reps: int, prefix: str = "") -> dict:
    """On the card {"ms": CUDA-event median of one call, host launch
    included; "device_ms": the call's kernel time under the profiler};
    on the CPU {"cpu_ms": host-clock median}; keys after ``prefix``."""
    st = time_fn(fn, iters=reps, warmup=2)
    if dev.type != "cuda":
        return {prefix + "cpu_ms": st["median_ms"]}
    return {prefix + "ms": st["median_ms"],
            prefix + "device_ms": device_ms(fn, iters=reps)}


def yardsticks(dev: torch.device, reps: int, plain, library, cost: tuple,
               dtype: str) -> dict:
    """What a probe kernel's time is read against: its plain version's
    time (``plain_*``), the time of one PyTorch call that computes the
    same function (``library_*``; ``library`` None where there is none),
    and ``bound_ms`` / ``bound_by``, the least time an H100 could take
    for ``cost`` = (bytes, operations of ``dtype``)."""
    ent = timing(dev, plain, reps, "plain_")
    if library is not None:
        ent.update(timing(dev, library, reps, "library_"))
    ent["bound_ms"], ent["bound_by"] = bound_ms(*cost, dtype)
    return ent


def take_library(x: torch.Tensor, idx: torch.Tensor):
    """(torch.index_select computing take_rows(x, idx) on flat row
    indices prepared outside the call, the bytes take_rows must move:
    each distinct source row read once, the output written once, and
    each index in its own 32-byte sector where they lie that far
    apart)."""
    Nx, C = x.shape[-2:]
    rows = idx.long().clamp(0, Nx - 1)
    if x.dim() == 3:
        rows = rows + torch.arange(x.shape[0], device=x.device)[:, None] * Nx
    flat = rows.reshape(-1)
    x2 = x.reshape(-1, C)
    shape = (*idx.shape, C)
    esz = x.element_size()
    per_idx = 32 if idx.stride(-1) * 4 >= 32 else 4
    nbytes = ((int(torch.unique(flat).numel()) + idx.numel()) * C * esz
              + idx.numel() * per_idx)
    return lambda: torch.index_select(x2, 0, flat).reshape(shape), nbytes


def parse_device(name: str) -> torch.device:
    """The device a tool runs on; a card that is asked for and missing
    is an error, never a fall-back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"no CUDA device (asked for {name}); pass "
                         f"--device cpu to run the plain versions")
    return dev


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def run(argv=None) -> dict:
    """The tool's work: prints its lines and returns {"head",
    "locality", "results": {variant: line}}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = parse_device(args.device)

    from hotformerloc_torch.ops import conv as plain
    from hotformerloc_torch.ops.kernels import gather as kgather
    from hotformerloc_torch.ops.kernels import octree_conv as kconv

    B, C, K = args.batch, C_CHANNELS, K_TAPS
    nj = real_tables(B, device=dev)
    neigh = nj.cpu().numpy()
    N = neigh.shape[1]
    taps = int((neigh >= 0).sum())
    head = {"device": device_name(dev), "B": B, "N": N, "C": C, "K": K,
            "valid_taps": round(taps / neigh.size, 4)}
    print(json.dumps(head), flush=True)
    stats = locality(neigh)
    print(json.dumps({"locality": stats}), flush=True)

    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(0, 1, (B, N, C)).astype(
        np.float32)).to(dev, torch.bfloat16)
    w = torch.from_numpy(rng.normal(0, 0.2, (K, C)).astype(
        np.float32)).to(dev, torch.bfloat16)
    x32, w32 = x.float(), w.float()
    ref = plain.octree_dwconv(x, nj, w)
    ref32 = plain.octree_dwconv(x32, nj, w32)
    results = {}

    def record(name, fn, check=None, extra=None):
        ent = {}
        if check is not None:
            held, out, oracle = check
            ent["maxdiff"] = held(name, out, oracle)
        ent.update(timing(dev, fn, args.reps))
        ent.update(extra or {})
        results[name] = ent
        print(json.dumps({name: ent}), flush=True)

    def flat_gather(xx, nn):
        return plain._gather_rows(xx, nn).reshape(B, N, K * C)[:, :, :C]

    def dw_cost(xx):
        esz = xx.element_size()
        return (2 * B * N * C * esz + nj.numel() * 4 + K * C * esz,
                2 * taps * C)

    record("flat_gather", lambda: flat_gather(x, nj))
    record("dw_current", lambda: kconv.octree_dwconv(x, nj, w),
           (check_close, kconv.octree_dwconv(x, nj, w), ref))
    record("dw_current_fp32", lambda: kconv.octree_dwconv(x32, nj, w32),
           (check_close, kconv.octree_dwconv(x32, nj, w32), ref32))

    srt = np.sort(np.where(neigh >= 0, neigh, 0).reshape(B, -1),
                  axis=1).reshape(B, N, K)
    nj_sorted = torch.from_numpy(srt).to(dev)
    record("sorted_gather", lambda: flat_gather(x, nj_sorted))

    for f in (4, 16):
        xf = x.reshape(B, N // f, f * C)
        idxf = torch.from_numpy(rng.integers(0, N // f, (B, N * K // f))
                                .astype(np.int32)).to(dev)
        record(f"rowsize_x{f}", lambda xf=xf, idxf=idxf: plain._gather_rows(
            xf, idxf).reshape(B, N, K * C)[:, :, :C])

    tap0 = nj[..., 0]
    lib, nbytes = take_library(x, tap0)
    take_ref = kgather.take_rows_reference(x, tap0)
    check_equal("pl_take library", lib(), take_ref)
    record("pl_take", lambda: kgather.take_rows(x, tap0),
           (check_equal, kgather.take_rows(x, tap0), take_ref),
           yardsticks(dev, args.reps,
                      lambda: kgather.take_rows_reference(x, tap0), lib,
                      (nbytes, 0), "bf16"))
    def dw_plan(xx, cluster=None):
        plan = kgather.resident_plan(N, C, xx.element_size(),
                                     cluster=cluster)
        active = (kgather.resident_active_clusters(plan, N, C, xx.dtype, dev)
                  if dev.type == "cuda" else None)
        return {**plan, "active_clusters": active}

    record("pl_dw", lambda: kgather.dwconv_resident(x, nj, w),
           (check_close, kgather.dwconv_resident(x, nj, w), ref),
           {**dw_plan(x), **yardsticks(
               dev, args.reps, lambda: plain.octree_dwconv(x, nj, w), None,
               dw_cost(x), "bf16")})
    alt = next(c for c in kgather.RESIDENT_CLUSTERS
               if c != results["pl_dw"]["cluster"])
    record("pl_dw_alt_cluster",
           lambda: kgather.dwconv_resident(x, nj, w, cluster=alt),
           (check_close, kgather.dwconv_resident(x, nj, w, cluster=alt),
            ref),
           {**dw_plan(x, alt),
            **{k: results["pl_dw"][k] for k in ("bound_ms", "bound_by")}})
    record("pl_dw_fp32", lambda: kgather.dwconv_resident(x32, nj, w32),
           (check_close, kgather.dwconv_resident(x32, nj, w32), ref32),
           {**dw_plan(x32), **yardsticks(
               dev, args.reps, lambda: plain.octree_dwconv(x32, nj, w32),
               None, dw_cost(x32), "fp32")})

    S, HR = ONEHOT_TILE, ONEHOT_HALO
    W = S + 2 * HR
    tiles = N // S
    nb = neigh.reshape(B, tiles, S, K)
    loc = nb - (np.arange(tiles) * S - HR)[None, :, None, None]
    inside = (loc >= 0) & (loc < W)
    esc_frac = float((~inside & (nb >= 0)).mean())
    locj = torch.from_numpy(np.where(inside & (nb >= 0), loc, W).astype(
        np.int32)).to(dev)
    cols = torch.arange(W, device=dev, dtype=torch.int32)

    def onehot_window(xx, ll, ww):
        xp = torch.nn.functional.pad(xx, (0, 0, HR, HR))
        ht = xp.unfold(1, W, S).transpose(2, 3)            # (B, T, W, C)
        oh = (ll[..., None] == cols).to(xx.dtype)          # (B, T, S, K, W)
        g = torch.einsum("btskw,btwc->btskc", oh, ht)
        out = torch.einsum("btskc,kc->btsc", g, ww)
        return out.reshape(B, N, C)

    record("onehot_window", lambda: onehot_window(x, locj, w),
           extra={"esc_frac": round(esc_frac, 4)})

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, "gather_bench.json")
        with open(path, "w") as fh:
            json.dump({**head, "locality": stats, "results": results}, fh,
                      indent=1)
        print(f"wrote {path}", flush=True)
    return {"head": head, "locality": stats, "results": results}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
