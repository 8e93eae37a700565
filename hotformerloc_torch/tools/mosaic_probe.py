"""Probes of the attention's building blocks, the row gathers, and the
attention and depthwise-conv kernels, on the card.

    python -m hotformerloc_torch.tools.mosaic_probe
        {constructs,attn,gather,band} [--device cuda|cpu] [--reps 20]
        [--out DIR]

Counterpart of hotformerloc_tpu/tools/mosaic_probe.py, whose subcommands
asked which constructs the TPU's Mosaic compiler accepts. Here every
subcommand runs the port's kernels at the JAX tool's shapes and seeds,
holds each against its plain version and times it; one JSON line per
probe (``ms``: median CUDA-event time of one call, the host's launch
included; ``device_ms``: its kernel time under torch.profiler; ``cpu_ms``
on the host clock with ``--device cpu``, which is no device number). The
constructs and gather lines also give the plain version's time
(``plain_*``), that of one PyTorch call computing the same function where
there is one (``library_*``: torch.bmm, embedding, index_add, F.pad,
softmax, mul, index_select), and ``bound_ms``, the least time an H100
could take for the same bytes and operations. A failed build, launch or
check raises and the tool exits non-zero: nothing is caught. ``--out``
writes mosaic_probe_<subcommand>.json there; nothing else is written.

  constructs  the ten construct kernels of ops/kernels/constructs.py
              (WT=8, T=49, K=48, C=256, H=16, hd=16, R=231); each line
              names the kernel body it runs on the card (``body``). On
              the card one more line, ``floor``, gives the card's floor
              for them (``floor_line``): the device ms of an empty
              launch and of a dependent index-and-row load and a store,
              in one warp and in a 4-warp block on every SM
  gather      take_rows at the JAX tool's six row-gather cases, against
              the numpy oracle x[idx]
  attn        K1 forward, and K1 + K2 for grad(sum(out^2)) with respect
              to q and the RPE table, once per distinct (H, C, G, P) of
              the JAX tool's cases (BW=704, K=48, bnd=38). ``pack`` and
              ``window_tile`` are TPU layout knobs: a pack=2 case is the
              same function as twice the windows, so each line names
              every JAX case it stands for.
  band        K3 forward, and K3 + K4 forward and backward, at the JAX
              tool's band() shape (B=8, C=256, depth 6, N=4224), against
              the flat plain version. There is no (halo, escape-capacity)
              sweep: the port gathers every tap directly and has no band
              tables (ROADMAP.md §1 item 3), so those knobs do not exist.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from hotformerloc_torch.tools.gather_bench import (check_close, check_equal,
                                                   device_name, parse_device,
                                                   take_library, timing,
                                                   yardsticks)
from hotformerloc_torch.utils.profiling import device_ms

WT, T, C, H, K, R = 8, 49, 256, 16, 48, 231
HD = C // H
SEL = 4                        # k_selloop's truncated select loop

# construct -> (the JAX probe's name, exact?). The products, the softmax
# and the dtab sum are held to a relative 1e-5 (fp32 sums in another
# order), the copies, pad, reshape, lookup and selects exactly.
CONSTRUCT_PROBES = {
    "headloop": ("headloop_1batch_dot_laneslice", False),
    "reshape": ("reshape_3d_to_flatcol", True),
    "onehot4d": ("onehot4d_dot_minor", True),
    "dtab": ("dtab_contract_majors", False),
    "pad": ("pad_middle_dims", True),
    "selloop": ("scalar_select_loop", True),
    "softmax": ("softmax3d", False),
    "slicestore": ("lane_slice_store", True),
    "dk": ("dot_contract_sublane", False),
    "packbias": ("packed_rows_dot", False),
}


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def construct_inputs() -> dict:
    """{construct: its argument tuple} on the CPU, drawn from
    ``default_rng(0)`` in the JAX tool's order."""
    rng = np.random.default_rng(0)
    q = _bf16(rng.normal(0, 1, (WT, T, C)))
    k = _bf16(rng.normal(0, 1, (WT, T, C)))
    idx3 = torch.from_numpy(rng.integers(0, R, (WT, K, K)).astype(np.int32))
    tab = torch.from_numpy(rng.normal(0, 1, (R, H)).astype(np.float32))
    logits = torch.from_numpy(rng.normal(0, 1, (WT, T, T)).astype(
        np.float32))
    bias = torch.from_numpy(rng.normal(0, 1, (WT, K, K)).astype(np.float32))
    g4 = torch.from_numpy(rng.normal(0, 1, (WT, K, K, H)).astype(np.float32))
    q2 = _bf16(rng.normal(0, 1, (WT // 2, 2 * T, C)))
    return {"headloop": (q, k, HD), "reshape": (idx3,),
            "onehot4d": (idx3, tab), "dtab": (idx3, g4, R), "pad": (bias, 1),
            "selloop": (idx3, tab, SEL), "softmax": (logits,),
            "slicestore": (q, 2 * HD), "dk": (q, k, HD),
            "packbias": (q2, q2, HD)}


def to_device(args, dev):
    return tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                 for a in args)


def check_construct(name: str, out: torch.Tensor, ref: torch.Tensor) -> float:
    """Exact or relative 1e-5 (CONSTRUCT_PROBES); returns max |diff|."""
    exact = CONSTRUCT_PROBES[name][1]
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"construct_{name}: {out.dtype} "
                             f"{tuple(out.shape)} vs {ref.dtype} "
                             f"{tuple(ref.shape)}")
    err = float((out.float() - ref.float()).abs().max())
    lim = 0.0 if exact else 1e-5 * float(ref.float().abs().max())
    if not (err <= lim and torch.isfinite(out.float()).all()):
        raise AssertionError(f"construct_{name}: max |kernel - plain| = "
                             f"{err} > {lim}")
    return err


def construct_cost(name: str, args: tuple, out: torch.Tensor) -> tuple:
    """(bytes, bf16 operations) of one call of a construct: each input
    byte it needs read once, its output written once; operations for the
    three products (bf16 inputs, fp32 sums) only."""
    def nb(t):
        return t.numel() * t.element_size()
    if name in ("headloop", "dk", "packbias"):
        q, k, hd = args
        width = 2 * hd if name == "headloop" else hd
        WT, T_ = q.shape[:2]
        reads = (1 if name == "packbias" else 2) * WT * T_ * width * 2
        flops = 2 * WT * T_ * (T_ * width if name != "dk" else hd * hd)
        return reads + nb(out), flops
    if name == "slicestore":
        return 2 * nb(out), 0
    if name == "selloop":
        return nb(args[0]) + 4 * args[2] + nb(out), 0
    if name == "dtab":
        return nb(args[0]) + nb(args[1]) + nb(out), 0
    return sum(nb(a) for a in args if isinstance(a, torch.Tensor)) \
        + nb(out), 0


def construct_library(name: str, args: tuple):
    """One PyTorch call that computes the construct's function, on
    inputs prepared outside the call, or None where there is none."""
    F = torch.nn.functional
    if name in ("headloop", "dk", "packbias"):
        q, k, hd = args
        width = 2 * hd if name == "headloop" else hd
        qa = q[..., :width].float().contiguous()
        ka = k[..., :width].float().contiguous()
        if name == "dk":
            qt = qa.transpose(1, 2)
            return lambda: torch.bmm(qt, ka)
        kt = ka.transpose(1, 2)
        return lambda: torch.bmm(qa, kt)
    if name == "reshape":
        return lambda: args[0].view(-1, 1).float()
    if name == "onehot4d":
        tab = args[1].to(torch.bfloat16).float()
        return lambda: F.embedding(args[0], tab)
    if name == "dtab":
        idx, g, R_ = args
        il = idx.reshape(-1).long()
        gr = g.to(torch.bfloat16).float().reshape(-1, g.shape[-1])
        zero = torch.zeros((R_, g.shape[-1]), device=g.device)
        return lambda: zero.index_add(0, il, gr)
    if name == "pad":
        return lambda: F.pad(args[0], (args[1], 0, args[1], 0))
    if name == "selloop":
        idx, tab, nsel = args
        lut = torch.zeros((tab.shape[0], 1), device=tab.device)
        lut[:nsel, 0] = tab[:nsel, 0]
        return lambda: F.embedding(idx, lut)[..., 0]
    if name == "softmax":
        return lambda: torch.softmax(args[0], dim=-1)
    if name == "slicestore":
        q, width = args
        return lambda: torch.mul(q[..., :width], 2)
    return None


def constructs(dev, reps):
    from hotformerloc_torch.ops.kernels.constructs import BODIES, CONSTRUCTS

    lines = []
    for name, args in construct_inputs().items():
        fn, ref_fn, _ = CONSTRUCTS[name]
        a = to_device(args, dev)
        out = fn(*a)
        err = check_construct(name, out, ref_fn(*a))
        lib = construct_library(name, a)
        if lib is not None:              # the yardstick computes the same
            check_construct(name, lib().reshape(out.shape), out)
        lines.append({"probe": CONSTRUCT_PROBES[name][0], "construct": name,
                      "body": BODIES[name], "ok": True, "maxdiff": err,
                      "out": list(out.shape),
                      "dtype": str(out.dtype).split(".")[1],
                      **timing(dev, lambda: fn(*a), reps),
                      **yardsticks(dev, reps, lambda: ref_fn(*a), lib,
                                   construct_cost(name, a, out), "bf16")})
    if dev.type == "cuda":
        lines.append(floor_line(dev, reps))
    return lines


FLOOR_ROWS = 4224              # floor_chain's table: rows of 16 bytes


def floor_line(dev, reps):
    """The card's floor for the constructs, on the card only: the device
    ms (``device_ms``, as the constructs' lines) of the empty kernel
    (``empty_device_ms``), of one warp's dependent index and row load and
    store (``warp_chain_device_ms``), and of the same chain in a 4-warp
    block on every SM (``grid_chain_device_ms``). The chains are checked
    against x[idx] first."""
    from hotformerloc_torch.ops.kernels.constructs import (
        FLOOR_GRID, floor_chain, floor_chain_reference, floor_empty)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 1, (FLOOR_ROWS, 4)).astype(
        np.float32)).to(dev)
    threads, blocks = FLOOR_GRID
    idx = {n: torch.from_numpy(rng.integers(0, FLOOR_ROWS, (n,)).astype(
        np.int32)).to(dev) for n in (32, threads * blocks)}
    runs = {"empty": lambda: floor_empty(x),
            "warp_chain": lambda: floor_chain(x, idx[32], 32),
            "grid_chain": lambda: floor_chain(x, idx[threads * blocks],
                                              threads)}
    ln = {"probe": "launch_floor", "construct": "floor", "ok": True,
          "grid": {"threads": threads, "blocks": blocks}}
    for name, fn in runs.items():
        out = fn()
        if name != "empty":
            check_equal(f"floor_{name}", out,
                        floor_chain_reference(x, idx[out.shape[0]]))
        ln[f"{name}_device_ms"] = device_ms(fn, iters=reps)
    return ln


def gather_inputs() -> list:
    """[(probe name, x, idx)] of the JAX tool's row-gather cases on the
    CPU, drawn from ``default_rng(0)`` in its order."""
    rng = np.random.default_rng(0)
    cases = []
    for Nx, TN, C_, dt in ((512, 512, 256, torch.float32),
                           (4224, 512, 256, torch.bfloat16),
                           (4224, 4224, 256, torch.bfloat16)):
        x = torch.from_numpy(rng.normal(0, 1, (Nx, C_)).astype(
            np.float32)).to(dt)
        idx = torch.from_numpy(rng.integers(0, Nx, (TN,)).astype(np.int32))
        cases.append((f"take2d_N{Nx}_T{TN}_{str(dt).split('.')[1]}", x, idx))
    Nx, TN, C_ = 4224, 512, 256
    x = torch.from_numpy(rng.normal(0, 1, (Nx, C_)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, Nx, (TN,)).astype(np.int32))
    cases.append(("jnp_take_axis0", x, idx))
    cases.append(("rowloop_dynslice", x, idx))
    idx2 = torch.from_numpy(rng.integers(0, Nx, (8 * 512,)).astype(np.int32))
    cases.append(("take_grid_tiled", x, idx2))
    return cases


def gather(dev, reps):
    from hotformerloc_torch.ops.kernels.gather import (take_rows,
                                                       take_rows_reference)

    lines = []
    for name, x, idx in gather_inputs():
        want = x.float().numpy()[idx.numpy()]
        xd, idd = x.to(dev), idx.to(dev)
        out = take_rows(xd, idd)
        err = float(np.abs(out.float().cpu().numpy() - want).max())
        if err != 0.0:
            raise AssertionError(f"{name}: take_rows differs from x[idx] "
                                 f"by {err}")
        lib, nbytes = take_library(xd, idd)
        check_equal(f"{name} library", lib(), out)
        lines.append({"probe": name, "shape": [x.shape[0], idx.shape[0],
                                               x.shape[1]],
                      "dtype": str(x.dtype).split(".")[1], "ok": True,
                      "maxdiff": err,
                      **timing(dev, lambda: take_rows(xd, idd), reps),
                      **yardsticks(dev, reps,
                                   lambda: take_rows_reference(xd, idd), lib,
                                   (nbytes, 0), "bf16")})
    return lines


BW_ATTN, K_ATTN, BND_ATTN = 704, 48, 38
# (H, C, G, P): (forward cases, backward cases) of the JAX tool it covers
ATTN_FUNCTIONS = {
    (8, 128, 0, 128): (["base_H8_C128_G0"], ["bwd_H8_C128_G0"]),
    (16, 256, 1, 128): (["H16_C256_G1", "H16_C256_G1_wt16",
                         "H16_C256_G1_p2_wt8", "H16_C256_G1_p2_wt16"],
                        ["bwd_H16_C256_G1", "bwd_H16_C256_G1_p2_wt8"]),
    (16, 256, 1, 16): (["H16_C256_G1_wt16_P16"],
                       ["bwd_H16_C256_G1_wt16_P16"]),
    (16, 256, 1, 32): (["H16_C256_G1_wt16_P32"], []),
}
# kernel vs plain, relative to max(1, max |plain|): bf16 outputs are
# rounded once on both sides; the table gradient is an fp32 sum.
ATTN_TOL = {"act": 1e-2, "weight": 1e-4}


def _rel_check(name, out, ref, kind):
    err = float((out.float() - ref.float()).abs().max())
    lim = ATTN_TOL[kind] * max(1.0, float(ref.float().abs().max()))
    if not (err <= lim and torch.isfinite(out.float()).all()):
        raise AssertionError(f"{name}: max |kernel - plain| = {err} > {lim}")
    return err


def attn_inputs(H_, C_, G_, P, dev):
    """The JAX tool's case inputs (default_rng(0) per case, pack 1)."""
    T_ = K_ATTN + G_
    rng = np.random.default_rng(0)
    q, k, v = (_bf16(rng.normal(0, 1, (BW_ATTN, T_, C_))).to(dev)
               for _ in range(3))
    xyz = torch.from_numpy(rng.integers(0, P, (BW_ATTN, 3, K_ATTN)).astype(
        np.int32)).to(dev)
    mask = torch.ones((BW_ATTN, T_), dtype=torch.int32, device=dev)
    tab = torch.from_numpy(rng.normal(0, 0.1, (3 * (2 * BND_ATTN + 1), H_))
                           .astype(np.float32)).to(dev)
    return q, k, v, xyz, mask, tab


def attn(dev, reps):
    from hotformerloc_torch.ops.kernels import window_attn as kattn

    lines = []
    for (H_, C_, G_, P), (fwd_cases, bwd_cases) in ATTN_FUNCTIONS.items():
        q, k, v, xyz, mask, tab = attn_inputs(H_, C_, G_, P, dev)

        def fwd():
            return kattn.window_attention(q, k, v, xyz, mask, tab, H_,
                                          BND_ATTN)

        out = fwd()
        ref = kattn.window_attention_reference(q, k, v, xyz, mask, tab, H_,
                                               BND_ATTN)
        err = _rel_check(f"attn fwd {fwd_cases[0]}", out, ref, "act")

        def fwd_bwd():
            qg = q.detach().requires_grad_()
            tg = tab.detach().requires_grad_()
            o = kattn.window_attention(qg, k, v, xyz, mask, tg, H_, BND_ATTN)
            dq, dtab = torch.autograd.grad((o.float() ** 2).sum(), (qg, tg))
            return o, dq, dtab

        o, dq, dtab = fwd_bwd()
        g = (2 * o.detach().float()).to(q.dtype)
        rq, _, _, rtab = kattn.window_attention_bwd_reference(
            q, k, v, xyz, mask, tab, g, H_, BND_ATTN)
        err_dq = _rel_check(f"attn dq {fwd_cases[0]}", dq, rq, "act")
        err_dt = _rel_check(f"attn dtable {fwd_cases[0]}", dtab, rtab,
                            "weight")
        t_f = timing(dev, fwd, reps)
        t_fb = timing(dev, fwd_bwd, reps)
        lines.append({"H": H_, "C": C_, "G": G_, "P": P,
                      "cases": fwd_cases, "bwd_cases": bwd_cases, "ok": True,
                      "shape": [BW_ATTN, K_ATTN + G_, C_],
                      "maxdiff": err, "maxdiff_dq": err_dq,
                      "maxdiff_dtable": err_dt,
                      **{f"fwd_{k_}": v_ for k_, v_ in t_f.items()},
                      **{f"fwd_bwd_{k_}": v_ for k_, v_ in t_fb.items()}})
    return lines


BAND_B, BAND_C, BAND_DEPTH, BAND_N = 8, 256, 6, 4224


def band_inputs(dev):
    """The JAX band() probe's inputs: a depth-6 octree of 8 uniform
    clouds in +-1 with N=4224 nodes, its 27-tap table, x bf16 and w fp32
    from default_rng(0)."""
    from hotformerloc_torch.octree.build import build_batched_octree
    from hotformerloc_torch.octree.neigh import all_neigh_tables

    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.uniform(-1, 1, (BAND_B, 4096, 3)).astype(
        np.float32)).to(dev)
    msk = torch.ones((BAND_B, 4096), dtype=torch.bool, device=dev)
    oc = build_batched_octree(pts, msk, BAND_DEPTH, BAND_DEPTH, (BAND_N,))
    neigh = all_neigh_tables(oc, (None,))[0]
    x = _bf16(rng.normal(0, 1, (BAND_B, neigh.shape[1], BAND_C))).to(dev)
    w = torch.from_numpy(rng.normal(0, 0.2, (27, BAND_C)).astype(
        np.float32)).to(dev)
    return neigh, x, w, int(oc.overflow.sum())


def band(dev, reps):
    from hotformerloc_torch.ops import conv as plain
    from hotformerloc_torch.ops.kernels import octree_conv as kconv

    neigh, x, w, overflow = band_inputs(dev)
    wc = w.to(x.dtype)
    out = kconv.octree_dwconv(x, neigh, w)
    err = check_close("band fwd", out, plain.octree_dwconv(x, neigh, wc))

    def fwd_bwd():
        xg = x.detach().requires_grad_()
        wg = w.detach().requires_grad_()
        o = kconv.octree_dwconv(xg, neigh, wg)
        dx, dw = torch.autograd.grad((o.float() ** 2).sum(), (xg, wg))
        return o, dx, dw

    o, dx, dw = fwd_bwd()
    dy = (2 * o.detach().float()).to(x.dtype)
    rdx, rdw = plain.octree_dwconv_bwd(x, neigh, wc, dy)
    err_dx = _rel_check("band dx", dx, rdx, "act")
    err_dw = _rel_check("band dw", dw, rdw, "weight")
    t_f = timing(dev, lambda: kconv.octree_dwconv(x, neigh, w), reps)
    t_fb = timing(dev, fwd_bwd, reps)
    return [{"probe": "band", "B": BAND_B, "C": BAND_C, "depth": BAND_DEPTH,
             "N": int(neigh.shape[1]), "overflow": overflow,
             "valid_taps": round(float((neigh >= 0).float().mean()), 4),
             "ok": True, "maxdiff": err, "maxdiff_dx": err_dx,
             "maxdiff_dw": err_dw,
             **{f"fwd_{k_}": v_ for k_, v_ in t_f.items()},
             **{f"fwd_bwd_{k_}": v_ for k_, v_ in t_fb.items()}}]


SUBCOMMANDS = {"constructs": constructs, "attn": attn, "gather": gather,
               "band": band}


def run(argv=None) -> list:
    """The tool's work: prints its lines and returns them."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cmd", nargs="?", default="constructs",
                    choices=sorted(SUBCOMMANDS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = parse_device(args.device)
    print(json.dumps({"device": device_name(dev), "subcommand": args.cmd}),
          flush=True)
    lines = SUBCOMMANDS[args.cmd](dev, args.reps)
    for ln in lines:
        print(json.dumps(ln), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, f"mosaic_probe_{args.cmd}.json")
        with open(path, "w") as fh:
            json.dump({"device": device_name(dev), "lines": lines}, fh,
                      indent=1)
        print(f"wrote {path}", flush=True)
    return lines


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
