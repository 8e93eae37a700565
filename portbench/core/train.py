"""Train cells: ``make_train_step`` with the configuration's published
recipe, one call a step.

Set-up builds the one step object (model, Adam state, EMA teacher),
drives it through its first ``check.steps`` steps on distinct pool
batches (these are its warm-up, and what the reference follows), keeps
their losses, the optimizer's first gradient (from Adam's first moment
after step 1) and the parameters' and teacher's change after them, and
hands the same object to the window. The window runs whole steps, each
ending with its loss and overflow read back, until ``seconds`` have
passed.
"""
from __future__ import annotations

import math
import time
from typing import Dict

import torch

from portbench.core import counts, reference
from portbench.core.runner import Run


def recipe(r: Run) -> Dict:
    """The configuration's training recipe with the cell's overrides."""
    return dict(r.cell.config["train"], **r.cell.workload.get("recipe", {}))


def setup(r: Run) -> Dict:
    """Build the one step object and drive it through the check steps.
    Returns {'one': k -> the step's stats on pool batch k, 'batch': k ->
    that batch on the card, 'B': rows a step, 'rec': the recipe,
    'program': the check steps' readings, keyed as ``reference.follow``'s
    (without 'pure')}. Dropping 'one' frees the step object."""
    from hotformerloc_torch.losses.losses import make_loss
    from hotformerloc_torch.models.config import ModelConfig
    from hotformerloc_torch.models.hotformerloc import HOTFormerLoc
    from hotformerloc_torch.training.optim import lr_schedule, make_optimizer
    from hotformerloc_torch.training.step import StepConfig, make_train_step

    rec = recipe(r)
    wl = r.cell.workload
    cfg = ModelConfig(**r.fields)
    model = HOTFormerLoc(cfg, device=r.device, dtype=getattr(torch,
                                                             wl["dtype"]))
    r.load(model)
    r.mark("model")
    opt = make_optimizer(model.parameters(), "adam", lr_schedule(
        rec["lr"], rec["steps_per_epoch"], rec["epochs"],
        milestones=rec["milestones"], warmup_epochs=rec["warmup_epochs"]),
        weight_decay=rec["weight_decay"])
    loss_fn = r.hooks.get("loss_fn", lambda f: f)(make_loss(
        rec["loss"], tau1=rec["tau1"],
        positives_per_query=rec["positives_per_query"]))
    B, mb = int(r.cell.traffic["batch"]), int(r.cell.traffic["microbatch"])
    step = make_train_step(model, opt, loss_fn, StepConfig(
        accum_steps=B // mb, mesa=float(rec.get("mesa", 0.0)),
        use_ema=bool(rec.get("use_ema", False)),
        ema_decay=float(rec["ema_decay"])))
    # the phase of training the cell stands for (the schedule's update count)
    step.state.step = int(rec.get("start_epoch", 0)) * int(
        rec["steps_per_epoch"])
    call = r.hooks.get("train_step", lambda s: s)(step)
    pool = r.pinned(r.pool["points"])
    P = pool.shape[0]
    pmask = torch.ones(pool.shape[1:3], dtype=torch.bool, device=r.device)
    pos = torch.from_numpy(r.pool["positives_mask"]).to(r.device)
    neg = torch.from_numpy(r.pool["negatives_mask"]).to(r.device)

    def batch(k: int):
        return {"points": pool[k % P].to(r.device, non_blocking=True),
                "pmask": pmask, "positives_mask": pos,
                "negatives_mask": neg}

    def one(k: int):
        return call(batch(k), r.seed + k)

    named = list(model.named_parameters())
    b1 = opt.param_groups[0]["betas"][0]
    losses = []
    for k in range(int(wl["check"]["steps"])):
        losses.append(float(one(k)["loss"]))
        r.mark(f"step{k}")
        if k == 0:        # the optimizer's gradient, from its first moment
            grad = {n: (opt.state[p]["exp_avg"] / (1 - b1) if p in opt.state
                        else torch.zeros_like(p)).detach().clone()
                    for n, p in named}
    ema = step.state.ema_model
    prog = {"losses": losses, "grad": grad,
            "delta": {n: p.detach() - r.weights[n] for n, p in named},
            "ema": (None if ema is None else
                    {n: p.detach() - r.weights[n]
                     for n, p in ema.named_parameters()})}
    return {"one": one, "batch": batch, "B": B, "rec": rec, "program": prog}


def reference_side(r: Run, rec: Dict, batch, **kw) -> Dict:
    """The plain reference through the same check steps, from the same
    weights, batches and seeds (``kw``: a control's ``prec`` or
    ``half_batch``)."""
    wl = r.cell.workload
    B, mb = int(r.cell.traffic["batch"]), int(r.cell.traffic["microbatch"])
    ref = reference.TrainReference(r.fields, r.weights, rec, B // mb,
                                   r.device, int(wl["check"]["chunk"]), **kw)
    return reference.follow(ref, r.weights, batch,
                            int(wl["check"]["steps"]), r.seed)


def run(r: Run) -> Dict:
    wl = r.cell.workload
    prog = setup(r)
    one, B, rec = prog["one"], prog["B"], prog["rec"]
    S = int(wl["check"]["steps"])
    P = r.pool["points"].shape[0]
    r.sync()
    r.end_setup()

    failed = n = 0
    t0 = time.perf_counter()
    while True:
        st = one(S + n)
        loss, ovf = float(st["loss"]), int(st["octree_overflow"])
        n += 1
        if ovf > 0 or not math.isfinite(loss):
            failed += 1
        te = time.perf_counter()
        if te - t0 >= r.seconds:
            break
    r.metric("train_submaps_per_s", n * B / (te - t0), "submaps/s")
    r.attempted, r.failed = n * B, failed * B

    if r.trace:
        nt = int(wl.get("trace_steps", 1))
        summary = r.profile(lambda i: one(S + n + i), nt)
        traced = [(S + n + i) % P for i in range(nt)]
    r.mark("window")
    r.read_peak()
    del one, st
    prog.pop("one")
    r.free()

    if r.trace:
        rcfg = r.ref_fields_cfg()
        pts = torch.from_numpy(r.pool["points"][traced]).to(r.device)
        fwd = counts.batch_counts(rcfg, counts.level_counts(
            rcfg, pts.flatten(0, 1)), list(range(nt * B)))
        teacher = 1 if float(rec.get("mesa", 0.0)) > 0 else 0
        summary.update(
            entry="train", submaps=nt * B,
            model_flops=(3 + teacher) * fwd["flops"],
            attn_flops=(2 + teacher) * fwd["attn_flops"]
            + fwd["attn_bwd_flops"],
            attn_bytes=(2 + teacher) * fwd["attn_bytes"]
            + fwd["attn_bwd_bytes"])
        r.per_layer(summary)

    if r.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(r.device)
    ref = reference_side(r, rec, prog["batch"])
    if r.device.type == "cuda":
        r.note(f"reference peak {torch.cuda.max_memory_allocated(r.device)}"
               " bytes")
    r.note("losses " + " ".join(f"{a!r}/{b!r}" for a, b in zip(
        prog["program"]["losses"], ref["losses"])) + " (program/reference)")
    nums, worst = reference.train_numbers(prog["program"], ref)
    for name, v in nums.items():
        r.compare(name, v)
    for name, g in worst.items():
        r.note(f"{name} worst leaves " + "; ".join(
            f"{n} {v:.4g} (ref norm {rn:.4g})" for n, v, rn in g[:3]))
    r.mark("reference")
    return r.result()
