"""The plain reference's side of the comparison that decides ``correct``.

The reference is ``portbench/ref``: a frozen copy of the port's model
with every kernel call on a plain formulation, in fp32 (TF32 off) unless
asked for another precision. It takes the benchmark's inputs (the
points, the weights from ``weights.make_weights``, the seeds) and works
out everything else again: octree, plan, embeddings, losses, gradients,
Adam moments and the EMA teacher. Its forward is independent per sample
(layernorm everywhere, DropPath per sample, no batch statistics in the
shipped models), so it runs in chunks of rows that fit.
"""
from __future__ import annotations

import contextlib
import copy
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.ref.losses import kd_loss, truncated_smoothap
from portbench.ref.models.config import ModelConfig
from portbench.ref.models.hotformerloc import HOTFormerLoc as RefModel
from portbench.ref.ops.precision import fp8_products
from portbench.ref.optim import adam_update, lr_schedule


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for the reference's fp32 products."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def precision(name: str):
    """(compute dtype, context) of a reference precision: 'fp32' (the
    reference), 'fp8' (the control: bf16 activations, every product's
    operands rounded to e4m3)."""
    if name == "fp32":
        return torch.float32, exact_fp32()
    if name == "fp8":
        return torch.bfloat16, fp8_products()
    raise ValueError(f"unknown reference precision {name!r}")


def build(fields: dict, weights: Dict[str, torch.Tensor], device
          ) -> RefModel:
    model = RefModel(ModelConfig(**dict(fields, grad_checkpoint=False)),
                     device=device)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])
    return model


def embed(model: RefModel, points: torch.Tensor, chunk: int,
          prec: str = "fp32") -> torch.Tensor:
    """Eval-mode descriptors (S, D) fp32 of ``points`` (S, P, 3), and the
    octree overflow count."""
    dtype, ctx = precision(prec)
    model.eval()
    outs, ovf = [], 0
    pm = torch.ones(points.shape[:2], dtype=torch.bool, device=points.device)
    with ctx, torch.no_grad():
        for i in range(0, points.shape[0], chunk):
            o = model(points[i:i + chunk], pm[i:i + chunk], dtype=dtype)
            outs.append(o["global"].float())
            ovf += int(o["octree_overflow"])
    return torch.cat(outs), ovf


def drop_generator(seed: int, micro: int) -> torch.Generator:
    """training/step.py ``drop_generator`` (frozen copy): the CPU
    generator of microbatch ``micro``'s DropPath masks."""
    return torch.Generator().manual_seed(
        (int(seed) * 1_000_003 + int(micro)) % (2 ** 63))


class TrainReference:
    """The shipped multistage step written out plainly: per step, every
    microbatch's embeddings without gradients (train mode, the step's
    DropPath masks), the fp32 TruncatedSmoothAP loss over the batch (plus
    ``mesa`` times the distillation term against the EMA teacher's eval
    embeddings), its gradient with respect to the embeddings, the chain
    rule into the parameters chunk by chunk, Adam, then the EMA."""

    def __init__(self, fields: dict, weights: Dict[str, torch.Tensor],
                 recipe: dict, accum: int, device, chunk: int,
                 prec: str = "fp32", half_batch: bool = False):
        self.model = build(fields, weights, device)
        self.params = dict(self.model.named_parameters())
        self.recipe, self.accum, self.chunk = recipe, accum, chunk
        self.prec = prec
        self.half_batch = half_batch       # a fault: half the rows left out
        self.schedule = lr_schedule(
            recipe["lr"], recipe["steps_per_epoch"], recipe["epochs"],
            milestones=recipe["milestones"],
            warmup_epochs=recipe["warmup_epochs"])
        self.opt_state: Dict[str, dict] = {}
        self.mesa = float(recipe.get("mesa", 0.0))
        self.ema: Optional[RefModel] = None
        if recipe.get("use_ema", False):
            self.ema = copy.deepcopy(self.model).eval().requires_grad_(False)
        self.step_count = int(recipe.get("start_epoch", 0)) * int(
            recipe["steps_per_epoch"])

    def _forward(self, pts, pm, masks, grad: bool):
        dtype, ctx = precision(self.prec)
        with ctx, torch.set_grad_enabled(grad):
            return self.model(pts, pm, drop_masks=masks,
                              dtype=dtype)["global"].float()

    def step(self, batch: Dict[str, torch.Tensor], seed: int) -> Dict:
        """One step; returns {'loss' (the TruncatedSmoothAP term, as the
        program's stats report it), 'grad' (the optimizer's gradient of
        every parameter, weight decay included), 'pure_grad'}."""
        m = self.model
        pts, pos, neg = (batch["points"], batch["positives_mask"],
                         batch["negatives_mask"])
        B = pts.shape[0]
        mb = B // self.accum
        pm = torch.ones(pts.shape[:2], dtype=torch.bool, device=pts.device)
        masks = [m.draw_drop_masks(mb, drop_generator(seed, i))
                 for i in range(self.accum)]
        rows = list(range(B))
        if self.half_batch:
            rows = rows[:B // 2]

        def chunks():
            for i in range(self.accum):
                for a in range(i * mb, (i + 1) * mb, self.chunk):
                    b = min(a + self.chunk, (i + 1) * mb)
                    yield a, b, masks[i][:, a - i * mb:b - i * mb]

        m.train()
        embs = [self._forward(pts[a:b], pm[a:b], mk, False)
                for a, b, mk in chunks()]
        emb = torch.cat(embs).detach().requires_grad_(True)
        with torch.enable_grad():
            sel = torch.tensor(rows, device=pts.device)
            loss, stats = truncated_smoothap(
                emb[sel], pos[sel][:, sel], neg[sel][:, sel],
                tau1=self.recipe.get("tau1", 0.01),
                positives_per_query=self.recipe["positives_per_query"])
            if self.ema is not None and self.mesa > 0:
                dtype, ctx = precision(self.prec)
                with ctx, torch.no_grad():
                    t = torch.cat([self.ema(pts[a:b], pm[a:b], dtype=dtype)[
                        "global"].float() for a, b, _ in chunks()])
                loss = loss + self.mesa * kd_loss(emb[sel], t[sel])
            (g_emb,) = torch.autograd.grad(loss, emb)
        for p in m.parameters():
            p.grad = None
        for a, b, mk in chunks():
            out = self._forward(pts[a:b], pm[a:b], mk, True)
            out.backward(g_emb[a:b])
        wd = self.recipe["weight_decay"]
        pure = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                for n, p in self.params.items()}
        grads = {n: g + wd * self.params[n].detach() for n, g in pure.items()}
        adam_update({n: p.data for n, p in self.params.items()}, pure,
                    self.opt_state, self.schedule(self.step_count), wd)
        if self.ema is not None:
            d = self.recipe["ema_decay"]
            with torch.no_grad():
                for e, p in zip(self.ema.parameters(), m.parameters()):
                    e.mul_(d).add_(p, alpha=1.0 - d)
        self.step_count += 1
        return {"loss": float(stats["loss"]), "grad": grads,
                "pure_grad": pure}


def follow(ref: TrainReference, weights: Dict[str, torch.Tensor], batch,
           steps: int, seed: int) -> Dict:
    """Drive ``ref`` through the check steps a run's set-up takes (step k
    on ``batch(k)`` with seed ``seed + k``) and return {'losses', 'grad'
    (the first step's optimizer gradient), 'pure' (its gradient without
    weight decay), 'delta' (the parameters' change), 'ema' (the teacher's
    change, or None)}."""
    losses = []
    for k in range(steps):
        out = ref.step(batch(k), seed + k)
        losses.append(out["loss"])
        if k == 0:
            grad, pure = out["grad"], out["pure_grad"]
    return {"losses": losses, "grad": grad, "pure": pure,
            "delta": {n: t.detach() - weights[n]
                      for n, t in ref.model.named_parameters()},
            "ema": (None if ref.ema is None else
                    {n: t - weights[n]
                     for n, t in ref.ema.named_parameters()})}


def leaf_numbers(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                 keep: Optional[List[str]] = None, diff: bool = False
                 ) -> List[tuple]:
    """Per leaf (name, number, ||ref_leaf||), worst first, over ``keep``
    (every leaf when None). The number is | ||prog_leaf|| - ||ref_leaf|| |
    (the gap of the norms), or with ``diff`` ||prog_leaf - ref_leaf|| (the
    norm of the difference), over the larger of ||ref_leaf|| and the
    median leaf's norm."""
    names = keep if keep is not None else list(ref)
    rn = np.array([float(ref[n].float().norm()) for n in names])
    if diff:
        num = np.array([float((prog[n].float() - ref[n].float()).norm())
                        for n in names])
    else:
        num = np.abs(np.array([float(prog[n].float().norm())
                               for n in names]) - rn)
    denom = np.maximum(rn, np.median(rn))
    denom[denom == 0] = 1.0
    return sorted(zip(names, (num / denom).tolist(), rn.tolist()),
                  key=lambda t: -t[1])


def moved_leaves(ref: Dict) -> List[str]:
    """Leaves whose pure reference gradient is at least a thousandth of
    the median leaf's: the others (a key's bias under softmax) move under
    Adam by round-off alone, and are left out of the changes."""
    norms = {n: float(g.norm()) for n, g in ref["pure"].items()}
    med = sorted(norms.values())[len(norms) // 2]
    return [n for n, v in norms.items() if v >= 1e-3 * med]


def train_numbers(prog: Dict, ref: Dict):
    """The numbers a train cell compares, and each one's leaves worst
    first. ``prog`` and ``ref`` are ``follow``'s dicts (the program's
    needs no 'pure').

    - grad_diff: the worst leaf's norm of the first gradients' difference;
    - delta_gap, ema_gap: the worst leaf's gap of change norms, over the
      leaves that ``moved_leaves`` keeps."""
    keep = moved_leaves(ref)
    worst = {"grad_diff": leaf_numbers(prog["grad"], ref["grad"], diff=True),
             "delta_gap": leaf_numbers(prog["delta"], ref["delta"], keep)}
    if prog["ema"] is not None:
        worst["ema_gap"] = leaf_numbers(prog["ema"], ref["ema"], keep)
    return {k: g[0][1] for k, g in worst.items()}, worst
