"""Training and evaluation steps, including multistage large-batch
backprop and MESA (EMA distillation).

Counterpart of hotformerloc_tpu/training/step.py. The multistage step
trains on a batch of B clouds as accum_steps microbatches:

1. one octree and plan per microbatch, built once for both passes;
2. stage 1: every microbatch's embeddings without gradients, the model
   in train mode;
3. stage 2: the fp32 loss over all B embeddings and its gradient with
   respect to them;
4. stage 3: per microbatch, the forward again with gradients and
   ``emb.backward(g_emb)``, accumulating the fp32 parameter gradients;
5. the optimizer update, the optional EMA, and the gradient norm.

The DropPath masks and the dropout seed of microbatch i are drawn from a
generator seeded from (seed, i), so stages 1 and 3 see the same masks and
the recomputed embeddings equal the first ones. The compute dtype is the
model's (``HOTFormerLoc(dtype=...)``); parameters and gradients stay
fp32.

Running statistics (BatchNorm / PowerNorm buffers) change as the JAX
step's ``model_state`` does: every forward of a step runs from the
state the step started with; the single-pass step keeps its forward's
update, and the multistage step keeps stage 1's last microbatch's (its
scan's carry), dropping the other microbatches' and stage 3's. The EMA
teacher (MESA) runs in eval mode on the student's running statistics,
as JAX's teacher reads ``state.model_state``. A batch may carry
'normals' (B, P, 3) for the 'N' input feature (the JAX step has no such
key).

Over a process group of n ranks (``parallel/dist.py``) the layout is
the JAX step's under its mesh: global microbatch i is rows
i·mb .. (i+1)·mb - 1 of the global batch of B clouds (mb = B /
accum_steps), and rank r holds its 1/n share of each, rows
i·mb + r·lb .. i·mb + (r+1)·lb - 1 (lb = mb / n; ``dist.local_rows``),
stacked microbatch by microbatch, with the same rows of the (B, B)
masks. Its microbatch i is then its local rows i·lb .. (i+1)·lb - 1.
The DropPath masks are drawn per global microbatch and each rank takes
its rows of them; the norms sum their batch statistics over the ranks
(``HOTFormerLoc.set_stats_group``), so every rank stages the statistics
of the whole global microbatch. Stage 2 gathers every rank's
embeddings and mask rows back into global order
(``dist.all_gather_micro``), so each rank computes the same global loss
and its gradient; stage 3 backpropagates the rank's own rows of it (the
norms' sums carry their gradient across the ranks); the parameter
gradients are summed over the ranks once, after the last microbatch.
At world n the step then equals one process's step over the global
batch with the same accum_steps, for every model, up to the order of
the fp32 sums. Dropout (rate > 0) is the exception: its masks are drawn
per rank, so the two agree in distribution, not in bits.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Dict, Optional

import torch
from torch import nn

from hotformerloc_torch.losses.losses import kd_loss
from hotformerloc_torch.models.hotformerloc import (HOTFormerLoc,
                                                    build_model_plan)
from hotformerloc_torch.parallel import dist

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class StepConfig:
    accum_steps: int = 1          # microbatches per step (multistage BP)
    ema_decay: float = 0.9998     # EMA decay of the teacher weights
    mesa: float = 0.0             # MESA weight; > 0 enables distillation
    use_ema: bool = False
    # Also report max |stage-3 embedding - stage-1 embedding| as the stat
    # 'recompute_max_abs' (multistage only; costs one small reduction).
    check_recompute: bool = False


@dataclasses.dataclass
class TrainState:
    """What a step changes besides the model's parameters and the
    optimizer's moments: the update count and the EMA teacher."""
    step: int = 0
    ema_model: Optional[HOTFormerLoc] = None


def apply_qkv_init(model: nn.Module, generator: torch.Generator,
                   spec: str) -> None:
    """Re-initialise every qkv projection weight in place per the model
    config's ``qkv_init`` (counterpart of the JAX ``apply_qkv_init``).

    spec: "mode[,std]" with mode in torch_default (leave as is) |
    trunc_normal (N(0, std^2) truncated at 2 std, std 0.02 by default,
    as flax's truncated_normal(std)) |
    xavier_uniform | xavier_normal | kaiming_uniform | kaiming_normal,
    the last four with gain sqrt(2) (relu). A torch weight is
    (fan_out, fan_in), the transpose of the flax kernel, and the
    ``torch.nn.init`` calls read the fans that way. Values are drawn on
    the CPU from ``generator`` in named_parameters order, then copied."""
    parts = [s.strip() for s in str(spec).split(",")]
    mode = parts[0]
    if mode == "torch_default":
        return
    gain = math.sqrt(2.0)
    if mode == "trunc_normal":
        std = float(parts[1]) if len(parts) > 1 else 0.02

        def init(t):
            nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
    elif mode == "xavier_uniform":
        def init(t):
            nn.init.xavier_uniform_(t, gain, generator=generator)
    elif mode == "xavier_normal":
        def init(t):
            nn.init.xavier_normal_(t, gain, generator=generator)
    elif mode == "kaiming_uniform":
        def init(t):
            nn.init.kaiming_uniform_(t, 0.0, "fan_in", "relu",
                                     generator=generator)
    elif mode == "kaiming_normal":
        def init(t):
            nn.init.kaiming_normal_(t, 0.0, "fan_in", "relu",
                                    generator=generator)
    else:
        raise ValueError(f"Invalid qkv_init type: {mode}")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "qkv" in name and name.endswith(".weight"):
                t = torch.empty(p.shape, dtype=torch.float32)
                init(t)
                p.copy_(t)


def drop_generator(seed: int, micro: int) -> torch.Generator:
    """The CPU generator of microbatch ``micro``'s DropPath masks."""
    return torch.Generator().manual_seed(
        (int(seed) * 1_000_003 + int(micro)) % (2 ** 63))


def _grad_norm(params) -> torch.Tensor:
    return torch.sqrt(sum((p.grad.float() ** 2).sum() for p in params))


class TrainStep:
    """``step(batch, seed) -> stats``. batch: {'points': (B, P, 3),
    'pmask': (B, P), 'positives_mask': (B, B), 'negatives_mask': (B, B)}
    on the model's device. Stats are 0-d tensors with the JAX step's
    keys: the loss's, 'octree_overflow' and 'grad_norm' (the JAX step's
    'band_overflow' has no counterpart: every tap is gathered directly).
    After a step every parameter's ``.grad`` holds that step's gradient.

    ``group``: the process group of data parallelism (None: one
    process). Each rank then passes its rows of the global batch in the
    microbatch layout (``dist.local_rows(B, accum_steps, rank, world)``),
    the same rows of the (B, B) masks, and the same seed; stats,
    parameters and running statistics are the same on every rank,
    'octree_overflow' summed over them."""

    def __init__(self, model: HOTFormerLoc, optimizer: torch.optim.Optimizer,
                 loss_fn: Callable, cfg: StepConfig = StepConfig(),
                 group=None):
        self.model, self.optimizer, self.loss_fn, self.cfg = (
            model, optimizer, loss_fn, cfg)
        self.group = group
        model.set_stats_group(group)
        self.params = [p for p in model.parameters() if p.requires_grad]
        ema = None          # MESA needs the EMA teacher, as in JAX
        if cfg.use_ema:
            ema = copy.deepcopy(model).eval().requires_grad_(False)
        self.state = TrainState(step=0, ema_model=ema)

    def _teacher(self, points, pmask, plan=None, normals=None):
        ema = self.state.ema_model
        if self.cfg.mesa <= 0.0 or ema is None:
            return None
        with torch.no_grad():
            for e, b in zip(ema.buffers(), self.model.buffers()):
                e.copy_(b)          # the student's running statistics
            return ema(points, pmask, plan=plan, normals=normals)["global"]

    def _draws(self, lb: int, micro: int):
        """Global microbatch ``micro``'s DropPath masks, this rank's
        ``lb`` columns of them (rows of its microbatch), and the rank's
        dropout seed."""
        r, n = dist.rank(self.group), dist.world(self.group)
        g = drop_generator(self.seed, micro)
        masks = self.model.draw_drop_masks(n * lb, g)
        seed = int(torch.randint(2 ** 62, (), generator=g))
        return (masks[:, r * lb:(r + 1) * lb],
                (seed + r * 1_000_003) % (2 ** 62))

    def __call__(self, batch: Batch, seed: int) -> Dict[str, torch.Tensor]:
        self.model.train()
        self.seed = seed
        self.optimizer.zero_grad(set_to_none=True)
        if self.cfg.accum_steps <= 1:
            stats = self._single_pass(batch, seed)
        else:
            stats = self._multistage(batch, seed)
        return self._finish(stats)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch's rows from every rank's rows ``x``."""
        return dist.all_gather_micro(x, max(self.cfg.accum_steps, 1),
                                     self.group)

    def _gather_masks(self, batch: Batch):
        """The global (B, B) masks from every rank's (b, B) rows."""
        return (self._gather(batch["positives_mask"]),
                self._gather(batch["negatives_mask"]))

    def _single_pass(self, batch: Batch, seed: int):
        m, g = self.model, self.group
        pts, msk, nrm = batch["points"], batch["pmask"], batch.get("normals")
        b, r = pts.shape[0], dist.rank(g)
        masks, dseed = self._draws(b, 0)
        out = m(pts, msk, drop_masks=masks, normals=nrm, dropout_seed=dseed)
        emb = out["global"]
        if g is not None:
            # the other ranks' rows detached, this rank's with their graph
            every = dist.all_gather_rows(emb.detach(), g)
            emb = torch.cat([every[:r * b], emb, every[(r + 1) * b:]])
        loss, stats = self.loss_fn(emb, *self._gather_masks(batch))
        t_emb = self._teacher(pts, msk, normals=nrm)
        if t_emb is not None:
            loss = loss + self.cfg.mesa * kd_loss(
                emb, dist.all_gather_rows(t_emb, g))
        loss.backward()
        m.commit_stats()
        stats = dict(stats, octree_overflow=out["octree_overflow"])
        return stats

    def _multistage(self, batch: Batch, seed: int):
        m, A, g = self.model, self.cfg.accum_steps, self.group
        pts, msk, nrm = batch["points"], batch["pmask"], batch.get("normals")
        b, r = pts.shape[0], dist.rank(g)
        if b % A:
            raise ValueError(f"batch {b} is not a multiple of "
                             f"accum_steps {A}")
        mb = b // A
        chunks = [slice(i * mb, (i + 1) * mb) for i in range(A)]
        with torch.no_grad():
            plans = [build_model_plan(
                m.cfg, pts[sl], msk[sl],
                normals=None if nrm is None else nrm[sl]) for sl in chunks]
        draws = [self._draws(mb, i) for i in range(A)]

        # Stage 1: embeddings without parameter gradients.
        embs, t_embs, ovf = [], [], []
        with torch.no_grad():
            for i, sl in enumerate(chunks):
                out = m(pts[sl], msk[sl], plan=plans[i],
                        drop_masks=draws[i][0], dropout_seed=draws[i][1])
                embs.append(out["global"])
                ovf.append(out["octree_overflow"])
                t = self._teacher(pts[sl], msk[sl], plans[i])
                if t is not None:
                    t_embs.append(t)
        staged = m.staged_stats()      # the last microbatch's update
        emb = self._gather(torch.cat(embs)).detach().requires_grad_(True)

        # Stage 2: loss over the full batch, gradient w.r.t. embeddings.
        with torch.enable_grad():
            loss, stats = self.loss_fn(emb, *self._gather_masks(batch))
            if t_embs:
                loss = loss + self.cfg.mesa * kd_loss(
                    emb, self._gather(torch.cat(t_embs)))
            (g_emb,) = torch.autograd.grad(loss, emb)
        n = dist.world(g)                     # this rank's rows
        g_emb = g_emb.view(A, n, mb, -1)[:, r].reshape(b, -1)
        stats = dict(stats, octree_overflow=torch.stack(ovf).sum())

        # Stage 3: recompute per microbatch, chain rule into the params.
        diff = []
        for i, sl in enumerate(chunks):
            out = m(pts[sl], msk[sl], plan=plans[i], drop_masks=draws[i][0],
                    dropout_seed=draws[i][1])
            out["global"].backward(g_emb[sl])
            if self.cfg.check_recompute:
                diff.append((out["global"].detach() - embs[i]).abs().max())
        m.commit_stats(staged)
        if diff:
            stats["recompute_max_abs"] = torch.stack(diff).max()
        return stats

    def _finish(self, stats):
        for p in self.params:       # JAX gives zeros, not None, to unused
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        # once per step: the gradients and the overflow count, summed
        dist.all_reduce_sum_([p.grad for p in self.params]
                             + [stats["octree_overflow"]], self.group)
        stats["grad_norm"] = _grad_norm(self.params)
        lr = self.optimizer.schedule(self.state.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        ema = self.state.ema_model
        if self.cfg.use_ema and ema is not None:
            d = self.cfg.ema_decay
            with torch.no_grad():
                e_params = list(ema.parameters())
                torch._foreach_mul_(e_params, d)
                torch._foreach_add_(e_params, list(self.model.parameters()),
                                    alpha=1.0 - d)
        self.state.step += 1
        return stats


def make_train_step(model: HOTFormerLoc, optimizer: torch.optim.Optimizer,
                    loss_fn: Callable, cfg: StepConfig = StepConfig(),
                    group=None) -> TrainStep:
    """The train step: single pass for accum_steps <= 1, else the
    multistage step; over ``group`` when given (data parallelism:
    accum_steps global microbatches, each split over the ranks). The optimizer comes from
    ``make_optimizer`` (it carries the learning-rate schedule)."""
    return TrainStep(model, optimizer, loss_fn, cfg, group)


def make_eval_step(model: HOTFormerLoc, loss_fn: Callable, group=None):
    """Validation step: embeddings (eval mode, no gradients) + loss
    stats; over ``group``, of every rank's rows gathered, so the stats
    equal one process's on the global batch."""

    def eval_step(batch: Batch) -> Dict[str, torch.Tensor]:
        model.eval()
        with torch.no_grad():
            out = model(batch["points"], batch["pmask"],
                        normals=batch.get("normals"))
            _, stats = loss_fn(
                dist.all_gather_rows(out["global"], group),
                dist.all_gather_rows(batch["positives_mask"], group),
                dist.all_gather_rows(batch["negatives_mask"], group))
        return stats

    return eval_step
