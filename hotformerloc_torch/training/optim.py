"""Optimizers and learning-rate schedules.

Counterparts of hotformerloc_tpu/training/optim.py. ``lr_schedule``
returns the same piecewise, epoch-granular schedule as a plain function
step -> lr; ``make_optimizer`` returns a ``torch.optim`` optimizer with
the schedule attached (``optimizer.schedule``), which the train step
reads before each update (optax evaluates it at the update count, so
step 0 uses schedule(0)).
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Sequence

import torch

from hotformerloc_torch.convert import jax_leaf


def lr_schedule(base_lr: float, steps_per_epoch: int, epochs: int,
                scheduler: str = "MultiStepLR",
                milestones: Sequence[int] = (),
                gamma: float = 0.1, min_lr: float = 0.0,
                warmup_epochs: Optional[int] = None
                ) -> Callable[[int], float]:
    """step -> lr. A linear epoch-wise warm-up (factor at least 1e-3)
    over ``warmup_epochs``, then MultiStepLR / CosineAnnealingLR /
    ExponentialLR / constant counted in epochs from the end of warm-up."""
    spe = max(1, steps_per_epoch)
    wu = warmup_epochs or 0
    if scheduler not in ("MultiStepLR", "CosineAnnealingLR",
                         "ExponentialLR", None, "none", "constant"):
        raise NotImplementedError(f"Unsupported LR scheduler: {scheduler}")
    ms = list(milestones) if milestones else [epochs + 1]

    def schedule(step: int) -> float:
        e = float(step // spe)
        if scheduler == "MultiStepLR":
            main = base_lr * gamma ** sum((e - wu) >= m for m in ms)
        elif scheduler == "CosineAnnealingLR":
            t_max = epochs + 1
            main = min_lr + 0.5 * (base_lr - min_lr) * (
                1 + math.cos(math.pi * min(e - wu, t_max) / t_max))
        elif scheduler == "ExponentialLR":
            main = base_lr * gamma ** max(e - wu, 0)
        else:
            main = base_lr
        if wu > 0 and e < wu:
            return base_lr * max(e / wu, 1e-3)
        return main

    return schedule


class Lamb(torch.optim.Optimizer):
    """``optax.lamb(lr, weight_decay=wd)``, written out: per parameter
    u = m_hat / (sqrt(v_hat) + eps) (Adam moments, b1 0.9, b2 0.999, eps
    1e-6, eps_root 0) plus wd * p on every parameter; then per leaf
    p -= lr * r * u with the trust ratio r = ||p|| / ||u|| (1 where
    either is 0). A leaf is a list of parameters whose norms are taken
    together: optax's leaf is a whole array, and the JAX package stacks
    the HOTFormer iterations' parameters in one (``convert.jax_leaf``).
    Parameters without a gradient are skipped, as torch's Adam does."""

    def __init__(self, leaves: Sequence[Sequence[torch.nn.Parameter]],
                 lr: float, betas=(0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.0):
        self.leaves = [list(leaf) for leaf in leaves]
        super().__init__([p for leaf in self.leaves for p in leaf],
                         dict(lr=lr, betas=betas, eps=eps,
                              weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        group = self.param_groups[0]
        b1, b2 = group["betas"]
        for leaf in self.leaves:
            ps, us = [], []
            for p in leaf:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
                t = st["step"]
                m, v = st["exp_avg"], st["exp_avg_sq"]
                m.mul_(b1).add_(p.grad, alpha=1 - b1)
                v.mul_(b2).addcmul_(p.grad, p.grad, value=1 - b2)
                u = (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt()
                                           + group["eps"])
                ps.append(p)
                us.append(u.add_(p, alpha=group["weight_decay"]))
            if not ps:
                continue
            p_norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(p) for p in ps]))
            u_norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(u) for u in us]))
            ratio = torch.where((p_norm == 0) | (u_norm == 0),
                                torch.ones_like(p_norm), p_norm / u_norm)
            scale = -group["lr"] * ratio
            for p, u in zip(ps, us):
                p.add_(u * scale)
        return loss


def make_optimizer(params: Iterable, optimizer: str,
                   schedule: Callable[[int], float],
                   weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """'adam': torch Adam, whose weight decay is L2 added to the gradient
    before the moments (optax add_decayed_weights then scale_by_adam);
    'adamw': decoupled decay (optax.adamw); 'lamb': ``Lamb``
    (optax.lamb). ``params``: parameters, or (name, parameter) pairs such
    as ``model.named_parameters()``; LAMB needs the names to take one
    trust ratio per JAX leaf, and takes each parameter as its own leaf
    without them."""
    name = optimizer.lower()
    wd = weight_decay or 0.0
    lr = schedule(0)
    items = list(params)
    named = [it for it in items if isinstance(it, tuple)]
    if named and len(named) != len(items):
        raise ValueError("params: give all parameters with names or none")
    plist = [it[1] for it in named] if named else items
    if name == "adam":
        opt = torch.optim.Adam(plist, lr=lr, weight_decay=wd)
    elif name == "adamw":
        opt = torch.optim.AdamW(plist, lr=lr, weight_decay=wd)
    elif name == "lamb":
        leaves: dict = {}
        for n, p in named:
            leaves.setdefault(jax_leaf(n), []).append(p)
        opt = Lamb(list(leaves.values()) if named else [[p] for p in plist],
                   lr=lr, weight_decay=wd)
    else:
        raise NotImplementedError(f"Unsupported optimizer: {optimizer}")
    opt.schedule = schedule
    return opt
