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


def make_optimizer(params: Iterable[torch.nn.Parameter], optimizer: str,
                   schedule: Callable[[int], float],
                   weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """'adam': torch Adam, whose weight decay is L2 added to the gradient
    before the moments (optax add_decayed_weights then scale_by_adam);
    'adamw': decoupled decay (optax.adamw). 'lamb' is not ported."""
    name = optimizer.lower()
    wd = weight_decay or 0.0
    lr = schedule(0)
    if name == "adam":
        opt = torch.optim.Adam(params, lr=lr, weight_decay=wd)
    elif name == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, weight_decay=wd)
    elif name == "lamb":
        raise NotImplementedError("lamb: torch.optim has no LAMB; not "
                                  "ported yet")
    else:
        raise NotImplementedError(f"Unsupported optimizer: {optimizer}")
    opt.schedule = schedule
    return opt
