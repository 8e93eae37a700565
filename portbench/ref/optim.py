# Frozen copy of lr_schedule from hotformerloc_torch/training/optim.py at
# commit 17534d0; ``adam_update`` writes out torch.optim.Adam's update.
"""The reference's optimizer: the epoch-granular learning-rate schedule
and Adam with L2 weight decay, written out."""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

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


def adam_update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                state: Dict[str, dict], lr: float, weight_decay: float,
                betas=(0.9, 0.999), eps: float = 1e-8) -> None:
    """One step of torch.optim.Adam (L2 weight decay added to the
    gradient before the moments, bias-corrected moments) on fp32
    ``params`` in place; ``state[name]`` keeps 'step', 'exp_avg',
    'exp_avg_sq'."""
    b1, b2 = betas
    with torch.no_grad():
        for name, p in params.items():
            g = grads[name] + weight_decay * p
            st = state.setdefault(name, {"step": 0,
                                         "exp_avg": torch.zeros_like(p),
                                         "exp_avg_sq": torch.zeros_like(p)})
            st["step"] += 1
            t = st["step"]
            st["exp_avg"].mul_(b1).add_(g, alpha=1 - b1)
            st["exp_avg_sq"].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (st["exp_avg_sq"].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
            p.addcdiv_(st["exp_avg"], denom, value=-lr / (1 - b1 ** t))
