"""Random weights from the seed, made on the device in one draw per
initialiser kind, and handed to both the program and the reference.

The parameters' names, shapes and initialisers come from the
reference's model built on the meta device (the same module tree as the
program's): ("trunc", std) a normal truncated at 2 std, ("fan_in", s)
variance scaling over the fan-in (prod(shape[:-1])), ("normal", std),
("const", value) (models/layers.py ``init_weights``, whose laws these
are; it draws them on the host leaf by leaf).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from portbench.ref.models.config import ModelConfig
from portbench.ref.models.hotformerloc import HOTFormerLoc as RefModel

_TRUNC_STD = 0.87962566103423978   # std of N(0,1) truncated to [-2, 2]


def make_weights(fields: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{parameter name: fp32 tensor on ``device``} for the configuration
    ``fields``; the same seed gives the same weights."""
    meta = RefModel(ModelConfig(**fields), device="meta")
    g = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    named = list(meta.named_parameters())
    out: Dict[str, torch.Tensor] = {}
    trunc = [(n, p) for n, p in named if p.init_kind[0] in ("trunc",
                                                             "fan_in")]
    normal = [(n, p) for n, p in named if p.init_kind[0] == "normal"]
    for group, draw in ((trunc, "trunc"), (normal, "normal")):
        if not group:
            continue
        sizes = [p.numel() for _, p in group]
        flat = torch.empty(sum(sizes), device=device)
        if draw == "trunc":
            nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=g)
        else:
            flat.normal_(0.0, 1.0, generator=g)
        scales = torch.tensor([_scale(p) for _, p in group], device=device)
        flat.mul_(torch.repeat_interleave(
            scales, torch.tensor(sizes, device=device)))
        for (n, p), t in zip(group, torch.split(flat, sizes)):
            out[n] = t.view(p.shape)
    for n, p in named:
        kind = p.init_kind
        if kind[0] == "const":
            out[n] = torch.full(p.shape, float(kind[1]), device=device)
        elif n not in out:
            raise ValueError(f"unknown initialiser {kind} for {n}")
    return out


def _scale(p) -> float:
    kind = p.init_kind
    if kind[0] == "trunc":
        return float(kind[1])
    if kind[0] == "fan_in":
        s = kind[1] if len(kind) > 1 else 1.0
        return math.sqrt(s / math.prod(p.shape[:-1])) / _TRUNC_STD
    return float(kind[1])                      # normal(std)


def load_weights(model: nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``model``'s parameters, which must have
    exactly these names."""
    names = {n for n, _ in model.named_parameters()}
    if names != set(weights):
        raise ValueError("parameter names differ: "
                         f"{sorted(names ^ set(weights))[:5]}")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])
