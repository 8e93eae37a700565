"""Operand precision of the reference's products.

The reference computes in fp32 (or in the compute dtype its caller
asks for). ``fp8_products`` rounds both operands of every product (the
Linear layers, the convs, the attention and pooling products) to
float8 e4m3 with one scale per tensor (its absolute maximum onto 448),
accumulating in fp32 as the H100's fp8 tensor cores do: the control of
the benchmark's comparison, one precision step below the bf16 the
configurations state. Only forward operands are rounded: a backward
product takes the rounded forward operand and the unrounded gradient.
"""
from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


class _State:
    fp8 = False


def _round_e4m3(t: torch.Tensor) -> torch.Tensor:
    """t rounded to e4m3 with one scale per tensor; the gradient passes
    through unchanged (the rounding is a constant offset to autograd)."""
    with torch.no_grad():
        tf = t.float()
        scale = torch.clamp(tf.abs().amax(), min=1e-30) / E4M3_MAX
        q = ((tf / scale).to(torch.float8_e4m3fn).float() * scale).to(
            t.dtype)
    return t + (q - t).detach() if t.requires_grad else q


def product(t: torch.Tensor) -> torch.Tensor:
    """``t`` as an operand of a product: itself, or under
    ``fp8_products`` rounded to e4m3."""
    return _round_e4m3(t) if _State.fp8 else t


@contextlib.contextmanager
def fp8_products():
    prev = _State.fp8
    _State.fp8 = True
    try:
        yield
    finally:
        _State.fp8 = prev
