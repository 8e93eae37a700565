"""Serving entry point: points -> descriptors.

Counterpart of hotformerloc_tpu/training/step.py:make_embed_step as the
evaluator drives it (bf16 compute, evaluation/pnv_evaluate.py).
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, Optional

import torch

from hotformerloc_torch.models.hotformerloc import HOTFormerLoc
from hotformerloc_torch.utils import profiling


def compute_dtype(device) -> torch.dtype:
    """The compute dtype of the train and evaluate entry points: bf16 on
    the card, fp32 on the CPU (as the JAX trainer picks per backend)."""
    return torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32


def make_embed_fn(model: HOTFormerLoc, dtype: torch.dtype = torch.bfloat16
                  ) -> Callable[[torch.Tensor, torch.Tensor],
                                Dict[str, torch.Tensor]]:
    """Return ``embed(points, pmask, normals=None) -> {'global',
    'octree_overflow'}`` (``normals`` (B, P, 3) for the 'N' input
    feature) running ``model`` in ``dtype`` (a converted copy when the
    model's parameters have another dtype) under
    ``torch.inference_mode``. Inputs are moved to the model's device.
    cuDNN TF32 is switched off during the call so fp32 runs stay fp32.
    Each call is one ``hfl.embed`` span, the root of the model's spans."""
    params = next(model.parameters())
    m = model if params.dtype == dtype else copy.deepcopy(model).to(dtype)
    m.eval()
    device = params.device

    def embed(points: torch.Tensor, pmask: torch.Tensor,
              normals: Optional[torch.Tensor] = None):
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            with profiling.annotate("hfl.embed"), torch.inference_mode():
                return m(points.to(device), pmask.to(device), dtype=dtype,
                         normals=None if normals is None
                         else normals.to(device))
        finally:
            torch.backends.cudnn.allow_tf32 = prev

    return embed
