"""Determinism helpers: counterpart of hotformerloc_tpu/utils/seed.py."""
from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int = 42):
    """Seed the process-wide generators of ``random``, numpy and torch
    (the CPU one and every CUDA device's). The model's initial weights,
    the loader's draws and the DropPath masks come from explicit
    generators of their own; this covers anything that does not."""
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)         # also seeds every CUDA device
    print("Determinism: Enabled")
