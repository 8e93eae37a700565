"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

Each source under hotformerloc_torch/csrc/ is compiled by ``nvcc`` at
first use into a shared library with a plain C interface, loaded with
ctypes (build.py). A wrapper launches its kernel on a CUDA tensor and
takes the plain PyTorch version beside it only for a CPU tensor; a
build or launch error raises. Every kernel call goes through a
``torch.autograd.Function`` whose backward is the matching backward
kernel, so gradients flow through the kernels (but the LayerNorm's,
whose backward is aten's own, fed the kernel's statistics).

``LAUNCHES`` counts wrapper calls that launched on the card, per kernel
name, so a run can show that it went through the kernels. A backward
entry point counts once under its own name, whichever kernel bodies it
runs (dx of the convs reuses the forward bodies). ``window_attn``,
``window_attn_bwd``, ``octree_conv`` and ``octree_conv_bwd`` count every
launch of K1, K2, K5 and K6; the same names with ``_tc`` count those
that ran the tensor-core bodies. ``layer_norm`` counts every launch of
``layer_norm_rows_kernel``, one per LayerNorm module called on the card
(a forward, or its recompute under activation checkpointing); its
backward is aten's and counts nothing.
"""
from __future__ import annotations

LAUNCHES = {"window_attn": 0, "octree_dwconv": 0, "octree_conv": 0,
            "window_attn_bwd": 0, "octree_dwconv_bwd": 0,
            "octree_conv_bwd": 0,
            "window_attn_tc": 0, "window_attn_bwd_tc": 0,
            "octree_conv_tc": 0, "octree_conv_bwd_tc": 0,
            # every LayerNorm forward (norm.py; its backward is aten's)
            "layer_norm": 0,
            # the probe tools' kernels (gather.py, constructs.py)
            "take_rows": 0, "dwconv_resident": 0,
            **{f"construct_{n}": 0 for n in (
                "headloop", "reshape", "onehot4d", "dtab", "pad", "selloop",
                "softmax", "slicestore", "dk", "packbias",
                # the card's floor for them (mosaic_probe's floor line)
                "floor_empty", "floor_copy", "floor_chain")}}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_device(t, what: str) -> None:
    """Raise for a tensor on neither the CPU (the plain versions) nor a
    CUDA card (the kernels). The kernel ops register no meta (fake)
    implementation, so they are called only after this check."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
