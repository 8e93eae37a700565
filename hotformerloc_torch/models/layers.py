"""Core layers: Linear, MLP, LayerNorm, octree conv blocks, CPE, ADaPE,
LayerScale, DropPath, and the parameter initialisers.

Counterparts of hotformerloc_tpu/models/layers.py. Parameter layouts
follow the JAX package so that ``convert.params_from_jax`` is a rename:
conv weights are (taps, C, O), depthwise weights (27, C, 1), RPE tables
(3*num, H).

Compute dtype is the activations' dtype, the flax way: every module
casts its (fp32) parameters to the dtype of its input at use
(``Dense(dtype=bf16)`` with fp32 params, ``w.astype(self.dtype)`` in the
convs), so a bf16 step keeps fp32 parameters and fp32 gradients. A
model converted with ``.to(torch.bfloat16)`` (bf16 serving) casts
nothing. Softmax logits stay fp32.

Kernel routing: modules with a ``use_kernels`` attribute send stride-1
convs through the CUDA kernels of ops/kernels (whose CPU path is the
plain version); ``use_kernels = False`` runs the plain tensor code.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from hotformerloc_torch.ops import conv as plain
from hotformerloc_torch.ops.kernels import octree_conv as kconv

# Parameter initialisers, matching the JAX package's distributions:
#   ("trunc", std)  N(0, std^2) truncated to [-2 std, 2 std] (flax
#                   truncated_normal(std): std is the untruncated
#                   normal's, the samples' is 0.88 std; Linear kernels,
#                   RPE tables)
#   ("fan_in",)     variance_scaling(1, fan_in, truncated_normal) with
#                   fan_in = prod(shape[:-1]) (octree conv kernels)
#   ("normal", s)   normal(s) (pooling queries)
#   ("const", v)    constant
_TRUNC_STD = 0.87962566103423978   # std of N(0,1) truncated to [-2, 2]


def tag(p: nn.Parameter, *kind) -> nn.Parameter:
    p.init_kind = kind
    return p


def param(shape, *kind, device=None) -> nn.Parameter:
    return tag(nn.Parameter(torch.empty(shape, device=device)), *kind)


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Initialise every tagged parameter from ``generator`` (a CPU
    generator), in named_parameters order, then copy to the device: the
    same seed gives the same weights on every device."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            kind = getattr(p, "init_kind", None)
            if kind is None:
                raise ValueError(f"parameter {name} has no initialiser")
            t = torch.empty(p.shape, dtype=torch.float32)
            if kind[0] in ("trunc", "fan_in"):
                # variance_scaling corrects for the truncation,
                # truncated_normal does not
                scale = (kind[1] if kind[0] == "trunc" else 1.0 / (
                    math.sqrt(math.prod(p.shape[:-1])) * _TRUNC_STD))
                nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                t.mul_(scale)
            elif kind[0] == "normal":
                t.normal_(0.0, kind[1], generator=generator)
            elif kind[0] == "const":
                t.fill_(kind[1])
            else:
                raise ValueError(f"unknown initialiser {kind} for {name}")
            p.copy_(t)


def cast(p: Optional[torch.Tensor], x: torch.Tensor):
    """Parameter p in x's dtype (p itself when it already is)."""
    return None if p is None else p.to(x.dtype)


class Linear(nn.Linear):
    """nn.Linear computing in its input's dtype."""

    def forward(self, x):
        return F.linear(x, cast(self.weight, x), cast(self.bias, x))


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm computing in its input's dtype."""

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, cast(self.weight, x),
                            cast(self.bias, x), self.eps)


def linear(fin: int, fout: int, bias: bool = True, device=None) -> Linear:
    """Linear with trunc-normal(0.02) weight and zero bias."""
    m = Linear(fin, fout, bias=bias, device=device)
    tag(m.weight, "trunc", 0.02)
    if bias:
        tag(m.bias, "const", 0.0)
    return m


def layer_norm(dim: int, device=None) -> LayerNorm:
    m = LayerNorm(dim, eps=1e-5, device=device)
    tag(m.weight, "const", 1.0)
    tag(m.bias, "const", 0.0)
    return m


class Mlp(nn.Module):
    """Two-layer exact-GELU MLP."""

    def __init__(self, fin: int, hidden: int, out: int, device=None):
        super().__init__()
        self.fc1 = linear(fin, hidden, device=device)
        self.fc2 = linear(hidden, out, device=device)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class LayerScale(nn.Module):
    """Optional per-channel residual scale; identity when init is None."""

    def __init__(self, dim: int, init: Optional[float], device=None):
        super().__init__()
        self.gamma = (None if init is None
                      else param((dim,), "const", init, device=device))

    def forward(self, x):
        return x if self.gamma is None else x * cast(self.gamma, x)


class DropPath(nn.Module):
    """Per-sample stochastic depth on a residual branch (timm; the JAX
    DropPath, hotformerloc_tpu/models/layers.py:429-451): x * mask[b]
    with mask[b] in {0, 1/keep}.

    The mask is drawn outside (``HOTFormerLoc.draw_drop_masks``) and set
    in ``self.mask`` (B,) before a forward, so that a recomputed forward
    (stage 3 of the multistage step) sees the same masks. Identity when
    no mask is set: in eval mode, or at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.mask: Optional[torch.Tensor] = None

    def forward(self, x):
        if self.mask is None:
            return x
        m = self.mask.to(device=x.device, dtype=x.dtype)
        return x * m.reshape((x.shape[0],) + (1,) * (x.dim() - 1))


class _KernelRouted(nn.Module):
    """Routes stride-1 convs through the kernels' autograd Functions
    (``use_kernels``) or the plain tensor code; weights are cast to the
    activation dtype either way (the Functions cast inside, so their
    weight gradients come back fp32)."""
    use_kernels = True

    def conv(self, x, neigh, w, b, taps=None):
        if self.use_kernels:
            return kconv.octree_conv(x, neigh, w, b, taps)
        return plain.octree_conv(x, neigh, cast(w, x), cast(b, x))

    def dwconv(self, x, neigh, w, taps=None):
        if self.use_kernels:
            return kconv.octree_dwconv(x, neigh, w, taps)
        return plain.octree_dwconv(x, neigh, cast(w, x))


class OctreeConvNormRelu(_KernelRouted):
    """Stride-1 27-tap octree conv + LayerNorm + ReLU. Every such conv,
    any C, goes through the K5 kernel when kernels are on."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.kernel = param((27, cin, cout), "fan_in", device=device)
        self.bias = param((cout,), "const", 0.0, device=device)
        self.norm = layer_norm(cout, device=device)

    def forward(self, x, neigh, taps=None):
        return F.relu(self.norm(self.conv(x, neigh, self.kernel, self.bias,
                                          taps)))


class Downsample(nn.Module):
    """Kernel-2 stride-2 conv + LayerNorm (no ReLU), plain tensor code.
    ``down`` is ``OctreePlan.down_tables``' (children, parent, octant),
    whose inverse tables give the scatter-free backward."""
    relu = False

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.kernel = param((8, cin, cout), "fan_in", device=device)
        self.bias = param((cout,), "const", 0.0, device=device)
        self.norm = layer_norm(cout, device=device)

    def forward(self, x, down):
        children, parent, octant = down
        y = self.norm(plain.octree_down_conv(x, children,
                                             cast(self.kernel, x),
                                             cast(self.bias, x), parent,
                                             octant))
        return F.relu(y) if self.relu else y


class OctreeDownConvNormRelu(Downsample):
    """Kernel-2 stride-2 conv + LayerNorm + ReLU (stem downsample)."""
    relu = True


class CPE(_KernelRouted):
    """Conditional positional encoding: depthwise 27-tap octree conv +
    LayerNorm, through the K3 kernel when kernels are on, at every depth.
    The JAX package runs the CPE at depths <= ``dense_cpe_max_depth`` on
    a dense voxel grid instead; the function is the same
    (tests/test_torch_cpe.py)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.dw_kernel = param((27, dim, 1), "fan_in", device=device)
        self.norm = layer_norm(dim, device=device)

    def forward(self, x, ctx):
        return self.norm(self.dwconv(x, ctx.neigh, self.dw_kernel[..., 0],
                                     ctx.taps))


class ADaPE(nn.Module):
    """Distribution-aware position encoding: MLP over window statistics."""

    def __init__(self, nstats: int, dim: int, device=None):
        super().__init__()
        self.mlp = Mlp(nstats, dim, dim, device=device)

    def forward(self, stats, dtype: torch.dtype):
        return self.mlp(stats.to(dtype))


def rpe_pos_bnd(patch_size: int, dilation: int) -> int:
    """pos_bnd = int(0.8 * K * sqrt(D))."""
    return int(0.8 * patch_size * dilation**0.5)
