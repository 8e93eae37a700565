"""Core layers: Linear, MLP, the norms (LayerNorm, MaskedBatchNorm,
PowerNorm), octree conv blocks, CPE / xCPE, ADaPE, LayerScale, DropPath,
Dropout, and the parameter initialisers.

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
convs and LayerNorms through the CUDA kernels of ops/kernels (whose CPU
path is the plain version); ``use_kernels = False`` runs the plain
tensor code.

Running statistics (``RunningStats``: MaskedBatchNorm, PowerNorm and the
heads' BatchNorm) follow the JAX package's ``batch_stats`` collection,
which a train-mode ``apply`` returns as a new state and the caller keeps
or drops. A train-mode forward here computes the new buffers and stages
them (``staged``) without writing them; ``HOTFormerLoc.commit_stats``
writes them. The train step commits once per step, the forward it keeps
(models/hotformerloc.py, training/step.py), so a recomputed forward
(stage 3 of the multistage step, activation checkpointing) changes
nothing. Under data parallelism each such module's ``group`` is the
process group (``HOTFormerLoc.set_stats_group``): a train-mode forward
at world > 1 sums its batch statistics over the ranks, so they are the
whole global microbatch's, as under the JAX package's mesh. Eval mode
and world 1 never reduce.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from hotformerloc_torch.ops import conv as plain
from hotformerloc_torch.ops.kernels import norm as knorm
from hotformerloc_torch.ops.kernels import octree_conv as kconv
from hotformerloc_torch.parallel import dist

# Parameter initialisers, matching the JAX package's distributions:
#   ("trunc", std)  N(0, std^2) truncated to [-2 std, 2 std] (flax
#                   truncated_normal(std): std is the untruncated
#                   normal's, the samples' is 0.88 std; Linear kernels,
#                   RPE tables)
#   ("fan_in", s)   variance_scaling(s, fan_in, truncated_normal) with
#                   fan_in = prod(shape[:-1]) (octree conv kernels; s = 1
#                   when omitted, 8 for the deconv)
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
                scale = (kind[1] if kind[0] == "trunc" else math.sqrt(
                    (kind[1] if len(kind) > 1 else 1.0)
                    / math.prod(p.shape[:-1])) / _TRUNC_STD)
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
    """nn.LayerNorm over the last axis computing in its input's dtype,
    through ``layer_norm_rows_kernel`` (ops/kernels/norm.py; the plain
    version on CPU tensors) when kernels are on, else ``F.layer_norm``.
    ``valid`` is taken and ignored, as by the other norms of
    ``make_norm`` that need it."""
    use_kernels = True

    def forward(self, x, valid=None):
        w, b = cast(self.weight, x), cast(self.bias, x)
        if self.use_kernels:
            return knorm.layer_norm(x, w, b, self.eps)
        return F.layer_norm(x, self.normalized_shape, w, b, self.eps)


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


class Dropout(nn.Module):
    """flax ``nn.Dropout``: keep each element with probability 1 - rate
    and scale it by 1 / (1 - rate). The mask comes from a generator on
    x's device seeded with ``seed``, which the model sets on every site
    before a train-mode forward (``HOTFormerLoc.forward``), so a forward
    run again with the same seeds (stage 3 of the multistage step, an
    activation-checkpoint recompute) draws the same masks. Identity when
    no seed is set (eval mode) or at rate 0. The JAX package draws its
    masks from its own key; the two agree in distribution, not in bits."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.seed: Optional[int] = None

    def forward(self, x):
        if self.seed is None or self.rate <= 0.0:
            return x
        g = torch.Generator(device=x.device).manual_seed(self.seed)
        keep = torch.rand(x.shape, generator=g, device=x.device) \
            >= self.rate
        return torch.where(keep, x / (1.0 - self.rate), 0.0).to(x.dtype)


class Mlp(nn.Module):
    """Two-layer exact-GELU MLP, with dropout at ``drop`` after the GELU
    and after the output."""

    def __init__(self, fin: int, hidden: int, out: int, drop: float = 0.0,
                 device=None):
        super().__init__()
        self.fc1 = linear(fin, hidden, device=device)
        self.fc2 = linear(hidden, out, device=device)
        self.drop1 = Dropout(drop)
        self.drop2 = Dropout(drop)

    def forward(self, x):
        return self.drop2(self.fc2(self.drop1(F.gelu(self.fc1(x)))))


class _Shared:
    """A reference that ``copy.deepcopy`` shares instead of copying (a
    process group cannot be copied; a model copy keeps its group)."""

    def __init__(self, value):
        self.value = value

    def __deepcopy__(self, memo):
        return self


class RunningStats(nn.Module):
    """A module with running statistics (buffers, the JAX package's
    ``batch_stats``). A train-mode forward puts the new values in
    ``staged`` instead of writing them; ``commit`` writes them.
    ``group`` is the process group its batch statistics are summed over
    (None: this process's rows only)."""
    staged: Optional[dict] = None
    _group = _Shared(None)

    @property
    def group(self):
        return self._group.value

    @group.setter
    def group(self, value) -> None:
        self._group = _Shared(value)

    def stage(self, **new) -> None:
        self.staged = {k: v.detach() for k, v in new.items()}

    def commit(self, staged: Optional[dict]) -> None:
        with torch.no_grad():
            for k, v in (staged or {}).items():
                getattr(self, k).copy_(v)

    def reduce_group(self):
        """The group a forward sums its statistics over: ``group`` in
        train mode at world > 1, else None."""
        return (self.group if self.training and dist.world(self.group) > 1
                else None)


def _masked_mean(v: torch.Tensor, valid: Optional[torch.Tensor],
                 group=None, grad: bool = True):
    """Mean of fp32 v (..., C) over every axis but the last, over the
    rows where ``valid`` (v.shape[:-1]) holds when given. With ``group``
    (world > 1) the sum and the row count are summed over its ranks
    first, differentiably (``dist.all_reduce_sum_diff``) or, with
    ``grad`` False, as constants (``dist.all_reduce_sum``)."""
    red = tuple(range(v.dim() - 1))
    if group is None:
        if valid is None:
            return v.mean(red)
        w = valid.to(torch.float32)[..., None]
        return (v * w).sum(red) / torch.clamp(w.sum(), min=1.0)
    if valid is None:
        s = v.sum(red)
        n = v.new_full((1,), float(math.prod(v.shape[:-1])))
    else:
        w = valid.to(torch.float32)[..., None]
        s, n = (v * w).sum(red), w.sum().reshape(1)
    both = torch.cat([s, n.to(s.dtype)])
    both = (dist.all_reduce_sum_diff if grad else dist.all_reduce_sum)(
        both, group)
    return both[:-1] / torch.clamp(both[-1], min=1.0)


class MaskedBatchNorm(RunningStats):
    """BatchNorm over valid octree nodes only (JAX models/layers.py
    MaskedBatchNorm): in train mode the fp32 mean and biased variance of
    the rows ``valid`` marks (every row when None), the running buffers
    staged as m * running + (1 - m) * batch with m = 0.9 (torch
    BatchNorm1d's momentum 0.1); in eval mode the running buffers."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5, device=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = param((features,), "const", 1.0, device=device)
        self.bias = param((features,), "const", 0.0, device=device)
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x, valid=None):
        xf = x.float()
        if self.training:
            g = self.reduce_group()
            mean = _masked_mean(xf, valid, g)
            var = _masked_mean((xf - mean) ** 2, valid, g)
            m = self.momentum
            self.stage(mean=m * self.mean + (1 - m) * mean,
                       var=m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)


def _group_scaling(xf: torch.Tensor, group_num: int, eps: float):
    """GroupScaling1D: every position divided by the square root of its
    channel group's second moment."""
    C = xf.shape[-1]
    g = xf.reshape(*xf.shape[:-1], group_num, C // group_num)
    m2 = (g * g).mean(-1, keepdim=True)
    return (g / torch.sqrt(m2 + eps)).reshape(xf.shape)


class PowerCoreFn(torch.autograd.Function):
    """z = xs * rsqrt(denom) with the PowerNorm paper's approximate
    backward, as JAX's ``_power_core``: the denominator is a constant (no
    gradient through the statistics) and
    gx = (g - (1 - abkw) * ema_gz * z) * rsqrt(var), with the batch
    variance ``var`` even when the forward divided by running_phi."""

    @staticmethod
    def forward(ctx, xs, denom, var, ema_gz, abkw):
        z = xs * torch.rsqrt(denom)
        ctx.save_for_backward(z, var, ema_gz)
        ctx.abkw = abkw
        return z

    @staticmethod
    def backward(ctx, g):
        z, var, ema_gz = ctx.saved_tensors
        gx = (g - (1.0 - ctx.abkw) * ema_gz * z) * torch.rsqrt(var)
        return gx, None, None, None, None


class PowerNorm(RunningStats):
    """MaskPowerNorm as the JAX package runs it (models/layers.py
    PowerNorm): group scaling, then division by the masked batch second
    moment during warm-up (iteration <= warmup_iters) and by
    ``running_phi`` after, then the affine map; ``PowerCoreFn``'s
    backward. Train mode stages iters + 1 and running_phi as JAX updates
    it: a cumulative average while iters + 1 < warmup_iters, then the EMA
    step with alpha_fwd on top of it, unconditionally. ``ema_gz`` is never
    written (the JAX package's documented deviation from the reference,
    which writes it inside its backward)."""

    def __init__(self, features: int, eps: float = 1e-5,
                 alpha_fwd: float = 0.9, alpha_bkw: float = 0.9,
                 warmup_iters: int = 10000, group_num: int = 1,
                 device=None):
        super().__init__()
        self.eps, self.alpha_fwd, self.alpha_bkw = eps, alpha_fwd, alpha_bkw
        self.warmup_iters, self.group_num = warmup_iters, group_num
        self.weight = param((features,), "const", 1.0, device=device)
        self.bias = param((features,), "const", 0.0, device=device)
        self.register_buffer("running_phi",
                             torch.ones(features, device=device))
        self.register_buffer("ema_gz", torch.zeros(features, device=device))
        self.register_buffer("iters", torch.zeros((), dtype=torch.int32,
                                                  device=device))

    def forward(self, x, valid=None):
        xs = _group_scaling(x.float(), self.group_num, self.eps)
        phi = self.running_phi
        if self.training:
            it = self.iters + 1
            # no gradient reaches the statistics (PowerCoreFn), so the
            # ranks' sums travel as constants
            var = _masked_mean(xs * xs, valid, self.reduce_group(),
                               grad=False)
            denom = torch.where(it <= self.warmup_iters, var, phi) + self.eps
            z = PowerCoreFn.apply(xs, denom, var + self.eps, self.ema_gz,
                                  self.alpha_bkw)
            itf = it.float()
            phi1 = torch.where(it < self.warmup_iters,
                               phi * (itf - 1.0) / itf + var / itf, phi)
            self.stage(running_phi=self.alpha_fwd * phi1
                       + (1.0 - self.alpha_fwd) * var, iters=it)
        else:
            z = xs * torch.rsqrt(phi + self.eps)
        return (z * self.weight.float() + self.bias.float()).to(x.dtype)


class BatchNorm(RunningStats):
    """flax ``nn.BatchNorm`` with its defaults (the pooling heads'):
    statistics over every axis but the last, padding rows included,
    biased variance E[x^2] - E[x]^2 clipped at 0 (flax's
    use_fast_variance), momentum 0.99 (running = 0.99 running + 0.01
    batch), eps 1e-5.

    ``two_pass`` takes the same variance as E[(x - E[x])^2], which loses
    less to rounding where the mean is large against the spread, as for
    a batch's pooled descriptors. There flax's form amplifies small
    differences of its input: chip_smoke.py's kernel-vs-plain gradients
    of ablation variant B (PyramidOctGeMgc) differed by 2.4 times its bar
    with it and by 0.08 to 0.24 times with two passes (H100 80GB HBM3,
    700 W).
    Agreeing with JAX needs flax's rounding, so it is off by default;
    chip_smoke.py turns it on to compare the kernel path with the plain
    path through such a head."""
    two_pass = False

    def __init__(self, features: int, momentum: float = 0.99,
                 eps: float = 1e-5, device=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = param((features,), "const", 1.0, device=device)
        self.bias = param((features,), "const", 0.0, device=device)
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x):
        xf = x.float()
        if self.training:
            g = self.reduce_group()
            mean = _masked_mean(xf, None, g)
            var = (_masked_mean((xf - mean) ** 2, None, g) if self.two_pass
                   else torch.clamp(_masked_mean(xf * xf, None, g)
                                    - mean * mean, min=0.0))
            m = self.momentum
            self.stage(mean=m * self.mean + (1 - m) * mean,
                       var=m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight.float())
        return (y + self.bias.float()).to(x.dtype)


def make_norm(kind: str, features: int, device=None) -> nn.Module:
    """The post-conv norm of ``ModelConfig.conv_norm`` (JAX models/
    layers.py Norm); each takes (x, valid)."""
    if kind == "layernorm":
        return layer_norm(features, device=device)
    if kind == "batchnorm":
        return MaskedBatchNorm(features, device=device)
    if kind == "powernorm":
        return PowerNorm(features, device=device)
    raise ValueError(f"unknown norm kind {kind}")


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
    """Stride-1 27-tap octree conv + norm (``conv_norm``) + ReLU. Every
    such conv, any C, goes through the K5 kernel when kernels are on.
    ``valid``: the level's node mask, for the batch statistics."""

    def __init__(self, cin: int, cout: int, conv_norm: str = "layernorm",
                 device=None):
        super().__init__()
        self.kernel = param((27, cin, cout), "fan_in", device=device)
        self.bias = param((cout,), "const", 0.0, device=device)
        self.norm = make_norm(conv_norm, cout, device=device)

    def forward(self, x, neigh, valid=None, taps=None):
        return F.relu(self.norm(self.conv(x, neigh, self.kernel, self.bias,
                                          taps), valid))


class Downsample(nn.Module):
    """Kernel-2 stride-2 conv + norm (no ReLU), plain tensor code.
    ``down`` is ``OctreePlan.down_tables``' (children, parent, octant),
    whose inverse tables give the scatter-free backward; ``valid`` the
    coarser level's node mask."""
    relu = False

    def __init__(self, cin: int, cout: int, conv_norm: str = "layernorm",
                 device=None):
        super().__init__()
        self.kernel = param((8, cin, cout), "fan_in", device=device)
        self.bias = param((cout,), "const", 0.0, device=device)
        self.norm = make_norm(conv_norm, cout, device=device)

    def forward(self, x, down, valid=None):
        children, parent, octant = down
        y = self.norm(plain.octree_down_conv(x, children,
                                             cast(self.kernel, x),
                                             cast(self.bias, x), parent,
                                             octant), valid)
        return F.relu(y) if self.relu else y


class OctreeDownConvNormRelu(Downsample):
    """Kernel-2 stride-2 conv + norm + ReLU (stem downsample)."""
    relu = True


class OctreeDeconvNormRelu(nn.Module):
    """Kernel-2 stride-2 transposed conv + norm + ReLU (JAX models/
    layers.py OctreeDeconvNormRelu; no model builds it): depth d - 1
    features onto the depth-d nodes. ``down`` is the depth-d
    ``OctreePlan.down_tables`` (children, parent, octant); ``valid`` the
    depth-d node mask. Each output node takes one tap (its parent through
    its octant's slice), so the init's variance_scaling scale is 8 on
    the (8, C, O) kernel."""

    def __init__(self, cin: int, cout: int, conv_norm: str = "layernorm",
                 device=None):
        super().__init__()
        self.kernel = param((8, cin, cout), "fan_in", 8.0, device=device)
        self.bias = param((cout,), "const", 0.0, device=device)
        self.norm = make_norm(conv_norm, cout, device=device)

    def forward(self, x, down, valid=None):
        children, parent, octant = down
        y = plain.octree_deconv(x, parent, octant, cast(self.kernel, x),
                                cast(self.bias, x), children)
        return F.relu(self.norm(y, valid))


class CPE(_KernelRouted):
    """Conditional positional encoding: depthwise 27-tap octree conv +
    norm, through the K3 kernel when kernels are on, at every depth. The
    JAX package runs the CPE at depths <= ``dense_cpe_max_depth`` on a
    dense voxel grid instead; the function is the same
    (tests/test_torch_cpe.py).

    ``xcpe``: a full 27-tap conv with bias (K5 forward, K6 backward, at
    every depth; the JAX package sends it through its banded conv, the
    same function) followed by a Linear, in place of the depthwise conv.
    Activation checkpointing's 'save_hot' keeps the conv's output (K3's,
    or the xCPE's K5's), so the backward runs neither again."""

    def __init__(self, dim: int, conv_norm: str = "layernorm",
                 xcpe: bool = False, device=None):
        super().__init__()
        self.xcpe = xcpe
        if xcpe:
            self.kernel = param((27, dim, dim), "fan_in", device=device)
            self.bias = param((dim,), "const", 0.0, device=device)
            self.linear = linear(dim, dim, device=device)
        else:
            self.dw_kernel = param((27, dim, 1), "fan_in", device=device)
        self.norm = make_norm(conv_norm, dim, device=device)

    def forward(self, x, ctx):
        if self.xcpe:
            y = self.linear(self.conv(x, ctx.neigh, self.kernel, self.bias,
                                      ctx.taps))
        else:
            y = self.dwconv(x, ctx.neigh, self.dw_kernel[..., 0], ctx.taps)
        return self.norm(y, ctx.node_valid)


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
