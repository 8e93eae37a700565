"""Flax variables of the JAX package -> a HOTFormerLoc state_dict.

``params_from_jax`` takes the flax ``params`` tree, and optionally the
``batch_stats`` tree, as nested dicts of numpy arrays (no JAX needed)
and renames them onto this package's modules:

* flax's automatic submodule names become attribute names (``_RENAME``;
  a ``Norm`` wrapper and the norm inside it become ``norm``);
* Dense kernels (in, out) become ``nn.Linear.weight`` (out, in) and a
  norm's ``scale`` becomes ``weight``;
* ``batch_stats`` leaves (MaskedBatchNorm's and the heads' BatchNorms'
  ``mean`` / ``var``, PowerNorm's ``running_phi`` / ``ema_gz`` /
  ``iters``) become the buffers of those names;
* octree conv kernels, depthwise kernels, RPE tables and pooling queries
  keep their JAX layout;
* the ``backbone/hotf_stage/iter`` subtree, stacked on a leading axis by
  ``nn.scan`` (params and batch_stats alike), is unstacked into
  ``backbone.hotf_stage.iters.<i>`` (``jax_leaf`` maps those names back
  onto their one stacked leaf).

Every JAX leaf is used exactly once and every parameter of the target
model is set, and every buffer when ``batch_stats`` is given; the
converter raises otherwise. Any tree shaped like the
params maps the same way: ``params_from_jax`` of a ``jax.grad`` tree
gives the gradients by the port's parameter names (Dense kernels
transposed like the weights), which is how the tests compare gradients.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_RENAME = {
    "CPE_0": "cpe", "WindowAttention_0": "attn", "TokenAttention_0": "attn",
    "Mlp_0": "mlp", "LayerNorm_0": "norm1", "LayerNorm_1": "norm2",
    "Dense_0": "fc1", "Dense_1": "fc2", "LayerScale_0": "ls1",
    "LayerScale_1": "ls2", "GeM_0": "gem", "GatingContext_0": "gating",
}
# the norm modules a flax Norm wrapper holds, one at a time
_NORMS = ("LayerNorm_0", "MaskedBatchNorm_0", "PowerNorm_0")
_STACKED = ("backbone", "hotf_stage", "iter")
# the port's prefix of the parameters unstacked from that subtree
_UNSTACKED = "backbone.hotf_stage.iters."


def _leaves(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _torch_name(path: Tuple[str, ...]) -> Tuple[str, bool]:
    """flax path -> (torch parameter name, is_dense_kernel) for one
    unstacked leaf."""
    parts = []
    i = 0
    while i < len(path) - 1:
        if path[i] == "Norm_0" and path[i + 1] in _NORMS:
            parts.append("norm")       # Norm wrapper around its norm
            i += 2
            continue
        parts.append(_RENAME.get(path[i], path[i]))
        i += 1
    leaf = path[-1]
    if leaf == "scale":                # only norms have a scale
        leaf = "weight"
    return ".".join(parts + [leaf]), leaf == "kernel"


def params_from_jax(params: Dict, model: torch.nn.Module,
                    batch_stats: Optional[Dict] = None
                    ) -> Dict[str, torch.Tensor]:
    """Convert a flax param tree (nested dicts of numpy arrays, the value
    of ``variables['params']``) into a state_dict for ``model``, with the
    running-statistics buffers from ``batch_stats`` (the value of
    ``variables['batch_stats']``) when given. Without it the dict holds
    the parameters only (``load_state_dict(..., strict=False)`` keeps the
    model's buffers)."""
    state = model.state_dict()
    names = {n for n, _ in model.named_parameters()}
    if batch_stats is not None:
        names |= {n for n, _ in model.named_buffers()}
    target = {n: state[n] for n in names}
    out: Dict[str, torch.Tensor] = {}
    hotf = getattr(getattr(model, "backbone", None), "hotf_stage", None)
    n_iters = len(getattr(hotf, "iters", ()))

    def put(name: str, arr: np.ndarray, dense: bool, src: str):
        if dense and name[:-len("kernel")] + "weight" in target \
                and arr.ndim == 2:
            name = name[:-len("kernel")] + "weight"
            arr = arr.T
        if name not in target:
            raise KeyError(f"JAX leaf {src} maps to {name}, which the "
                           "model does not have")
        if name in out:
            raise KeyError(f"two JAX leaves map to {name}")
        want = tuple(target[name].shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"{src} -> {name}: shape {arr.shape} != {want}")
        out[name] = torch.tensor(np.ascontiguousarray(arr),
                                 dtype=target[name].dtype)

    leaves = list(_leaves(params))
    if batch_stats is not None:
        leaves += list(_leaves(batch_stats))
    for path, arr in leaves:
        src = "/".join(path)
        if path[:3] == _STACKED:
            if arr.shape[0] != n_iters:
                raise ValueError(f"{src}: stacked axis {arr.shape[0]} != "
                                 f"{n_iters} iterations")
            name, dense = _torch_name(path[3:])
            for i in range(n_iters):
                put(f"{_UNSTACKED}{i}.{name}", arr[i], dense,
                    src)
        else:
            name, dense = _torch_name(path)
            put(name, arr, dense, src)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"entries not set by the JAX tree: {missing[:8]}"
                       f"{' ...' if len(missing) > 8 else ''}")
    return out


def jax_leaf(name: str) -> str:
    """The JAX leaf a port parameter comes from, named by the port's
    parameter name with the iteration index of an unstacked HOTFormer
    iteration replaced by ``*``: the parameters of one stacked leaf share
    the name. (Per-leaf optimiser terms such as LAMB's trust ratio are
    taken over the whole leaf.)"""
    if name.startswith(_UNSTACKED):
        return _UNSTACKED + "*." + name[len(_UNSTACKED):].split(".", 1)[1]
    return name
