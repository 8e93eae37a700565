"""Flax parameters of the JAX package -> a HOTFormerLoc state_dict.

``params_from_jax`` takes the flax ``params`` tree as nested dicts of
numpy arrays (no JAX needed) and renames it onto this package's modules:

* flax's automatic submodule names become attribute names (``_RENAME``);
* Dense kernels (in, out) become ``nn.Linear.weight`` (out, in) and
  LayerNorm ``scale`` becomes ``weight``;
* octree conv kernels, depthwise kernels, RPE tables and pooling queries
  keep their JAX layout;
* the ``backbone/hotf_stage/iter`` subtree, stacked on a leading axis by
  ``nn.scan``, is unstacked into ``backbone.hotf_stage.iters.<i>``
  (``jax_leaf`` maps those names back onto their one stacked leaf).

Every JAX leaf is used exactly once and every parameter of the target
model is set; the converter raises otherwise. Any tree shaped like the
params maps the same way: ``params_from_jax`` of a ``jax.grad`` tree
gives the gradients by the port's parameter names (Dense kernels
transposed like the weights), which is how the tests compare gradients.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_RENAME = {
    "CPE_0": "cpe", "WindowAttention_0": "attn", "TokenAttention_0": "attn",
    "Mlp_0": "mlp", "LayerNorm_0": "norm1", "LayerNorm_1": "norm2",
    "Dense_0": "fc1", "Dense_1": "fc2", "LayerScale_0": "ls1",
    "LayerScale_1": "ls2",
}
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
        if path[i] == "Norm_0" and path[i + 1] == "LayerNorm_0":
            parts.append("norm")       # Norm wrapper around a LayerNorm
            i += 2
            continue
        parts.append(_RENAME.get(path[i], path[i]))
        i += 1
    leaf = path[-1]
    is_norm = parts[-1].startswith("norm")
    if leaf == "scale" and is_norm:
        leaf = "weight"
    return ".".join(parts + [leaf]), leaf == "kernel"


def params_from_jax(params: Dict, model: torch.nn.Module
                    ) -> Dict[str, torch.Tensor]:
    """Convert a flax param tree (nested dicts of numpy arrays, the value
    of ``variables['params']``) into a state_dict for ``model``."""
    target = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    n_iters = len(model.backbone.hotf_stage.iters)

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

    for path, arr in _leaves(params):
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
        raise KeyError(f"parameters not set by the JAX tree: {missing[:8]}"
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
