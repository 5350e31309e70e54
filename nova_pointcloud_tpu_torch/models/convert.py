"""Convert the JAX model's parameters into the port's ``state_dict``.

Input: the flax param pytree of ``nova_pointcloud_tpu``'s
``NOVAPointCloudTransformer`` with numpy leaves (``jax.tree.map(np.asarray,
params)``); this module never imports JAX. Mapping:

- ``Dense`` kernel (in, out) -> ``nn.Linear.weight`` (out, in); bias as is.
- ``LayerNorm`` scale / bias -> weight / bias.
- ``MultiHeadDotProductAttention`` (under ``attn`` / ``cluster_attn``):
  query/key/value kernels (D, H, hd) -> (D, D) transposed, biases (H, hd)
  -> (D,); the out kernel (H, hd, D) -> (D, D) transposed.
- The scanned stack ``blocks/layers/block/...`` carries a leading depth
  axis: leaf ``[i]`` goes to ``blocks.layers.{i}....``.

``convert_tree`` carries the ``qparams`` and act-scale trees across: they
have the same keys and shapes on both sides.
"""

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

_MHA_PARENTS = ("attn", "cluster_attn")
_MHA_PROJ = ("query", "key", "value", "out")
_STACK = ("blocks", "layers", "block")


def _leaves(tree, path=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, np.asarray(tree)


def _convert_leaf(path: Tuple[str, ...], v: np.ndarray, lead: int):
    """(torch name suffix, array) for one leaf; ``lead`` leading stack axes."""
    name = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    in_mha = len(path) > 2 and path[-3] in _MHA_PARENTS and parent in _MHA_PROJ
    stack = v.shape[:lead]
    if name == "kernel":
        if in_mha and parent == "out":  # (H, hd, D) -> (H*hd, D)
            v = v.reshape(stack + (-1, v.shape[-1]))
        elif in_mha:  # (D, H, hd) -> (D, H*hd)
            v = v.reshape(stack + (v.shape[lead], -1))
        return "weight", np.swapaxes(v, -1, -2)
    if name == "bias":
        if in_mha and parent != "out":  # (H, hd) -> (D,)
            v = v.reshape(stack + (-1,))
        return "bias", v
    if name == "scale":
        return "weight", v
    return name, v


def convert_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax param tree (numpy leaves) -> the port's ``state_dict``."""
    out = {}
    for path, v in _leaves(params):
        stacked = path[:3] == _STACK
        suffix, arr = _convert_leaf(path, v, 1 if stacked else 0)
        if stacked:
            rest = ".".join(path[3:-1] + (suffix,))
            for i in range(arr.shape[0]):
                out[f"blocks.layers.{i}.{rest}"] = torch.from_numpy(
                    np.ascontiguousarray(arr[i]))
        else:
            out[".".join(path[:-1] + (suffix,))] = torch.from_numpy(
                np.ascontiguousarray(arr))
    return out


def convert_tree(tree):
    """Nested dict of arrays -> the same nesting of torch tensors."""
    if isinstance(tree, dict):
        return {k: convert_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))
