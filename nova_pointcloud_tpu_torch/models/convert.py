"""Convert the JAX model's parameters into the port's ``state_dict``.

Input: the flax param pytree of ``nova_pointcloud_tpu``'s
``NOVAPointCloudTransformer``, ``ARRefiner``, ``NOVAPointCloudARTransformer``
or ``NOVATransformer`` with numpy leaves
(``jax.tree.map(np.asarray, params)``); this module never imports JAX.
Mapping:

- ``Dense`` kernel (in, out) -> ``nn.Linear.weight`` (out, in); bias as is.
- ``LayerNorm`` scale / bias -> weight / bias.
- ``Embed`` embedding (vocab, D) -> ``nn.Embedding.weight`` as is.
- ``MultiHeadDotProductAttention`` (under ``attn`` / ``cluster_attn`` /
  ``biattn``):
  query/key/value kernels (D, H, hd) -> (D, D) transposed, biases (H, hd)
  -> (D,); the out kernel (H, hd, D) -> (D, D) transposed.
- A scanned stack (``<parent>/layers/block/...`` in the pc model,
  ``<vit>/enc_layers/block/...`` and ``<vit>/dec_layers/block/...`` in the
  NOVA ViTs and the masked-AR pc model's ``encoder``, ``layers/block/...``
  in the Phi text encoder) carries a leading
  depth axis: leaf ``[i]`` goes to ``<parent>.layers.{i}....``
  (``<vit>.enc_layers.{i}....``).
- Everything else (the diffusion heads' and the refiner's ``blocks_{i}``,
  raw parameters such as ``null_prompt``, ``bos_token``, ``pos_embed`` or
  the label table's ``weight``) keeps its path, dot-joined.

``convert_tree`` carries the ``qparams`` and act-scale trees across: they
have the same keys and shapes on both sides. ``jax_param_paths`` goes the
other way for a model: each port parameter's JAX path and JAX rank, which
the optimizer's masks are defined on (engine/optim.py). A JAX gradient tree
has the param tree's structure, so ``convert_params`` names its leaves too.

The VAEs (``models/autoencoders``) have an entry of their own,
``convert_vae_params``: their trees hold convolutions, whose kernels no
rule of ``convert_params`` may take by rank (a scanned stack's attention
kernels are rank 4 too).
"""

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

_MHA_PARENTS = ("attn", "cluster_attn", "biattn")
_MHA_PROJ = ("query", "key", "value", "out")
_SCANS = ("layers", "enc_layers", "dec_layers")  # nn.scan stacks: <scan>/block/...


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
    if name in ("scale", "embedding"):
        return "weight", v
    return name, v


def _stack_index(path: Tuple[str, ...]):
    """Index of the ``block`` key of a scanned stack in ``path``, or None."""
    for j in range(1, len(path) - 1):
        if path[j] == "block" and path[j - 1] in _SCANS:
            return j
    return None


def convert_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax param tree (numpy leaves) -> the port's ``state_dict``."""
    out = {}
    for path, v in _leaves(params):
        j = _stack_index(path)
        suffix, arr = _convert_leaf(path, v, 0 if j is None else 1)
        if j is not None:
            head = ".".join(path[:j])
            rest = ".".join(path[j + 1:-1] + (suffix,))
            for i in range(arr.shape[0]):
                out[f"{head}.{i}.{rest}"] = torch.from_numpy(np.ascontiguousarray(arr[i]))
        else:
            out[".".join(path[:-1] + (suffix,))] = torch.from_numpy(
                np.ascontiguousarray(arr))
    return out


def convert_vae_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A VAE's flax param tree (numpy leaves) -> the port VAE's
    ``state_dict``: ``Conv`` kernels (kh, kw, in, out) -> (out, in, kh, kw)
    and (kt, kh, kw, in, out) -> (out, in, kt, kh, kw), ``Dense`` kernels
    transposed, ``GroupNorm`` scales -> weight; every other leaf (biases,
    ``scale_shift_table``, ``timestep_scale``, the latent statistics) as is,
    at its dot-joined path."""
    axes = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
    out = {}
    for path, v in _leaves(params):
        name = path[-1]
        if name == "kernel":
            name, v = "weight", np.transpose(v, axes[v.ndim])
        elif name == "scale":
            name = "weight"
        out[".".join(path[:-1] + (name,))] = torch.from_numpy(np.array(v))
    return out


def convert_tree(tree):
    """Nested dict of arrays -> the same nesting of torch tensors."""
    if isinstance(tree, dict):
        return {k: convert_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def jax_param_paths(model: nn.Module) -> Dict[str, Tuple[str, int]]:
    """Port parameter name -> (its JAX param path, "a/b/kernel", and the JAX
    leaf's rank): the inverse of :func:`convert_params`'s naming. A leaf of a
    scanned stack has one more axis in JAX (the depth), an attention
    projection of a ``MultiHeadDotProductAttention`` one more (heads)."""
    out = {}
    for mod_name, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            leaf = pname
            if isinstance(mod, nn.Linear):
                leaf = {"weight": "kernel"}.get(pname, pname)
            elif isinstance(mod, nn.LayerNorm):
                leaf = {"weight": "scale"}.get(pname, pname)
            elif isinstance(mod, nn.Embedding):
                leaf = {"weight": "embedding"}.get(pname, pname)
            parts = mod_name.split(".") if mod_name else []
            path, ndim, i = [], p.ndim, 0
            while i < len(parts):
                if parts[i] in _SCANS and i + 1 < len(parts) and parts[i + 1].isdigit():
                    path += [parts[i], "block"]
                    ndim += 1
                    i += 2
                    continue
                path.append(parts[i])
                i += 1
            if (len(path) > 1 and path[-2] in _MHA_PARENTS and path[-1] in _MHA_PROJ
                    and (leaf == "kernel" or path[-1] != "out")):
                ndim += 1
            out[".".join(parts + [pname])] = ("/".join(path + [leaf]), ndim)
    return out
