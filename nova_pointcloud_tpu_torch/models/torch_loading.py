"""Load reference NOVA torch checkpoints into the port's NOVATransformer
(port of ``nova_pointcloud_tpu/models/torch_loading.py``).

The reference ships diffusers-style state dicts of
``NOVATransformer3DModel``. Both that model and the port are torch
modules, so a weight keeps its layout and only its name changes, with one
exception: a patch embedding is a ``Conv2d`` (O, C, p, p) in the reference
and an ``nn.Linear`` (O, p*p*C) over NOVA's (p_h, p_w, C) patch order here.
The names map straight onto the port's state-dict keys:

- ``{video,image}_encoder.blocks.{i}`` -> ``enc_layers.{i}`` for the first
  half of the blocks, ``dec_layers.{i - half}`` for the rest;
- ``{video,image}_encoder.patch_embed.proj`` -> ``{video,image}_patch_embed.proj``;
- ``image_decoder.patch_embed.proj`` -> ``image_decoder.patch_proj``,
  ``image_decoder.blocks.{i}`` -> ``image_decoder.blocks_{i}``;
- ``mask_embed`` -> ``mask_tokens``; the text bank buffer
  ``text_embed.weight`` -> ``text_embed.null_prompt``;
- the Sequential MLPs ``video_pos_embed.time_proj.{0,2}`` and
  ``motion_embed.{flow,fps}_proj.{0,2}`` -> ``time_fc{1,2}`` /
  ``{flow,fps}_fc{1,2}``, ``video_pos_embed.norm`` -> ``time_norm``;
- ``video_encoder.mixer`` -> ``mixer.ada``;
- every other name (``label_embed``, ``text_embed.proj`` / ``norm``, the
  head's ``time_cond_embed``, ``norm`` and ``head``) as it is.

Which parts are read follows the model: the reference names of its own
state-dict keys. The tests hold the result bitwise against the JAX loader
followed by ``models/convert.convert_params``.
"""

import re
from typing import Dict

import numpy as np
import torch

from nova_pointcloud_tpu_torch.models.nova import NOVATransformer

# (port key pattern, its reference name with the pattern's groups)
_RENAMES = (
    (r"(video|image)_patch_embed\.proj\.(.*)", r"\1_encoder.patch_embed.proj.\2"),
    (r"image_decoder\.patch_proj\.(.*)", r"image_decoder.patch_embed.proj.\1"),
    (r"image_decoder\.blocks_(\d+)\.(.*)", r"image_decoder.blocks.\1.\2"),
    (r"mask_tokens\.(.*)", r"mask_embed.\1"),
    (r"text_embed\.null_prompt", r"text_embed.weight"),
    (r"video_pos_embed\.time_fc1\.(.*)", r"video_pos_embed.time_proj.0.\1"),
    (r"video_pos_embed\.time_fc2\.(.*)", r"video_pos_embed.time_proj.2.\1"),
    (r"video_pos_embed\.time_norm\.(.*)", r"video_pos_embed.norm.\1"),
    (r"motion_embed\.(flow|fps)_fc1\.(.*)", r"motion_embed.\1_proj.0.\2"),
    (r"motion_embed\.(flow|fps)_fc2\.(.*)", r"motion_embed.\1_proj.2.\2"),
    (r"mixer\.ada\.(.*)", r"video_encoder.mixer.\1"),
)
_PATCH_WEIGHTS = ("video_patch_embed.proj.weight", "image_patch_embed.proj.weight",
                  "image_decoder.patch_proj.weight")


def reference_names(model: NOVATransformer) -> Dict[str, str]:
    """Each port state-dict key of ``model`` -> its reference name."""
    out = {}
    for key in model.state_dict():
        m = re.fullmatch(r"(video|image)_encoder\.(enc|dec)_layers\.(\d+)\.(.*)", key)
        if m:
            vit = getattr(model, f"{m[1]}_encoder")
            i = int(m[3]) + (vit.enc_depth if m[2] == "dec" else 0)
            out[key] = f"{m[1]}_encoder.blocks.{i}.{m[4]}"
            continue
        for pattern, ref in _RENAMES:
            if re.fullmatch(pattern, key):
                out[key] = re.sub(pattern, ref, key)
                break
        else:
            out[key] = key
    return out


def _float32(t) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu()
    return torch.from_numpy(np.asarray(t, np.float32))


def load_torch_nova_weights(model: NOVATransformer, state_dict: Dict) -> Dict[str, torch.Tensor]:
    """The port model's state_dict, float32, from a reference-named one
    (torch tensors or numpy), for ``model.load_state_dict``."""
    out = {}
    for key, ref in reference_names(model).items():
        w = _float32(state_dict[ref])
        if key in _PATCH_WEIGHTS:  # (O, C, p, p) -> (O, p*p*C) in (p_h, p_w, C) order
            w = w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)
        out[key] = w.contiguous()
    return out


def reference_state_dict(model: NOVATransformer) -> Dict[str, torch.Tensor]:
    """The model's weights under the reference's names and layouts (the
    inverse of :func:`load_torch_nova_weights`), on the CPU in their dtype."""
    sd = model.state_dict()
    c, out = model.image_dim, {}
    for key, ref in reference_names(model).items():
        w = sd[key].detach().cpu()
        if key in _PATCH_WEIGHTS:
            p = int(round((w.shape[1] // c) ** 0.5))
            w = w.reshape(w.shape[0], p, p, c).permute(0, 3, 1, 2)
        out[ref] = w.contiguous()
    return out
