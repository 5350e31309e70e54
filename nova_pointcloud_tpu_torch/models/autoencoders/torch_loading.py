"""Load reference / HF torch VAE checkpoints into the port's VAEs (port of
``nova_pointcloud_tpu/models/autoencoders/torch_loading.py``).

The reference VAEs ship as torch state_dicts with diffusers / OpenSoraPlan /
LTX / CogVideoX names. Each loader maps one onto the flax-named tree of the
JAX loader (the same mapping, kept here in numpy):

- Conv2d (O, I, kh, kw) -> flax Conv kernel (kh, kw, I, O); Conv3d
  (O, I, kt, kh, kw) -> (kt, kh, kw, I, O)
- Linear (O, I) -> Dense kernel (I, O)
- GroupNorm / LayerNorm weight -> scale

and returns that tree through ``models/convert.convert_vae_params``: the
port VAE's ``state_dict``, for ``model.load_state_dict``. So a checkpoint
takes the same path as JAX-initialised weights do.
"""

from typing import Dict

import numpy as np
import torch

from nova_pointcloud_tpu_torch.models.convert import convert_vae_params


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t)


def _conv(sd, name):
    return {"kernel": _np(sd[f"{name}.weight"]).transpose(2, 3, 1, 0),
            "bias": _np(sd[f"{name}.bias"])}


def _dense(sd, name):
    return {"kernel": _np(sd[f"{name}.weight"]).T,
            "bias": _np(sd[f"{name}.bias"])}


def _norm(sd, name):
    return {"scale": _np(sd[f"{name}.weight"]),
            "bias": _np(sd[f"{name}.bias"])}


def _resblock(sd, prefix, has_shortcut):
    out = {"norm1": _norm(sd, f"{prefix}.norm1"),
           "conv1": _conv(sd, f"{prefix}.conv1"),
           "norm2": _norm(sd, f"{prefix}.norm2"),
           "conv2": _conv(sd, f"{prefix}.conv2")}
    if has_shortcut:
        out["conv_shortcut"] = _conv(sd, f"{prefix}.conv_shortcut")
    return out


def _mid_block(sd, prefix, depth=1):
    out = {"resnets_0": _resblock(sd, f"{prefix}.resnets.0", False)}
    for i in range(depth):
        out[f"resnets_{i + 1}"] = _resblock(sd, f"{prefix}.resnets.{i + 1}",
                                            False)
        a = f"{prefix}.attentions.{i}"
        out[f"attentions_{i}"] = {
            "group_norm": _norm(sd, f"{a}.group_norm"),
            "to_q": _dense(sd, f"{a}.to_q"),
            "to_k": _dense(sd, f"{a}.to_k"),
            "to_v": _dense(sd, f"{a}.to_v"),
            "to_out": _dense(sd, f"{a}.to_out.0"),
        }
    return out


def _conv3d(sd, name):
    """torch Conv3d (O, I, kt, kh, kw) -> flax Conv kernel (kt, kh, kw, I, O)."""
    return {"kernel": _np(sd[f"{name}.weight"]).transpose(2, 3, 4, 1, 0),
            "bias": _np(sd[f"{name}.bias"])}


def _wrapped_conv(sd, name, three_d):
    """CausalConv3d / Conv2dStage both wrap an nn.Conv child named 'conv'."""
    return {"conv": _conv3d(sd, name) if three_d else _conv(sd, name)}


def load_torch_vae_weights(model, state_dict: Dict) -> Dict[str, torch.Tensor]:
    """The port AutoencoderKL's state_dict from a diffusers-named one."""
    sd = state_dict
    dims = list(model.block_out_channels)
    n = len(dims)
    layers = model.layers_per_block

    enc = {"conv_in": _conv(sd, "encoder.conv_in"),
           "conv_norm_out": _norm(sd, "encoder.conv_norm_out"),
           "conv_out": _conv(sd, "encoder.conv_out"),
           "mid_block": _mid_block(sd, "encoder.mid_block")}
    for i in range(n):
        in_dim = dims[max(i - 1, 0)]
        for j in range(layers):
            has_sc = j == 0 and in_dim != dims[i]
            enc[f"down_{i}_res_{j}"] = _resblock(
                sd, f"encoder.down_blocks.{i}.resnets.{j}", has_sc)
        if i < n - 1:
            enc[f"down_{i}_resize"] = {"conv": _conv(
                sd, f"encoder.down_blocks.{i}.downsamplers.0.conv")}

    rdims = list(reversed(dims))
    dec = {"conv_in": _conv(sd, "decoder.conv_in"),
           "conv_norm_out": _norm(sd, "decoder.conv_norm_out"),
           "conv_out": _conv(sd, "decoder.conv_out"),
           "mid_block": _mid_block(sd, "decoder.mid_block")}
    for i in range(n):
        in_dim = rdims[max(i - 1, 0)]
        for j in range(layers + 1):
            has_sc = j == 0 and in_dim != rdims[i]
            dec[f"up_{i}_res_{j}"] = _resblock(
                sd, f"decoder.up_blocks.{i}.resnets.{j}", has_sc)
        if i < n - 1:
            dec[f"up_{i}_resize"] = {"conv": _conv(
                sd, f"decoder.up_blocks.{i}.upsamplers.0.conv")}

    params = {"encoder": enc, "decoder": dec}
    if model.use_quant_conv:
        params["quant_conv"] = _conv(sd, "quant_conv")
    if model.use_post_quant_conv:
        params["post_quant_conv"] = _conv(sd, "post_quant_conv")
    return convert_vae_params(params)


# ---------------------------------------------------------------------------
# OpenSoraPlan causal 3D VAE
# (`diffnext/models/autoencoders/autoencoder_kl_opensora.py:143-236`)
# ---------------------------------------------------------------------------

def _os_resblock(sd, prefix, has_shortcut, three_d):
    out = {"norm1": _norm(sd, f"{prefix}.norm1"),
           "conv1": _wrapped_conv(sd, f"{prefix}.conv1", three_d),
           "norm2": _norm(sd, f"{prefix}.norm2"),
           "conv2": _wrapped_conv(sd, f"{prefix}.conv2", three_d)}
    if has_shortcut:
        out["conv_shortcut"] = _wrapped_conv(sd, f"{prefix}.conv_shortcut",
                                             three_d)
    return out


def _os_mid(sd, prefix, three_d, depth=1):
    out = {"resnets_0": _os_resblock(sd, f"{prefix}.resnets.0", False,
                                     three_d)}
    for i in range(depth):
        out[f"resnets_{i + 1}"] = _os_resblock(
            sd, f"{prefix}.resnets.{i + 1}", False, three_d)
        a = f"{prefix}.attentions.{i}"
        out[f"attentions_{i}"] = {
            "group_norm": _norm(sd, f"{a}.group_norm"),
            "to_q": _dense(sd, f"{a}.to_q"),
            "to_k": _dense(sd, f"{a}.to_k"),
            "to_v": _dense(sd, f"{a}.to_v"),
            "to_out": _dense(sd, f"{a}.to_out.0"),
        }
    return out


def _quant_conv(sd, name):
    """quant/post_quant conv: our module is CausalConv3d(1,1,1); the torch
    side is Conv3d or Conv2d depending on the config's deepest block."""
    w = _np(sd[f"{name}.weight"])
    if w.ndim == 4:  # (O, I, 1, 1) 2D checkpoint -> lift to 3D kernel
        w = w[:, :, None]
    return {"conv": {"kernel": w.transpose(2, 3, 4, 1, 0),
                     "bias": _np(sd[f"{name}.bias"])}}


def load_torch_opensora_weights(model, state_dict: Dict) -> Dict[str, torch.Tensor]:
    """The port AutoencoderKLOpenSora's state_dict from an OpenSoraPlan one."""
    sd = state_dict
    dims = list(model.block_out_channels)
    n = len(dims)
    layers = model.layers_per_block
    is3d = lambda t: "2D" not in t  # noqa: E731

    dtypes = list(model.down_block_types)
    enc = {"conv_in": {"conv": _conv(sd, "encoder.conv_in")},
           "conv_norm_out": _norm(sd, "encoder.conv_norm_out"),
           "conv_out": _wrapped_conv(sd, "encoder.conv_out",
                                     is3d(dtypes[-1])),
           "mid_block": _os_mid(sd, "encoder.mid_block", is3d(dtypes[-1]))}
    for i in range(n):
        in_dim = dims[max(i - 1, 0)]
        for j in range(layers):
            has_sc = j == 0 and in_dim != dims[i]
            enc[f"down_{i}_res_{j}"] = _os_resblock(
                sd, f"encoder.down_blocks.{i}.resnets.{j}", has_sc,
                is3d(dtypes[i]))
        if i < n - 1:
            enc[f"down_{i}_resize"] = {"resize": _wrapped_conv(
                sd, f"encoder.down_blocks.{i}.downsamplers.0.conv",
                is3d(dtypes[i + 1]))}

    rdims = list(reversed(dims))
    rtypes = list(reversed(list(model.up_block_types)))
    dec = {"conv_in": _wrapped_conv(sd, "decoder.conv_in", is3d(rtypes[0])),
           "conv_norm_out": _norm(sd, "decoder.conv_norm_out"),
           "conv_out": _wrapped_conv(sd, "decoder.conv_out",
                                     is3d(rtypes[-1])),
           "mid_block": _os_mid(sd, "decoder.mid_block", is3d(rtypes[0]))}
    for i in range(n):
        in_dim = rdims[max(i - 1, 0)]
        for j in range(layers + 1):
            has_sc = j == 0 and in_dim != rdims[i]
            dec[f"up_{i}_res_{j}"] = _os_resblock(
                sd, f"decoder.up_blocks.{i}.resnets.{j}", has_sc,
                is3d(rtypes[i]))
        if i < n - 1:
            dec[f"up_{i}_resize"] = {"resize": _wrapped_conv(
                sd, f"decoder.up_blocks.{i}.upsamplers.0.conv",
                is3d(rtypes[i]))}

    params = {"encoder": enc, "decoder": dec,
              "quant_conv": _quant_conv(sd, "quant_conv"),
              "post_quant_conv": _quant_conv(sd, "post_quant_conv")}
    return convert_vae_params(params)


# ---------------------------------------------------------------------------
# LTX-Video causal 3D VAE
# (`diffnext/models/autoencoders/autoencoder_kl_ltx.py:192-312`)
# ---------------------------------------------------------------------------

def _ltx_conv(sd, name):
    """LTXConv3d wraps an nn.Conv child named 'conv'; torch side is Conv3d."""
    return {"conv": _conv3d(sd, name)}


def _ltx_res(sd, prefix, conditioned):
    out = {"conv1": _ltx_conv(sd, f"{prefix}.conv1"),
           "conv2": _ltx_conv(sd, f"{prefix}.conv2")}
    if conditioned:  # causal=False blocks carry a scale_shift_table
        out["scale_shift_table"] = _np(sd[f"{prefix}.scale_shift_table"])
    return out


def _ltx_time_embed(sd, prefix):
    return {"fc1": _dense(sd, f"{prefix}.timestep_proj.fc1"),
            "fc2": _dense(sd, f"{prefix}.timestep_proj.fc2")}


def load_torch_ltx_weights(model, state_dict: Dict) -> Dict[str, torch.Tensor]:
    """The port AutoencoderKLLTXVideo's state_dict from an LTX one."""
    sd = state_dict
    depths = list(model.layers_per_block)

    enc = {"conv_in": _ltx_conv(sd, "encoder.conv_in"),
           "conv_out": _ltx_conv(sd, "encoder.conv_out")}
    for i in range(4):  # 4 down blocks (`:202-204`)
        for j in range(depths[i]):
            enc[f"down_{i}_res_{j}"] = _ltx_res(
                sd, f"encoder.down_blocks.{i}.resnets.{j}", False)
        enc[f"down_{i}_resize"] = {"conv": _ltx_conv(
            sd, f"encoder.down_blocks.{i}.downsamplers.0.conv")}
    for j in range(depths[-1]):
        enc[f"mid_res_{j}"] = _ltx_res(sd, f"encoder.mid_block.resnets.{j}",
                                       False)

    ddepths = list(model.decoder_layers_per_block)
    dec = {"conv_in": _ltx_conv(sd, "decoder.conv_in"),
           "conv_out": _ltx_conv(sd, "decoder.conv_out"),
           "mid_time_embed": _ltx_time_embed(sd, "decoder.mid_block.time_embed"),
           "time_embed": _ltx_time_embed(sd, "decoder.time_embed"),
           "scale_shift_table": _np(sd["decoder.scale_shift_table"]),
           "timestep_scale": _np(sd["decoder.timestep_scale"])}
    for j in range(ddepths[-1]):
        dec[f"mid_res_{j}"] = _ltx_res(sd, f"decoder.mid_block.resnets.{j}",
                                       True)
    for i in range(len(ddepths) - 1):  # len-1 up blocks (`:227-229`)
        dec[f"up_{i}_resize"] = {"conv": _ltx_conv(
            sd, f"decoder.up_blocks.{i}.upsamplers.0.conv")}
        dec[f"up_{i}_time_embed"] = _ltx_time_embed(
            sd, f"decoder.up_blocks.{i}.time_embed")
        for j in range(ddepths[i]):
            dec[f"up_{i}_res_{j}"] = _ltx_res(
                sd, f"decoder.up_blocks.{i}.resnets.{j}", True)

    params = {"encoder": enc, "decoder": dec}
    if model.use_latent_stats:
        params["shift_factors"] = _np(sd["shift_factors"])
        params["scaling_factors"] = _np(sd["scaling_factors"])
    return convert_vae_params(params)


# ---------------------------------------------------------------------------
# CogVideoX causal 3D VAE
# (`diffnext/models/autoencoders/autoencoder_kl_cogvideox.py:152-233`)
# ---------------------------------------------------------------------------

def _cog_adagn(sd, prefix, conditioned):
    """AdaGroupNorm: the GroupNorm weight/bias live on the module itself
    (it subclasses nn.GroupNorm); scale/shift are Conv3d when conditioned."""
    out = {"norm": _norm(sd, prefix)}
    if conditioned:
        out["scale"] = {"conv": _conv3d(sd, f"{prefix}.scale")}
        out["shift"] = {"conv": _conv3d(sd, f"{prefix}.shift")}
    return out


def _cog_res(sd, prefix, has_shortcut, conditioned):
    out = {"norm1": _cog_adagn(sd, f"{prefix}.norm1", conditioned),
           "conv1": {"conv": _conv3d(sd, f"{prefix}.conv1")},
           "norm2": _cog_adagn(sd, f"{prefix}.norm2", conditioned),
           "conv2": {"conv": _conv3d(sd, f"{prefix}.conv2")}}
    if has_shortcut:
        out["conv_shortcut"] = {"conv": _conv3d(sd, f"{prefix}.conv_shortcut")}
    return out


def load_torch_cogvideox_weights(model, state_dict: Dict) -> Dict[str, torch.Tensor]:
    """The port AutoencoderKLCogVideoX's state_dict from a CogVideoX one."""
    sd = state_dict
    dims = list(model.block_out_channels)
    n = len(dims)
    layers = model.layers_per_block

    enc = {"conv_in": {"conv": _conv3d(sd, "encoder.conv_in")},
           "conv_norm_out": _cog_adagn(sd, "encoder.conv_norm_out", False),
           "conv_out": {"conv": _conv3d(sd, "encoder.conv_out")}}
    for i in range(n):
        in_dim = dims[max(i - 1, 0)]
        for j in range(layers):
            has_sc = j == 0 and in_dim != dims[i]
            enc[f"down_{i}_res_{j}"] = _cog_res(
                sd, f"encoder.down_blocks.{i}.resnets.{j}", has_sc, False)
        if i < n - 1:  # modes 2,2,1 then none (`:161`)
            enc[f"down_{i}_resize"] = {"conv": _conv(
                sd, f"encoder.down_blocks.{i}.downsamplers.0.conv")}
    for j in range(2):
        enc[f"mid_res_{j}"] = _cog_res(
            sd, f"encoder.mid_block.resnets.{j}", False, False)

    rdims = list(reversed(dims))
    dec = {"conv_in": {"conv": _conv3d(sd, "decoder.conv_in")},
           "conv_norm_out": _cog_adagn(sd, "decoder.conv_norm_out", True),
           "conv_out": {"conv": _conv3d(sd, "decoder.conv_out")}}
    for j in range(2):
        dec[f"mid_res_{j}"] = _cog_res(
            sd, f"decoder.mid_block.resnets.{j}", False, True)
    for i in range(n):
        in_dim = rdims[max(i - 1, 0)]
        for j in range(layers + 1):
            has_sc = j == 0 and in_dim != rdims[i]
            dec[f"up_{i}_res_{j}"] = _cog_res(
                sd, f"decoder.up_blocks.{i}.resnets.{j}", has_sc, True)
        if i < n - 1:
            dec[f"up_{i}_resize"] = {"conv": _conv(
                sd, f"decoder.up_blocks.{i}.upsamplers.0.conv")}

    return convert_vae_params({"encoder": enc, "decoder": dec})
