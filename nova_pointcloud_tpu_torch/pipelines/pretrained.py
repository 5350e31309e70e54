"""One-call loading of a reference checkpoint directory (port of
``nova_pointcloud_tpu/pipelines/pretrained.py``).

A downloaded ``BAAI/nova-*`` directory (``model_index.json``,
``transformer/``, ``scheduler/``, ``vae/``, ``text_encoder/``,
``tokenizer/``) becomes a serving pipeline in one call, with the JAX
function's semantics:

- a component's weight shards are merged (``*.safetensors``, read by the
  port's own reader, ``utils/safetensors_io``; else ``*.bin`` / ``*.pt``
  through ``torch.load``), floating tensors read as float32;
- the transformer's names map straight onto the port's keys
  (``models/torch_loading``), the VAE's through
  ``models/autoencoders/torch_loading`` (``AutoencoderKL`` and the OpenSora
  VAE only), the text encoder's through ``load_torch_phi_weights`` (with
  or without the ``model.`` prefix of ``PhiForCausalLM`` checkpoints);
- the text encoder is built only when both ``text_encoder/`` and
  ``tokenizer/`` exist (the tokenizer through ``transformers``, imported
  only then), and runs in float32; ``dtype`` casts the transformer and the
  VAE;
- ``model_index.json``'s ``_class_name`` picks ``NOVAC2IPipeline`` or
  ``NOVAPipeline``.

Components absent on disk, or switched off, are skipped: the pipeline then
takes ``prompt_embeds`` and returns latents.
"""

import glob
import json
import os
from typing import Dict, Optional

import torch

from nova_pointcloud_tpu_torch.utils import safetensors_io
from nova_pointcloud_tpu_torch.utils.device import resolve_device

__all__ = ["from_pretrained"]


def _read_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _read_state_dict(subdir: str) -> Dict[str, torch.Tensor]:
    """All weight shards of a component directory merged into one state
    dict on the CPU; floating tensors as float32."""
    files = sorted(glob.glob(os.path.join(subdir, "*.safetensors")))
    if files:
        sd = {}
        for f in files:
            for k, v in safetensors_io.load_file(f).items():
                sd[k] = v.float() if v.is_floating_point() else v
        return sd
    files = sorted(glob.glob(os.path.join(subdir, "*.bin"))
                   + glob.glob(os.path.join(subdir, "*.pt")))
    if files:
        sd = {}
        for f in files:
            for k, v in torch.load(f, map_location="cpu", weights_only=True).items():
                sd[k] = v.float()
        return sd
    raise FileNotFoundError(f"no weight files (*.safetensors|*.bin) in {subdir}")


def _scheduler_from_config(cfg: Dict):
    """A diffusers scheduler_config.json -> the port's scheduler."""
    from nova_pointcloud_tpu_torch.schedulers.ddpm import DDPMScheduler
    from nova_pointcloud_tpu_torch.schedulers.flow_match import FlowMatchEulerScheduler

    name = cfg.get("_class_name", "FlowMatchEulerDiscreteScheduler")
    if "FlowMatch" in name:
        return FlowMatchEulerScheduler(num_train_timesteps=int(cfg.get("num_train_timesteps",
                                                                       1000)),
                                       shift=float(cfg.get("shift", 1.0)))
    if "DDPM" in name:
        keys = ("num_train_timesteps", "beta_start", "beta_end", "beta_schedule",
                "variance_type", "clip_sample", "clip_sample_range", "prediction_type",
                "timestep_spacing", "steps_offset", "rescale_betas_zero_snr", "trained_betas")
        return DDPMScheduler(**{k: cfg[k] for k in keys if k in cfg})
    raise ValueError(f"unsupported scheduler class {name!r}")


def _vae_from_dir(subdir: str, dtype, device):
    from nova_pointcloud_tpu_torch.models.autoencoders import (AutoencoderKL,
                                                               AutoencoderKLOpenSora)
    from nova_pointcloud_tpu_torch.models.autoencoders.torch_loading import (
        load_torch_opensora_weights, load_torch_vae_weights)

    cfg = _read_json(os.path.join(subdir, "config.json"))
    name = cfg.get("_class_name", "AutoencoderKL")
    common = dict(
        in_channels=int(cfg.get("in_channels", 3)),
        out_channels=int(cfg.get("out_channels", 3)),
        block_out_channels=tuple(cfg.get("block_out_channels", (128, 256, 512, 512))),
        layers_per_block=int(cfg.get("layers_per_block", 2)),
        latent_channels=int(cfg.get("latent_channels", 4)),
        scaling_factor=float(cfg.get("scaling_factor", 0.18215)),
        shift_factor=cfg.get("shift_factor"), dtype=dtype, device=device)
    if name == "AutoencoderKL":
        vae = AutoencoderKL(use_quant_conv=bool(cfg.get("use_quant_conv", 1)),
                            use_post_quant_conv=bool(cfg.get("use_post_quant_conv", 1)),
                            **common)
        loader = load_torch_vae_weights
    elif "OpenSora" in name:
        for k in ("down_block_types", "up_block_types"):
            if k in cfg:
                common[k] = tuple(cfg[k])
        vae = AutoencoderKLOpenSora(**common)
        loader = load_torch_opensora_weights
    else:
        raise ValueError(f"unsupported VAE class {name!r}")
    vae.load_state_dict(loader(vae, _read_state_dict(subdir)))
    return vae


def _text_encoder_from_dir(root: str, num_tokens: int, device):
    """transformers-layout ``text_encoder/`` + ``tokenizer/`` -> PhiTextEncoder."""
    from nova_pointcloud_tpu_torch.models.text_encoders.phi import (
        PhiConfig, PhiEncoderModel, PhiTextEncoder, load_torch_phi_weights)

    enc_dir = os.path.join(root, "text_encoder")
    cfg = PhiConfig.from_hf(_read_json(os.path.join(enc_dir, "config.json")))
    model = PhiEncoderModel(cfg, device=device)
    model.load_state_dict(load_torch_phi_weights(model, _read_state_dict(enc_dir)))
    from transformers import AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(os.path.join(root, "tokenizer"))
    return PhiTextEncoder(model, tokenizer, num_tokens=num_tokens)


def from_pretrained(path: str, dtype: Optional[torch.dtype] = None, device=None,
                    load_vae: bool = True, load_text_encoder: bool = True):
    """A serving pipeline from a reference checkpoint directory. ``dtype``
    (e.g. ``torch.bfloat16``): the transformer's and the VAE's weights and
    compute dtype. ``device``: ``cuda`` unless ``"cpu"`` is asked for."""
    from nova_pointcloud_tpu_torch.models.torch_loading import load_torch_nova_weights
    from nova_pointcloud_tpu_torch.pipelines.builder import build_transformer

    dev = resolve_device(device)
    index = _read_json(os.path.join(path, "model_index.json"))
    cls_name = index.get("_class_name", "NOVAPipeline")
    tcfg = _read_json(os.path.join(path, "transformer", "config.json"))
    tcfg = {k: v for k, v in tcfg.items() if not k.startswith("_")}
    sample_sched = _scheduler_from_config(
        _read_json(os.path.join(path, "scheduler", "scheduler_config.json")))
    model = build_transformer(tcfg, noise_scheduler=sample_sched, dtype=dtype, device=dev)
    model.load_state_dict(load_torch_nova_weights(
        model, _read_state_dict(os.path.join(path, "transformer"))))

    vae = None
    if load_vae and os.path.isdir(os.path.join(path, "vae")):
        vae = _vae_from_dir(os.path.join(path, "vae"), dtype, dev)

    text_encoder = None
    if (load_text_encoder and os.path.isdir(os.path.join(path, "text_encoder"))
            and os.path.isdir(os.path.join(path, "tokenizer"))):
        text_encoder = _text_encoder_from_dir(path, model.text_token_len, dev)

    if dtype is not None:
        model.to(dtype)
        if vae is not None:
            vae.to(dtype)

    if cls_name == "NOVAC2IPipeline":
        from nova_pointcloud_tpu_torch.pipelines.nova_c2i import NOVAC2IPipeline

        return NOVAC2IPipeline(model, sample_sched, vae=vae)
    from nova_pointcloud_tpu_torch.pipelines.nova import NOVAPipeline

    return NOVAPipeline(model, sample_sched, vae=vae, text_encoder=text_encoder)
