"""Training pipeline of NOVA text-to-image (port of
``nova_pointcloud_tpu/pipelines/train_nova.py``: ``NOVATrainT2IPipeline``,
the freeze rules, latents from cached VAE moments, the loss).

A batch is the records layout: ``moments`` (B, H, W, 2C) cached VAE
encoder outputs (fp16), sampled into latents on the device, and
``text_embeds`` (B, L, token_dim). The freeze rules name JAX parameter paths
(``models/convert.jax_param_paths``): a frozen parameter gets no update and
no decay. The VAE's ``scale`` (a ``vae=`` argument), video (t2v) and
class-conditional (c2i) training wait for their slices and raise.
"""

from typing import Dict, Iterator, Optional, Sequence

import torch

from nova_pointcloud_tpu_torch.engine.optim import AdamW, build_optimizer
from nova_pointcloud_tpu_torch.engine.trainer import Trainer
from nova_pointcloud_tpu_torch.models.autoencoders.modeling_utils import DiagonalGaussian
from nova_pointcloud_tpu_torch.models.convert import jax_param_paths
from nova_pointcloud_tpu_torch.models.nova import NOVATransformer

# JAX param path substrings that get no updates
T2I_FROZEN = ("text_embed/norm", "video_pos_embed", "video_patch_embed")


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md, module queue, "
                               f"NOVA training")


def freeze_mask(model: torch.nn.Module, frozen_substrings: Sequence[str]) -> Dict[str, bool]:
    """Port parameter name -> trainable (False when its JAX path holds one of
    ``frozen_substrings``)."""
    return {name: not any(s in path for s in frozen_substrings)
            for name, (path, _) in jax_param_paths(model).items()}


def apply_freeze(optimizer: AdamW, model: torch.nn.Module,
                 frozen_substrings: Sequence[str]) -> AdamW:
    """Freeze the parameters the rules name (no update, no decay, no
    moments); the optimizer is returned."""
    if frozen_substrings:
        optimizer.set_trainable(freeze_mask(model, frozen_substrings))
    return optimizer


class NOVATrainT2IPipeline:
    """Text-to-image training: latents from cached moments, the model's
    ``train_losses``, and the single-device ``Trainer``.

    ``optimizer``: ``engine/optim.AdamW`` over ``model``'s parameters; the
    default is optax ``adamw(1e-4, b1=0.9, b2=0.95, weight_decay=0.02)``
    (decay on every parameter). ``trainer_kw`` go to the ``Trainer``."""

    def __init__(self, model: NOVATransformer, vae=None, optimizer: Optional[AdamW] = None,
                 mesh=None, output_dir: Optional[str] = None, **trainer_kw):
        if vae is not None:
            raise _unported("the VAE latent scale in training (vae=)")
        self.model = model
        if optimizer is None:
            optimizer = build_optimizer(model, 1e-4, weight_decay=0.02, betas=(0.9, 0.95),
                                        decay={n: True for n, _ in model.named_parameters()})
        optimizer = apply_freeze(optimizer, model, T2I_FROZEN)
        self.trainer = Trainer(self.loss_fn, model, optimizer, mesh=mesh,
                               output_dir=output_dir, **trainer_kw)

    def prepare_latents(self, batch: Dict, generator: Optional[torch.Generator],
                        eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Latents sampled from ``batch["moments"]`` (float32); ``eps`` gives
        the normal draw."""
        dev = self.model.device
        dist = DiagonalGaussian.from_params(batch["moments"].to(dev))
        return dist.sample(generator, eps=None if eps is None else eps.to(dev))

    def loss_fn(self, batch: Dict, generator: Optional[torch.Generator],
                draws: Optional[Dict[str, torch.Tensor]] = None):
        """(total loss, {name: loss}) of one batch. ``draws``: the random
        draws to use instead of ``generator``'s, ``latent_eps`` and those of
        ``NOVATransformer.train_losses``."""
        draws = draws or {}
        x = self.prepare_latents(batch, generator, draws.get("latent_eps"))
        if x.ndim == 4:
            x = x[:, None]
        losses = self.model(x, batch["text_embeds"], generator=generator, draws=draws)
        total = sum(losses.values())
        return total, losses

    def train(self, data: Iterator[Dict], max_steps: Optional[int] = None) -> Dict[str, float]:
        return self.trainer.train(data, max_steps)


class NOVATrainT2VPipeline:
    def __init__(self, *args, **kwargs):
        raise _unported("NOVATrainT2VPipeline (video training)")


class NOVATrainC2IPipeline:
    def __init__(self, *args, **kwargs):
        raise _unported("NOVATrainC2IPipeline (class-conditional training)")
