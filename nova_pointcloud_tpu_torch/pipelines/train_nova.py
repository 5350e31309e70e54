"""Training pipelines of NOVA (port of
``nova_pointcloud_tpu/pipelines/train_nova.py``): text-to-image
(``NOVATrainT2IPipeline``), text-to-video (``NOVATrainT2VPipeline``) and
class-conditional (``NOVATrainC2IPipeline``) on one base, the freeze rules,
latents from cached VAE moments, the loss.

A batch is the records layout: ``moments`` (B[, T], H, W, 2C) cached VAE
encoder outputs (fp16), sampled into latents on the device and, with a
``vae=``, put through its ``scale``; or ready ``latents`` (B[, T], H, W, C),
used as they are. The conditioning: ``text_embeds`` (B, L, token_dim); t2v
also ``motion_flow`` and ``fps`` (B,) (the MotionEmbed's bases when absent);
c2i ``labels`` (B,). The freeze rules name JAX parameter paths
(``models/convert.jax_param_paths``): a frozen parameter gets no update and
no decay.
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
T2V_FROZEN = ("text_embed/norm",)


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


class _NOVATrainBase:
    """Latents from cached moments, the model's ``train_losses`` and the
    single-device ``Trainer``; a subclass names its freeze rules and its
    conditioning.

    ``vae``: a VAE whose ``scale`` the sampled latents go through.
    ``optimizer``: ``engine/optim.AdamW`` over ``model``'s parameters; the
    default is optax ``adamw(1e-4, b1=0.9, b2=0.95, weight_decay=0.02)``
    (decay on every parameter). ``trainer_kw`` go to the ``Trainer``."""

    frozen: tuple = ()

    def __init__(self, model: NOVATransformer, vae=None, optimizer: Optional[AdamW] = None,
                 mesh=None, output_dir: Optional[str] = None, **trainer_kw):
        self.model, self.vae = model, vae
        if optimizer is None:
            optimizer = build_optimizer(model, 1e-4, weight_decay=0.02, betas=(0.9, 0.95),
                                        decay={n: True for n, _ in model.named_parameters()})
        optimizer = apply_freeze(optimizer, model, self.frozen)
        self.trainer = Trainer(self.loss_fn, model, optimizer, mesh=mesh,
                               output_dir=output_dir, **trainer_kw)

    def prepare_latents(self, batch: Dict, generator: Optional[torch.Generator],
                        eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``batch["latents"]`` as they are, else latents sampled from
        ``batch["moments"]`` (float32) and put through the VAE's ``scale``;
        ``eps`` gives the normal draw."""
        dev = self.model.device
        if "latents" in batch:
            return batch["latents"].to(dev)
        dist = DiagonalGaussian.from_params(batch["moments"].to(dev))
        z = dist.sample(generator, eps=None if eps is None else eps.to(dev))
        return z if self.vae is None else self.vae.scale(z)

    def conditioning(self, batch: Dict) -> Dict:
        raise NotImplementedError

    def loss_fn(self, batch: Dict, generator: Optional[torch.Generator],
                draws: Optional[Dict[str, torch.Tensor]] = None):
        """(total loss, {name: loss}) of one batch. ``draws``: the random
        draws to use instead of ``generator``'s, ``latent_eps`` and those of
        ``NOVATransformer.train_losses``."""
        draws = draws or {}
        x = self.prepare_latents(batch, generator, draws.get("latent_eps"))
        if x.ndim == 4:
            x = x[:, None]
        losses = self.model(x, generator=generator, draws=draws, **self.conditioning(batch))
        total = sum(losses.values())
        return total, losses

    def train(self, data: Iterator[Dict], max_steps: Optional[int] = None) -> Dict[str, float]:
        return self.trainer.train(data, max_steps)


class NOVATrainT2IPipeline(_NOVATrainBase):
    """Text-to-image training (frozen: the text embed's norm, the video
    position and patch embeds)."""

    frozen = T2I_FROZEN

    def conditioning(self, batch: Dict) -> Dict:
        return {"text_embeds": batch["text_embeds"]}


class NOVATrainT2VPipeline(_NOVATrainBase):
    """Text-to-video training over (B, T, ...) latents: the block-causal TAM
    over BOS and frames, the motion tokens, the AdaLN mixer (frozen: the
    text embed's norm)."""

    frozen = T2V_FROZEN

    def conditioning(self, batch: Dict) -> Dict:
        return {"text_embeds": batch["text_embeds"], "motion_flow": batch.get("motion_flow"),
                "fps": batch.get("fps")}


class NOVATrainC2IPipeline(_NOVATrainBase):
    """Class-conditional training on ``labels`` (nothing frozen)."""

    frozen = ()

    def conditioning(self, batch: Dict) -> Dict:
        return {"labels": batch["labels"]}
