"""Point-cloud training pipeline (port of
``nova_pointcloud_tpu/pipelines/pointcloud_train.py``): the composite loss
and the train-side pipeline.

- ``make_pc_loss_fn``: noisify with the DDPM scheduler, predict with the
  model's training forward (dropout live), regress against the scheduler's
  parameterization (epsilon / sample / v_prediction), and add the
  geometric terms on the reconstructed x0: Chamfer, Sinkhorn EMD and, when
  the points split into ``num_subsets``, the AR subset-consistency term
  (0.85 / 0.12 / 0.08 / 0.2). The loss value is guarded: a non-finite loss
  counts in ``nonfinite_loss`` and becomes 0.
- ``NOVATrainPointCloudPipeline``: the trainer, the dataset normalizer
  (``stats.json`` beside the checkpoints), ``train`` / ``validate`` /
  ``sample`` / ``save`` / ``load``.

The default optimizer is optax's ``adamw(1e-4, weight_decay=0.01)``: betas
(0.9, 0.999) and decay on every parameter (optax's adamw has no mask, so the
biases and LayerNorms decay too, unlike the port's T2I rules).
"""

import dataclasses
import os
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from nova_pointcloud_tpu_torch.data.shapenet import GlobalNormalizer
from nova_pointcloud_tpu_torch.engine.optim import AdamW, build_optimizer
from nova_pointcloud_tpu_torch.engine.trainer import Trainer
from nova_pointcloud_tpu_torch.ops import losses as L
from nova_pointcloud_tpu_torch.ops import pointops
from nova_pointcloud_tpu_torch.schedulers.ddpm import DDPMScheduler


@dataclasses.dataclass
class PointCloudLossConfig:
    """The composite loss's weights and the Sinkhorn and partition settings."""

    diffusion: float = 0.85
    chamfer: float = 0.12
    emd: float = 0.08
    ar_consistency: float = 0.2
    num_subsets: int = 16
    use_ar_loss: bool = True
    sinkhorn_iters: int = 30
    sinkhorn_eps: float = 0.05


def pc_adamw(model, learning_rate=1e-4, weight_decay: float = 0.01, transforms=()) -> AdamW:
    """optax ``adamw(learning_rate, weight_decay=...)`` over ``model``: betas
    (0.9, 0.999), eps 1e-8, decay on every parameter; ``transforms`` (the
    JAX chain's ``per_layer_clip`` / ``adaptive_lr_on_spike``) in front."""
    return build_optimizer(model, learning_rate, weight_decay=weight_decay,
                           betas=(0.9, 0.999), decay={n: True for n, _ in model.named_parameters()},
                           transforms=transforms)


def make_pc_loss_fn(model, scheduler: DDPMScheduler,
                    cfg: PointCloudLossConfig = PointCloudLossConfig()):
    """``loss_fn(batch, generator, t=None, noise=None, dropout_masks=None,
    subset_ids=None) -> (loss, metrics)`` for the ``Trainer``.

    batch: ``{"points": (B, N, 3) normalized clouds, "text": (B, L, Dt)}``.
    The draws come from ``generator`` in the order timesteps, noise, the
    model's dropout, the partition; each one given is used instead (the
    tests give the JAX side's)."""

    def loss_fn(batch, generator, t=None, noise=None, dropout_masks=None, subset_ids=None):
        pts, text = batch["points"], batch.get("text")
        b, n = pts.shape[:2]
        if t is None:
            t = scheduler.sample_timesteps(generator, (b,), device=pts.device)
        if noise is None:
            noise = torch.randn(pts.shape, generator=generator, device=pts.device)
        t = torch.as_tensor(t, device=pts.device)
        x_t = scheduler.add_noise(pts, noise, t)
        pred = model(x_t, t, text, deterministic=False, generator=generator,
                     dropout_masks=dropout_masks)
        if scheduler.prediction_type == "epsilon":
            target = noise
        elif scheduler.prediction_type == "sample":
            target = pts
        elif scheduler.prediction_type == "v_prediction":
            target = scheduler.get_velocity(pts, noise, t)
        else:
            raise ValueError(f"Unsupported prediction type {scheduler.prediction_type}.")
        loss_diff = torch.mean(torch.square(pred - target))
        # x0 from the model output under the scheduler's parameterization
        x0_hat = scheduler.predict_x0(pred, t, x_t)
        loss_cd = torch.mean(L.chamfer_distance(x0_hat, pts))
        loss_emd = torch.mean(L.sinkhorn_emd(x0_hat, pts, cfg.sinkhorn_eps, cfg.sinkhorn_iters))
        loss = cfg.diffusion * loss_diff + cfg.chamfer * loss_cd + cfg.emd * loss_emd
        metrics = {"loss_diffusion": loss_diff, "loss_chamfer": loss_cd, "loss_emd": loss_emd}
        if cfg.use_ar_loss and n % cfg.num_subsets == 0:
            if subset_ids is None:
                _, subset_ids = pointops.dynamic_partition(generator, n, cfg.num_subsets,
                                                           device=pts.device)
            loss_ar = L.ar_consistency_loss(x0_hat, torch.as_tensor(subset_ids,
                                                                    device=pts.device))
            loss = loss + cfg.ar_consistency * loss_ar
            metrics["loss_ar"] = loss_ar
        return loss, metrics

    def guarded_loss_fn(batch, generator, **draws):
        # the value is guarded here; the gradients go through the
        # optimizer's transforms (engine/grad_tools)
        loss, metrics = loss_fn(batch, generator, **draws)
        finite = torch.isfinite(loss)
        metrics["nonfinite_loss"] = (~finite).to(torch.float32)
        loss = torch.where(finite, loss, torch.zeros_like(loss))
        return loss, metrics

    return guarded_loss_fn


class NOVATrainPointCloudPipeline:
    """Train-side pc pipeline: trainer + normalizer + sampling, one object.

    ``optimizer``: ``engine/optim.AdamW`` over ``model``'s parameters
    (default :func:`pc_adamw`); ``trainer_kw`` go to the ``Trainer``. The
    normalizer's stats are saved as ``stats.json`` in ``output_dir``."""

    def __init__(self, model, scheduler: Optional[DDPMScheduler] = None,
                 text_encoder=None, normalizer: Optional[GlobalNormalizer] = None,
                 output_dir: Optional[str] = None,
                 loss_config: PointCloudLossConfig = PointCloudLossConfig(),
                 optimizer: Optional[AdamW] = None, mesh=None, **trainer_kw):
        self.model = model
        self.scheduler = scheduler or DDPMScheduler(beta_schedule="squaredcos_cap_v2")
        self.text_encoder = text_encoder
        self.normalizer = normalizer or GlobalNormalizer()
        self.output_dir = output_dir
        self.loss_fn = make_pc_loss_fn(model, self.scheduler, loss_config)
        self.trainer = Trainer(self.loss_fn, model, optimizer or pc_adamw(model), mesh=mesh,
                               output_dir=output_dir, **trainer_kw)
        if output_dir and self.normalizer.fitted:
            self.normalizer.save(os.path.join(output_dir, "stats.json"))

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self.trainer.params

    @property
    def device(self) -> torch.device:
        return self.model.device

    def encode_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Host-side prompt encode; the points and embeddings as float32
        tensors on the model's device."""
        out = {"points": torch.as_tensor(np.asarray(batch["points"]), dtype=torch.float32,
                                         device=self.device)}
        if self.text_encoder is not None and "prompts" in batch:
            embeds, _ = self.text_encoder.encode(batch["prompts"])
            out["text"] = torch.as_tensor(embeds, device=self.device)
        return out

    def train(self, data: Iterator[Dict[str, Any]], max_steps: int) -> Dict[str, float]:
        return self.trainer.train((self.encode_batch(b) for b in data), max_steps)

    @torch.no_grad()
    def validate(self, batches, generator: Optional[torch.Generator] = None
                 ) -> Dict[str, float]:
        """Mean composite-loss metrics over held-out batches (dropout live,
        as the JAX validation's loss; draws from ``generator``, seed 0 by
        default)."""
        g = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(0)
        agg: Dict[str, list] = {}
        for batch in batches:
            loss, metrics = self.loss_fn(self.encode_batch(batch), g)
            agg.setdefault("loss", []).append(float(loss))
            for name, v in metrics.items():
                agg.setdefault(name, []).append(float(v))
        return {k: float(np.mean(v)) for k, v in agg.items()}

    def sample(self, prompts, num_points: int = 2048, **kw):
        """The generation pipeline over this model, points denormalized."""
        from nova_pointcloud_tpu_torch.pipelines.pointcloud_gen import (
            NOVAPointCloudGenerationPipeline)

        pipe = NOVAPointCloudGenerationPipeline(self.model, self.scheduler,
                                                text_encoder=self.text_encoder,
                                                normalizer=self.normalizer)
        return pipe(prompts, num_points=num_points, denormalize=True, **kw)

    def save(self) -> None:
        """A checkpoint of the trainer at its step, and ``stats.json``."""
        if self.output_dir is None:
            raise ValueError("save needs an output_dir")
        self.trainer.save()
        if self.normalizer.fitted:
            self.normalizer.save(os.path.join(self.output_dir, "stats.json"))

    def load(self, step: Optional[int] = None) -> int:
        """Restore checkpoint ``step`` (the latest when None) and the stats;
        returns the step."""
        if self.trainer.ckpt is None:
            raise ValueError("load needs an output_dir")
        out = self.trainer.ckpt.restore(step, map_location=self.device)
        if out is None:
            raise FileNotFoundError(f"no checkpoint under {self.output_dir}")
        self.trainer.load_state_dict(out["state"])
        stats = os.path.join(self.output_dir, "stats.json")
        if os.path.exists(stats):
            self.normalizer = GlobalNormalizer.load(stats)
        return self.trainer.step
