"""Text-to-point-cloud generation pipeline (port of
``nova_pointcloud_tpu/pipelines/pointcloud_gen.py``).

- prompt encoding with CFG negatives, ``[uncond, cond]`` batch order
- randn (B, N, 3) latents scaled by ``init_noise_sigma``, or given latents
- DDPM reverse loop with CFG on the batch dimension; below
  ``guidance_trunc`` only the cond half runs (a static split: the first
  steps at 2x batch, the rest at 1x with ``text_raw[batch:]``)
- int8 serving: weights quantized once per call, outside the step loop,
  with the calibrated static activation scales merged in when present
- standard postprocess (tanh, +0.1 noise, clamp [-1, 1]) or the eval one
  (clamp [-2, 2]), and position-based colors; ``denormalize`` maps the
  points back through the dataset's ``GlobalNormalizer`` (``normalizer``)

- the dynamic-partition AR refinement mode (``use_autoregressive=True``):
  the sampled cloud split into ``num_subsets`` equal subsets in a random
  order, each refined by the ``ar_refiner`` conditioned on the subsets
  refined before it; it replaces the postprocess

Randomness comes from a ``torch.Generator`` (``generator=``) in place of the
JAX ``key``; ``deterministic=True`` with given ``latents`` (and, in the AR
mode, a given ``partition``) draws nothing. Mesh serving is not ported yet
(ROADMAP.md).
"""

import dataclasses
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from nova_pointcloud_tpu_torch.models.pointcloud import NOVAPointCloudTransformer
from nova_pointcloud_tpu_torch.ops.pointops import dynamic_partition
from nova_pointcloud_tpu_torch.ops.quantization import (
    max_merge_stats, merge_act_scales, quantize_serving_params)
from nova_pointcloud_tpu_torch.schedulers.ddpm import DDPMScheduler


@dataclasses.dataclass
class NOVAPointCloudPipelineOutput:
    point_clouds: Any
    colors: Any


class NOVAPointCloudGenerationPipeline:
    """Orchestrates a NOVAPointCloudTransformer + DDPM scheduler + text encoder.

    Runs where the model's parameters live (``cuda`` unless the model was
    built with ``device="cpu"``). ``ar_refiner``: the refinement mode's
    ``models/pointcloud.ARRefiner``, its weights loaded, on the model's
    device."""

    def __init__(self, model: NOVAPointCloudTransformer,
                 scheduler: Optional[DDPMScheduler] = None, text_encoder=None,
                 normalizer=None, mesh=None, ar_refiner=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh (multi-device) serving is not ported yet: ROADMAP.md, "
                "module queue, parallelism")
        self.model = model
        self.scheduler = scheduler or DDPMScheduler(beta_schedule="squaredcos_cap_v2")
        self.text_encoder = text_encoder
        self.normalizer = normalizer  # data.shapenet.GlobalNormalizer or None
        self.ar_refiner = ar_refiner
        # calibrated static activation scales (calibrate()); merged into the
        # qparams of every later call
        self.act_scales: Optional[Dict] = None

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _generator(self, generator: Optional[torch.Generator]) -> torch.Generator:
        return generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(0)

    # -- calibration --------------------------------------------------------------
    @torch.no_grad()
    def calibrate(self, prompt: Optional[Sequence[str]] = None,
                  negative_prompt: Optional[Sequence[str]] = None,
                  prompt_embeds: Optional[np.ndarray] = None,
                  num_points: int = 2048, num_diffusion_steps: int = 25,
                  guidance_scale: float = 5.0,
                  generator: Optional[torch.Generator] = None,
                  margin: float = 1.05) -> Dict:
        """Record activation ranges over one sampling trajectory (through the
        blocks' plain calibration mirrors) and keep them, times ``margin``,
        as the static int8 scales of every later call. Returns the tree."""
        if isinstance(prompt, str):
            prompt = [prompt]
        g = self._generator(generator)
        use_cfg = guidance_scale > 1.0
        if prompt_embeds is None:
            prompt_embeds = self.encode_prompt(prompt, negative_prompt, use_cfg)
        batch = prompt_embeds.shape[0] // (2 if use_cfg else 1)
        sched = self.scheduler.set_timesteps(num_diffusion_steps)
        nb = batch * (2 if use_cfg else 1)
        dev = self.device
        text_raw = torch.as_tensor(prompt_embeds, dtype=torch.float32, device=dev)
        x = torch.randn((batch, num_points, 3), generator=g, device=dev)
        x = x * self.scheduler.init_noise_sigma
        stats = None
        for t in sched.timesteps.tolist():
            x_in = torch.cat([x, x]) if use_cfg else x
            pred, s = self.model.calibration_forward(
                x_in, torch.full((nb,), t, device=dev), text_raw)
            if use_cfg:
                uncond, cond = torch.chunk(pred, 2)
                pred = uncond + guidance_scale * (cond - uncond)
            x = self.scheduler.step(pred, t, x, generator=g, schedule=sched)
            stats = s if stats is None else max_merge_stats(stats, s)
        self.act_scales = _tree_map(lambda a: a.float() * margin, stats)
        return self.act_scales

    # -- prompt encoding ---------------------------------------------------------
    def encode_prompt(self, prompt: Sequence[str],
                      negative_prompt: Optional[Sequence[str]] = None,
                      use_cfg: bool = True,
                      num_per_prompt: int = 1) -> np.ndarray:
        """[uncond, cond] raw hidden states."""
        cond, _ = self.text_encoder.encode(list(prompt))
        if num_per_prompt > 1:
            cond = np.repeat(cond, num_per_prompt, axis=0)
        if not use_cfg:
            return cond
        neg = list(negative_prompt) if negative_prompt else [""] * len(prompt)
        uncond, _ = self.text_encoder.encode(neg)
        if num_per_prompt > 1:
            uncond = np.repeat(uncond, num_per_prompt, axis=0)
        return np.concatenate([uncond, cond], axis=0)

    def serving_qparams(self) -> Optional[Dict]:
        """int8 weights (and calibrated scales) for one call, or None on the
        float path."""
        if not self.model.quantize:
            return None
        qp = quantize_serving_params(self.model)
        if self.act_scales is not None:
            qp = merge_act_scales(qp, self.act_scales)
        return qp

    # -- main entry ----------------------------------------------------------------
    @torch.no_grad()
    def __call__(
        self,
        prompt: Optional[Sequence[str]] = None,
        negative_prompt: Optional[Sequence[str]] = None,
        num_points: int = 2048,
        num_diffusion_steps: int = 25,
        guidance_scale: float = 7.5,
        guidance_trunc: float = 0.0,  # disable CFG below this timestep
        num_point_clouds_per_prompt: int = 1,
        use_autoregressive: bool = False,
        num_subsets: int = 16,
        generator: Optional[torch.Generator] = None,
        prompt_embeds: Optional[np.ndarray] = None,
        output_type: str = "numpy",
        denormalize: bool = False,
        postprocess: str = "standard",  # "standard" | "eval"
        deterministic: bool = False,  # zero-variance DDPM, no added noise
        latents=None,  # (B, N, 3) pre-drawn x_T
        partition=None,  # the AR mode's (order (k,), subset_ids (k, N // k))
    ) -> NOVAPointCloudPipelineOutput:
        if isinstance(prompt, str):
            prompt = [prompt]
        use_cfg = guidance_scale > 1.0
        if prompt_embeds is None:
            prompt_embeds = self.encode_prompt(prompt, negative_prompt, use_cfg,
                                               num_point_clouds_per_prompt)
        batch = prompt_embeds.shape[0] // (2 if use_cfg else 1)
        if use_autoregressive and self.ar_refiner is None:
            raise ValueError("AR mode requires an ar_refiner")
        dev, model, scheduler = self.device, self.model, self.scheduler
        gen = self._generator(generator)
        g = None if deterministic else gen  # the step and postprocess noise
        sched = scheduler.set_timesteps(num_diffusion_steps)
        ts = sched.timesteps.tolist()
        n_cfg = num_diffusion_steps
        if use_cfg and guidance_trunc > 0:
            n_cfg = int(np.sum(sched.timesteps >= guidance_trunc))
        text_raw = torch.as_tensor(prompt_embeds, dtype=torch.float32, device=dev)
        if latents is not None:
            x = torch.as_tensor(latents, dtype=torch.float32, device=dev)
        else:
            x = torch.randn((batch, num_points, 3), device=dev, generator=gen)
        x = x * scheduler.init_noise_sigma
        qparams = self.serving_qparams()  # once per call, outside the loop

        for j, t in enumerate(ts):
            if j < n_cfg:
                x_in = torch.cat([x, x]) if use_cfg else x
                pred = model(x_in, torch.full((x_in.shape[0],), t, device=dev),
                             text_raw, qparams)
                if use_cfg:
                    uncond, cond = torch.chunk(pred, 2)
                    pred = uncond + guidance_scale * (cond - uncond)
            else:  # post-truncation: cond-only pass at half batch
                pred = model(x, torch.full((batch,), t, device=dev),
                             text_raw[batch:] if use_cfg else text_raw, qparams)
            x = scheduler.step(pred, t, x, generator=g, schedule=sched)
        x = x / scheduler.init_noise_sigma

        if use_autoregressive:
            x = self._ar_refine(x, num_subsets, gen, partition)
        elif postprocess == "standard":
            x = torch.tanh(x)
            if not deterministic:
                x = x + 0.1 * torch.randn(x.shape, generator=g, device=dev)
            x = torch.clamp(x, -1.0, 1.0)
        elif postprocess == "eval":
            x = torch.clamp(x, -2.0, 2.0)
        else:
            raise ValueError(f"postprocess must be 'standard' or 'eval', got {postprocess!r}")
        colors = torch.clamp(torch.abs(x), 0, 1)
        if not deterministic:
            colors = torch.clamp(
                colors + 0.1 * torch.randn(x.shape, generator=g, device=dev), 0, 1)
        if denormalize and self.normalizer is not None:
            x = (x * torch.as_tensor(self.normalizer.std, device=dev)
                 + torch.as_tensor(self.normalizer.mean, device=dev))
        if output_type == "numpy":
            return NOVAPointCloudPipelineOutput(x.cpu().numpy(), colors.cpu().numpy())
        return NOVAPointCloudPipelineOutput(x, colors)


    def _ar_refine(self, x: torch.Tensor, num_subsets: int, generator: torch.Generator,
                   partition=None) -> torch.Tensor:
        """Dynamic-partition AR refinement of x (B, N, 3): the subsets in the
        partition's order, each refined by the refiner from the points and
        validity of those refined before it (not-yet-refined points sit at
        the origin, invalid), and written into the output."""
        batch, n, _ = x.shape
        dev = x.device
        if partition is None:
            partition = dynamic_partition(generator, n, num_subsets, device=dev)
        order, subset_ids = (torch.as_tensor(a, device=dev).long() for a in partition)
        gen_points = torch.zeros((batch, n, 3), dtype=x.dtype, device=dev)
        gen_valid = torch.zeros((batch, n), dtype=x.dtype, device=dev)
        out = torch.zeros_like(x)
        for i in range(num_subsets):
            ids = subset_ids[order[i]]
            progress = torch.full((batch,), i / num_subsets, dtype=torch.float32, device=dev)
            refined = self.ar_refiner(x[:, ids], gen_points, gen_valid, progress)
            gen_points[:, ids] = refined
            gen_valid[:, ids] = 1.0
            out[:, ids] = refined
        return out


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)
