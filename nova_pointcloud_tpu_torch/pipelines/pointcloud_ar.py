"""Masked-AR text-to-point-cloud pipeline (port of
``nova_pointcloud_tpu/pipelines/pointcloud_ar.py``).

The NOVA sampler over point patches, as Python loops:

- a cosine mask schedule over ``num_inference_steps`` AR steps over the
  N/p patch tokens, zero-count steps kept (such a step predicts nothing but
  still runs an encoder pass and its diffusion loop, and still draws its
  noise); each step predicts a fixed-size padded slice of a random token
  order;
- per AR step one encoder pass over the canvas (mask tokens where nothing
  is predicted yet, the ClusterBlock's summary of the canvas' patch
  centres), then ``num_diffusion_steps`` evals of the head on the predicted
  slice, CFG as a batch expansion ``[cond | uncond]`` with the guidance
  decayed over the AR steps, and the scheduler's step (DDPM with the
  integer timestep and a noise draw, or the flow-matching Euler step);
- the slice is clipped to [-1, 1] and scattered into the canvas.

The points are the unpatchified canvas (no tanh); the colours are
``clip(|p|)`` plus 0.1 noise, clipped to [0, 1]. int8 serving
(``model.quantize``): the weights are quantized once per call, outside the
loops. Randomness (the order, each AR step's initial noise, the DDPM steps'
noise, the colour noise) comes from a ``torch.Generator``; ``order`` /
``noise`` may be given instead, which the tests use to replay the JAX
algorithm.
"""

from typing import Optional, Sequence

import numpy as np
import torch

from nova_pointcloud_tpu_torch.models.guidance import GuidanceConfig
from nova_pointcloud_tpu_torch.models.pointcloud_ar import NOVAPointCloudARTransformer
from nova_pointcloud_tpu_torch.ops import masking
from nova_pointcloud_tpu_torch.pipelines.nova import NOVAPipeline
from nova_pointcloud_tpu_torch.pipelines.pointcloud_gen import NOVAPointCloudPipelineOutput
from nova_pointcloud_tpu_torch.schedulers.flow_match import FlowMatchEulerScheduler


class NOVAPointCloudARPipeline:
    """Masked-AR sampler over a NOVAPointCloudARTransformer. Runs where the
    model's parameters live (``cuda`` unless the model was built with
    ``device="cpu"``)."""

    def __init__(self, model: NOVAPointCloudARTransformer, scheduler, text_encoder=None,
                 normalizer=None):
        self.model, self.scheduler = model, scheduler
        self.text_encoder = text_encoder
        self.normalizer = normalizer  # data.shapenet.GlobalNormalizer or None

    @property
    def device(self) -> torch.device:
        return self.model.device

    def schedule(self, num_inference_steps: int):
        """Per-AR-step prediction counts (zero counts kept), their start
        offsets and the padded slice width."""
        counts = masking.cosine_pred_counts(num_inference_steps, self.model.num_tokens)
        starts, pad_p = masking.pred_boundaries(counts)
        return counts, starts, pad_p

    @torch.no_grad()
    def encode_prompt(self, prompt: Optional[Sequence[str]], negative_prompt=None,
                      guidance: GuidanceConfig = GuidanceConfig(),
                      prompt_embeds: Optional[np.ndarray] = None) -> torch.Tensor:
        """The expanded model-dim conditioning ``[cond | uncond]``."""
        model, dev = self.model, self.device
        if prompt_embeds is None:
            prompt_embeds, _ = self.text_encoder.encode(list(prompt))
        c_cond = model.embed_text(torch.as_tensor(prompt_embeds, device=dev))
        if not guidance.enabled:
            return c_cond
        if negative_prompt is not None:
            neg, _ = self.text_encoder.encode(list(negative_prompt))
            c_null = model.embed_text(torch.as_tensor(neg, device=dev))
        else:
            c_null = model.null_text(c_cond.shape[0], c_cond.shape[1])
        return guidance.expand_text(c_cond, c_null)

    def _step(self, pred, j, t, x, sched, generator):
        if isinstance(self.scheduler, FlowMatchEulerScheduler):
            return self.scheduler.step(pred, j, x, sched)
        return self.scheduler.step(pred, int(t), x, generator=generator, schedule=sched)

    @torch.no_grad()
    def __call__(self, prompt: Optional[Sequence[str]] = None,
                 num_inference_steps: int = 16,
                 num_diffusion_steps: int = 25,
                 guidance_scale: float = 5.0,
                 negative_prompt: Optional[Sequence[str]] = None,
                 generator: Optional[torch.Generator] = None,
                 output_type: str = "numpy",
                 denormalize: bool = False,
                 prompt_embeds: Optional[np.ndarray] = None,
                 order=None, noise=None) -> NOVAPointCloudPipelineOutput:
        """Text to (B, N, 3) points and colours. ``order`` (B, N/p) and
        ``noise`` (S, B, P, p*3): the prediction order and the AR steps'
        initial noise, drawn from ``generator`` when not given."""
        if isinstance(prompt, str):
            prompt = [prompt]
        model, dev = self.model, self.device
        guidance = GuidanceConfig(guidance_scale=guidance_scale)
        c = self.encode_prompt(prompt, negative_prompt, guidance, prompt_embeds)
        n_passes = guidance.num_passes
        batch = c.shape[0] // n_passes
        g = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
        nt, pd, S = model.num_tokens, model.patch_dim, num_inference_steps
        sched = self.scheduler.set_timesteps(num_diffusion_steps)
        ts = [float(t) for t in sched.timesteps]
        counts, starts, pad_p = self.schedule(S)
        qparams = model.serving_qparams()  # once per call, outside the loops
        if order is None:
            order = masking.random_pred_order(g, batch, nt, dev)
        order = torch.as_tensor(order, device=dev)
        canvas = torch.zeros((batch, nt, pd), dtype=torch.float32, device=dev)
        mask = torch.ones((batch, nt, 1), dtype=torch.float32, device=dev)
        for i in range(S):
            scale = guidance.decayed_scale((i + 1.0) / S)
            tokens = model.tokens_from_patches(canvas)
            coords = model.patch_centers(canvas)
            z = model.encode_step(tokens.repeat(n_passes, 1, 1), mask.repeat(n_passes, 1, 1), c,
                                  coords.repeat(n_passes, 1, 1), qparams=qparams)
            ids, valid = masking.pred_slice(order, int(starts[i]), int(counts[i]), pad_p)
            ids_e = ids.repeat(n_passes, 1)
            z_sel = torch.gather(z, 1, ids_e[..., None].expand(-1, -1, z.shape[-1]))
            if noise is None:
                x_t = torch.randn((batch, pad_p, pd), generator=g, device=dev)
            else:
                x_t = torch.as_tensor(noise[i], dtype=torch.float32, device=dev)
            for j, t in enumerate(ts):
                pred = model.denoise_step(guidance.expand(x_t),
                                          torch.full((batch * n_passes,), t, device=dev), z_sel,
                                          qparams=qparams)
                pred = guidance.combine(pred.float(), scale, t)
                x_t = self._step(pred, j, t, x_t, sched, g)
            # the canvas feeds the next step's encoder; training data is
            # clipped to [-1, 1], so keep generated patches in range
            x_t = torch.clamp(x_t, -1.0, 1.0)
            canvas, mask = NOVAPipeline._scatter(canvas, mask, ids, valid, x_t)
        points = model.unpatchify(canvas)
        colors = torch.clamp(torch.abs(points), 0, 1)
        colors = torch.clamp(colors + 0.1 * torch.randn(points.shape, generator=g, device=dev),
                             0, 1)
        if denormalize and self.normalizer is not None:
            points = (points * torch.as_tensor(self.normalizer.std, device=dev)
                      + torch.as_tensor(self.normalizer.mean, device=dev))
        if output_type == "numpy":
            return NOVAPointCloudPipelineOutput(points.cpu().numpy(), colors.cpu().numpy())
        return NOVAPointCloudPipelineOutput(points, colors)
