"""NOVA text-to-image inference pipeline (port of
``nova_pointcloud_tpu/pipelines/nova.py``: ``encode_prompt``, the T=1 sampler,
``calibrate`` and ``__call__`` with latent output).

The sampler is the JAX package's masked-AR algorithm, run as Python loops:

- a cosine mask schedule over the AR steps (zero-count steps dropped);
  each step predicts a fixed-size padded slice of a random token order;
- per AR step one image-encoder pass over the canvas (mask tokens where
  nothing is predicted yet), in phases with a static visible bucket
  (``BUCKET_FRACS``: 1/8, 1/4, 1/2 of the tokens), then the full masking path;
- per AR step ``num_diffusion_steps`` evals of the diffusion head on the
  predicted slice, CFG as a batch expansion ``[cond | uncond]``, the
  flow-matching Euler step; below ``guidance_trunc`` the tail runs cond-only
  at 1x batch (a static split);
- the slice scatters into the canvas, which stays in patch space.

int8 serving (``model.quantize``): weights are quantized once per call,
outside the loops, with the calibrated static scales and softmax offsets
merged in when ``calibrate()`` has run. Randomness (the prediction order and
each AR step's noise) comes from a ``torch.Generator``; ``order`` / ``noise``
may be given instead, which the tests use to replay the JAX algorithm.

Not ported yet, and raising: the VAE decode (``output_type`` other than
"latent"), video (``max_latent_length`` > 1), image prefill (``latents``),
mesh serving, host offload, and schedulers other than flow matching.
"""

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nova_pointcloud_tpu_torch.models.embeddings import unpatchify
from nova_pointcloud_tpu_torch.models.guidance import GuidanceConfig
from nova_pointcloud_tpu_torch.models.nova import NOVATransformer
from nova_pointcloud_tpu_torch.ops import masking
from nova_pointcloud_tpu_torch.ops.quantization import (max_merge_stats, merge_act_scales,
                                                        quantize_serving_params)
from nova_pointcloud_tpu_torch.schedulers.flow_match import FlowMatchEulerScheduler


@dataclasses.dataclass
class NOVAPipelineOutput:
    images: Optional[Any] = None
    frames: Optional[Any] = None
    latents: Optional[Any] = None


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md, module queue, NOVA")


BUCKET_FRACS = (8, 4, 2)  # the JAX pipeline's default bucket phases


def bucket_plan(starts: np.ndarray, ni: int) -> Optional[List[Tuple[int, int, Optional[int]]]]:
    """The JAX sampler's phase plan: (first step, end step, visible bucket or
    None for the full masking path) per phase, or None for one phase."""
    S = len(starts)
    if S <= 1 or ni < 64:
        return None
    plan, s_cur = [], 0
    for frac in BUCKET_FRACS:
        bucket = ni // frac
        if bucket < 8:  # too small to be worth a phase
            continue
        # last step whose visible count still fits this bucket
        end = int(np.searchsorted(starts, bucket, side="right"))
        if end > s_cur:
            plan.append((s_cur, end, bucket))
            s_cur = end
    if s_cur < S:
        plan.append((s_cur, S, None))
    return plan if len(plan) > 1 else None


class NOVAPipeline:
    """Orchestrates a NOVATransformer + flow-matching scheduler + text encoder.
    Runs where the model's parameters live (``cuda`` unless the model was
    built with ``device="cpu"``)."""

    def __init__(self, model: NOVATransformer, scheduler=None, vae=None,
                 text_encoder=None, mesh=None):
        if vae is not None:
            raise _unported("the VAE decode (t2i e2e)")
        if mesh is not None:
            raise NotImplementedError("mesh (multi-device) serving is not ported yet: "
                                      "ROADMAP.md, module queue, parallelism")
        scheduler = scheduler or FlowMatchEulerScheduler()
        if not isinstance(scheduler, FlowMatchEulerScheduler):
            raise _unported(f"NOVAPipeline with {type(scheduler).__name__}")
        self.model, self.scheduler, self.text_encoder = model, scheduler, text_encoder
        # calibrated static activation scales and softmax offsets (calibrate())
        self.act_scales: Optional[Dict] = None
        self._act_margin = 1.0

    @property
    def device(self) -> torch.device:
        return self.model.device

    def enable_host_offload(self) -> None:
        raise NotImplementedError("host offload is not ported yet: ROADMAP.md, module queue, "
                                  "parallelism and infra")

    # -- prompt handling ------------------------------------------------------
    @torch.no_grad()
    def encode_prompt(self, prompt: Optional[Sequence[str]], negative_prompt=None,
                      guidance: GuidanceConfig = GuidanceConfig(),
                      num_images_per_prompt: int = 1,
                      prompt_embeds: Optional[np.ndarray] = None) -> torch.Tensor:
        """The expanded model-dim conditioning ``[cond | uncond]``."""
        dev = self.device
        if prompt_embeds is None:
            prompt_embeds, _ = self.text_encoder.encode(list(prompt))
        c_cond = self.model.embed_text(torch.as_tensor(prompt_embeds, device=dev))
        if negative_prompt is not None:
            neg, _ = self.text_encoder.encode(list(negative_prompt))
            c_null = self.model.embed_text(torch.as_tensor(neg, device=dev))
        else:
            c_null = self.model.null_text(c_cond.shape[0], c_cond.shape[1])
        c = guidance.expand_text(c_cond, c_null)
        if num_images_per_prompt > 1:
            c = torch.repeat_interleave(c, num_images_per_prompt, dim=0)
        return c

    def serving_qparams(self) -> Optional[Dict]:
        """int8 weights (and calibrated scales) for one call, or None on the
        float path."""
        if not self.model.quantize:
            return None
        qp = quantize_serving_params(self.model)
        if self.act_scales is not None:
            qp = merge_act_scales(qp, self.act_scales, margin=self._act_margin)
        return qp

    def _schedule(self, num_inference_steps: int, num_diffusion_steps: int,
                  flow_shift: Optional[float] = None):
        ni = self.model.num_image_tokens
        sched = self.scheduler.set_timesteps(
            num_diffusion_steps, **({"shift": flow_shift} if flow_shift else {}))
        counts = masking.cosine_pred_counts(num_inference_steps, ni)
        # the reference drops zero-prediction steps and decays guidance over
        # the surviving count
        counts = counts[counts > 0]
        starts, pad_p = masking.pred_boundaries(counts)
        return sched, counts, starts, pad_p

    # -- the T=1 sampler ----------------------------------------------------------
    def _generate_frame(self, cond: torch.Tensor, batch: int, num_inference_steps: int,
                        num_diffusion_steps: int, guidance: GuidanceConfig,
                        flow_shift: Optional[float], qparams: Optional[Dict],
                        generator: torch.Generator, order=None, noise=None) -> torch.Tensor:
        """One frame: the AR loop over steps, each with its diffusion loop.
        Returns the canvas (B, Ni, patch_dim) float32."""
        model, scheduler, dev = self.model, self.scheduler, self.device
        ni, pd = model.num_image_tokens, model.patch_dim
        sched, counts, starts, pad_p = self._schedule(num_inference_steps,
                                                      num_diffusion_steps, flow_shift)
        S, D = len(counts), num_diffusion_steps
        ts = sched.timesteps.tolist()
        n_passes = guidance.num_passes
        n_cfg_d = D
        if guidance.enabled and guidance.guidance_trunc > 0:
            n_cfg_d = int(np.sum(sched.timesteps >= guidance.guidance_trunc))
        phases = bucket_plan(starts, ni) or [(0, S, None)]
        stg_rows = (batch if (guidance.enabled and guidance.spatiotemporal_guidance_scale
                              and not guidance.image_guidance_scale) else None)
        if order is None:
            order = masking.random_pred_order(generator, batch, ni, dev)
        order = torch.as_tensor(order, device=dev)
        canvas = torch.zeros((batch, ni, pd), dtype=torch.float32, device=dev)
        mask = torch.ones((batch, ni, 1), dtype=torch.float32, device=dev)
        for s_b, s_e, bucket in phases:
            for i in range(s_b, s_e):
                scale = guidance.decayed_scale((i + 1.0) / S)
                tokens = model.tokens_from_patches(canvas)
                z = model.encode_image_step(tokens.repeat(n_passes, 1, 1),
                                            mask.repeat(n_passes, 1, 1), cond,
                                            visible_bucket=bucket, qparams=qparams)
                ids, valid = masking.pred_slice(order, int(starts[i]), int(counts[i]), pad_p)
                ids_e = ids.repeat(n_passes, 1)
                z_sel = torch.gather(z, 1, ids_e[..., None].expand(-1, -1, z.shape[-1]))
                if noise is None:
                    x_t = torch.randn((batch, pad_p, pd), generator=generator, device=dev)
                else:
                    x_t = torch.as_tensor(noise[i], dtype=torch.float32, device=dev)
                for j in range(D):
                    t = ts[j]
                    if j < n_cfg_d:
                        pred = model.denoise_step(
                            guidance.expand(x_t),
                            torch.full((batch * n_passes,), t, device=dev), z_sel,
                            stg_rows=stg_rows, qparams=qparams)
                        pred = guidance.combine(pred.float(), scale, t)
                    else:  # truncated tail: cond-only at 1x batch
                        pred = model.denoise_step(x_t, torch.full((batch,), t, device=dev),
                                                  z_sel[:batch], qparams=qparams).float()
                    x_t = scheduler.step(pred, j, x_t, sched)
                canvas, mask = self._scatter(canvas, mask, ids, valid, x_t)
        return canvas

    @staticmethod
    def _scatter(canvas, mask, ids, valid, x_t):
        """Write the predicted slice into the canvas; masked-out lanes (the
        padding, which repeats the slice's first id) add 0."""
        ni = canvas.shape[1]
        pred_mask = masking.scatter_mask(ids, valid, ni)
        scattered = torch.zeros_like(canvas).scatter_add_(
            1, ids[..., None].expand(-1, -1, canvas.shape[-1]), x_t * valid[..., None])
        return canvas * (1.0 - pred_mask) + scattered, mask * (1.0 - pred_mask)

    # -- calibration --------------------------------------------------------------
    @torch.no_grad()
    def calibrate(self, prompt: Optional[Sequence[str]] = None,
                  negative_prompt: Optional[Sequence[str]] = None,
                  prompt_embeds: Optional[np.ndarray] = None,
                  num_inference_steps: int = 16, num_diffusion_steps: int = 25,
                  guidance_scale: float = 5.0, generator: Optional[torch.Generator] = None,
                  margin: float = 1.05, max_latent_length: int = 1,
                  order=None, noise=None) -> Dict:
        """Record activation ranges and max attention logits over one real
        (shortened) AR trajectory, through the blocks' calibration mirrors and
        the dispatcher attention (the masking path, no buckets), and fold
        them into every later call as static int8 scales (times ``margin``;
        q/k amax times ``margin`` and the extra q/k margin) and static
        softmax offsets. Returns the raw stats tree (the JAX collection's
        layout)."""
        if max_latent_length > 1:
            raise _unported("calibrate with max_latent_length > 1 (t2v)")
        model, scheduler, dev = self.model, self.scheduler, self.device
        if isinstance(prompt, str):
            prompt = [prompt]
        g = generator if generator is not None else \
            torch.Generator(device=dev).manual_seed(0)
        guidance = GuidanceConfig(guidance_scale=guidance_scale)
        c = self.encode_prompt(prompt, negative_prompt, guidance, prompt_embeds=prompt_embeds)
        n_passes = guidance.num_passes
        batch = c.shape[0] // n_passes
        nb = batch * n_passes
        ni, pd = model.num_image_tokens, model.patch_dim
        D = num_diffusion_steps
        sched, counts, starts, pad_p = self._schedule(num_inference_steps, D)
        S, ts = len(counts), sched.timesteps.tolist()
        cond, stats = model.encode_video(model.bos_frame(nb), c, 1, calibrate=True)
        if order is None:
            order = masking.random_pred_order(g, batch, ni, dev)
        order = torch.as_tensor(order, device=dev)
        canvas = torch.zeros((batch, ni, pd), dtype=torch.float32, device=dev)
        mask = torch.ones((batch, ni, 1), dtype=torch.float32, device=dev)
        for i in range(S):
            scale = guidance.decayed_scale((i + 1.0) / S)
            tokens = model.tokens_from_patches(canvas)
            z, s_enc = model.encode_image_step(tokens.repeat(n_passes, 1, 1),
                                               mask.repeat(n_passes, 1, 1), cond,
                                               calibrate=True)
            stats = max_merge_stats(stats, s_enc)
            ids, valid = masking.pred_slice(order, int(starts[i]), int(counts[i]), pad_p)
            ids_e = ids.repeat(n_passes, 1)
            z_sel = torch.gather(z, 1, ids_e[..., None].expand(-1, -1, z.shape[-1]))
            x_t = (torch.randn((batch, pad_p, pd), generator=g, device=dev) if noise is None
                   else torch.as_tensor(noise[i], dtype=torch.float32, device=dev))
            for j in range(D):
                t = ts[j]
                pred, s_d = model.denoise_step(guidance.expand(x_t),
                                               torch.full((nb,), t, device=dev), z_sel,
                                               calibrate=True)
                stats = max_merge_stats(stats, s_d)
                pred = guidance.combine(pred.float(), scale, t)
                x_t = scheduler.step(pred, j, x_t, sched)
            canvas, mask = self._scatter(canvas, mask, ids, valid, x_t)
        self.act_scales = stats
        # amax sites get clipping headroom; merge_act_scales exempts the
        # a_smax logit offsets from the multiplicative margin
        self._act_margin = margin
        return self.act_scales

    # -- main entry -------------------------------------------------------------
    @torch.no_grad()
    def __call__(
        self,
        prompt: Optional[Sequence[str]] = None,
        num_inference_steps: int = 64,
        num_diffusion_steps: int = 25,
        max_latent_length: int = 1,
        guidance_scale: float = 5.0,
        guidance_trunc: float = 0.0,
        guidance_renorm: float = 1.0,
        image_guidance_scale: float = 0.0,
        spatiotemporal_guidance_scale: float = 0.0,
        min_guidance_scale: Optional[float] = None,
        flow_shift: Optional[float] = None,
        negative_prompt: Optional[Sequence[str]] = None,
        num_images_per_prompt: int = 1,
        generator: Optional[torch.Generator] = None,
        latents=None,
        prompt_embeds: Optional[np.ndarray] = None,
        output_type: str = "latent",
        order=None,
        noise=None,
    ) -> NOVAPipelineOutput:
        """Text to (B, H, W, C) latents. ``order`` (B, Ni) and ``noise``
        (S, B, P, patch_dim): the prediction order and the AR steps' initial
        noise, drawn from ``generator`` when not given."""
        if max_latent_length > 1:
            raise _unported("NOVAPipeline with max_latent_length > 1 (t2v)")
        if latents is not None:
            raise _unported("image prefill (latents=, i2v)")
        if output_type != "latent":
            raise _unported(f"output_type={output_type!r} (the VAE decode)")
        if isinstance(prompt, str):
            prompt = [prompt]
        guidance = GuidanceConfig(
            guidance_scale=guidance_scale, guidance_trunc=guidance_trunc,
            guidance_renorm=guidance_renorm, image_guidance_scale=image_guidance_scale,
            spatiotemporal_guidance_scale=spatiotemporal_guidance_scale,
            min_guidance_scale=min_guidance_scale)
        model, dev = self.model, self.device
        c = self.encode_prompt(prompt, negative_prompt, guidance, num_images_per_prompt,
                               prompt_embeds)
        batch = c.shape[0] // guidance.num_passes
        g = generator if generator is not None else \
            torch.Generator(device=dev).manual_seed(0)
        qparams = self.serving_qparams()  # once per call, outside the loops
        cond = model.encode_video(model.bos_frame(c.shape[0]), c, 1, qparams=qparams)
        canvas = self._generate_frame(cond, batch, num_inference_steps, num_diffusion_steps,
                                      guidance, flow_shift, qparams, g, order, noise)
        return NOVAPipelineOutput(
            latents=unpatchify(canvas, model.patch_size, model.image_base_size))
