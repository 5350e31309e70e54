"""NOVA text-to-image / text-to-video inference pipeline (port of
``nova_pointcloud_tpu/pipelines/nova.py``: ``encode_prompt``, the sampler,
``calibrate`` and ``__call__`` with latent output).

The sampler is the JAX package's masked-AR algorithm, run as Python loops:

- a cosine mask schedule over the AR steps (zero-count steps dropped);
  each step predicts a fixed-size padded slice of a random token order;
- per AR step one image-encoder pass over the canvas (mask tokens where
  nothing is predicted yet), in phases with a static visible bucket
  (``BUCKET_FRACS``: 1/8, 1/4, 1/2 of the tokens), then the full masking path;
- per AR step ``num_diffusion_steps`` evals of the diffusion head on the
  predicted slice, CFG as a batch expansion ``[cond | uncond]``, the
  flow-matching Euler step or the DDPM step; below ``guidance_trunc`` the
  tail runs cond-only at 1x batch (a static split);
- the slice scatters into the canvas, which stays in patch space.

Video (``max_latent_length`` T > 1) runs the frame loop of the JAX sampler:
frame 0 is the BOS frame with the text prefix (and a video model's motion
tokens) through the video encoder's KV caches (``encode_frame``), and each
later frame is the previous one's latents, patch-embedded, through the same
caches; each frame's image sampler is conditioned on its states (after the
AdaLN mixer with frame 0's states, where the model has one). ``latents=``
(i2v without the VAE) gives frame 0 instead of sampling it.

int8 serving (``model.quantize``): weights are quantized once per call,
outside the loops, with the calibrated static scales and softmax offsets
merged in when ``calibrate()`` has run. Randomness (each frame's prediction
order, each AR step's noise and, with DDPM, each step's noise) comes from a
``torch.Generator``; ``order`` / ``noise`` / ``step_noise`` may be given
instead, which the tests use to replay the JAX algorithm.

With a VAE (``vae=``, a module of ``models/autoencoders``), ``output_type``
"np" / "pil" decodes the latents through ``utils/image_processor`` to uint8
pixels (images for T = 1, frames for T > 1), and ``encode_image`` turns an
i2v prompt image into the scaled latents of the ``latents=`` prefill. Not
ported yet, and raising: mesh serving and host offload.
"""

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nova_pointcloud_tpu_torch.models.embeddings import patchify, unpatchify
from nova_pointcloud_tpu_torch.models.guidance import GuidanceConfig
from nova_pointcloud_tpu_torch.models.nova import NOVATransformer
from nova_pointcloud_tpu_torch.ops import masking
from nova_pointcloud_tpu_torch.ops.quantization import (max_merge_stats, merge_act_scales,
                                                        quantize_serving_params)
from nova_pointcloud_tpu_torch.schedulers.flow_match import FlowMatchEulerScheduler
from nova_pointcloud_tpu_torch.utils.image_processor import VaeImageProcessor


@dataclasses.dataclass
class NOVAPipelineOutput:
    images: Optional[Any] = None
    frames: Optional[Any] = None
    latents: Optional[Any] = None


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
    """Orchestrates a NOVATransformer + scheduler (flow matching, or DDPM) +
    text encoder + (optional) VAE. Runs where the model's parameters live
    (``cuda`` unless the model was built with ``device="cpu"``); the VAE
    where its own live."""

    def __init__(self, model: NOVATransformer, scheduler=None, vae=None,
                 text_encoder=None, mesh=None):
        if mesh is not None:
            raise NotImplementedError("mesh (multi-device) serving is not ported yet: "
                                      "ROADMAP.md, module queue, parallelism")
        scheduler = scheduler or FlowMatchEulerScheduler()
        self.is_flow = isinstance(scheduler, FlowMatchEulerScheduler)
        self.model, self.scheduler, self.text_encoder = model, scheduler, text_encoder
        self.vae = vae
        self.image_processor = VaeImageProcessor(vae)
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

    @torch.no_grad()
    def encode_image(self, image: np.ndarray, num_images_per_prompt: int = 1,
                     generator: Optional[torch.Generator] = None,
                     eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """An i2v prompt image, uint8 (H, W, 3), -> its scaled latents
        (N, h, w, C) for the ``latents=`` prefill: ``x / 127.5 - 1`` through
        ``vae.encode``, the posterior sampled as the JAX pipeline samples it,
        eps N(0, 1) from ``generator`` (seed 0 when none is given, so the
        call is deterministic) unless ``eps`` is given."""
        vae = self.vae
        x = torch.as_tensor(np.asarray(image), device=vae.device).float() / 127.5 - 1.0
        if generator is None and eps is None:
            generator = torch.Generator(device=vae.device).manual_seed(0)
        z = vae.scale(vae.encode(x[None]).sample(generator, eps=eps))
        return torch.repeat_interleave(z, num_images_per_prompt, dim=0)

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
            num_diffusion_steps, **({"shift": flow_shift} if self.is_flow and flow_shift
                                    else {}))
        counts = masking.cosine_pred_counts(num_inference_steps, ni)
        # the reference drops zero-prediction steps and decays guidance over
        # the surviving count
        counts = counts[counts > 0]
        starts, pad_p = masking.pred_boundaries(counts)
        return sched, counts, starts, pad_p

    def _step(self, pred, j: int, t: float, x_t, sched, generator, step_noise=None):
        """The scheduler's step: flow matching by index, DDPM by timestep with
        its noise (``step_noise`` if given, else drawn from ``generator``)."""
        if self.is_flow:
            return self.scheduler.step(pred, j, x_t, sched)
        noise = None if step_noise is None else torch.as_tensor(
            step_noise, dtype=torch.float32, device=x_t.device)
        return self.scheduler.step(pred, int(t), x_t, generator=generator, schedule=sched,
                                   noise=noise)

    # -- the sampler of one frame -------------------------------------------------
    def _generate_frame(self, cond: torch.Tensor, batch: int, num_inference_steps: int,
                        num_diffusion_steps: int, guidance: GuidanceConfig,
                        flow_shift: Optional[float], qparams: Optional[Dict],
                        generator: torch.Generator, order=None, noise=None,
                        step_noise=None) -> torch.Tensor:
        """One frame: the AR loop over steps, each with its diffusion loop.
        Returns the canvas (B, Ni, patch_dim) float32."""
        model, dev = self.model, self.device
        ni, pd = model.num_image_tokens, model.patch_dim
        sched, counts, starts, pad_p = self._schedule(num_inference_steps,
                                                      num_diffusion_steps, flow_shift)
        S, D = len(counts), num_diffusion_steps
        ts = [float(t) for t in sched.timesteps]
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
                    x_t = self._step(pred, j, t, x_t, sched, generator,
                                     None if step_noise is None else step_noise[i][j])
                canvas, mask = self._scatter(canvas, mask, ids, valid, x_t)
        return canvas

    # -- the frame loop (T > 1) ------------------------------------------------------
    def _generate_video(self, c: torch.Tensor, batch: int, num_frames: int,
                        guidance: GuidanceConfig, qparams: Optional[Dict],
                        generator: torch.Generator, frame_kw: Dict, latents0=None,
                        order=None, noise=None, step_noise=None) -> torch.Tensor:
        """Temporal AR through the video encoder's KV caches. Frame 0: the BOS
        frame (the image-guidance pass the raw BOS token) with the prefix
        ``c``, its states the condition of its sampler (or ``latents0`` in
        its place); frame t: frame t-1's latents, patch-embedded, at cache
        index ``len(prefix) + t * Nv``. Returns (B, T, Ni, patch_dim)."""
        model = self.model
        nb, text_len, nv = c.shape[0], c.shape[1], model.num_video_tokens

        def frame(cond, f):
            return self._generate_frame(
                cond, batch, generator=generator, qparams=qparams, guidance=guidance,
                order=None if order is None else order[f],
                noise=None if noise is None else noise[f],
                step_noise=None if step_noise is None else step_noise[f], **frame_kw)

        caches = model.init_video_caches(nb, text_len, num_frames)
        tokens = model.bos_frame(nb)[:, 0]
        bos_value = tokens[:1, :1]
        tokens = model.frame_tokens(tokens, 0, num_frames)
        if guidance.image_guidance_scale and guidance.enabled:
            # the image-free pass is the raw BOS token, without positions
            raw = bos_value.expand((batch,) + tuple(tokens.shape[1:])).to(tokens.dtype)
            tokens = torch.cat([tokens[:batch], raw, tokens[2 * batch:]], dim=0)
        states0, caches = model.encode_frame(tokens, c, caches, 0, 0, qparams=qparams)
        latents = [latents0 if latents0 is not None else frame(states0, 0)]
        cache_index = text_len + nv
        for t_idx in range(1, num_frames):
            prev = unpatchify(latents[-1], model.patch_size, model.image_base_size)
            tokens = model.frame_tokens(model.embed_video_frame(prev), t_idx, num_frames)
            tokens = guidance.expand(tokens, padding=bos_value)
            states, caches = model.encode_frame(tokens, None, caches, cache_index, t_idx,
                                                qparams=qparams)
            cond = states if model.mixer is None else model.mix_states(states0, states)
            latents.append(frame(cond, t_idx))
            cache_index += nv
        dt = torch.promote_types(latents[0].dtype, latents[-1].dtype)
        return torch.stack([lat.to(dt) for lat in latents], dim=1)

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
                  order=None, noise=None, step_noise=None) -> Dict:
        """Record activation ranges and max attention logits over one real
        (shortened) AR trajectory, through the blocks' calibration mirrors and
        the dispatcher attention (the masking path, no buckets), and fold
        them into every later call as static int8 scales (times ``margin``;
        q/k amax times ``margin`` and the extra q/k margin) and static
        softmax offsets. ``max_latent_length`` > 1 also runs frame 0 and then
        the trajectory's frame as frame 1 through the video encoder's KV
        caches (their layers sow the MLP's sites only: the cached attention
        keeps its plain core). Returns the raw stats tree (the JAX
        collection's layout)."""
        model, dev = self.model, self.device
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
        S, ts = len(counts), [float(t) for t in sched.timesteps]
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
                x_t = self._step(pred, j, t, x_t, sched, g,
                                 None if step_noise is None else step_noise[i][j])
            canvas, mask = self._scatter(canvas, mask, ids, valid, x_t)
        if max_latent_length > 1:
            nv, text_len = model.num_video_tokens, c.shape[1]
            caches = model.init_video_caches(nb, text_len, 2)
            tok0 = model.frame_tokens(model.bos_frame(nb)[:, 0], 0, 2)
            (_, caches), s0 = model.encode_frame(tok0, c, caches, 0, 0, calibrate=True)
            frame = unpatchify(canvas, model.patch_size, model.image_base_size)
            tok1 = model.frame_tokens(model.embed_video_frame(frame), 1, 2).repeat(n_passes, 1, 1)
            _, s1 = model.encode_frame(tok1, None, caches, text_len + nv, 1, calibrate=True)
            stats = max_merge_stats(stats, max_merge_stats(s0, s1))
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
        motion_flow: Optional[float] = 5.0,
        fps: Optional[float] = None,
        order=None,
        noise=None,
        step_noise=None,
    ) -> NOVAPipelineOutput:
        """Text to (B, H, W, C) latents, or (B, T, H, W, C) latent frames for
        ``max_latent_length`` T > 1; with ``output_type`` "np" (or "pil")
        the VAE's uint8 pixels: ``images`` (B, H', W', 3) for T = 1,
        ``frames`` (B, T', H', W', 3) otherwise. ``latents`` (B, H, W, C):
        frame 0 given (i2v, e.g. from ``encode_image``), not sampled. A video model's flow / fps tokens follow the
        prompt (``motion_flow=None``: none). ``order`` (B, Ni), ``noise`` (S,
        B, P, patch_dim) and, with DDPM, ``step_noise`` (S, D, B, P,
        patch_dim): the prediction order, the AR steps' initial noise and the
        diffusion steps' noise, with a leading frame axis when T > 1; drawn
        from ``generator`` when not given."""
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
        if motion_flow is not None and model.motion_embed is not None:
            nb = c.shape[0]
            m = model.embed_motion(
                nb, torch.full((nb,), float(motion_flow), device=dev),
                None if fps is None else torch.full((nb,), float(fps), device=dev))
            c = torch.cat([c, m.to(c.dtype)], dim=1)
        batch = c.shape[0] // guidance.num_passes
        g = generator if generator is not None else \
            torch.Generator(device=dev).manual_seed(0)
        latents0 = None
        if latents is not None:
            latents0 = patchify(torch.as_tensor(latents, device=dev), model.patch_size)
        qparams = self.serving_qparams()  # once per call, outside the loops
        frame_kw = dict(num_inference_steps=num_inference_steps,
                        num_diffusion_steps=num_diffusion_steps, flow_shift=flow_shift)
        T = max_latent_length
        if T == 1 and latents0 is not None:  # frame 0 given: nothing to generate
            out = latents0[:, None]
        elif T == 1:
            cond = model.encode_video(model.bos_frame(c.shape[0]), c, 1, qparams=qparams)
            out = self._generate_frame(cond, batch, guidance=guidance, qparams=qparams,
                                       generator=g, order=order, noise=noise,
                                       step_noise=step_noise, **frame_kw)[:, None]
        else:
            out = self._generate_video(c, batch, T, guidance, qparams, g, frame_kw, latents0,
                                       order, noise, step_noise)
        b, t = out.shape[:2]
        frames = unpatchify(out.reshape((b * t,) + tuple(out.shape[2:])), model.patch_size,
                            model.image_base_size)
        frames = frames.reshape((b, t) + tuple(frames.shape[1:]))
        if output_type == "latent":
            return NOVAPipelineOutput(latents=frames[:, 0] if T == 1 else frames)
        proc = self.image_processor
        if T == 1:
            return NOVAPipelineOutput(
                images=proc.postprocess(proc.decode_latents(frames[:, 0]), output_type))
        return NOVAPipelineOutput(frames=proc.postprocess(proc.decode_latents(frames), "np"))
