"""NOVA core: masked-AR transformer with a per-token diffusion head (port of
``nova_pointcloud_tpu/models/nova.py``: ``NOVATransformer``'s text-to-image
and text-to-video serving methods and its t2i training loss).

The module owns the parameters and exposes step methods that the pipelines
orchestrate: ``embed_text`` / ``null_text`` / ``embed_label`` (c2i: class ids
through the label table, the null class ``num_classes`` the CFG negative) /
``embed_motion``, ``bos_frame``,
``encode_video`` (the BOS frame with the text prefix, or T frames with the
block-causal bias and the AdaLN mixer), ``frame_tokens`` /
``embed_video_frame`` / ``encode_frame`` / ``mix_states`` (the KV-cached frame
decode), ``tokens_from_patches``, ``encode_image_step`` (masked or
bucket-gathered encoder half), ``denoise_step`` (the diffusion head), and
``train_losses`` (= ``forward``), the TAM + MAM + token-wise diffusion loss of
one training batch (t2i, t2v over T frames, c2i; flow matching or DDPM).
Positions are absolute sincos tables or, with ``rotary_pos_embed``, 3-axis
RoPE inside attention. Shapes are
channels-last, as in the JAX package. The step methods are differentiable;
the serving pipelines run them under ``torch.no_grad()``.

Each step method takes the model's serving tree ``qparams`` (the int8 path,
``ops/quantization.quantize_serving_params`` plus calibrated scales) and,
where the JAX package sows calibration stats, ``calibrate=True``, which makes
it return ``(out, stats)``. Not ported yet, and raising: MoE.
"""

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from nova_pointcloud_tpu_torch.models.diffusion_mlp import DiffusionMLP
from nova_pointcloud_tpu_torch.models.embeddings import (LabelEmbed, MaskTokens, MotionEmbed,
                                                         PatchEmbed, PosEmbed, TextEmbed,
                                                         VideoPosEmbed, patchify, rope_positions,
                                                         rope_weights)
from nova_pointcloud_tpu_torch.models.normalization import AdaLayerNorm
from nova_pointcloud_tpu_torch.models.vit import VisionTransformer
from nova_pointcloud_tpu_torch.ops import masking
from nova_pointcloud_tpu_torch.ops.attention import KVCache
from nova_pointcloud_tpu_torch.ops.losses import masked_diffusion_mse
from nova_pointcloud_tpu_torch.utils.device import resolve_device

# arch name -> (depth, embed_dim, num_heads), as the JAX registry
VIT_ARCHES = {
    "vit_d16w768": (16, 768, 12),
    "vit_d16w1024": (16, 1024, 16),
    "vit_d16w1536": (16, 1536, 16),
    "vit_d32w768": (32, 768, 12),
    "vit_d32w1024": (32, 1024, 16),
    "vit_d32w1536": (32, 1536, 16),
    # tiny arches for tests / golden configs
    "vit_d2w64": (2, 64, 2),
    "vit_d4w128": (4, 128, 4),
    "vit_d48w1024": (48, 1024, 16),
    "vit_d48w1536": (48, 1536, 16),
}
MLP_ARCHES = {
    "mlp_d3w1280": (3, 1280),
    "mlp_d6w768": (6, 768),
    "mlp_d6w1024": (6, 1024),
    "mlp_d6w1536": (6, 1536),
    "mlp_d2w64": (2, 64),
    "mlp_d3w128": (3, 128),
}


def _sub(qparams: Optional[Dict], name: str) -> Optional[Dict]:
    return None if qparams is None else qparams[name]


class NOVATransformer(nn.Module):
    """Unified AR-diffusion core; latents (B, T, H, W, C), T=1 for images.

    ``quantize``: the int8 serving path in both ViTs and the diffusion head
    (the kernels on the card, their plain versions on the CPU).
    ``dtype``: the compute dtype of the Dense layers, as the flax modules'
    (``torch.bfloat16`` with bf16 weights is the serving setting; bf16 with
    f32 weights the training one: each layer casts its weights inside
    autograd, so gradients land in f32 on them). ``noise_scheduler``,
    ``loss_repeat`` and ``remat`` (per-block recompute in the backward: the
    ViT blocks, as the JAX module's, and the diffusion head's blocks) are
    the training settings, as in the JAX module.
    ``device``: ``cuda`` unless ``"cpu"`` is asked for."""

    def __init__(self, arch: Tuple[str, str, str], image_dim: int = 4,
                 image_base_size: Tuple[int, int] = (16, 16),
                 video_base_size: Tuple[int, int, int] = (1, 8, 8), patch_size: int = 2,
                 text_token_dim: Optional[int] = None, text_token_len: int = 256,
                 num_classes: Optional[int] = None, rotary_pos_embed: bool = False,
                 video_mixer_rank: Optional[int] = None, loss_repeat: int = 4,
                 noise_scheduler=None, remat: bool = False, attn_impl: str = "auto",
                 quantize: bool = False, dtype: Optional[torch.dtype] = None,
                 attn_core: str = "bf16", num_experts: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.arch = tuple(arch)
        self.image_dim, self.patch_size = image_dim, patch_size
        self.image_base_size = tuple(image_base_size)
        self.video_base_size = tuple(video_base_size)
        self.text_token_dim, self.text_token_len = text_token_dim, text_token_len
        self.num_classes = num_classes
        self.quantize, self.dtype, self.attn_core = quantize, dtype, attn_core
        self.rotary_pos_embed, self.video_mixer_rank = rotary_pos_embed, video_mixer_rank
        self.loss_repeat, self.noise_scheduler = loss_repeat, noise_scheduler
        dv, wv, hv = VIT_ARCHES[arch[0]]
        di, wi, hi = VIT_ARCHES[arch[1]]
        dd, wd = MLP_ARCHES[arch[2]]
        if wv != wi:
            raise ValueError(f"video/image encoder widths must match ({arch[0]} vs {arch[1]})")
        kw = dict(attn_impl=attn_impl, quantize=quantize, dtype=dtype, attn_core=attn_core,
                  num_experts=num_experts, remat=remat, device=dev)
        self.video_patch_embed = PatchEmbed(wv, self.video_patch_size, image_dim, dev)
        self.image_patch_embed = PatchEmbed(wi, patch_size, image_dim, dev)
        self.video_encoder = VisionTransformer(dv, wv, hv, **kw)
        self.image_encoder = VisionTransformer(di, wi, hi, **kw)
        self.image_decoder = DiffusionMLP(dd, wd, cond_dim=wi, out_dim=self.patch_dim,
                                          quantize=quantize, dtype=dtype, remat=remat,
                                          device=dev)
        self.mask_tokens = MaskTokens(wi, dev)
        self.text_embed = (TextEmbed(text_token_dim, wi, text_token_len, device=dev)
                           if text_token_dim else None)
        # label conditioning (c2i) where the model takes no text
        self.label_embed = (LabelEmbed(wi, num_classes, device=dev)
                            if num_classes and not text_token_dim else None)
        self.video_pos_embed = self.image_pos_embed = None
        if not rotary_pos_embed:
            self.video_pos_embed = VideoPosEmbed(wv, self.video_base_size, dev)
            self.image_pos_embed = PosEmbed(wi, self.image_base_size)
        self.motion_embed = MotionEmbed(wv, device=dev) if video_base_size[0] > 1 else None
        self.mixer = None
        if video_mixer_rank is not None:
            self.mixer = AdaLayerNorm(wv, max(video_mixer_rank, 0) or None, eps=None,
                                      device=dev)
        self._head_dims = (wv // hv, wi // hi)

    # -- derived sizes ------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.mask_tokens.bos_token.device

    @property
    def video_patch_size(self) -> int:
        return self.patch_size * 2

    @property
    def num_image_tokens(self) -> int:
        return self.image_base_size[0] * self.image_base_size[1]

    @property
    def num_video_tokens(self) -> int:  # per frame
        return self.video_base_size[1] * self.video_base_size[2]

    @property
    def latent_hw(self) -> Tuple[int, int]:
        return (self.image_base_size[0] * self.patch_size,
                self.image_base_size[1] * self.patch_size)

    @property
    def patch_dim(self) -> int:
        return self.patch_size ** 2 * self.image_dim

    @property
    def embed_dim(self) -> int:
        return VIT_ARCHES[self.arch[1]][1]

    @property
    def head_dim_v(self) -> int:
        return self._head_dims[0]

    @property
    def head_dim_i(self) -> int:
        return self._head_dims[1]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "NOVATransformer":
        """Seeded random init after the flax initializers: Dense kernels
        normal with std 1/sqrt(fan_in), zero biases, unit LayerNorms, the
        null prompt and the BOS / mask tokens N(0, 0.02), and the AdaLN
        projections zero (as ``AdaLayerNormZero``'s kernel_init; the video
        mixer's too, which makes it the identity), the label table
        N(0, 0.02). A serving smoke test with
        zero AdaLN projections runs every diffusion block as the identity:
        fill them (``fill_zero_init``) to exercise the blocks. ``generator``
        lives on the model's device."""
        def normal(p, std):
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device,
                                dtype=torch.float32) * std)

        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                normal(mod.weight, mod.in_features ** -0.5)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        for p in (self.mask_tokens.bos_token, self.mask_tokens.mask_token):
            normal(p, 0.02)
        if self.text_embed is not None:
            normal(self.text_embed.null_prompt, 0.02)
        if self.label_embed is not None:
            normal(self.label_embed.weight, 0.02)
        for lin in self._adaln_projections():
            lin.weight.zero_()
        return self

    def _adaln_projections(self):
        out = [blk.norm1.proj for blk in self.image_decoder.blocks()]
        out.append(self.image_decoder.norm.proj)
        if self.mixer is not None:
            out.append(self.mixer.ada.proj)
        return out

    @torch.no_grad()
    def fill_zero_init(self, generator: torch.Generator, std: float = 0.02
                       ) -> "NOVATransformer":
        """Seeded non-zero values for the zero-initialised AdaLN projections
        (the video mixer's too), every bias and the label table's LayerNorm
        bias, so each diffusion block's gate, scale and shift, the mixer's
        modulation and the class tokens depend on their inputs."""
        def fill(p):
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device) * std)

        for lin in self._adaln_projections():
            fill(lin.weight)
        for mod in self.modules():
            if isinstance(mod, nn.Linear) and mod.bias is not None:
                fill(mod.bias)
        if self.label_embed is not None:
            fill(self.label_embed.norm.bias)
        return self

    # -- conditioning -------------------------------------------------------
    def embed_text(self, text_embeds: torch.Tensor) -> torch.Tensor:
        """Raw encoder states -> model-dim text tokens."""
        return self.text_embed(text_embeds)

    def null_text(self, batch: int, length: Optional[int] = None) -> torch.Tensor:
        """Model-dim null-prompt tokens (CFG negatives)."""
        return self.text_embed(self.text_embed.null_embeds(batch, length))

    def embed_label(self, labels: torch.Tensor) -> torch.Tensor:
        """Class ids (B,) -> model-dim class tokens (B, 1, D); id
        ``num_classes`` is the null class."""
        return self.label_embed(labels)

    def embed_motion(self, batch: int, flow: Optional[torch.Tensor] = None,
                     fps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, 2, D) flow / fps tokens of a video model."""
        return self.motion_embed(batch, flow, fps)

    # -- positional tables (no parameters) ----------------------------------
    def video_rope(self, num_frames: int, pad: int = 0):
        if not self.rotary_pos_embed:
            return None
        pos = rope_positions(num_frames, self.video_base_size[1:], self.device)
        return rope_weights(pos, self.head_dim_v, pad=pad)

    def image_rope(self, pad: int = 0):
        if not self.rotary_pos_embed:
            return None
        pos = rope_positions(1, self.image_base_size, self.device)
        return rope_weights(pos, self.head_dim_i, pad=pad)

    # -- TAM: temporal AR over frames ----------------------------------------
    def bos_frame(self, batch: int) -> torch.Tensor:
        """(B, 1, Nv, D) raw BOS tokens, no position."""
        return self.mask_tokens.bos((batch, 1, self.num_video_tokens))

    def frame_tokens(self, tokens: torch.Tensor, frame_index: int,
                     total_frames: int) -> torch.Tensor:
        """Add frame ``frame_index``'s time row (of a table over
        ``total_frames``, as in training) and the space table to raw (B, Nv,
        D) tokens; RoPE models take positions inside attention instead."""
        if self.rotary_pos_embed:
            return tokens
        row = self.video_pos_embed.time_embed(total_frames)[frame_index]
        return self.video_pos_embed(tokens + row.to(tokens.dtype), add_time=False)

    def embed_video_frame(self, x_frame: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> raw (B, Nv, D) video patch tokens."""
        return self.video_patch_embed(x_frame)

    def encode_video(self, c_vid: torch.Tensor, c_text: Optional[torch.Tensor],
                     num_frames: int, qparams: Optional[Dict] = None,
                     calibrate: bool = False):
        """c_vid (B, T, Nv, D) raw [BOS, frames..] tokens -> states (B, T*Nv, D).
        T > 1: teacher-forced, under the block-causal bias, then the AdaLN
        mixer re-modulates the first frame's states by each later frame's."""
        b, t, nv, d = c_vid.shape
        if not self.rotary_pos_embed:
            c_vid = self.video_pos_embed(c_vid)
        c_len = 0 if c_text is None else c_text.shape[1]
        bias = masking.block_causal_bias((nv,) * t, c_len, device=c_vid.device) if t > 1 \
            else None
        states, stats = self.video_encoder(c_vid.reshape(b, t * nv, d), c=c_text, bias=bias,
                                           rope=self.video_rope(t, pad=c_len),
                                           qparams=_sub(qparams, "video_encoder"),
                                           calibrate=calibrate)
        if self.mixer is not None and t > 1:
            s = states.reshape(b, t, nv, d)
            mixed = self.mixer(s[:, :1], s[:, 1:])  # x (frame 0) broadcasts over T - 1
            dt = torch.promote_types(s.dtype, mixed.dtype)
            states = torch.cat([s[:, :1].to(dt), mixed.to(dt)], 1).reshape(b, t * nv, d)
        return (states, {"video_encoder": stats}) if calibrate else states

    def encode_frame(self, tokens: torch.Tensor, c_text: Optional[torch.Tensor],
                     caches: Tuple[KVCache, KVCache], cache_index: int, frame_index: int,
                     qparams: Optional[Dict] = None, calibrate: bool = False):
        """Video-encoder pass of one frame through the KV caches: tokens (B,
        Nv, D), the text prefix on frame 0 only; RoPE positions are the
        frame's own. Returns (states, caches); the caches are written in
        place."""
        rope = None
        if self.rotary_pos_embed:
            pad = 0 if c_text is None else c_text.shape[1]
            off = torch.tensor([1.0, 0.0, 0.0], device=tokens.device) * frame_index
            pos = rope_positions(1, self.video_base_size[1:], tokens.device) + off
            rope = rope_weights(pos, self.head_dim_v, pad=pad)
        states, stats = self.video_encoder(tokens, c=c_text, rope=rope, caches=caches,
                                           cache_index=cache_index,
                                           qparams=_sub(qparams, "video_encoder"),
                                           calibrate=calibrate)
        if calibrate:
            return (states, caches), {"video_encoder": stats}
        return states, caches

    def mix_states(self, first: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
        """The AdaLN state mixer at decode: frame 0's states modulated by the
        current frame's."""
        return self.mixer(first, cur)

    def init_video_caches(self, batch: int, text_len: int, num_frames: int,
                          dtype=torch.float32) -> Tuple[KVCache, KVCache]:
        """Stacked (enc, dec) KV caches of the video encoder, room for the
        prefix and ``num_frames`` frames."""
        return self.video_encoder.init_caches(
            batch, text_len + num_frames * self.num_video_tokens, dtype)

    def encode_image_step(self, tokens: torch.Tensor, mask: torch.Tensor,
                          cond: Optional[torch.Tensor], visible_bucket: Optional[int] = None,
                          qparams: Optional[Dict] = None, calibrate: bool = False):
        """Masked-token image encoding for one AR step: tokens (B, Ni, D)
        patch embeddings (no position), mask (B, Ni, 1) with 1 = masked, cond
        (B, Lc, D). ``visible_bucket``: the static bound on the visible
        count; the encoder half then gathers the visible tokens."""
        z = self.mask_tokens.apply_mask(tokens, mask)
        if not self.rotary_pos_embed:
            z = self.image_pos_embed(z)
        visible = 1.0 - mask[..., 0]
        rope = self.image_rope(pad=0 if cond is None else cond.shape[1])
        z, stats = self.image_encoder(z, c=cond, visible=visible, rope=rope,
                                      visible_bucket=visible_bucket,
                                      qparams=_sub(qparams, "image_encoder"),
                                      calibrate=calibrate)
        return (z, {"image_encoder": stats}) if calibrate else z

    def tokens_from_patches(self, patches: torch.Tensor) -> torch.Tensor:
        """(B, Ni, patch_dim) patchified canvas -> (B, Ni, D) tokens."""
        return self.image_patch_embed(patches, pre_patchified=True)

    def denoise_step(self, x_t: torch.Tensor, timestep: torch.Tensor, z: torch.Tensor,
                     stg_rows: Optional[int] = None, qparams: Optional[Dict] = None,
                     calibrate: bool = False):
        """One eval of the per-token diffusion head: x_t (B, P, patch_dim),
        timestep (B,) or (B, P), z (B, P, D)."""
        if calibrate:
            out, stats = self.image_decoder.calibration_forward(x_t, timestep, z)
            return out, {"image_decoder": stats}
        return self.image_decoder(x_t, timestep, z, stg_rows=stg_rows,
                                  qparams=_sub(qparams, "image_decoder"))

    # -- training -------------------------------------------------------------
    def train_losses(self, x: torch.Tensor, text_embeds: Optional[torch.Tensor] = None,
                     labels: Optional[torch.Tensor] = None,
                     motion_flow: Optional[torch.Tensor] = None,
                     fps: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """TAM + MAM + token-wise diffusion loss of one batch.

        x: (B, H, W, C) or (B, T, H, W, C) clean latents (float32). The text
        prompts drop to the null bank and the class ids to the null class
        (CFG dropout); the motion tokens (``motion_flow``, ``fps``; the
        MotionEmbed's bases when None) follow them when T > 1 on a video
        model. [BOS, frames 0..T-2] go through the video encoder
        (teacher-forced, the block-causal bias and the mixer when T > 1);
        each frame is masked (ratio >= 0.7, the visible-token gather at
        bucket ``round(0.3 Ni)``) and encoded against its own frame's
        states; the diffusion head regresses every token, tiled
        ``loss_repeat`` times with fresh timesteps and noise: the
        flow-matching target, or with a DDPM scheduler (``add_noise`` gives
        x_t alone) the noise at the integer timestep. The loss is the MSE
        over the masked tokens, ``{"loss"}`` at T = 1, else per frame
        ``{"loss_t2i": frame 0 x T, "loss_i2i": frames 1.. x T / (T - 1)}``.
        Random draws come from ``generator``; ``draws`` may give any of them
        instead: ``drop`` (B,) bool (the prompts), ``label_drop`` (B,) bool
        (the class ids), ``mask`` (B*T, Ni, 1), ``timesteps`` (R*B*T, Ni)
        int, ``noise`` (R*B*T, Ni, patch_dim)."""
        if x.ndim == 4:
            x = x[:, None]
        b, t = x.shape[:2]
        draws = draws or {}
        dev = self.device
        ni, nv = self.num_image_tokens, self.num_video_tokens

        c_parts = []
        if self.text_token_dim and text_embeds is not None:
            c_parts.append(self.embed_text(self.text_embed.drop_prompts(
                text_embeds.to(dev), generator, draws.get("drop"))))
        if self.num_classes and labels is not None:
            c_parts.append(self.embed_label(self.label_embed.drop_labels(
                labels.to(dev), generator, draws.get("label_drop"))))
        if t > 1 and self.video_base_size[0] > 1:
            c_parts.append(self.embed_motion(b, motion_flow, fps))
        c_text = None
        if c_parts:
            dt = c_parts[0].dtype
            for c in c_parts[1:]:
                dt = torch.promote_types(dt, c.dtype)
            c_text = torch.cat([c.to(dt) for c in c_parts], 1)

        # TAM: [BOS, frames 0..T-2] -> per-frame states (B, T*Nv, D)
        c_vid = self.bos_frame(b)
        if t > 1:
            vid = self.video_patch_embed(x[:, : t - 1])
            dt = torch.promote_types(c_vid.dtype, vid.dtype)
            c_vid = torch.cat([c_vid.to(dt), vid.to(dt)], 1)
        states = self.encode_video(c_vid, c_text, t)

        # MAM: each frame masked and encoded against its own states
        z_tok = self.image_patch_embed(x).reshape(b * t, ni, -1)
        mask = draws.get("mask")
        if mask is None:
            mask, _ = masking.sample_train_mask(generator, b * t, ni, device=dev)
        mask = mask.to(dev, torch.float32)
        cond = states.reshape(b * t, nv, -1)
        bucket = int(round((1.0 - masking.TRAIN_MASK_RATIO_MIN) * ni))
        z = self.encode_image_step(z_tok, mask, cond, visible_bucket=max(bucket, 1))

        rep = self.loss_repeat
        x_patches = patchify(x.reshape((b * t,) + tuple(x.shape[2:])), self.patch_size)
        z_r = z.repeat(rep, 1, 1)
        x_r = x_patches.repeat(rep, 1, 1).float()
        mask_r = mask.repeat(rep, 1, 1)
        sched = self.noise_scheduler
        tsteps = draws.get("timesteps")
        if tsteps is None:
            tsteps = sched.sample_timesteps(generator, z_r.shape[:2], device=dev)
        tsteps = tsteps.to(dev)
        noise = draws.get("noise")
        if noise is None:
            noise = torch.randn(x_r.shape, generator=generator, device=dev)
        noise = noise.to(dev, torch.float32)
        noised = sched.add_noise(x_r, noise, tsteps)
        if isinstance(noised, tuple):  # flow matching: (x_t, the model's timestep)
            (x_t, model_t), target = noised, sched.target(x_r, noise)
        else:  # DDPM: x_t alone; the target is the noise
            x_t, model_t, target = noised, tsteps, noise
        pred = self.denoise_step(x_t.to(z_r.dtype), model_t, z_r)
        if t > 1:
            err = torch.mean((pred.float() - target) ** 2, dim=-1, keepdim=True) * mask_r
            err = err / (torch.sum(mask_r) + 1e-5)
            per_frame = err.reshape(rep * b, t, ni).sum(dim=(0, 2))  # (T,)
            return {"loss_t2i": per_frame[0] * t,
                    "loss_i2i": per_frame[1:].sum() * (t / (t - 1))}
        return {"loss": masked_diffusion_mse(pred, target, mask_r)}

    def forward(self, x: torch.Tensor, text_embeds: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None, **kwargs) -> Dict[str, torch.Tensor]:
        return self.train_losses(x, text_embeds, labels, **kwargs)
