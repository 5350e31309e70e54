"""Masked-AR point-cloud model (port of
``nova_pointcloud_tpu/models/pointcloud_ar.py``): the NOVA engine with a
point frontend.

- points (B, N, 3) are patchified into (B, N/p, p*3) tokens by a reshape
  (sort the cloud by Morton code first, ``ops/pointops.morton_sort``, so
  each patch is a spatially compact group);
- a ``VisionTransformer`` encodes the tokens MAE-style (mask tokens where
  nothing is known yet, the visible tokens through the encoder half) with
  the text prefix, a learned position table and the ClusterBlock's summary
  of the patch centres;
- a ``DiffusionMLP`` denoises per-token point patches over the cosine
  masked-AR schedule (``pipelines/pointcloud_ar.py``).

``quantize`` selects the int8 serving path of the ViT (its qkv /
out-projections through ``int8_linear``, its MLP through
``fused_int8_mlp_postln``) and of the head (``fused_int8_diffusion_block``):
the kernels on the card, their plain versions on the CPU. The attention
core (at most text + N/p keys) stays on the dispatcher's plain core. Module
names are the flax tree's (``models/convert.py``); ``pos_embed`` is the
flax ``pos_embed`` parameter. The step methods are differentiable
(training); the pipeline runs them under ``torch.no_grad()``.
"""

from typing import Dict, Optional

import torch
from torch import nn

from nova_pointcloud_tpu_torch.models.diffusion_mlp import DiffusionMLP
from nova_pointcloud_tpu_torch.models.embeddings import MaskTokens, TextEmbed
from nova_pointcloud_tpu_torch.models.layers import dense
from nova_pointcloud_tpu_torch.models.pointcloud import PC_ARCHES, ClusterBlock
from nova_pointcloud_tpu_torch.models.vit import VisionTransformer
from nova_pointcloud_tpu_torch.ops import masking
from nova_pointcloud_tpu_torch.ops.losses import masked_diffusion_mse
from nova_pointcloud_tpu_torch.ops.quantization import quantize_serving_params
from nova_pointcloud_tpu_torch.utils.device import resolve_device

MLP_DEPTH = 6


def _sub(qparams: Optional[Dict], name: str) -> Optional[Dict]:
    return None if qparams is None else qparams[name]


class NOVAPointCloudARTransformer(nn.Module):
    """Masked-AR + per-token diffusion over point patches.

    ``dtype``: the compute dtype of the Dense layers (``torch.bfloat16`` with
    bf16 weights serves on the card). ``noise_scheduler``, ``loss_repeat``
    and ``remat`` are the training settings. ``device``: ``cuda`` unless
    ``"cpu"`` is asked for."""

    def __init__(self, arch: str = "pc_d32w768", point_cloud_size: int = 2048,
                 patch_size: int = 16, text_token_dim: Optional[int] = None,
                 text_token_len: int = 32, num_clusters: int = 8, loss_repeat: int = 4,
                 noise_scheduler=None, remat: bool = False, quantize: bool = False,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        if arch not in PC_ARCHES:
            raise KeyError(f"unknown pc arch {arch!r}; known: {sorted(PC_ARCHES)}")
        dev = resolve_device(device)
        depth, dim, heads = PC_ARCHES[arch]
        self.arch, self.point_cloud_size, self.patch_size = arch, point_cloud_size, patch_size
        self.text_token_dim, self.text_token_len = text_token_dim, text_token_len
        self.loss_repeat, self.noise_scheduler = loss_repeat, noise_scheduler
        self.quantize, self.dtype = quantize, dtype
        self.patch_proj = nn.Linear(self.patch_dim, dim, device=dev)
        self.pos_embed = nn.Parameter(torch.zeros(1, self.num_tokens, dim, device=dev))
        self.encoder = VisionTransformer(depth, dim, heads, attn_impl="auto", quantize=quantize,
                                         dtype=dtype, remat=remat, device=dev)
        self.decoder = DiffusionMLP(MLP_DEPTH, dim, cond_dim=dim, out_dim=self.patch_dim,
                                    quantize=quantize, dtype=dtype, device=dev)
        self.mask_tokens = MaskTokens(dim, dev)
        self.cluster = ClusterBlock(dim, heads, num_clusters, dev)
        self.text_embed = (TextEmbed(text_token_dim, dim, text_token_len, device=dev)
                           if text_token_dim else None)

    @property
    def num_tokens(self) -> int:
        return self.point_cloud_size // self.patch_size

    @property
    def patch_dim(self) -> int:
        return self.patch_size * 3

    @property
    def device(self) -> torch.device:
        return self.pos_embed.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "NOVAPointCloudARTransformer":
        """Seeded random init after the flax initializers: Dense kernels
        normal with std 1/sqrt(fan_in), zero biases, unit LayerNorms,
        pos_embed, the BOS / mask tokens and the null prompt N(0, 0.02), the
        cluster centres N(0, 0.1), and the head's AdaLN projections zero.
        ``generator`` lives on the model's device."""
        def normal(p, std):
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device,
                                dtype=torch.float32) * std)

        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                normal(mod.weight, mod.in_features ** -0.5)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        for p in (self.pos_embed, self.mask_tokens.bos_token, self.mask_tokens.mask_token):
            normal(p, 0.02)
        if self.text_embed is not None:
            normal(self.text_embed.null_prompt, 0.02)
        normal(self.cluster.cluster_centers, 0.1)
        for blk in self.decoder.blocks():
            blk.norm1.proj.weight.zero_()
        self.decoder.norm.proj.weight.zero_()
        return self

    @torch.no_grad()
    def fill_zero_init(self, generator: torch.Generator, std: float = 0.02
                       ) -> "NOVAPointCloudARTransformer":
        """Seeded non-zero values for the head's zero-initialised AdaLN
        projections and every bias, so each diffusion block's gate, scale
        and shift depend on their inputs."""
        adaln = [blk.norm1.proj for blk in self.decoder.blocks()] + [self.decoder.norm.proj]
        for lin in adaln:
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=generator,
                                         device=lin.weight.device) * std)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                mod.bias.copy_(torch.randn(mod.bias.shape, generator=generator,
                                           device=mod.bias.device) * std)
        return self

    def serving_qparams(self) -> Optional[Dict]:
        """int8 weights of the ViT blocks and the head's blocks for one
        sampling call (``quantize_serving_params``: the JAX tree's keys and
        shapes), or None on the float path."""
        return quantize_serving_params(self) if self.quantize else None

    # -- frontends ---------------------------------------------------------------
    def patchify(self, points: torch.Tensor) -> torch.Tensor:
        b, n, _ = points.shape
        return points.reshape(b, n // self.patch_size, self.patch_dim)

    def unpatchify(self, patches: torch.Tensor) -> torch.Tensor:
        return patches.reshape(patches.shape[0], self.point_cloud_size, 3)

    def patch_centers(self, patches: torch.Tensor) -> torch.Tensor:
        """(B, N/p, p*3) patches -> (B, N/p, 3) mean xyz of each patch."""
        b, nt, _ = patches.shape
        return torch.mean(patches.reshape(b, nt, self.patch_size, 3), dim=2)

    def tokens_from_patches(self, patches: torch.Tensor) -> torch.Tensor:
        return dense(patches, self.patch_proj, self.dtype)

    def embed_text(self, text_embeds: torch.Tensor, generator: Optional[torch.Generator] = None,
                   drop: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Raw encoder states -> model-dim text tokens; with a ``generator``
        (or a given ``drop`` (B,) bool) prompts first drop to the null bank
        (train-time CFG dropout)."""
        if generator is not None or drop is not None:
            text_embeds = self.text_embed.drop_prompts(text_embeds, generator, drop)
        return self.text_embed(text_embeds)

    def null_text(self, batch: int, length: Optional[int] = None) -> torch.Tensor:
        return self.text_embed(self.text_embed.null_embeds(batch, length))

    # -- engine steps --------------------------------------------------------------
    def encode_step(self, tokens: torch.Tensor, mask: torch.Tensor, cond: Optional[torch.Tensor],
                    coords: Optional[torch.Tensor] = None,
                    qparams: Optional[Dict] = None) -> torch.Tensor:
        """Masked encoding of patch tokens (B, N/p, D), mask (B, N/p, 1) with
        1 = masked, cond (B, Lc, D); ``coords`` (B, N/p, 3): the patch
        centres for the ClusterBlock's summary token, which never drops
        (deterministic, in training too). ``qparams``: the model's serving
        tree (int8 path)."""
        z = self.mask_tokens.apply_mask(tokens, mask)
        z = z + self.pos_embed[:, : z.shape[1]].to(z.dtype)
        if coords is not None:
            z = z + self.cluster(coords, self.dtype).to(z.dtype)
        visible = 1.0 - mask[..., 0]
        z, _ = self.encoder(z, c=cond, visible=visible, qparams=_sub(qparams, "encoder"))
        return z

    def denoise_step(self, x_t: torch.Tensor, timestep: torch.Tensor, z: torch.Tensor,
                     qparams: Optional[Dict] = None) -> torch.Tensor:
        """One eval of the per-token head: x_t (B, P, p*3), timestep (B,) or
        (B, P), z (B, P, D)."""
        return self.decoder(x_t, timestep, z, qparams=_sub(qparams, "decoder"))

    # -- training --------------------------------------------------------------------
    def train_losses(self, points: torch.Tensor, text_embeds: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """Masked modelling + token diffusion over point patches, the loss of
        one batch of (B, N, 3) points (float32).

        The prompts drop to the null bank (CFG dropout); a training mask
        (ratio >= 0.7) hides patches, whose centres then enter the
        ClusterBlock as zeros, as the sampler's empty canvas does; the head
        regresses the scheduler's target (the noise, or noise - x for flow
        matching) of every patch, tiled ``loss_repeat`` times with fresh
        timesteps and noise; the loss is the MSE over the masked patches.
        Random draws come from ``generator``; ``draws`` may give any of them
        instead: ``drop`` (B,) bool, ``mask`` (B, N/p, 1), ``timesteps``
        (R*B, N/p), ``noise`` (R*B, N/p, p*3)."""
        draws = draws or {}
        dev = self.device
        points = points.to(dev, torch.float32)
        b = points.shape[0]
        patches = self.patchify(points)
        tokens = self.tokens_from_patches(patches)
        coords = self.patch_centers(patches)
        cond = None
        if self.text_embed is not None and text_embeds is not None:
            cond = self.embed_text(text_embeds.to(dev), generator, draws.get("drop"))
        mask = draws.get("mask")
        if mask is None:
            mask, _ = masking.sample_train_mask(generator, b, self.num_tokens, device=dev)
        mask = mask.to(dev, torch.float32)
        coords = coords * (1.0 - mask)
        z = self.encode_step(tokens, mask, cond, coords)

        rep = self.loss_repeat
        sched = self.noise_scheduler
        z_r = z.repeat(rep, 1, 1)
        x_r = patches.repeat(rep, 1, 1)
        mask_r = mask.repeat(rep, 1, 1)
        t = draws.get("timesteps")
        if t is None:
            t = sched.sample_timesteps(generator, z_r.shape[:2], device=dev)
        t = t.to(dev)
        noise = draws.get("noise")
        if noise is None:
            noise = torch.randn(x_r.shape, generator=generator, device=dev)
        noise = noise.to(dev, torch.float32)
        noised = sched.add_noise(x_r, noise, t)
        if isinstance(noised, tuple):  # flow matching: (x_t, model timestep)
            x_t, model_t = noised
            target = noise - x_r
        else:
            x_t, model_t = noised, t
            target = noise
        pred = self.denoise_step(x_t.to(z_r.dtype), model_t, z_r)
        return {"loss": masked_diffusion_mse(pred, target, mask_r)}

    def forward(self, points: torch.Tensor, text_embeds: Optional[torch.Tensor] = None,
                **kwargs) -> Dict[str, torch.Tensor]:
        return self.train_losses(points, text_embeds, **kwargs)
