"""LTX-Video causal 3D KL VAE, channels-last (port of
``nova_pointcloud_tpu/models/autoencoders/autoencoder_kl_ltx.py``):

- Conv3d with causal (frame 0 replicated in front) or symmetric
  (first / last frame replicated) time padding;
- parameter-free RMSNorm in float32;
- residual pixel-shuffle downsampling (space / time to depth, the shortcut
  a group mean) and upsampling (depth to space, the shortcut a channel
  repeat, the first r - 1 frames dropped);
- a 4 x 4 patchify at the encoder stem, latent_channels + 1 output channels
  (one shared logvar through the odd-channel trick);
- the timestep-conditioned decoder (a TimeEmbed per up block, a final
  scale / shift table, a learned ``timestep_scale``), the timestep threaded
  through the decode's tiling;
- per-channel ``latents_mean`` / ``latents_std`` scaling
  (``use_latent_stats``).

Submodules keep the flax names; no kernel of the repo runs here.
"""

from typing import Optional, Sequence, Tuple

import torch
from einops import rearrange
from torch import nn

from nova_pointcloud_tpu_torch.models.autoencoders.modeling_utils import (
    DiagonalGaussian, channels_last_weights, init_vae_weights, tiled_temporal_apply)
from nova_pointcloud_tpu_torch.models.embeddings import timestep_freq_embed
from nova_pointcloud_tpu_torch.models.layers import conv, dense, silu
from nova_pointcloud_tpu_torch.utils.device import resolve_device


class LTXConv3d(nn.Module):
    """3D conv; time padded by replication, in front (causal) or on both
    sides; space zero padded to keep its size."""

    def __init__(self, in_dim: int, features: int, kernel=(3, 3, 3), causal: bool = True,
                 dtype=None):
        super().__init__()
        self.kernel, self.causal, self.dtype = tuple(kernel), causal, dtype
        self.conv = nn.Conv3d(in_dim, features, self.kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kt, kh, kw = self.kernel
        if kt > 1:
            def rep(frame, n):
                return frame.expand((x.shape[0], n) + tuple(x.shape[2:]))

            if self.causal:
                x = torch.cat([rep(x[:, :1], kt - 1), x], dim=1)
            else:
                half = (kt - 1) // 2
                x = torch.cat([rep(x[:, :1], half), x, rep(x[:, -1:], half)], dim=1)
        return conv(x, self.conv, self.dtype, padding=(0, kh // 2, kw // 2))


def rms_norm(x: torch.Tensor) -> torch.Tensor:
    """Parameter-free RMSNorm over channels, float32 statistics."""
    xf = x.float()
    ms = torch.mean(xf ** 2, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + 1e-8)).to(x.dtype)


class TimeEmbed(nn.Module):
    """Frequency features (given, or made from a (B,) timestep) -> a SiLU
    MLP."""

    def __init__(self, embed_dim: int, freq_dim: int = 256):
        super().__init__()
        self.freq_dim = freq_dim
        self.fc1, self.fc2 = nn.Linear(freq_dim, embed_dim), nn.Linear(embed_dim, embed_dim)

    def forward(self, temb: torch.Tensor) -> torch.Tensor:
        x = timestep_freq_embed(temb, self.freq_dim) if temb.ndim == 1 else temb
        return dense(silu(dense(x, self.fc1)), self.fc2)


class LTXResBlock(nn.Module):
    """RMS -> (AdaLN from temb where not causal) -> conv, x2, + x."""

    def __init__(self, dim: int, causal: bool = True, dtype=None):
        super().__init__()
        if not causal:  # the decoder's blocks, always given a temb
            self.scale_shift_table = nn.Parameter(torch.zeros(4, dim))
        self.conv1 = LTXConv3d(dim, dim, causal=causal, dtype=dtype)
        self.conv2 = LTXConv3d(dim, dim, causal=causal, dtype=dtype)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        stats = None
        if hasattr(self, "scale_shift_table") and temb is not None:
            s = temb + self.scale_shift_table.reshape(-1)
            stats = torch.chunk(s[:, None, None, None, :], 4, dim=-1)
        h = rms_norm(x)
        if stats is not None:
            h = h * (1 + stats[1]) + stats[0]
        h = rms_norm(self.conv1(silu(h)))
        if stats is not None:
            h = h * (1 + stats[3]) + stats[2]
        return self.conv2(silu(h)) + x


_PATCH = "b (t r) (h p) (w q) c -> b t h w (c r p q)"
_UNPATCH = "b t h w (c r p q) -> b (t r) (h p) (w q) c"


class LTXDownsample(nn.Module):
    """Residual space / time to depth: the conv's output and the input, each
    patched into channels, the input's channels averaged in groups."""

    def __init__(self, dim: int, out_dim: int, stride: Tuple[int, int, int],
                 causal: bool = True, dtype=None):
        super().__init__()
        self.dim, self.out_dim, self.stride = dim, out_dim, tuple(stride)
        vol = stride[0] * stride[1] * stride[2]
        self.conv = LTXConv3d(dim, out_dim // vol, causal=causal, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r, p, q = self.stride
        if r > 1:
            x = torch.cat([x[:, :1].expand((x.shape[0], r - 1) + tuple(x.shape[2:])), x], dim=1)
        shortcut = rearrange(x, _PATCH, r=r, p=p, q=q)
        group = (self.dim * r * p * q) // self.out_dim
        shortcut = shortcut.reshape(tuple(shortcut.shape[:-1]) + (self.out_dim, group)).mean(-1)
        return rearrange(self.conv(x), _PATCH, r=r, p=p, q=q) + shortcut


class LTXUpsample(nn.Module):
    """Residual depth to space: the conv's output and the input repeated
    over channels, each unpatched; the first r - 1 frames dropped."""

    def __init__(self, dim: int, out_dim: int, stride=(2, 2, 2), causal: bool = False,
                 dtype=None):
        super().__init__()
        self.dim, self.out_dim, self.stride = dim, out_dim, tuple(stride)
        vol = stride[0] * stride[1] * stride[2]
        self.conv = LTXConv3d(dim, out_dim * vol, causal=causal, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r, p, q = self.stride
        repeats = (self.out_dim * r * p * q) // self.dim
        shortcut = rearrange(x.repeat(1, 1, 1, 1, repeats), _UNPATCH, r=r, p=p, q=q)
        h = rearrange(self.conv(x), _UNPATCH, r=r, p=p, q=q)
        if r > 1:
            h, shortcut = h[:, r - 1:], shortcut[:, r - 1:]
        return h + shortcut


class LTXEncoder(nn.Module):
    """(B, T, H, W, C) -> (B, T', H', W', latent + 1)."""

    STRIDES = ((1, 2, 2), (2, 1, 1), (2, 2, 2), (2, 2, 2))

    def __init__(self, in_dim: int, out_dim: int, block_dims: Sequence[int],
                 block_depths: Sequence[int], patch_size: int = 4, dtype=None):
        super().__init__()
        self.depths, self.patch_size = list(block_depths), patch_size
        self.conv_in = LTXConv3d(in_dim * patch_size ** 2, block_dims[0], dtype=dtype)
        for i, stride in enumerate(self.STRIDES):
            for j in range(block_depths[i]):
                setattr(self, f"down_{i}_res_{j}", LTXResBlock(block_dims[i], dtype=dtype))
            setattr(self, f"down_{i}_resize",
                    LTXDownsample(block_dims[i], block_dims[i + 1], stride, dtype=dtype))
        for j in range(block_depths[-1]):
            setattr(self, f"mid_res_{j}", LTXResBlock(block_dims[-1], dtype=dtype))
        self.conv_out = LTXConv3d(block_dims[-1], out_dim + 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pz = self.patch_size
        h = self.conv_in(rearrange(x, "b t (h p) (w q) c -> b t h w (c q p)", p=pz, q=pz))
        for i in range(len(self.STRIDES)):
            for j in range(self.depths[i]):
                h = getattr(self, f"down_{i}_res_{j}")(h)
            h = getattr(self, f"down_{i}_resize")(h)
        for j in range(self.depths[-1]):
            h = getattr(self, f"mid_res_{j}")(h)
        return self.conv_out(silu(rms_norm(h)))


class LTXDecoder(nn.Module):
    """Timestep-conditioned decoder: len(block_dims) - 1 up blocks, each
    halving the width, the exact inverse of the encoder."""

    def __init__(self, latent_dim: int, out_dim: int, block_dims: Sequence[int],
                 block_depths: Sequence[int], patch_size: int = 4, dtype=None):
        super().__init__()
        dims = list(reversed(block_dims))  # encoder order, reversed here
        self.dims, self.depths, self.patch_size = dims, list(block_depths), patch_size
        self.timestep_scale = nn.Parameter(torch.tensor(1000.0))
        self.conv_in = LTXConv3d(latent_dim, dims[0], causal=False, dtype=dtype)
        self.mid_time_embed = TimeEmbed(dims[0] * 4)
        for j in range(block_depths[-1]):
            setattr(self, f"mid_res_{j}", LTXResBlock(dims[0], causal=False, dtype=dtype))
        for i, (dim, depth) in enumerate(zip(dims, block_depths[:-1])):
            out = dim // 2
            setattr(self, f"up_{i}_resize", LTXUpsample(dim, out, dtype=dtype))
            setattr(self, f"up_{i}_time_embed", TimeEmbed(out * 4))
            for j in range(depth):
                setattr(self, f"up_{i}_res_{j}", LTXResBlock(out, causal=False, dtype=dtype))
        self.scale_shift_table = nn.Parameter(torch.zeros(2, dims[-1]))
        self.time_embed = TimeEmbed(dims[-1] * 2)
        self.conv_out = LTXConv3d(dims[-1], out_dim * patch_size ** 2, causal=False,
                                  dtype=dtype)

    def forward(self, z: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        freq = timestep_freq_embed(temb.float() * self.timestep_scale, 256)
        h = self.conv_in(z)
        mid_temb = self.mid_time_embed(freq)
        for j in range(self.depths[-1]):
            h = getattr(self, f"mid_res_{j}")(h, mid_temb)
        for i, depth in enumerate(self.depths[:-1]):
            h = getattr(self, f"up_{i}_resize")(h)
            up_temb = getattr(self, f"up_{i}_time_embed")(freq)
            for j in range(depth):
                h = getattr(self, f"up_{i}_res_{j}")(h, up_temb)
        h = rms_norm(h)
        s = self.time_embed(freq) + self.scale_shift_table.reshape(-1)
        shift, scale = torch.chunk(s[:, None, None, None, :], 2, dim=-1)
        h = self.conv_out(silu(h * (1 + scale) + shift))
        pz = self.patch_size
        return rearrange(h, "b t h w (c q p) -> b t (h p) (w q) c", p=pz, q=pz)


class AutoencoderKLLTXVideo(nn.Module):
    """LTX causal 3D KL VAE. ``dtype`` / ``device`` as ``AutoencoderKL``'s."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 block_out_channels: Tuple[int, ...] = (128, 256, 512, 1024, 2048),
                 layers_per_block: Tuple[int, ...] = (4, 6, 6, 2, 2),
                 decoder_block_out_channels: Tuple[int, ...] = (128, 256, 512, 1024),
                 decoder_layers_per_block: Tuple[int, ...] = (5, 5, 5, 5),
                 latent_channels: int = 128, scaling_factor: float = 1.0,
                 shift_factor: Optional[float] = None, use_latent_stats: bool = False,
                 patch_size: int = 4, sample_min_t: int = 249, latent_min_t: int = 32,
                 dtype=None, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.block_out_channels = tuple(block_out_channels)
        self.layers_per_block = tuple(layers_per_block)
        self.decoder_block_out_channels = tuple(decoder_block_out_channels)
        self.decoder_layers_per_block = tuple(decoder_layers_per_block)
        self.latent_channels, self.use_latent_stats = latent_channels, use_latent_stats
        self.scaling_factor, self.shift_factor = scaling_factor, shift_factor
        self.sample_min_t, self.latent_min_t, self.dtype = sample_min_t, latent_min_t, dtype
        with torch.device(dev):
            self.encoder = LTXEncoder(in_channels, latent_channels, block_out_channels,
                                      layers_per_block, patch_size, dtype)
            self.decoder = LTXDecoder(latent_channels, out_channels, decoder_block_out_channels,
                                      decoder_layers_per_block, patch_size, dtype)
            if use_latent_stats:
                self.shift_factors = nn.Parameter(torch.zeros(latent_channels))
                self.scaling_factors = nn.Parameter(torch.ones(latent_channels))
        channels_last_weights(self)

    @property
    def device(self) -> torch.device:
        return self.decoder.timestep_scale.device

    def init_weights(self, generator: torch.Generator) -> "AutoencoderKLLTXVideo":
        return init_vae_weights(self, generator)

    def scale(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_latent_stats:
            return (x - self.shift_factors) * self.scaling_factors
        if self.shift_factor:
            x = x - self.shift_factor
        return x * self.scaling_factor

    def unscale(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_latent_stats:
            return x / self.scaling_factors + self.shift_factors
        x = x / self.scaling_factor
        return x + self.shift_factor if self.shift_factor else x

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        image = x.ndim == 4
        if image:
            x = x[:, None]
        z = tiled_temporal_apply(self.encoder, x, self.sample_min_t, 1, 0)
        return DiagonalGaussian.from_params(z[:, 0] if image else z)

    def decode(self, z: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``temb`` (B,): the decoder's timestep (0 when not given), the same
        for every window of the tiling."""
        image = z.ndim == 4
        if image:
            z = z[:, None]
        if temb is None:
            temb = torch.zeros((z.shape[0],), dtype=torch.float32, device=z.device)
        x = tiled_temporal_apply(lambda w: self.decoder(w, temb), z, self.latent_min_t, 0, 1)
        return x[:, 0] if image else x

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        dist = self.encode(x)
        z = dist.sample(generator) if generator is not None else dist.mode()
        return self.decode(z.to(x.dtype)), dist
