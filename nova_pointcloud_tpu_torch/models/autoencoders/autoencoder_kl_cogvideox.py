"""CogVideoX causal 3D KL VAE, channels-last (port of
``nova_pointcloud_tpu/models/autoencoders/autoencoder_kl_cogvideox.py``):

- causal Conv3d (``autoencoder_kl_opensora.CausalConv3d``);
- ``AdaGroupNorm``: GroupNorm modulated by the decoder's input latents,
  resized (nearest) to the activation with frame 0 kept apart in time;
- ``CogResize``: stride-2 2D conv down (after a first-frame-preserving
  temporal average in mode 2), nearest x2 up (frame 0 in space only in
  mode 2);
- encoder: two spatiotemporal stages, then a spatial one; the decoder
  mirrors it, every norm conditioned on the latents;
- temporal tiling: 17-frame / 5-latent windows.

Submodules keep the flax names; no kernel of the repo runs here.
"""

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nova_pointcloud_tpu_torch.models.autoencoders.autoencoder_kl import _gn, nearest_up2
from nova_pointcloud_tpu_torch.models.autoencoders.autoencoder_kl_opensora import (
    CausalConv3d, fold_time, unfold_time)
from nova_pointcloud_tpu_torch.models.autoencoders.modeling_utils import (
    DiagonalGaussian, LatentScaling, channels_last_weights, init_vae_weights,
    tiled_temporal_apply)
from nova_pointcloud_tpu_torch.models.layers import conv, group_norm, silu
from nova_pointcloud_tpu_torch.utils.device import resolve_device


def _nearest(x: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")`` along one axis: source index
    floor((i + 0.5) * m / n), in float32 as JAX computes it."""
    m = x.shape[axis]
    if m == n:
        return x
    src = np.floor((np.arange(n, dtype=np.float32) + np.float32(0.5)) * np.float32(m)
                   / np.float32(n)).astype(np.int64)
    return torch.index_select(x, axis, torch.from_numpy(src).to(x.device))


def _resize_latent_to(z: torch.Tensor, t: int, h: int, w: int) -> torch.Tensor:
    """Nearest-resize z (B, T, H, W, C) to (t, h, w); for an odd t > 1,
    frame 0 alone to frame 0 and the rest to the rest."""
    def resize(a, tt):
        return _nearest(_nearest(_nearest(a, 1, tt), 2, h), 3, w)

    if t > 1 and t % 2 == 1:
        return torch.cat([resize(z[:, :1], 1), resize(z[:, 1:], t - 1)], dim=1)
    return resize(z, t)


class AdaGroupNorm(nn.Module):
    """GroupNorm, with a latent-conditioned scale and shift when ``z_dim``
    is given."""

    def __init__(self, dim: int, z_dim: Optional[int] = None, num_groups: int = 32,
                 dtype=None):
        super().__init__()
        self.norm = nn.GroupNorm(num_groups, dim, eps=1e-6)
        self.z_dim = z_dim
        if z_dim is not None:
            self.scale = CausalConv3d(z_dim, dim, (1, 1, 1), dtype=dtype)
            self.shift = CausalConv3d(z_dim, dim, (1, 1, 1), dtype=dtype)

    def forward(self, x: torch.Tensor, z: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = group_norm(x, self.norm)
        if self.z_dim is None or z is None:
            return h
        z = _resize_latent_to(z, x.shape[1], x.shape[2], x.shape[3])
        return h * self.scale(z) + self.shift(z)


class CogResBlock(nn.Module):
    """AdaGN -> SiLU -> causal conv, x2, + shortcut."""

    def __init__(self, in_dim: int, out_dim: int, z_dim: Optional[int] = None, dtype=None):
        super().__init__()
        if in_dim != out_dim:
            self.conv_shortcut = CausalConv3d(in_dim, out_dim, (1, 1, 1), dtype=dtype)
        self.norm1 = AdaGroupNorm(in_dim, z_dim, dtype=dtype)
        self.conv1 = CausalConv3d(in_dim, out_dim, (3, 3, 3), dtype=dtype)
        self.norm2 = AdaGroupNorm(out_dim, z_dim, dtype=dtype)
        self.conv2 = CausalConv3d(out_dim, out_dim, (3, 3, 3), dtype=dtype)

    def forward(self, x: torch.Tensor, z: Optional[torch.Tensor] = None) -> torch.Tensor:
        shortcut = self.conv_shortcut(x) if hasattr(self, "conv_shortcut") else x
        h = self.conv1(silu(self.norm1(x, z)))
        h = self.conv2(silu(self.norm2(h, z)))
        return h + shortcut


class CogResize(nn.Module):
    """Down / up x2; mode 1 spatial, mode 2 spatiotemporal."""

    def __init__(self, dim: int, mode: int, down: bool, dtype=None):
        super().__init__()
        self.mode, self.down, self.dtype = mode, down, dtype
        self.conv = nn.Conv2d(dim, dim, 3, stride=2 if down else 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        if self.down:
            if self.mode == 2 and t > 1:  # first-frame-preserving temporal average
                t2 = (t - 1) // 2
                rest = x[:, 1:1 + 2 * t2].reshape(b, t2, 2, h, w, c).mean(dim=2)
                x = torch.cat([x[:, :1], rest], dim=1)
            y, tt = fold_time(F.pad(x, (0, 0, 0, 1, 0, 1)))
            return unfold_time(conv(y, self.conv, self.dtype), tt)
        if self.mode == 2 and t > 1:
            rest = torch.repeat_interleave(x[:, 1:], 2, dim=1)
            x = torch.cat([x[:, :1], rest], dim=1)
        y, tt = fold_time(nearest_up2(x))
        return unfold_time(conv(y, self.conv, self.dtype, padding=1), tt)


def _resize_mode(i: int, n: int) -> int:
    return 2 if i < 2 else (1 if i < n - 1 else 0)


class CogEncoder(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, block_dims: Sequence[int],
                 block_depth: int = 3, dtype=None):
        super().__init__()
        self.dims, self.block_depth = list(block_dims), block_depth
        self.conv_in = CausalConv3d(in_dim, block_dims[0], (3, 3, 3), dtype=dtype)
        prev = block_dims[0]
        for i, dim in enumerate(block_dims):
            for j in range(block_depth):
                setattr(self, f"down_{i}_res_{j}", CogResBlock(prev, dim, dtype=dtype))
                prev = dim
            mode = _resize_mode(i, len(block_dims))
            if mode:
                setattr(self, f"down_{i}_resize", CogResize(dim, mode, True, dtype))
        for j in range(2):
            setattr(self, f"mid_res_{j}", CogResBlock(prev, prev, dtype=dtype))
        self.conv_norm_out = AdaGroupNorm(prev, dtype=dtype)
        self.conv_out = CausalConv3d(prev, 2 * out_dim, (3, 3, 3), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for i in range(len(self.dims)):
            for j in range(self.block_depth):
                h = getattr(self, f"down_{i}_res_{j}")(h)
            if _resize_mode(i, len(self.dims)):
                h = getattr(self, f"down_{i}_resize")(h)
        for j in range(2):
            h = getattr(self, f"mid_res_{j}")(h)
        return self.conv_out(silu(self.conv_norm_out(h)))


class CogDecoder(nn.Module):
    """Latent-conditioned decoder: every AdaGN sees the input latents."""

    def __init__(self, latent_dim: int, out_dim: int, block_dims: Sequence[int],
                 block_depth: int = 3, dtype=None):
        super().__init__()
        dims = list(reversed(block_dims))  # encoder order, reversed here
        self.dims, self.block_depth = dims, block_depth
        self.conv_in = CausalConv3d(latent_dim, dims[0], (3, 3, 3), dtype=dtype)
        for j in range(2):
            setattr(self, f"mid_res_{j}", CogResBlock(dims[0], dims[0], latent_dim, dtype))
        prev = dims[0]
        for i, dim in enumerate(dims):
            for j in range(block_depth + 1):
                setattr(self, f"up_{i}_res_{j}", CogResBlock(prev, dim, latent_dim, dtype))
                prev = dim
            mode = _resize_mode(i, len(dims))
            if mode:
                setattr(self, f"up_{i}_resize", CogResize(dim, mode, False, dtype))
        self.conv_norm_out = AdaGroupNorm(dims[-1], latent_dim, dtype=dtype)
        self.conv_out = CausalConv3d(dims[-1], out_dim, (3, 3, 3), dtype=dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z)
        for j in range(2):
            h = getattr(self, f"mid_res_{j}")(h, z)
        for i in range(len(self.dims)):
            for j in range(self.block_depth + 1):
                h = getattr(self, f"up_{i}_res_{j}")(h, z)
            if _resize_mode(i, len(self.dims)):
                h = getattr(self, f"up_{i}_resize")(h)
        return self.conv_out(silu(self.conv_norm_out(h, z)))


class AutoencoderKLCogVideoX(LatentScaling, nn.Module):
    """CogVideoX causal 3D KL VAE. ``dtype`` / ``device`` as
    ``AutoencoderKL``'s."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 block_out_channels: Tuple[int, ...] = (128, 256, 256, 512),
                 layers_per_block: int = 3, latent_channels: int = 16,
                 scaling_factor: float = 0.7, shift_factor: Optional[float] = None,
                 sample_min_t: int = 17, latent_min_t: int = 5, dtype=None, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.block_out_channels, self.layers_per_block = tuple(block_out_channels), layers_per_block
        self.latent_channels = latent_channels
        self.scaling_factor, self.shift_factor = scaling_factor, shift_factor
        self.sample_min_t, self.latent_min_t, self.dtype = sample_min_t, latent_min_t, dtype
        with torch.device(dev):
            self.encoder = CogEncoder(in_channels, latent_channels, block_out_channels,
                                      layers_per_block, dtype)
            self.decoder = CogDecoder(latent_channels, out_channels, block_out_channels,
                                      layers_per_block, dtype)
        channels_last_weights(self)

    @property
    def device(self) -> torch.device:
        return self.decoder.conv_out.conv.weight.device

    def init_weights(self, generator: torch.Generator) -> "AutoencoderKLCogVideoX":
        return init_vae_weights(self, generator)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        image = x.ndim == 4
        if image:
            x = x[:, None]
        z = tiled_temporal_apply(self.encoder, x, self.sample_min_t, 1, 0)
        return DiagonalGaussian.from_params(z[:, 0] if image else z)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        image = z.ndim == 4
        if image:
            z = z[:, None]
        x = tiled_temporal_apply(self.decoder, z, self.latent_min_t, 0, 1)
        return x[:, 0] if image else x

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        dist = self.encode(x)
        z = dist.sample(generator) if generator is not None else dist.mode()
        return self.decode(z.to(x.dtype)), dist
