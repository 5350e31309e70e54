"""SD-style 2D KL VAE, channels-last (port of
``nova_pointcloud_tpu/models/autoencoders/autoencoder_kl.py``): 4 down / up
UNet res stages, a mid block with single-head attention, quant /
post-quant convs, double_z diagonal-Gaussian or identity latents, latent
scale / unscale. Submodules keep the flax modules' names, so
``models/convert.convert_vae_params`` maps the JAX param tree onto them.

No kernel of the repo runs here: the attention is the plain
``ops/attention.sdpa`` (as in the JAX module), never the dispatcher, whose
flash kernel takes head dim 64 only; convolutions, GroupNorm and resizes are
PyTorch's.
"""

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from nova_pointcloud_tpu_torch.models.autoencoders.modeling_utils import (
    DiagonalGaussian, IdentityDistribution, LatentScaling, channels_last_weights,
    init_vae_weights)
from nova_pointcloud_tpu_torch.models.layers import conv, dense, group_norm, silu
from nova_pointcloud_tpu_torch.ops.attention import sdpa
from nova_pointcloud_tpu_torch.utils.device import resolve_device


def _gn(dim: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, dim, eps=1e-6)


def nearest_up2(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) -> (..., 2H, 2W, C), each pixel repeated (``jnp.repeat``
    by 2 along H and W), in one copy."""
    *lead, h, w, c = x.shape
    x = x[..., :, None, :, None, :].expand(*lead, h, 2, w, 2, c)
    return x.reshape(*lead, 2 * h, 2 * w, c)


class VAEAttention(nn.Module):
    """Spatial self-attention with GroupNorm and to_q / to_k / to_v / to_out
    projections, over (B, H, W, C)."""

    def __init__(self, dim: int, num_heads: int = 1, dtype=None):
        super().__init__()
        self.dim, self.num_heads, self.dtype = dim, num_heads, dtype
        self.group_norm = _gn(dim)
        self.to_q, self.to_k, self.to_v, self.to_out = (nn.Linear(dim, dim) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        y = group_norm(x, self.group_norm).reshape(b, h * w, c)
        heads, hd = self.num_heads, self.dim // self.num_heads
        q, k, v = (dense(y, lin, self.dtype).reshape(b, h * w, heads, hd).transpose(1, 2)
                   for lin in (self.to_q, self.to_k, self.to_v))
        o = sdpa(q, k, v).transpose(1, 2).reshape(b, h * w, self.dim)
        return dense(o, self.to_out, self.dtype).reshape(b, h, w, c)


class ResBlock(nn.Module):
    """GroupNorm-SiLU-Conv x2 with a 1x1 shortcut where the width changes."""

    def __init__(self, in_dim: int, out_dim: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        if in_dim != out_dim:
            self.conv_shortcut = nn.Conv2d(in_dim, out_dim, 1)
        self.norm1, self.conv1 = _gn(in_dim), nn.Conv2d(in_dim, out_dim, 3)
        self.norm2, self.conv2 = _gn(out_dim), nn.Conv2d(out_dim, out_dim, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if hasattr(self, "conv_shortcut"):
            shortcut = conv(x, self.conv_shortcut, self.dtype)
        h = conv(silu(group_norm(x, self.norm1)), self.conv1, self.dtype, padding=1)
        h = conv(silu(group_norm(h, self.norm2)), self.conv2, self.dtype, padding=1)
        return h + shortcut


class Downsample(nn.Module):
    """Asymmetric (0, 1) pad, then a VALID stride-2 3x3 conv."""

    def __init__(self, dim: int, dtype=None):
        super().__init__()
        self.dtype, self.conv = dtype, nn.Conv2d(dim, dim, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(torch.nn.functional.pad(x, (0, 0, 0, 1, 0, 1)), self.conv, self.dtype)


class Upsample(nn.Module):
    """Nearest 2x, then a 3x3 conv."""

    def __init__(self, dim: int, dtype=None):
        super().__init__()
        self.dtype, self.conv = dtype, nn.Conv2d(dim, dim, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(nearest_up2(x), self.conv, self.dtype, padding=1)


class MidBlock(nn.Module):
    def __init__(self, dim: int, depth: int = 1, dtype=None):
        super().__init__()
        self.depth = depth
        self.resnets_0 = ResBlock(dim, dim, dtype)
        for i in range(depth):
            setattr(self, f"attentions_{i}", VAEAttention(dim, dtype=dtype))
            setattr(self, f"resnets_{i + 1}", ResBlock(dim, dim, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets_0(x)
        for i in range(self.depth):
            a = getattr(self, f"attentions_{i}")(x)
            x = getattr(self, f"resnets_{i + 1}")(x + a)
        return x


class Encoder(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, block_dims: Sequence[int],
                 block_depth: int = 2, dtype=None):
        super().__init__()
        self.dtype, self.block_dims, self.block_depth = dtype, tuple(block_dims), block_depth
        self.conv_in = nn.Conv2d(in_dim, block_dims[0], 3)
        prev = block_dims[0]
        for i, dim in enumerate(block_dims):
            for j in range(block_depth):
                setattr(self, f"down_{i}_res_{j}", ResBlock(prev, dim, dtype))
                prev = dim
            if i < len(block_dims) - 1:
                setattr(self, f"down_{i}_resize", Downsample(dim, dtype))
        self.mid_block = MidBlock(block_dims[-1], dtype=dtype)
        self.conv_norm_out = _gn(block_dims[-1])
        self.conv_out = nn.Conv2d(block_dims[-1], out_dim, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = conv(x, self.conv_in, self.dtype, padding=1)
        for i in range(len(self.block_dims)):
            for j in range(self.block_depth):
                h = getattr(self, f"down_{i}_res_{j}")(h)
            if i < len(self.block_dims) - 1:
                h = getattr(self, f"down_{i}_resize")(h)
        h = self.mid_block(h)
        h = silu(group_norm(h, self.conv_norm_out))
        return conv(h, self.conv_out, self.dtype, padding=1)


class Decoder(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, block_dims: Sequence[int],
                 block_depth: int = 2, dtype=None):
        super().__init__()
        dims = list(reversed(block_dims))  # encoder order, reversed here
        self.dtype, self.dims, self.block_depth = dtype, dims, block_depth
        self.conv_in = nn.Conv2d(in_dim, dims[0], 3)
        self.mid_block = MidBlock(dims[0], dtype=dtype)
        prev = dims[0]
        for i, dim in enumerate(dims):
            for j in range(block_depth + 1):
                setattr(self, f"up_{i}_res_{j}", ResBlock(prev, dim, dtype))
                prev = dim
            if i < len(dims) - 1:
                setattr(self, f"up_{i}_resize", Upsample(dim, dtype))
        self.conv_norm_out = _gn(dims[-1])
        self.conv_out = nn.Conv2d(dims[-1], out_dim, 3)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid_block(conv(z, self.conv_in, self.dtype, padding=1))
        for i in range(len(self.dims)):
            for j in range(self.block_depth + 1):
                h = getattr(self, f"up_{i}_res_{j}")(h)
            if i < len(self.dims) - 1:
                h = getattr(self, f"up_{i}_resize")(h)
        h = silu(group_norm(h, self.conv_norm_out))
        return conv(h, self.conv_out, self.dtype, padding=1)


class AutoencoderKL(LatentScaling, nn.Module):
    """2D KL VAE over (B, H, W, C): ``encode`` -> the latent distribution,
    ``decode`` <- latents. ``dtype``: the convolutions' and projections'
    compute dtype (``torch.bfloat16`` with bf16 weights serves as the bench
    does). ``device``: ``cuda`` unless ``"cpu"`` is asked for."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 block_out_channels: Tuple[int, ...] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 16,
                 scaling_factor: float = 0.18215, shift_factor: Optional[float] = None,
                 double_z: bool = True, use_quant_conv: bool = True,
                 use_post_quant_conv: bool = True, dtype=None, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.block_out_channels, self.layers_per_block = tuple(block_out_channels), layers_per_block
        self.latent_channels, self.double_z = latent_channels, double_z
        self.scaling_factor, self.shift_factor = scaling_factor, shift_factor
        self.use_quant_conv, self.use_post_quant_conv = use_quant_conv, use_post_quant_conv
        self.dtype = dtype
        z_dim = (1 + double_z) * latent_channels
        with torch.device(dev):
            self.encoder = Encoder(in_channels, z_dim, block_out_channels, layers_per_block,
                                   dtype)
            self.decoder = Decoder(latent_channels, out_channels, block_out_channels,
                                   layers_per_block, dtype)
            if use_quant_conv:
                self.quant_conv = nn.Conv2d(z_dim, z_dim, 1)
            if use_post_quant_conv:
                self.post_quant_conv = nn.Conv2d(latent_channels, latent_channels, 1)
        channels_last_weights(self)

    @property
    def device(self) -> torch.device:
        return self.decoder.conv_in.weight.device

    def init_weights(self, generator: torch.Generator) -> "AutoencoderKL":
        return init_vae_weights(self, generator)

    def encode(self, x: torch.Tensor):
        z = self.encoder(x)
        if self.use_quant_conv:
            z = conv(z, self.quant_conv, self.dtype)
        return DiagonalGaussian.from_params(z) if self.double_z else IdentityDistribution(z)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        if self.use_post_quant_conv:
            z = conv(z, self.post_quant_conv, self.dtype)
        return self.decoder(z)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """The round trip: (reconstruction, distribution); the latents are
        sampled with ``generator`` when given, else the mode."""
        dist = self.encode(x)
        z = dist.sample(generator) if generator is not None else dist.mode()
        return self.decode(z.to(x.dtype)), dist
