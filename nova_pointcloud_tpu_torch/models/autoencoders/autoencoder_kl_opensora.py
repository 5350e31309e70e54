"""OpenSoraPlan-style causal 3D KL VAE, channels-last (port of
``nova_pointcloud_tpu/models/autoencoders/autoencoder_kl_opensora.py``):

- causal Conv3d: frame 0 replicated ``kt - 1`` times in front;
- mixed 2D / 3D stages chosen by the block-type strings, the frames folded
  into the batch for 2D stages and unfolded at a 3D one;
- per-frame spatial attention in the mid block, its GroupNorm pooling over
  the frames first;
- stride-2 downsampling after a right / bottom pad (3D: causal stride 2 in
  time too); x2 upsampling: nearest 2D, trilinear 3D with frame 0 resized in
  space only, or space-only for the last two 3D positions of the decoder;
- temporal tiling: 17-frame encode / 5-latent decode windows, overlap 1;
  ``decode`` runs ``decode_window`` on each window in turn, so one window's
  activations are alive at a time.

Videos are (B, T, H, W, C). Submodules keep the flax names; no kernel of
the repo runs here.
"""

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from nova_pointcloud_tpu_torch.models.autoencoders.autoencoder_kl import _gn, nearest_up2
from nova_pointcloud_tpu_torch.models.autoencoders.modeling_utils import (
    DiagonalGaussian, LatentScaling, channels_last_weights, init_vae_weights,
    tiled_temporal_apply)
from nova_pointcloud_tpu_torch.models.layers import conv, dense, group_norm, silu
from nova_pointcloud_tpu_torch.ops.attention import dot_product_attention
from nova_pointcloud_tpu_torch.utils.device import resolve_device


def fold_time(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(B, T, H, W, C) -> ((B*T, H, W, C), T)."""
    b, t = x.shape[:2]
    return x.reshape((b * t,) + tuple(x.shape[2:])), t


def unfold_time(x: torch.Tensor, t: int) -> torch.Tensor:
    return x.reshape((-1, t) + tuple(x.shape[1:]))


def _is3d(block_type: str) -> bool:
    return "2D" not in block_type


class CausalConv3d(nn.Module):
    """3D conv, causal in time (frame 0 replicated ``kt - 1`` times in
    front); ``spatial_pad`` zero pads each spatial side (None: kh // 2)."""

    def __init__(self, in_dim: int, features: int, kernel=(3, 3, 3), strides=(1, 1, 1),
                 spatial_pad: Optional[int] = None, dtype=None):
        super().__init__()
        self.kernel, self.spatial_pad, self.dtype = tuple(kernel), spatial_pad, dtype
        self.conv = nn.Conv3d(in_dim, features, self.kernel, stride=tuple(strides))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kt, kh, kw = self.kernel
        if kt > 1:
            front = x[:, :1].expand((x.shape[0], kt - 1) + tuple(x.shape[2:]))
            x = torch.cat([front, x], dim=1)
        sp = self.spatial_pad
        pad = (0, kh // 2 if sp is None else sp, kw // 2 if sp is None else sp)
        return conv(x, self.conv, self.dtype, padding=pad)


class Conv2dStage(nn.Module):
    """2D conv over the last three axes of x (..., H, W, C): frames folded
    into the batch, or plain images (flax's ``Conv`` takes any leading
    axes)."""

    def __init__(self, in_dim: int, features: int, kernel=(3, 3), strides: int = 1,
                 padding: int = 1, dtype=None):
        super().__init__()
        self.padding, self.dtype = padding, dtype
        self.conv = nn.Conv2d(in_dim, features, tuple(kernel), stride=strides)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = tuple(x.shape[:-3])
        y = conv(x.reshape((-1,) + tuple(x.shape[-3:])), self.conv, self.dtype,
                 padding=self.padding)
        return y.reshape(lead + tuple(y.shape[1:]))


def _conv_stage(in_dim: int, out_dim: int, k: int, three_d: bool, dtype) -> nn.Module:
    if three_d:
        return CausalConv3d(in_dim, out_dim, (k,) * 3, dtype=dtype)
    return Conv2dStage(in_dim, out_dim, (k, k), padding=k // 2, dtype=dtype)


class ResBlock(nn.Module):
    """GN-SiLU-Conv x2, 2D or causal 3D by ``three_d``."""

    def __init__(self, in_dim: int, out_dim: int, three_d: bool = False, dtype=None):
        super().__init__()
        if in_dim != out_dim:
            self.conv_shortcut = _conv_stage(in_dim, out_dim, 1, three_d, dtype)
        self.norm1, self.conv1 = _gn(in_dim), _conv_stage(in_dim, out_dim, 3, three_d, dtype)
        self.norm2, self.conv2 = _gn(out_dim), _conv_stage(out_dim, out_dim, 3, three_d, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = self.conv_shortcut(x) if hasattr(self, "conv_shortcut") else x
        h = self.conv1(silu(group_norm(x, self.norm1)))
        h = self.conv2(silu(group_norm(h, self.norm2)))
        return h + shortcut


class FrameAttention(nn.Module):
    """Per-frame spatial attention with to_q / to_k / to_v / to_out. One
    head: q kᵀ in the input dtype, scaled by c^-0.5 after the product, the
    softmax in float32; several heads: flax's ``dot_product_attention``."""

    def __init__(self, dim: int, num_heads: int = 1, dtype=None):
        super().__init__()
        self.dim, self.num_heads, self.dtype = dim, num_heads, dtype
        self.group_norm = _gn(dim)
        self.to_q, self.to_k, self.to_v, self.to_out = (nn.Linear(dim, dim) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        video = x.ndim == 5
        y = group_norm(x, self.group_norm)  # over the frames too, before the fold
        if video:
            y, t = fold_time(y)
        b, h, w, c = y.shape
        y = y.reshape(b, h * w, c)
        q, k, v = (dense(y, lin, self.dtype) for lin in (self.to_q, self.to_k, self.to_v))
        if self.num_heads > 1:
            hd = c // self.num_heads
            o = dot_product_attention(*(a.reshape(b, h * w, self.num_heads, hd)
                                        for a in (q, k, v)))
            o = o.reshape(b, h * w, c)
        else:
            logits = torch.bmm(q, k.transpose(1, 2)) * (c ** -0.5)
            probs = torch.softmax(logits.float(), dim=-1)
            del logits
            o = torch.bmm(probs.to(v.dtype), v)
        y = dense(o, self.to_out, self.dtype).reshape(b, h, w, c)
        return unfold_time(y, t) if video else y


class MidBlock(nn.Module):
    def __init__(self, dim: int, three_d: bool = False, depth: int = 1, dtype=None):
        super().__init__()
        self.depth = depth
        self.resnets_0 = ResBlock(dim, dim, three_d, dtype)
        for i in range(depth):
            setattr(self, f"attentions_{i}", FrameAttention(dim, dtype=dtype))
            setattr(self, f"resnets_{i + 1}", ResBlock(dim, dim, three_d, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets_0(x)
        for i in range(self.depth):
            a = getattr(self, f"attentions_{i}")(x)
            x = getattr(self, f"resnets_{i + 1}")(x + a)
        return x


class Downsample(nn.Module):
    """Stride 2 after a right / bottom pad; 3D also halves time causally."""

    def __init__(self, dim: int, three_d: bool = False, dtype=None):
        super().__init__()
        self.resize = (CausalConv3d(dim, dim, (3, 3, 3), (2, 2, 2), spatial_pad=0, dtype=dtype)
                       if three_d else Conv2dStage(dim, dim, (3, 3), 2, padding=0, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resize(F.pad(x, (0, 0, 0, 1, 0, 1)))


def _resize_linear(x: torch.Tensor, size: Tuple[int, ...]) -> torch.Tensor:
    """Half-pixel (bi/tri)linear resize of the axes between batch and
    channels of a channels-last x, as ``jax.image.resize(..., "linear")``
    upsamples: edge samples take the edge value (PyTorch clamps the source
    coordinate where JAX renormalises the weights that fall inside)."""
    mode = "bilinear" if len(size) == 2 else "trilinear"
    y = F.interpolate(x.movedim(-1, 1), size=size, mode=mode, align_corners=False)
    return y.movedim(1, -1).contiguous()


class Upsample(nn.Module):
    """x2: ``"2d"`` nearest, ``"3d_trilinear"`` (frame 0 in space only,
    frames 1: in time and space), ``"3d_spatial"`` nearest in space only."""

    def __init__(self, dim: int, mode: str, dtype=None):
        super().__init__()
        self.mode = mode
        if mode == "2d":
            self.resize = Conv2dStage(dim, dim, (3, 3), padding=1, dtype=dtype)
        else:
            kernel = (1, 3, 3) if mode == "3d_spatial" else (3, 3, 3)
            self.resize = CausalConv3d(dim, dim, kernel, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode in ("2d", "3d_spatial"):
            return self.resize(nearest_up2(x))
        b, t, h, w, c = x.shape
        parts = [_resize_linear(x[:, 0], (2 * h, 2 * w))[:, None]]
        if t > 1:
            parts.append(_resize_linear(x[:, 1:], (2 * (t - 1), 2 * h, 2 * w)))
        return self.resize(torch.cat(parts, dim=1) if t > 1 else parts[0])


class Encoder(nn.Module):
    """Mixed 2D / 3D encoder; input (B, T, H, W, C)."""

    def __init__(self, in_dim: int, out_dim: int, block_types: Sequence[str],
                 block_dims: Sequence[int], block_depth: int = 2, dtype=None):
        super().__init__()
        self.types, self.dims, self.block_depth = list(block_types), list(block_dims), block_depth
        self.conv_in = Conv2dStage(in_dim, block_dims[0], (3, 3), padding=1, dtype=dtype)
        prev = block_dims[0]
        for i, (btype, dim) in enumerate(zip(block_types, block_dims)):
            for j in range(block_depth):
                setattr(self, f"down_{i}_res_{j}", ResBlock(prev, dim, _is3d(btype), dtype))
                prev = dim
            if i < len(block_dims) - 1:
                setattr(self, f"down_{i}_resize",
                        Downsample(dim, _is3d(block_types[i + 1]), dtype))
        last_3d = _is3d(block_types[-1])
        self.mid_block = MidBlock(block_dims[-1], last_3d, dtype=dtype)
        self.conv_norm_out = _gn(block_dims[-1])
        self.conv_out = _conv_stage(block_dims[-1], out_dim, 3, last_3d, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, t = fold_time(x)
        h = self.conv_in(h)
        folded = True
        for i, btype in enumerate(self.types):
            if _is3d(btype) and folded:
                h, folded = unfold_time(h, t), False
            for j in range(self.block_depth):
                h = getattr(self, f"down_{i}_res_{j}")(h)
            if i < len(self.dims) - 1:
                if _is3d(self.types[i + 1]) and folded:
                    h, folded = unfold_time(h, t), False
                h = getattr(self, f"down_{i}_resize")(h)
                t = t if folded else h.shape[1]
        h = self.mid_block(h)
        h = self.conv_out(silu(group_norm(h, self.conv_norm_out)))
        return h if _is3d(self.types[-1]) else unfold_time(h, t)


class Decoder(nn.Module):
    """Mixed 3D / 2D decoder; latents (B, T', H', W', C). The block types and
    widths come in encoder order and are reversed here."""

    def __init__(self, in_dim: int, out_dim: int, block_types: Sequence[str],
                 block_dims: Sequence[int], block_depth: int = 2, dtype=None):
        super().__init__()
        dims, types = list(reversed(block_dims)), list(reversed(block_types))
        self.dims, self.types, self.block_depth = dims, types, block_depth
        deep_3d = _is3d(types[0])
        self.conv_in = _conv_stage(in_dim, dims[0], 3, deep_3d, dtype)
        self.mid_block = MidBlock(dims[0], deep_3d, dtype=dtype)
        prev = dims[0]
        for i, (btype, dim) in enumerate(zip(types, dims)):
            stage_3d = _is3d(btype)
            for j in range(block_depth + 1):
                setattr(self, f"up_{i}_res_{j}", ResBlock(prev, dim, stage_3d, dtype))
                prev = dim
            if i < len(dims) - 1:
                # the reference's (1, 3, 3) upsampler at the last two 3D
                # positions is space-only
                mode = ("3d_trilinear" if i < len(dims) - 2 else "3d_spatial") if stage_3d \
                    else "2d"
                setattr(self, f"up_{i}_resize", Upsample(dim, mode, dtype))
        self.conv_norm_out = _gn(dims[-1])
        self.conv_out = _conv_stage(dims[-1], out_dim, 3, _is3d(types[-1]), dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid_block(self.conv_in(z))
        folded = not _is3d(self.types[0])
        t = None if folded else h.shape[1]
        for i, btype in enumerate(self.types):
            if not _is3d(btype) and not folded:
                h, t = fold_time(h)
                folded = True
            for j in range(self.block_depth + 1):
                h = getattr(self, f"up_{i}_res_{j}")(h)
            if i < len(self.dims) - 1:
                h = getattr(self, f"up_{i}_resize")(h)
        h = self.conv_out(silu(group_norm(h, self.conv_norm_out)))
        return h if _is3d(self.types[-1]) else unfold_time(h, t)


class AutoencoderKLOpenSora(LatentScaling, nn.Module):
    """Causal 3D KL VAE with temporal tiling. ``dtype`` / ``device`` as
    ``AutoencoderKL``'s."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 down_block_types: Tuple[str, ...] = ("DownEncoderBlock2D",
                                                      "DownEncoderBlock3D",
                                                      "DownEncoderBlock3D",
                                                      "DownEncoderBlock3D"),
                 up_block_types: Tuple[str, ...] = ("UpDecoderBlock2D", "UpDecoderBlock3D",
                                                    "UpDecoderBlock3D", "UpDecoderBlock3D"),
                 block_out_channels: Tuple[int, ...] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 16,
                 scaling_factor: float = 0.18215, shift_factor: Optional[float] = None,
                 sample_min_t: int = 17, latent_min_t: int = 5, dtype=None, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.down_block_types, self.up_block_types = tuple(down_block_types), tuple(up_block_types)
        self.block_out_channels, self.layers_per_block = tuple(block_out_channels), layers_per_block
        self.latent_channels = latent_channels
        self.scaling_factor, self.shift_factor = scaling_factor, shift_factor
        self.sample_min_t, self.latent_min_t, self.dtype = sample_min_t, latent_min_t, dtype
        z = latent_channels
        with torch.device(dev):
            self.encoder = Encoder(in_channels, 2 * z, down_block_types, block_out_channels,
                                   layers_per_block, dtype)
            self.decoder = Decoder(z, out_channels, up_block_types, block_out_channels,
                                   layers_per_block, dtype)
            self.quant_conv = CausalConv3d(2 * z, 2 * z, (1, 1, 1), dtype=dtype)
            self.post_quant_conv = CausalConv3d(z, z, (1, 1, 1), dtype=dtype)
        channels_last_weights(self)

    @property
    def device(self) -> torch.device:
        return self.post_quant_conv.conv.weight.device

    def init_weights(self, generator: torch.Generator) -> "AutoencoderKLOpenSora":
        return init_vae_weights(self, generator)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        """x: (B, T, H, W, C), or (B, H, W, C) for one image."""
        image = x.ndim == 4
        if image:
            x = x[:, None]
        z = self.quant_conv(tiled_temporal_apply(self.encoder, x, self.sample_min_t, 1, 1))
        return DiagonalGaussian.from_params(z[:, 0] if image else z)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        image = z.ndim == 4
        if image:
            z = z[:, None]
        x = tiled_temporal_apply(self.decode_window, z, self.latent_min_t, 1, 1)
        return x[:, 0] if image else x

    def decode_window(self, z: torch.Tensor) -> torch.Tensor:
        """Decode one temporal window (at most ``latent_min_t`` latents), no
        tiling. post_quant_conv is pointwise in time, so splitting the
        windows before it is exact."""
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        dist = self.encode(x)
        z = dist.sample(generator) if generator is not None else dist.mode()
        return self.decode(z.to(x.dtype)), dist
