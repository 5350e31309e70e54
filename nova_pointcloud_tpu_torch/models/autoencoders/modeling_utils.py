"""VAE latent distributions and temporal tiling (port of
``nova_pointcloud_tpu/models/autoencoders/modeling_utils.py``:
``DiagonalGaussian``, ``IdentityDistribution``, ``tiled_temporal_apply``),
channels-last: images (B, H, W, C), videos (B, T, H, W, C). Also what the
port's four VAE classes share: the latent scaling and a seeded
initialisation of their weights."""

from typing import Callable, NamedTuple, Optional

import torch
from torch import nn


class DiagonalGaussian(NamedTuple):
    """mean / logvar split from the last (channel) axis."""

    mean: torch.Tensor
    logvar: torch.Tensor

    @classmethod
    def from_params(cls, z: torch.Tensor) -> "DiagonalGaussian":
        """Moments (..., 2C) -> the distribution in float32; logvar clipped to
        [-30, 20]. An odd channel count repeats the last channel (as the
        reference's padding trick does)."""
        c = z.shape[-1]
        if c % 2:
            z = torch.cat([z, z[..., -1:].expand(tuple(z.shape[:-1]) + (c - 2,))], dim=-1)
        mean, logvar = torch.chunk(z.float(), 2, dim=-1)
        return cls(mean, torch.clamp(logvar, -30.0, 20.0))

    @property
    def std(self) -> torch.Tensor:
        return torch.exp(0.5 * self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None, dtype=None) -> torch.Tensor:
        """``mean + std * eps`` (float32, then ``dtype`` if given), eps N(0, 1)
        from ``generator`` unless given."""
        if eps is None:
            eps = torch.randn(self.mean.shape, generator=generator, device=self.mean.device)
        out = self.mean + self.std * eps.to(self.mean.device, torch.float32)
        return out if dtype is None else out.to(dtype)

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        """KL(q || N(0, I)) summed over the non-batch axes."""
        return 0.5 * torch.sum(self.mean ** 2 + torch.exp(self.logvar) - 1.0 - self.logvar,
                               dim=tuple(range(1, self.mean.ndim)))


class IdentityDistribution(NamedTuple):
    parameters: torch.Tensor

    def sample(self, generator: Optional[torch.Generator] = None, eps=None,
               dtype=None) -> torch.Tensor:
        return self.parameters

    def mode(self) -> torch.Tensor:
        return self.parameters


def tiled_temporal_apply(fn: Callable, x: torch.Tensor, min_t: int, ovr_t: int,
                         out_ovr_t: int) -> torch.Tensor:
    """Apply ``fn`` over overlapping temporal windows of x (B, T, H, W, C)
    and stitch: windows of ``min_t`` frames start every ``min_t - ovr_t``
    frames, each output but the first drops its first ``out_ovr_t`` frames.
    A trailing remainder that fills no window is dropped, as in the JAX
    package."""
    t = x.shape[1]
    if t <= min_t:
        return fn(x)
    tiles = []
    for i, start in enumerate(range(0, t, min_t - ovr_t)):
        if start + min_t > t:
            break
        out = fn(x[:, start:start + min_t])
        tiles.append(out[:, out_ovr_t:] if i else out)
    return torch.cat(tiles, dim=1)


class LatentScaling:
    """``scale`` / ``unscale`` of latents by ``scaling_factor`` and an
    optional ``shift_factor`` (the JAX VAEs' methods of those names)."""

    scaling_factor: float
    shift_factor: Optional[float]

    def scale(self, x: torch.Tensor) -> torch.Tensor:
        if self.shift_factor:
            x = x - self.shift_factor
        return x * self.scaling_factor

    def unscale(self, x: torch.Tensor) -> torch.Tensor:
        x = x / self.scaling_factor
        return x + self.shift_factor if self.shift_factor else x


def channels_last_weights(module: nn.Module) -> nn.Module:
    """Store every convolution weight of ``module`` channels-last, the
    memory format of the activations' channels-first views, so the library
    convolutions take both without a copy. ``load_state_dict`` and
    ``.to(dtype)`` keep the format."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            m.weight.data = m.weight.data.contiguous(memory_format=torch.channels_last)
        elif isinstance(m, nn.Conv3d):
            m.weight.data = m.weight.data.contiguous(memory_format=torch.channels_last_3d)
    return module


@torch.no_grad()
def init_vae_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights (the JAX initialisers' scales): convolution and
    dense weights N(0, 1 / fan_in), biases 0, norm scales 1; a raw
    ``scale_shift_table`` N(0, 1 / C), ``timestep_scale`` 1000, the
    per-channel latent statistics 0 and 1."""
    def randn(shape):
        return torch.randn(shape, generator=generator, device=generator.device)

    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale_shift_table":
            p.copy_(randn(p.shape) * p.shape[-1] ** -0.5)
        elif leaf == "timestep_scale":
            p.fill_(1000.0)
        elif leaf == "scaling_factors":
            p.fill_(1.0)
        elif leaf in ("bias", "shift_factors"):
            p.zero_()
        elif p.ndim == 1:  # a norm's scale
            p.fill_(1.0)
        else:
            fan_in = p[0].numel()
            p.copy_(randn(p.shape) * fan_in ** -0.5)
    return module
