"""VAE latent distributions (port of
``nova_pointcloud_tpu/models/autoencoders/modeling_utils.py``:
``DiagonalGaussian``), channels-last. Training samples latents from cached
VAE moments with it. The VAEs and the temporal tiling wait for slice 5
(ROADMAP.md)."""

from typing import NamedTuple, Optional

import torch


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
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mean + std * eps`` (float32), eps N(0, 1) from ``generator``
        unless given."""
        if eps is None:
            eps = torch.randn(self.mean.shape, generator=generator, device=self.mean.device)
        return self.mean + self.std * eps.float()

    def mode(self) -> torch.Tensor:
        return self.mean
