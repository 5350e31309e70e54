"""Adaptive LayerNorm (port of ``nova_pointcloud_tpu/models/normalization.py``:
``AdaLayerNormZero`` and ``AdaLayerNorm``).

The flax modules' names are kept (``proj``, ``ada``), so ``models/convert.py``
maps one tree onto the other. Compute follows the input dtype as flax's does
when ``dtype`` is unset: the projection in the promoted dtype of its input and
weight, the LayerNorm's statistics in float32. ``rank`` puts a low-rank
projection (``lora``, no bias) before ``proj``; ``eps=None`` modulates x
without normalizing it (the video models' AdaLN state mixer).
"""

from typing import Optional, Tuple

import torch
from torch import nn

from nova_pointcloud_tpu_torch.models.layers import dense, layer_norm, silu


class AdaLayerNormZero(nn.Module):
    """LayerNorm (no affine) modulated by (scale, shift[, gates...]) projected
    from ``z``: returns ``(LN(x) * (1 + scale) + shift, gates)``."""

    def __init__(self, dim: int, rank: Optional[int] = None, num_stats: int = 2,
                 eps: Optional[float] = 1e-6, device=None):
        super().__init__()
        self.num_stats, self.eps = num_stats, eps
        self.lora = nn.Linear(dim, rank, bias=False, device=device) if rank else None
        self.proj = nn.Linear(rank or dim, num_stats * dim, device=device)

    def forward(self, x: torch.Tensor, z: torch.Tensor
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        h = silu(z)
        if self.lora is not None:
            h = dense(h, self.lora)
        stats = dense(h, self.proj)
        stats = torch.chunk(stats, self.num_stats, dim=-1)
        y = x if self.eps is None else layer_norm(x, None, self.eps)
        y = y * (1.0 + stats[0]) + stats[1]
        return y, stats[2:]


class AdaLayerNorm(nn.Module):
    """AdaLayerNormZero without extra gates; returns the tensor only."""

    def __init__(self, dim: int, rank: Optional[int] = None, eps: Optional[float] = 1e-6,
                 device=None):
        super().__init__()
        self.ada = AdaLayerNormZero(dim, rank, num_stats=2, eps=eps, device=device)

    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        return self.ada(x, z)[0]
