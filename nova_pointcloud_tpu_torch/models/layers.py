"""flax ``Dense`` and ``LayerNorm`` semantics over torch modules.

``nn.Linear`` holds flax's ``Dense`` kernel transposed; ``nn.LayerNorm`` its
``scale`` / ``bias``. The compute dtype follows flax's rule: the module's
``dtype`` when given, else the promoted dtype of the input and the
parameters.
"""

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _compute_dtype(x: torch.Tensor, p: torch.Tensor, dtype) -> torch.dtype:
    return dtype if dtype is not None else torch.promote_types(x.dtype, p.dtype)


def dense(x: torch.Tensor, lin: nn.Linear, dtype=None) -> torch.Tensor:
    """flax ``Dense``: computes in ``dtype``, else in the promoted dtype; the
    product is rounded to that dtype before the bias is added, as flax's
    ``dot_general`` + ``bias`` do."""
    dt = _compute_dtype(x, lin.weight, dtype)
    y = F.linear(x.to(dt), lin.weight.to(dt))
    return y if lin.bias is None else y + lin.bias.to(dt)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact gelu as ``jax.nn.gelu(approximate=False)`` computes it in x's
    dtype: ``0.5 * x * erfc(-x * sqrt(1/2))``, each step rounded."""
    sqrt_half = torch.tensor(np.sqrt(0.5), dtype=x.dtype, device=x.device)
    return 0.5 * x * torch.erfc(-x * sqrt_half)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)`` in x's dtype, each step rounded."""
    return x * torch.sigmoid(x)


def layer_norm(x: torch.Tensor, norm: Optional[nn.LayerNorm], eps: float) -> torch.Tensor:
    """flax ``LayerNorm`` as it computes: float32 statistics by E[x^2] -
    E[x]^2 (clipped at 0), ``(x - mean) * (rsqrt(var + eps) * scale) + bias``,
    the result in the promoted dtype of x and the parameters. ``norm=None``:
    no scale and no bias (``use_scale=use_bias=False``)."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    mu2 = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    var = torch.clamp(mu2 - torch.square(mu), min=0.0)
    mul = torch.rsqrt(var + eps)
    if norm is None:
        return ((xf - mu) * mul).to(x.dtype)
    y = (xf - mu) * (mul * norm.weight.float()) + norm.bias.float()
    return y.to(torch.promote_types(x.dtype, norm.weight.dtype))
