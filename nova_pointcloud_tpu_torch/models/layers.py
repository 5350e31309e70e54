"""flax ``Dense``, ``Conv``, ``LayerNorm`` and ``GroupNorm`` semantics over
torch modules.

``nn.Linear`` holds flax's ``Dense`` kernel transposed; ``nn.Conv2d`` /
``nn.Conv3d`` its ``Conv`` kernel as (out, in, kh, kw) / (out, in, kt, kh,
kw); ``nn.LayerNorm`` and ``nn.GroupNorm`` its ``scale`` / ``bias``. The
compute dtype follows flax's rule: the module's ``dtype`` when given, else
the promoted dtype of the input and the parameters. Activations stay
channels-last, as in the JAX package.
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


def conv(x: torch.Tensor, mod: nn.Module, dtype=None, padding=0) -> torch.Tensor:
    """flax ``Conv`` on a channels-last x, (B, H, W, C) for an ``nn.Conv2d``,
    (B, T, H, W, C) for an ``nn.Conv3d``, at the module's stride: computes
    in ``dtype``, else in the promoted dtype; ``padding`` zero-pads each
    spatial side symmetrically (flax's explicit pads). The channels-first
    view of a contiguous x is
    already channels-last in memory, so no copy is made for the library
    convolution. The bias is added inside the convolution: one rounding
    where flax's ``conv + bias`` has two (a bf16 difference only)."""
    dt = _compute_dtype(x, mod.weight, dtype)
    fn = F.conv2d if mod.weight.ndim == 4 else F.conv3d
    y = fn(x.to(dt).movedim(-1, 1), mod.weight.to(dt),
           None if mod.bias is None else mod.bias.to(dt), mod.stride, padding)
    return y.movedim(1, -1).contiguous()


_GN_CHUNK = 1 << 26  # elements of x that group_norm's statistics take at a time


def group_norm(x: torch.Tensor, norm: nn.GroupNorm) -> torch.Tensor:
    """flax ``GroupNorm(num_groups, epsilon)`` as it computes: the
    statistics over every axis but the batch and the group (on a video
    (B, T, H, W, C) that includes time), in float32, by E[x^2] - E[x]^2
    clipped at 0; ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in
    float32, the result in the promoted dtype of x and the parameters.
    Taken ``_GN_CHUNK`` elements at a time, so no float32 copy of a large x
    is made whole."""
    b, c, g = x.shape[0], x.shape[-1], norm.num_groups
    xs = x.reshape(b, -1, g, c // g)
    rows = max(1, _GN_CHUNK // max(1, b * c))
    s1 = torch.zeros((b, g), dtype=torch.float32, device=x.device)
    s2 = torch.zeros_like(s1)
    for i in range(0, xs.shape[1], rows):
        part = xs[:, i:i + rows].float()
        s1 += part.sum((1, 3))
        s2 += part.square().sum((1, 3))
    n = xs.shape[1] * xs.shape[3]
    mean = s1 / n
    var = torch.clamp(s2 / n - torch.square(mean), min=0.0)
    mul = torch.rsqrt(var + norm.eps)[..., None] * norm.weight.float().reshape(g, c // g)
    mean, bias = mean[:, None, :, None], norm.bias.float().reshape(g, c // g)
    out = torch.empty(xs.shape, dtype=torch.promote_types(x.dtype, norm.weight.dtype),
                      device=x.device)
    for i in range(0, xs.shape[1], rows):
        part = xs[:, i:i + rows].float() - mean
        part *= mul[:, None]
        part += bias
        out[:, i:i + rows] = part
    return out.reshape(x.shape)
