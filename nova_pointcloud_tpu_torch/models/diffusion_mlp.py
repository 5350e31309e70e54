"""Per-token diffusion head (port of ``nova_pointcloud_tpu/models/diffusion_mlp.py``:
``Projector``, ``DiffusionBlock``, ``TimeCondEmbed``, ``DiffusionMLP``).

AdaLN-gated MLP blocks conditioned on (timestep, z), a final AdaLN and a
linear head, over a fixed-size padded token slice (the caller gathers and
scatters). Module names are the flax tree's (``blocks_{i}``, ``proj``,
``norm1`` ...). A ``DiffusionBlock`` has three forwards, as the JAX module:

- the float path (no qparams);
- the int8 serving path, one ``fused_int8_diffusion_block`` call with the
  block's pre-quantized weights (and calibrated ``a_z`` / ``a_h`` /
  ``a_silu`` when present); the JAX model takes it on its accelerator only,
  the port whenever ``quantize`` is set (the kernel on the card, its plain
  version on the CPU);
- ``calibration_forward``, the plain mirror that records the three quant
  sites' ranges.

``remat`` recomputes each float block in the backward pass
(``torch.utils.checkpoint``, non-reentrant; the same values), as the ViT
stacks do: eager PyTorch keeps about 10 intermediates of each block's rows
(the f32 LayerNorm and AdaLN chains, the f32 stats), about 60 GB at the t2v
training step's 4 x 27 x 1440 rows, where XLA's fusions keep the JAX
head's few.
"""

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from nova_pointcloud_tpu_torch.models.embeddings import TORCH_LN_EPS, timestep_freq_embed
from nova_pointcloud_tpu_torch.models.layers import dense, layer_norm, silu
from nova_pointcloud_tpu_torch.models.normalization import AdaLayerNormZero
from nova_pointcloud_tpu_torch.ops.kernels.fused_block import fused_int8_diffusion_block
from nova_pointcloud_tpu_torch.ops.quantization import (int8_matmul, quantize_serving_params,
                                                        quantize_weight)

ADALN_EPS = 1e-6


def _amax(v: torch.Tensor) -> torch.Tensor:
    """A calibration statistic: a measurement, carrying no gradient."""
    return torch.amax(torch.abs(v)).detach().float()


class Projector(nn.Module):
    """fc1 -> SiLU -> fc2."""

    def __init__(self, dim: int, mlp_dim: Optional[int] = None,
                 out_dim: Optional[int] = None, dtype=None, device=None):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(dim, mlp_dim or dim, device=device)
        self.fc2 = nn.Linear(mlp_dim or dim, out_dim or dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(silu(dense(x, self.fc1, self.dtype)), self.fc2, self.dtype)


class DiffusionBlock(nn.Module):
    """AdaLN-zero gated residual MLP block."""

    def __init__(self, dim: int, quantize: bool = False, dtype=None, device=None):
        super().__init__()
        self.quantize = quantize
        self.norm1 = AdaLayerNormZero(dim, num_stats=3, device=device)
        self.proj = Projector(dim, dim, dim, dtype=dtype, device=device)
        self.norm2 = nn.LayerNorm(dim, eps=TORCH_LN_EPS, device=device)

    def forward(self, x: torch.Tensor, z: torch.Tensor,
                qparams: Optional[Dict] = None) -> torch.Tensor:
        if self.quantize:
            return self.int8_forward(x, z, qparams or quantize_serving_params(self))
        h, (gate,) = self.norm1(x, z)
        h = self.proj(h)
        return layer_norm(h, self.norm2, TORCH_LN_EPS) * gate + x

    def int8_forward(self, x: torch.Tensor, z: torch.Tensor, q: Dict) -> torch.Tensor:
        pp = self.proj
        return fused_int8_diffusion_block(
            x, z, q["stats_q"], q["stats_s"], self.norm1.proj.bias, q["fc1_q"], q["fc1_s"],
            pp.fc1.bias, q["fc2_q"], q["fc2_s"], pp.fc2.bias, self.norm2.weight,
            self.norm2.bias, a_z=q.get("a_z"), a_h=q.get("a_h"), a_silu=q.get("a_silu"),
            n2_eps=TORCH_LN_EPS)

    def calibration_forward(self, x: torch.Tensor, z: torch.Tensor
                            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Plain mirror of the int8 block (per-row quant) that returns the
        ranges of its quant sites: ``a_z`` (post-silu cond), ``a_h``
        (post-AdaLN hidden), ``a_silu`` (post-silu mid)."""
        pp, n1 = self.proj, self.norm1.proj
        stats = {}
        zf = silu(z.float())
        stats["a_z"] = _amax(zf)
        st = int8_matmul(zf, quantize_weight(n1.weight.t()), torch.float32) + n1.bias.float()
        scale, shift, gate = torch.chunk(st, 3, dim=-1)
        xf = x.float()
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        h = (xf - mu) * torch.rsqrt(var + ADALN_EPS) * (1.0 + scale) + shift
        stats["a_h"] = _amax(h)
        a = silu(int8_matmul(h, quantize_weight(pp.fc1.weight.t()), torch.float32)
                   + pp.fc1.bias.float())
        stats["a_silu"] = _amax(a)
        o = int8_matmul(a, quantize_weight(pp.fc2.weight.t()), torch.float32) + pp.fc2.bias.float()
        return (layer_norm(o, self.norm2, TORCH_LN_EPS) * gate + xf).to(x.dtype), stats


class TimeCondEmbed(nn.Module):
    """Fused timestep + condition embedding."""

    def __init__(self, cond_dim: int, embed_dim: int, freq_dim: int = 256, dtype=None,
                 device=None):
        super().__init__()
        self.freq_dim = freq_dim
        self.timestep_proj = Projector(freq_dim, embed_dim, embed_dim, dtype, device)
        self.condition_proj = Projector(cond_dim, embed_dim, embed_dim, dtype, device)

    def forward(self, timestep: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        freq = timestep_freq_embed(timestep, self.freq_dim).to(z.dtype)
        t = self.timestep_proj(freq)
        if t.ndim == z.ndim - 1:
            t = t[:, None]
        return self.condition_proj(z) + t


class DiffusionMLP(nn.Module):
    """Dense per-token diffusion head: x (B, P, out_dim) noisy patch tokens,
    timestep (B,) or (B, P), z (B, P, cond_dim) -> (B, P, out_dim)."""

    def __init__(self, depth: int, embed_dim: int, cond_dim: int, out_dim: int,
                 quantize: bool = False, dtype=None, remat: bool = False, device=None):
        super().__init__()
        self.depth, self.dtype, self.remat = depth, dtype, remat
        self.patch_proj = nn.Linear(out_dim, embed_dim, device=device)
        self.time_cond_embed = TimeCondEmbed(cond_dim, embed_dim, dtype=dtype, device=device)
        for i in range(depth):
            self.add_module(f"blocks_{i}", DiffusionBlock(embed_dim, quantize, dtype, device))
        self.norm = AdaLayerNormZero(embed_dim, num_stats=2, device=device)
        self.head = nn.Linear(embed_dim, out_dim, device=device)

    def blocks(self):
        return [getattr(self, f"blocks_{i}") for i in range(self.depth)]

    def forward(self, x: torch.Tensor, timestep: torch.Tensor, z: torch.Tensor,
                stg_rows: Optional[int] = None, qparams: Optional[Dict] = None) -> torch.Tensor:
        """``stg_rows``: trailing batch rows (the spatiotemporal-guidance
        perturbed pass) that bypass the middle block. ``qparams``: this
        head's serving tree (``{"blocks_{i}": ...}``) on the int8 path."""
        h = dense(x, self.patch_proj, self.dtype)
        zc = self.time_cond_embed(timestep, z)
        remat = self.remat and torch.is_grad_enabled() and qparams is None and not stg_rows
        for i, blk in enumerate(self.blocks()):
            q = None if qparams is None else qparams[f"blocks_{i}"]
            if remat:
                h = checkpoint(blk, h, zc, use_reentrant=False)
            elif stg_rows and i == self.depth // 2:
                h = torch.cat([blk(h[:-stg_rows], zc[:-stg_rows], q), h[-stg_rows:]])
            else:
                h = blk(h, zc, q)
        h, _ = self.norm(h, zc)
        return dense(h, self.head, self.dtype)

    def calibration_forward(self, x: torch.Tensor, timestep: torch.Tensor, z: torch.Tensor):
        """Forward through the blocks' calibration mirrors; returns the
        prediction and ``{"blocks_{i}": {site: ()}}``."""
        h = dense(x, self.patch_proj, self.dtype)
        zc = self.time_cond_embed(timestep, z)
        stats = {}
        for i, blk in enumerate(self.blocks()):
            h, stats[f"blocks_{i}"] = blk.calibration_forward(h, zc)
        h, _ = self.norm(h, zc)
        return dense(h, self.head, self.dtype), stats
