"""Positional and conditioning embeddings (port of
``nova_pointcloud_tpu/models/embeddings.py``): the timestep features of the
pc model, and what NOVA t2i and t2v serving need:

- 3-axis RoPE: ``rope_axis_dims``, ``rope_positions``, ``rope_weights``
  (cos / sin tables, zero-angle rows for a conditioning prefix),
  ``apply_rope`` (interleaved pairs) and ``gather_rope`` (the rows of a
  token subset);
- ``sincos_2d`` / ``sincos_time`` tables (host numpy, copied);
- ``PosEmbed`` (additive 2D sincos), ``VideoPosEmbed`` (2D sincos + learned
  time MLP), ``MotionEmbed`` (flow / fps tokens of the video models);
- ``PatchEmbed`` (+ ``patchify`` / ``unpatchify`` in NOVA's (p_h, p_w, C)
  layout), including ``pre_patchified=True``;
- ``TextEmbed`` (learned null-prompt bank, proj + LayerNorm, padding past
  each prompt's length and train-time prompt dropout to the bank);
- ``LabelEmbed`` (the c2i class table with its null class, + LayerNorm);
- ``MaskTokens`` (BOS / mask tokens).

Parameter names are the flax modules' (``models/convert.py``).
"""

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from nova_pointcloud_tpu_torch.models.layers import dense, layer_norm, silu

TORCH_LN_EPS = 1e-5  # the reference's plain nn.LayerNorm(dim)


def timestep_freq_embed(timestep: torch.Tensor, freq_dim: int = 256) -> torch.Tensor:
    """Sinusoidal diffusion-timestep features: ``[cos(t·f), sin(t·f)]``."""
    half = freq_dim // 2
    log_theta = math.log(10000.0)
    freq = torch.exp(torch.arange(half, dtype=torch.float32,
                                  device=timestep.device) * (-log_theta / half))
    emb = timestep[..., None].float() * freq
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


def rope_axis_dims(head_dim: int) -> Tuple[int, int, int]:
    """Split head_dim across (t, h, w): d/8 + 2x((d - d/8)/2)."""
    dt = head_dim // 8
    ds = (head_dim - dt) // 2
    return dt, ds, ds


def rope_positions(t: int, hw: Tuple[int, int], device=None) -> torch.Tensor:
    """Dense (1, t*h*w, 3) float32 grid of (t, y, x) positions."""
    h, w = hw
    grids = torch.meshgrid(torch.arange(t, device=device), torch.arange(h, device=device),
                           torch.arange(w, device=device), indexing="ij")
    return torch.stack(grids, dim=-1).reshape(1, -1, 3).float()


def rope_weights(pos: torch.Tensor, head_dim: int, theta: float = 10000.0,
                 pad: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos / sin tables of 3-axis RoPE: pos (B, L, 3) -> each (B, 1, pad + L,
    head_dim // 2); ``pad`` prepends zero positions for a conditioning prefix."""
    if pad:
        zeros = torch.zeros(pos.shape[:1] + (pad, 3), dtype=pos.dtype, device=pos.device)
        pos = torch.cat([zeros, pos], dim=1)
    parts_cos, parts_sin = [], []
    for i, d_axis in enumerate(rope_axis_dims(head_dim)):
        scale = torch.arange(0, d_axis, 2, dtype=torch.float32, device=pos.device) / d_axis
        inv_freq = 1.0 / (theta ** scale)
        angle = pos[..., i:i + 1] * inv_freq  # (B, L, d_axis / 2)
        parts_cos.append(torch.cos(angle))
        parts_sin.append(torch.sin(angle))
    return torch.cat(parts_cos, dim=-1)[:, None], torch.cat(parts_sin, dim=-1)[:, None]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs: (x0, x1) -> (c*x0 - s*x1, s*x0 + c*x1), with
    cos / sin cast to x's dtype first. x (B, H, L, D); cos / sin (B, 1, L, D/2)."""
    shape = x.shape
    xp = x.reshape(shape[:-1] + (shape[-1] // 2, 2))
    x0, x1 = xp[..., 0], xp[..., 1]
    cos, sin = cos.to(x.dtype), sin.to(x.dtype)
    return torch.stack([cos * x0 - sin * x1, sin * x0 + cos * x1], dim=-1).reshape(shape)


def gather_rope(cos: torch.Tensor, sin: torch.Tensor, ids: torch.Tensor,
                pad: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RoPE rows of a token subset: cos / sin (B, 1, L, D/2) without the
    prefix, ids (B, P) into L -> tables of length pad + P whose prefix rows
    have zero angle (cos 1, sin 0)."""
    def sel(w, prefix_value):
        idx = ids[..., None].expand(-1, -1, w.shape[-1])
        g = torch.gather(w[:, 0], 1, idx)[:, None]
        if pad:
            prefix = torch.full(g.shape[:2] + (pad, g.shape[-1]), prefix_value, dtype=g.dtype,
                                device=g.device)
            g = torch.cat([prefix, g], dim=2)
        return g

    return sel(cos, 1.0), sel(sin, 0.0)


def sincos_2d(dim: int, h: int, w: int, base_hw: Tuple[int, int]) -> np.ndarray:
    """2D sincos table (h*w, dim)."""
    quarter = dim // 4
    freq = 1.0 / (10000 ** (np.arange(quarter, dtype=np.float32) / quarter))
    grid_h = np.arange(h, dtype=np.float32) * (base_hw[0] / h)
    grid_w = np.arange(w, dtype=np.float32) * (base_hw[1] / w)
    gw, gh = np.meshgrid(grid_w, grid_h)  # indexing="xy"
    fw = gw.reshape(-1, 1) * freq[None]
    fh = gh.reshape(-1, 1) * freq[None]
    return np.concatenate([np.sin(fw), np.cos(fw), np.sin(fh), np.cos(fh)],
                          axis=-1).astype(np.float32)


def sincos_time(num: int, base_t: int, freq_dim: int = 128) -> np.ndarray:
    """Per-frame sincos (num, 1, 2*freq_dim)."""
    freq = 1.0 / (10000 ** (np.arange(freq_dim, dtype=np.float32) / freq_dim))
    grid = np.arange(num, dtype=np.float32) / (num / base_t)
    f = grid[:, None, None] * freq[None, None, :]
    return np.concatenate([np.sin(f), np.cos(f)], axis=-1).astype(np.float32)


class PosEmbed(nn.Module):
    """Additive 2D sincos position embedding (no parameters)."""

    def __init__(self, dim: int, base_size: Tuple[int, int] = (16, 16)):
        super().__init__()
        self.dim, self.base_size = dim, tuple(base_size)

    def forward(self, x: torch.Tensor, hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        h, w = hw or self.base_size
        table = torch.from_numpy(sincos_2d(self.dim, h, w, self.base_size)).to(x.device)
        return x + table.to(x.dtype)


class VideoPosEmbed(nn.Module):
    """2D sincos space + learned-MLP time embedding."""

    def __init__(self, dim: int, base_size: Tuple[int, int, int] = (16, 16, 16),
                 device=None):
        super().__init__()
        self.dim, self.base_size = dim, tuple(base_size)
        self.time_fc1 = nn.Linear(256, dim, device=device)
        self.time_fc2 = nn.Linear(dim, dim, device=device)
        self.time_norm = nn.LayerNorm(dim, eps=TORCH_LN_EPS, device=device)

    def time_embed(self, num_frames: int) -> torch.Tensor:
        """(num_frames, 1, dim) learned projection of the time sincos."""
        sincos = torch.from_numpy(sincos_time(num_frames, self.base_size[0])).to(
            self.time_fc1.weight.device)
        h = dense(silu(dense(sincos, self.time_fc1)), self.time_fc2)
        return layer_norm(h, self.time_norm, TORCH_LN_EPS)

    def forward(self, x: torch.Tensor, hw: Optional[Tuple[int, int]] = None,
                add_time: bool = True) -> torch.Tensor:
        # x: (B, T, N, D) or (B, N, D)
        if x.ndim == 4 and add_time:
            x = x + self.time_embed(x.shape[1])[None].to(x.dtype)
        h, w = hw or self.base_size[1:]
        table = torch.from_numpy(sincos_2d(self.dim, h, w, self.base_size[1:])).to(x.device)
        return x + table.to(x.dtype)


class MotionEmbed(nn.Module):
    """Flow / fps conditioning tokens: each value's sincos features through
    its own two-layer MLP (``{flow,fps}_fc{1,2}``) -> (B, 2, dim)."""

    def __init__(self, dim: int, base_flow: float = 5.0, base_fps: float = 12.0,
                 freq_dim: int = 128, device=None):
        super().__init__()
        self.base_flow, self.base_fps, self.freq_dim = base_flow, base_fps, freq_dim
        for name in ("flow", "fps"):
            setattr(self, f"{name}_fc1", nn.Linear(2 * freq_dim, dim, device=device))
            setattr(self, f"{name}_fc2", nn.Linear(dim, dim, device=device))

    def _one(self, values: torch.Tensor, name: str) -> torch.Tensor:
        values = values.reshape(values.shape[0])  # (B,) or (B, 1)
        freq = 1.0 / (10000 ** (torch.arange(self.freq_dim, dtype=torch.float32,
                                             device=values.device) / self.freq_dim))
        f = values[:, None, None].float() * freq[None, None]
        sincos = torch.cat([torch.sin(f), torch.cos(f)], dim=-1)
        h = dense(sincos, getattr(self, f"{name}_fc1"))
        return dense(silu(h), getattr(self, f"{name}_fc2"))

    def forward(self, batch: int, flow: Optional[torch.Tensor] = None,
                fps: Optional[torch.Tensor] = None) -> torch.Tensor:
        dev = self.flow_fc1.weight.device
        flow = torch.full((batch,), self.base_flow, device=dev) if flow is None else flow
        fps = torch.full((batch,), self.base_fps, device=dev) if fps is None else fps
        return torch.cat([self._one(flow.to(dev), "flow"), self._one(fps.to(dev), "fps")],
                         dim=1)


def patchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, h*w, p*p*C), (p_h, p_w, C) innermost."""
    b, h, w, c = x.shape
    p = patch_size
    x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def unpatchify(x: torch.Tensor, patch_size: int, hw: Tuple[int, int]) -> torch.Tensor:
    """(B, h*w, p*p*C) -> (B, H, W, C), the inverse of :func:`patchify`."""
    b, n, d = x.shape
    p = patch_size
    h, w = hw
    c = d // (p * p)
    x = x.reshape(b, h, w, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * p, w * p, c)


class PatchEmbed(nn.Module):
    """Linear patch projection, channels-last."""

    def __init__(self, embed_dim: int, patch_size: int, in_channels: int, device=None):
        super().__init__()
        self.embed_dim, self.patch_size = embed_dim, patch_size
        self.proj = nn.Linear(patch_size * patch_size * in_channels, embed_dim, device=device)

    def forward(self, x: torch.Tensor, pre_patchified: bool = False) -> torch.Tensor:
        # (B, H, W, C) or (B, T, H, W, C) -> tokens (B[, T], N, D)
        if pre_patchified:  # (B, N, p*p*C) already in patch space
            return dense(x, self.proj)
        video = x.ndim == 5
        if video:
            b, t = x.shape[:2]
            x = x.reshape((b * t,) + x.shape[2:])
        tokens = dense(patchify(x, self.patch_size), self.proj)
        if video:
            tokens = tokens.reshape(b, t, tokens.shape[1], self.embed_dim)
        return tokens


class TextEmbed(nn.Module):
    """Project encoder hidden states into the model dim, with a learned
    null-prompt bank (CFG negatives, padding, train-time prompt dropout)."""

    def __init__(self, token_dim: int, embed_dim: int, num_tokens: int = 256,
                 max_positions: int = 512, dropout: float = 0.1, device=None):
        super().__init__()
        self.num_tokens, self.dropout = num_tokens, dropout
        self.null_prompt = nn.Parameter(torch.zeros(max_positions, token_dim, device=device))
        self.proj = nn.Linear(token_dim, embed_dim, device=device)
        self.norm = nn.LayerNorm(embed_dim, eps=TORCH_LN_EPS, device=device)

    def null_bank(self) -> torch.Tensor:
        return self.null_prompt

    def pad_embeds(self, embeds: torch.Tensor,
                   lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Replace positions >= each prompt's length with the null bank's
        rows (``lengths`` (B,); None: the embeds unchanged)."""
        if lengths is None:
            return embeds
        bank = self.null_bank()[: embeds.shape[1]].to(embeds.dtype)
        idx = torch.arange(embeds.shape[1], device=embeds.device)[None, :, None]
        keep = idx < torch.as_tensor(lengths, device=embeds.device)[:, None, None]
        return torch.where(keep, embeds, bank[None])

    def null_embeds(self, batch: int, length: Optional[int] = None) -> torch.Tensor:
        bank = self.null_bank()[: (length or self.num_tokens)]
        return bank[None].expand((batch,) + tuple(bank.shape))

    def drop_prompts(self, embeds: torch.Tensor, generator: Optional[torch.Generator] = None,
                     drop: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Train-time CFG dropout: each prompt is replaced whole by the null
        bank's rows with probability ``dropout``. ``drop`` (B,) bool gives the
        draw (else uniform < dropout from ``generator``)."""
        bank = self.null_bank()[: embeds.shape[1]].to(embeds.dtype)
        if drop is None:
            drop = torch.rand((embeds.shape[0],), generator=generator,
                              device=embeds.device) < self.dropout
        return torch.where(drop.to(embeds.device)[:, None, None], bank[None], embeds)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(dense(x, self.proj), self.norm, TORCH_LN_EPS)


class LabelEmbed(nn.Module):
    """Class-label embedding: a (num_classes + 1, D) table whose last row is
    the null class (the CFG negative), then a LayerNorm (torch's eps, 1e-5).
    In training, ``drop_labels`` sends ids to the null class at the JAX
    module's rate."""

    dropout = 0.1

    def __init__(self, embed_dim: int, num_classes: int = 1000, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.weight = nn.Parameter(torch.zeros(num_classes + 1, embed_dim, device=device))
        self.norm = nn.LayerNorm(embed_dim, eps=TORCH_LN_EPS, device=device)

    def drop_labels(self, input_ids: torch.Tensor, generator: Optional[torch.Generator] = None,
                    drop: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Train-time CFG dropout of (B,) or (B, L) ids, as (B, 1) or (B,
        L): each id whose uniform draw is not above ``dropout`` becomes the
        null class. ``drop`` (bool, the ids' count) gives the draw."""
        if input_ids.ndim == 1:
            input_ids = input_ids[:, None]
        if drop is None:
            drop = torch.rand(tuple(input_ids.shape), generator=generator,
                              device=input_ids.device) <= self.dropout
        drop = drop.to(input_ids.device).reshape(input_ids.shape)
        return torch.where(drop, torch.full_like(input_ids, self.num_classes), input_ids)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(B,) or (B, L) ids -> (B, 1, D) or (B, L, D)."""
        if input_ids.ndim == 1:
            input_ids = input_ids[:, None]
        return layer_norm(self.weight[input_ids.long()], self.norm, TORCH_LN_EPS)


class MaskTokens(nn.Module):
    """Learned BOS / mask tokens."""

    def __init__(self, embed_dim: int, device=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.bos_token = nn.Parameter(torch.zeros(1, embed_dim, device=device))
        self.mask_token = nn.Parameter(torch.zeros(1, embed_dim, device=device))

    def apply_mask(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x*(1-mask) + mask_token*mask; mask (B, N, 1), 1 = masked."""
        mask = mask.to(x.dtype)
        return x * (1.0 - mask) + self.mask_token.to(x.dtype) * mask

    def bos(self, shape: Sequence[int]) -> torch.Tensor:
        """The BOS token broadcast to (..., embed_dim)."""
        return self.bos_token.expand(tuple(shape) + (self.embed_dim,))
