"""Masked-autoregressive scheduling primitives (port of the sampler's part of
``nova_pointcloud_tpu/ops/masking.py``).

- cosine mask schedule -> per-AR-step prediction counts (host numpy)
- random prediction order: argsort of uniforms from a ``torch.Generator``
  (the JAX package draws them from a key; the two streams never match)
- a fixed-size padded slice of the order per AR step, its one-hot union,
  and the key-side bias that hides masked tokens from attention
- the training mask: one truncated-normal mask ratio per call in [0.7, 1],
  the visible set the first ``round((1 - ratio) N)`` of a per-sample random
  permutation
- the block-causal bias of teacher-forced video encoding
"""

import math
from typing import Optional, Tuple

import numpy as np
import torch


def cosine_pred_counts(num_steps: int, num_patches: int) -> np.ndarray:
    """Per-AR-step prediction counts from the cosine mask schedule; they sum
    to ``num_patches``."""
    ratios = np.cos(0.5 * np.pi * np.arange(num_steps + 1) / num_steps)
    lengths = np.round(ratios * num_patches).astype(np.int64)
    return lengths[:-1] - lengths[1:]


def pred_boundaries(counts: np.ndarray) -> Tuple[np.ndarray, int]:
    """Return (cumulative start offsets (S,), max padded count)."""
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return starts.astype(np.int32), int(counts.max())


def truncated_normal(generator: Optional[torch.Generator], lower: float, upper: float,
                     loc: float = 0.0, scale: float = 1.0, shape: Tuple[int, ...] = (),
                     device=None) -> torch.Tensor:
    """Normal(loc, scale) truncated to [lower, upper] (unstandardised
    bounds), by the inverse CDF of a uniform draw in float64."""
    a = (lower - loc) / scale
    b = (upper - loc) / scale
    cdf = lambda x: 0.5 * math.erfc(-x / math.sqrt(2.0))  # noqa: E731
    u = torch.rand(tuple(shape), generator=generator, device=device, dtype=torch.float64)
    p = cdf(a) + u * (cdf(b) - cdf(a))
    z = math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0)
    return (torch.clamp(z, a, b) * scale + loc).float()


# lower bound of the train mask ratio; bounds the visible count of the
# training pass's static gather bucket (models/vit.py)
TRAIN_MASK_RATIO_MIN = 0.7


def sample_train_mask(generator: Optional[torch.Generator], batch: int, num_tokens: int,
                      mask_ratios: Tuple[float, float, float] = (TRAIN_MASK_RATIO_MIN, 1.0, 0.25),
                      device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MAR-style training mask: one truncnorm(lo, hi, sigma) ratio per
    call (loc 1), the first ``round((1 - ratio) N)`` tokens of a random
    per-sample order visible. Returns ``mask`` (B, N, 1) float32 with 1 =
    masked and ``rank`` (B, N) int64, each token's position in the order."""
    lo, hi, sigma = mask_ratios
    ratio = truncated_normal(generator, lo, hi, loc=1.0, scale=sigma, device=device)
    num_visible = torch.round((1.0 - ratio) * num_tokens).to(torch.int64)
    order = random_pred_order(generator, batch, num_tokens, device)
    rank = torch.argsort(order, dim=1)
    return (rank >= num_visible).float()[..., None], rank


def random_pred_order(generator: Optional[torch.Generator], batch: int, num_tokens: int,
                      device=None) -> torch.Tensor:
    """Random generation order per sample: (B, N) int64 token indices, the
    argsort of uniforms drawn from ``generator``."""
    u = torch.rand((batch, num_tokens), generator=generator, device=device)
    return torch.argsort(u, dim=1)


def pred_slice(order: torch.Tensor, start: int, count: int, pad_count: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-size slice of the generation order for one AR step: (ids (B, P),
    valid (B, P) float32). Invalid lanes point at the slice's first id, so
    scatters stay in bounds; indices are clamped per lane."""
    batch, num_tokens = order.shape
    lane = torch.arange(pad_count, device=order.device)[None].expand(batch, pad_count)
    idx = torch.clamp(lane + int(start), max=num_tokens - 1)
    ids = torch.gather(order, 1, idx)
    live = lane < int(count)
    return torch.where(live, ids, ids[:, :1]), live.float()


def scatter_mask(ids: torch.Tensor, valid: torch.Tensor, num_tokens: int) -> torch.Tensor:
    """One-hot union of ids -> (B, N, 1) mask (duplicates are harmless)."""
    onehot = torch.nn.functional.one_hot(ids, num_tokens).to(valid.dtype)  # (B, P, N)
    return torch.amax(onehot * valid[..., None], dim=1)[..., None]


def block_causal_bias(frame_lens: Tuple[int, ...], text_len: int = 0,
                      dtype=torch.float32, device=None) -> torch.Tensor:
    """Additive (L, L) bias for block-causal temporal AR: token i may attend
    to token j iff block(i) >= block(j); the text prefix lives in block 0.
    0 allowed, -inf not; L = text_len + sum(frame_lens)."""
    blocks = [np.zeros(text_len, np.int32)] if text_len else []
    blocks += [np.full(n, i, np.int32) for i, n in enumerate(frame_lens)]
    d = np.concatenate(blocks)
    allowed = torch.from_numpy(d[:, None] >= d[None, :]).to(device)
    return torch.where(allowed, 0.0, float("-inf")).to(dtype)


def visibility_bias(visible: torch.Tensor, prefix_len: int = 0,
                    dtype=torch.float32) -> torch.Tensor:
    """Key-side bias excluding masked tokens from attention.

    visible: (B, N) with 1 = visible. Returns (B, 1, 1, prefix + N): 0 for a
    visible key (and the prefix), -inf for a masked one."""
    if prefix_len:
        ones = torch.ones(visible.shape[:1] + (prefix_len,), dtype=visible.dtype,
                          device=visible.device)
        visible = torch.cat([ones, visible], dim=1)
    bias = torch.where(visible > 0, 0.0, float("-inf")).to(dtype)
    return bias[:, None, None, :]
