"""Attention primitives and their dispatcher (port of
``nova_pointcloud_tpu/ops/attention.py``: ``sdpa``, ``attention``, the routing
predicate, and the attention function of the models' multi-head attention).

- :func:`sdpa`: plain attention over (B, H, L, D), float32 logits and
  softmax, fully masked rows give 0.
- :func:`dot_product_attention`: flax's ``nn.dot_product_attention`` over
  (B, L, H, D), the models' default core.
- :func:`attention` / :func:`make_attention_fn`: route to the flash kernel
  (``ops/kernels/flash_attention.py``) by the JAX package's rule, so one call
  takes one route in both packages: ``impl="pallas"`` (the JAX package's
  name for "the kernel", kept) always; ``"sdpa"`` / ``"xla"`` never;
  ``"auto"`` on the card from 1024 keys on, for the bias forms the kernel
  takes. The 1024-key rule and the cap on resident K/V bytes were set on the
  JAX package's hardware; they are kept here as routing rules only and say
  nothing about speed on this card (PERF.md has the H100 times of both
  routes). Off the card ``"auto"`` runs the plain core, as the JAX package
  does off its accelerator.

- :class:`KVCache` / :func:`cached_attention`: frame-by-frame decode over a
  preallocated cache with a validity length mask, plain attention as in the
  JAX package (its cached core is plain XLA, no kernel).

``impl="ring"`` (sequence-parallel attention) is not ported yet (ROADMAP.md).
"""

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from nova_pointcloud_tpu_torch.ops.kernels.flash_attention import flash_attention

FLASH_MIN_KEYS = 1024
FLASH_MAX_KV_BYTES = 8 * 1024 * 1024  # of 2 * Lk * D float32, per (batch, head)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         bias: Optional[torch.Tensor] = None,
         scale: Optional[float] = None) -> torch.Tensor:
    """Scaled dot-product attention. q, k, v: (B, H, L, D); bias broadcastable
    to (B, H, Lq, Lk). Logits and softmax in float32."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    # fully masked rows (all -inf) give NaN: emit zeros
    probs = torch.where(torch.isnan(probs), torch.zeros_like(probs), probs).to(v.dtype)
    return torch.matmul(probs, v)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          mask: Optional[torch.Tensor] = None,
                          dropout_mult: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, L, H, D) attention as flax's ``dot_product_attention``: q scaled
    by 1/sqrt(D), float32 logits and softmax, ``bias`` added and ``mask``
    (True = keep) applied as the most negative float; ``dropout_mult``
    (keep / keep_prob, broadcast to (B, H, Lq, Lk)) scales the weights, as
    flax's attention dropout does."""
    q = q / (q.shape[-1] ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:  # in place: the logits are this call's own (one fewer B H Lq Lk)
        logits.masked_fill_(~mask, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    del logits
    if dropout_mult is not None:
        probs = probs * dropout_mult
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def flash_route(lq: int, lk: int, head_dim: int, bias_shape: Optional[Sequence[int]],
                impl: str, on_card: bool) -> bool:
    """Whether a call goes to the flash kernel: the JAX package's
    ``_use_pallas`` with "on a TPU" read as "on the card"."""
    if impl == "pallas":
        return True
    if impl in ("sdpa", "xla"):
        return False
    if not on_card:
        return False
    if lk < FLASH_MIN_KEYS:
        return False
    if 2 * lk * head_dim * 4 > FLASH_MAX_KV_BYTES:
        return False
    if bias_shape is None:
        return True
    # key bias (.., 1, 1, Lk) or shared full bias (1, 1, Lq, Lk): the
    # trailing dims must match (not merely broadcast to) the scores
    if len(bias_shape) != 4 or bias_shape[1] != 1:
        return False
    if bias_shape[-1] != lk:
        return False
    return bias_shape[2] == 1 or (bias_shape[0] == 1 and bias_shape[2] == lq)


def _use_flash(q: torch.Tensor, k: torch.Tensor, bias, impl: str) -> bool:
    return flash_route(q.shape[-2], k.shape[-2], k.shape[-1],
                       None if bias is None else tuple(bias.shape), impl, q.is_cuda)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor] = None, impl: str = "auto") -> torch.Tensor:
    """(B, H, L, D) attention through the dispatcher. impl: "auto", "pallas"
    (the flash kernel), "sdpa" / "xla" (plain)."""
    if impl.startswith("ring"):
        raise NotImplementedError(
            "impl='ring' (sequence-parallel ring attention) is not ported yet: "
            "ROADMAP.md, module queue, parallelism")
    if impl in ("auto", "pallas") and _use_flash(q, k, bias, impl):
        return flash_attention(q, k, v, bias=bias)
    return sdpa(q, k, v, bias)


def make_attention_fn(impl: str = "auto"):
    """The attention function of a multi-head attention module over
    (B, L, H, D) projections, routed through this module's dispatcher (the
    JAX package's ``make_flax_attention_fn``): the flash kernel where
    :func:`flash_route` says so, else :func:`dot_product_attention`.

    A caller's ``bias`` may be a learned parameter, and the kernel gives
    biases no gradient, so an explicit bias stays on the plain core; a
    ``mask`` (a constant) rides the kernel as a 0 / -inf bias. Live
    attention dropout (``dropout_mult``) runs the plain core too, as the
    JAX adapter's ``has_dropout`` test sends it to flax's core."""
    if impl.startswith("ring"):
        raise NotImplementedError(
            "attn_impl='ring' (sequence-parallel ring attention) is not ported "
            "yet: ROADMAP.md, module queue, parallelism")

    def attention_fn(query, key, value, bias=None, mask=None, dropout_mult=None):
        q = query.transpose(-2, -3)  # (B, L, H, D) -> (B, H, L, D)
        k = key.transpose(-2, -3)
        b = bias
        if mask is not None:
            mb = torch.where(mask, 0.0, float("-inf")).to(torch.float32)
            b = mb if b is None else b + mb
        has_dropout = dropout_mult is not None
        if has_dropout or bias is not None or not _use_flash(q, k, b, impl):
            return dot_product_attention(query, key, value, bias=bias, mask=mask,
                                         dropout_mult=dropout_mult)
        out = flash_attention(q, k, value.transpose(-2, -3), bias=b)
        return out.transpose(-2, -3)

    return attention_fn


class KVCache(NamedTuple):
    """Preallocated KV cache: k / v (B, H, S_max, D), or with a leading layer
    axis for a stack of layers (``cache.layer(i)`` is layer i's)."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def create(cls, batch: int, num_heads: int, max_len: int, head_dim: int,
               dtype=torch.float32, layers: Optional[int] = None, device=None) -> "KVCache":
        shape = (batch, num_heads, max_len, head_dim)
        if layers is not None:
            shape = (layers,) + shape
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))

    def layer(self, i: int) -> "KVCache":
        """Layer ``i`` of a stacked cache: views, so an update writes the stack."""
        return KVCache(self.k[i], self.v[i])

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor, index: int) -> "KVCache":
        """Write new keys / values at [index : index + L), in place (the JAX
        cache's ``dynamic_update_slice``, without the copy)."""
        end = index + k_new.shape[2]
        self.k[:, :, index:end] = k_new.to(self.k.dtype)
        self.v[:, :, index:end] = v_new.to(self.v.dtype)
        return self


def cached_attention(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                     cache: KVCache, index: int, bias: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, KVCache]:
    """Decode attention over a static cache: the new keys / values written at
    ``index``, then queries attend to every cached position < index + Lq
    (``bias``, if given, padded with zeros to the cache length). The core is
    :func:`sdpa` on the cache cast to q's dtype. Returns (output, cache)."""
    lq = q.shape[2]
    cache = cache.update(k_new, v_new, index)
    max_len = cache.k.shape[2]
    pos = torch.arange(max_len, device=q.device)
    length_bias = torch.where(pos < index + lq, 0.0, float("-inf"))[None, None, None, :]
    if bias is not None:
        pad = max_len - bias.shape[-1]
        if pad:
            bias = torch.nn.functional.pad(bias, (0, pad))
        length_bias = length_bias + bias
    out = sdpa(q, cache.k.to(q.dtype), cache.v.to(q.dtype), length_bias)
    return out, cache
