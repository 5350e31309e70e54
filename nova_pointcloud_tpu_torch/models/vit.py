"""Encoder-decoder Vision Transformer, the NOVA workhorse (port of
``nova_pointcloud_tpu/models/vit.py``: ``MLP``, ``Attention``, ``Block``,
``VisionTransformer``).

Post-sublayer LayerNorm blocks (``x = x + LN(Attn(x)); x = x + LN(MLP(x))``,
eps 1e-5), an optional conditioning prefix ``c``, and the MAE-style split:
the first ``encoder_depth`` blocks see only the visible tokens, either by
key-side masking over the whole sequence or by gathering them into a
fixed-size bucket (``visible_bucket``), whose outputs scatter back.

Layers are ``nn.ModuleList``s named as the flax scan stacks
(``enc_layers`` / ``dec_layers``); qparams and calibration stats carry a
leading depth axis under ``"block"``, as the JAX collections do.

``quantize`` selects the int8 serving path, as the JAX model takes it on its
accelerator (the port takes it on the card and, with the kernels' plain
versions, on the CPU):

- the attention's qkv / out projections through ``int8_linear`` (per-row
  int8, the product rounded to the compute dtype before the bias);
- after calibration (``a_smax`` in the block's qparams) the attention core
  through ``flash_attention_static`` (bf16 scores, or int8 with
  ``attn_core="int8"``), else the dispatcher (``ops/attention.attention``);
- the MLP sub-block as one ``fused_int8_mlp_postln`` call.

A calibration forward (``calibrate=True``) records the ranges its quant sites
see (``a_smax``, ``a_q``, ``a_k`` under ``attn``; ``a_x``, ``a_gelu``) through
the block's plain MLP mirror and the dispatcher attention.

3-axis RoPE rotates q and k when cos / sin tables are given (prefix rows at
zero angle; the gather path takes the gathered tokens' rows). KV caches
(``caches=(enc, dec)``, stacked per half, ``ops/attention.KVCache``) serve
the frame-by-frame video decode: each layer writes its keys and values at
``cache_index`` in place and attends over the cache (``cached_attention``,
the plain core, as in the JAX model: a cached layer never takes the static
kernel and sows no attention stats).

The float path is differentiable (training). ``remat`` recomputes each block
in the backward pass (``torch.utils.checkpoint``, non-reentrant), as the JAX
stacks' ``nn.remat``: a flash attention layer then runs its forward twice per
step. MoE blocks and the pipeline-parallel runner are not ported yet and
raise.
"""

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from nova_pointcloud_tpu_torch.models.embeddings import TORCH_LN_EPS, apply_rope, gather_rope
from nova_pointcloud_tpu_torch.models.layers import dense, gelu, layer_norm
from nova_pointcloud_tpu_torch.ops import masking
from nova_pointcloud_tpu_torch.ops.attention import KVCache, attention, cached_attention
from nova_pointcloud_tpu_torch.ops.kernels.flash_attention import flash_attention_static
from nova_pointcloud_tpu_torch.ops.kernels.fused_block import (fused_int8_mlp_postln,
                                                               int8_linear)
from nova_pointcloud_tpu_torch.ops.quantization import (int8_matmul, quantize_serving_params,
                                                        quantize_weight,
                                                        quantize_weight_kmajor, stack_layers)


def _amax(v: torch.Tensor) -> torch.Tensor:
    """A calibration statistic: a measurement, carrying no gradient."""
    return torch.amax(torch.abs(v)).detach().float()


def layer_slice(tree, i: int):
    """Layer ``i`` of a depth-stacked tree (every leaf indexed on axis 0)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


class MLP(nn.Module):
    def __init__(self, dim: int, mlp_ratio: float = 4.0, dtype=None, device=None):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio), device=device)
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = dense(x, self.fc1, self.dtype)
        return dense(gelu(h), self.fc2, self.dtype)


class Attention(nn.Module):
    """Multi-head self-attention over (B, L, D); ``attn_core`` is the static
    kernel's score precision ("bf16" or "int8")."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 attn_impl: str = "auto", quantize: bool = False, dtype=None,
                 attn_core: str = "bf16", device=None):
        super().__init__()
        if attn_impl.startswith("ring"):
            raise NotImplementedError(
                "attn_impl='ring' (sequence-parallel ring attention) is not ported yet: "
                "ROADMAP.md, module queue, parallelism")
        self.dim, self.num_heads = dim, num_heads
        self.attn_impl, self.quantize, self.dtype, self.attn_core = (
            attn_impl, quantize, dtype, attn_core)
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def _int8_proj(self, x: torch.Tensor, lin: nn.Linear, q: Optional[Dict],
                   qname: str) -> torch.Tensor:
        """q8(x) @ int8 weight, pre-quantized in ``q`` when given, else
        quantized here; the bias added after the cast, in the compute dtype."""
        if q is not None and f"{qname}_q" in q:
            wq, ws = q[f"{qname}_q"], q[f"{qname}_s"]
        else:
            wq, ws = quantize_weight_kmajor(lin.weight)
        return int8_linear(x, wq, ws, lin.bias, self.dtype or x.dtype)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                q: Optional[Dict] = None, calibrate: bool = False, rope=None,
                cache: Optional[KVCache] = None, cache_index: int = 0
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
        b, l, _ = x.shape
        hd = self.dim // self.num_heads
        qkv = (self._int8_proj(x, self.qkv, q, "qkv") if self.quantize
               else dense(x, self.qkv, self.dtype))
        qkv = qkv.reshape(b, l, 3, self.num_heads, hd)
        qh, kh, vh = [qkv[:, :, i].transpose(1, 2) for i in range(3)]
        if rope is not None:
            qh, kh = apply_rope(qh, *rope), apply_rope(kh, *rope)
        stats = None
        if self.quantize and calibrate and cache is None:
            # the max attention logit (the static softmax offset) and the q/k
            # amax (the int8 score core's static scales)
            s = torch.matmul(qh.float() * hd ** -0.5, kh.float().transpose(-1, -2))
            if bias is not None:
                s = s + bias
            stats = {"a_smax": torch.amax(s).detach().float(), "a_q": _amax(qh),
                     "a_k": _amax(kh)}
        smax = None if q is None else q.get("a_smax")
        key_bias = bias is None or (bias.ndim == 4 and bias.shape[1] == 1
                                    and bias.shape[2] == 1)
        if (self.quantize and smax is not None and cache is None and key_bias
                and self.attn_impl in ("auto", "pallas")):
            aq = ak = None
            if self.attn_core == "int8":
                aq, ak = q.get("a_q"), q.get("a_k")
            o = flash_attention_static(qh, kh, vh, smax, bias, a_q=aq, a_k=ak)
        elif cache is not None:
            o, _ = cached_attention(qh, kh, vh, cache, cache_index, bias)
        else:
            o = attention(qh, kh, vh, bias, impl=self.attn_impl)
        o = o.transpose(1, 2).reshape(b, l, self.dim)
        out = (self._int8_proj(o, self.proj, q, "proj") if self.quantize
               else dense(o, self.proj, self.dtype))
        return out, stats


class Block(nn.Module):
    """Post-sublayer-norm transformer block."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, attn_impl: str = "auto", quantize: bool = False,
                 dtype=None, attn_core: str = "bf16", device=None):
        super().__init__()
        self.quantize = quantize
        self.attn = Attention(dim, num_heads, qkv_bias, attn_impl, quantize, dtype,
                              attn_core, device)
        self.norm1 = nn.LayerNorm(dim, eps=TORCH_LN_EPS, device=device)
        self.norm2 = nn.LayerNorm(dim, eps=TORCH_LN_EPS, device=device)
        self.mlp = MLP(dim, mlp_ratio, dtype, device)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                q: Optional[Dict] = None, calibrate: bool = False, rope=None,
                cache: Optional[KVCache] = None, cache_index: int = 0
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
        """``q``: this block's qparams (int8 path). With ``calibrate`` (and
        ``quantize``) returns the block's stats as the second value (a cached
        layer's hold the MLP's sites only, as the JAX sow)."""
        if self.quantize and q is None and not calibrate:
            q = quantize_serving_params(self)
        h, attn_stats = self.attn(x, bias, None if q is None else q.get("attn"), calibrate,
                                  rope, cache, cache_index)
        x = x + layer_norm(h, self.norm1, TORCH_LN_EPS)
        if self.quantize and calibrate:
            x, stats = self._calibration_mlp(x)
            if attn_stats is not None:
                stats["attn"] = attn_stats
            return x, stats
        if self.quantize:
            mlp = self.mlp
            return fused_int8_mlp_postln(
                x, q["fc1_q"], q["fc1_s"], mlp.fc1.bias, q["fc2_q"], q["fc2_s"], mlp.fc2.bias,
                self.norm2.weight, self.norm2.bias, a_x=q.get("a_x"), a_gelu=q.get("a_gelu"),
                ln_eps=TORCH_LN_EPS), None
        return x + layer_norm(self.mlp(x), self.norm2, TORCH_LN_EPS), None

    def _calibration_mlp(self, x: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """Plain mirror of the fused int8 MLP recording ``a_x`` (block input)
        and ``a_gelu`` (post-gelu)."""
        mlp = self.mlp
        xf = x.float()
        stats = {"a_x": _amax(xf)}
        a = int8_matmul(xf, quantize_weight(mlp.fc1.weight.t()), torch.float32) \
            + mlp.fc1.bias.float()
        a = gelu(a)
        stats["a_gelu"] = _amax(a)
        o = int8_matmul(a, quantize_weight(mlp.fc2.weight.t()), torch.float32) \
            + mlp.fc2.bias.float()
        return (xf + layer_norm(o, self.norm2, TORCH_LN_EPS)).to(x.dtype), stats


def _cat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Concatenate along the tokens in the promoted dtype (jnp.concatenate)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.cat([a.to(dt), b.to(dt)], dim=1)


class VisionTransformer(nn.Module):
    """Encoder-decoder ViT over pre-embedded tokens."""

    def __init__(self, depth: int, embed_dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 encoder_depth: Optional[int] = None, attn_impl: str = "auto",
                 quantize: bool = False, dtype=None, attn_core: str = "bf16",
                 num_experts: int = 0, remat: bool = False, device=None):
        super().__init__()
        if num_experts > 1:
            raise NotImplementedError("MoE blocks are not ported yet: ROADMAP.md, module "
                                      "queue, NOVA training")
        self.depth, self.embed_dim, self.num_heads = depth, embed_dim, num_heads
        self.remat = remat
        self.enc_depth = depth // 2 if encoder_depth is None else encoder_depth

        def blocks(n):
            return nn.ModuleList(Block(embed_dim, num_heads, mlp_ratio, True, attn_impl,
                                       quantize, dtype, attn_core, device) for _ in range(n))

        self.enc_layers = blocks(self.enc_depth)
        self.dec_layers = blocks(depth - self.enc_depth)
        self.norm = nn.LayerNorm(embed_dim, eps=TORCH_LN_EPS, device=device)

    def _stack(self, name: str, h: torch.Tensor, bias, qparams: Optional[Dict],
               calibrate: bool, stats: Dict, rope=None, cache: Optional[KVCache] = None,
               cache_index: int = 0) -> torch.Tensor:
        layers = getattr(self, name)
        stacked = None if qparams is None else qparams[name]["block"]
        per = []
        remat = (self.remat and torch.is_grad_enabled() and stacked is None and not calibrate
                 and cache is None)
        for i, blk in enumerate(layers):
            if remat:
                h = checkpoint(lambda x, b, blk=blk: blk(x, b, rope=rope)[0], h, bias,
                               use_reentrant=False)
                continue
            h, s = blk(h, bias, None if stacked is None else layer_slice(stacked, i), calibrate,
                       rope, None if cache is None else cache.layer(i), cache_index)
            per.append(s)
        if calibrate and per and per[0] is not None:
            stats[name] = {"block": stack_layers(per)}
        return h

    def forward(self, x: torch.Tensor, c: Optional[torch.Tensor] = None,
                visible: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
                visible_bucket: Optional[int] = None, qparams: Optional[Dict] = None,
                calibrate: bool = False, rope=None,
                caches: Optional[Tuple[KVCache, KVCache]] = None, cache_index: int = 0):
        """x (B, N, D) tokens; c (B, Lc, D) prefix; visible (B, N), 1 =
        visible (None = all); ``visible_bucket``: the static gather size (the
        per-sample visible count never exceeds it); ``rope``: (cos, sin)
        tables over prefix + tokens; ``caches``: the (enc, dec) stacked KV
        caches, written in place at ``cache_index``. Returns ``(out,
        stats)``: stats is the calibration tree when ``calibrate``, else
        None."""
        stats: Dict = {}
        c_len = 0 if c is None else c.shape[1]
        x_tokens = x
        use_split = visible is not None and self.enc_depth > 0
        use_gather = (use_split and visible_bucket is not None
                      and visible_bucket < x.shape[1] and bias is None and caches is None)
        enc_cache, dec_cache = caches if caches is not None else (None, None)
        if use_gather:
            k = visible_bucket
            b, n = visible.shape
            order = torch.argsort(1.0 - visible, dim=1, stable=True)
            ids = order[:, :k]
            nvis = torch.sum(visible, dim=1).to(torch.int64)
            valid = (torch.arange(k, device=x.device)[None] < nvis[:, None]).float()
            xg = torch.gather(x_tokens, 1, ids[..., None].expand(-1, -1, x.shape[-1]))
            hg = xg if c is None else _cat(c, xg)
            g_bias = masking.visibility_bias(valid, prefix_len=c_len)
            rope_g = None
            if rope is not None:
                cos, sin = rope
                if cos.shape[0] == 1 and b > 1:
                    cos = cos.expand((b,) + tuple(cos.shape[1:]))
                    sin = sin.expand((b,) + tuple(sin.shape[1:]))
                rope_g = gather_rope(cos[:, :, c_len:], sin[:, :, c_len:], ids, pad=c_len)
            h_enc = self._stack("enc_layers", hg, g_bias, qparams, calibrate, stats, rope_g)
            upd = h_enc[:, c_len:] * valid[..., None].to(h_enc.dtype)
            # scatter back: each visible token's row once (ids are distinct), an
            # index scatter equal to the JAX one-hot product
            scattered = torch.zeros(x_tokens.shape, dtype=h_enc.dtype, device=x.device)
            scattered.scatter_(1, ids[..., None].expand(-1, -1, upd.shape[-1]), upd)
            covered = torch.zeros((b, n), dtype=h_enc.dtype, device=x.device)
            covered.scatter_(1, ids, valid.to(h_enc.dtype))
            tail = scattered + x_tokens.to(h_enc.dtype) * (1.0 - covered[..., None])
            h = tail if c is None else torch.cat([h_enc[:, :c_len], tail], dim=1)
        else:
            h = x if c is None else _cat(c, x)
            enc_bias = bias
            if use_split:
                vis_bias = masking.visibility_bias(visible, prefix_len=c_len)
                enc_bias = vis_bias if bias is None else bias + vis_bias
            h = self._stack("enc_layers", h, enc_bias, qparams, calibrate, stats, rope,
                            enc_cache, cache_index)
            if use_split:
                vis = visible[..., None].to(h.dtype)
                tail = h[:, c_len:] * vis + x_tokens.to(h.dtype) * (1.0 - vis)
                h = tail if c is None else torch.cat([h[:, :c_len], tail], dim=1)
        h = self._stack("dec_layers", h, bias, qparams, calibrate, stats, rope, dec_cache,
                        cache_index)
        out = h if c is None else h[:, c_len:]
        return layer_norm(out, self.norm, TORCH_LN_EPS), (stats if calibrate else None)

    def init_caches(self, batch: int, max_len: int, dtype=torch.float32
                    ) -> Tuple[KVCache, KVCache]:
        """Stacked (layers, B, H, S, D) caches of the (encoder, decoder)
        halves, zero, on the model's device."""
        dev = self.norm.weight.device
        hd = self.embed_dim // self.num_heads
        return tuple(KVCache.create(batch, self.num_heads, max_len, hd, dtype, n, dev)
                     for n in (self.enc_depth, self.depth - self.enc_depth))
