"""Point-cloud diffusion transformer (port of
``nova_pointcloud_tpu/models/pointcloud.py``: DepthAwarePosEncoding,
ClusterBlock, PreLNBlock, BlockStack, NOVAPointCloudTransformer, and the
refinement modules of the dynamic-partition AR mode: EdgeAligner,
ARSubsetDiffusion, ARRefiner).

Serving (``deterministic=True``, the default) runs without autograd;
training (``deterministic=False``) is differentiable and applies
the flax model's dropout: after the ClusterBlock's first LayerNorm + relu
(rate 0.1, fixed), on each block's attention weights (one keep mask of
shape (1, 1, Lq, Lk) shared by every batch element and head, flax's
``broadcast_dropout``), on both residual branches and on the MLP's hidden
activation (rate ``dropout``). Masks are Bernoulli draws from a
``torch.Generator`` (or given, as the tests give JAX's); with live dropout
the attention runs the plain core, as the JAX adapter sends it to
``nn.dot_product_attention``. ``remat`` recomputes each block in the
backward (``torch.utils.checkpoint``); each block's masks come from a seed
drawn before the block runs, so the recompute draws the same masks.

Module and parameter names
follow the flax tree (``models/convert.py`` maps one onto the other):
``nn.Linear`` holds flax's ``Dense`` kernel transposed, ``nn.LayerNorm``
(eps 1e-6, flax's default) its ``scale``/``bias``, and each
``MultiHeadAttention`` projection the flax ``(D, H, hd)`` kernel flattened.

``dtype`` is the compute dtype, as the flax modules' ``dtype``: ``None``
promotes inputs and parameters, ``torch.bfloat16`` is the serving setting
on the card. A ``PreLNBlock`` has three forwards:

- the float path (``forward`` with no qparams), its attention routed by
  ``attn_impl`` through ``ops/attention.py`` (the flash kernel from 1024
  keys on the card);
- the int8 serving path (``forward`` with the block's qparams), through the
  fused kernels of ``ops/kernels/fused_block.py``: the one-kernel attention
  sub-block where the JAX model takes it, else the split path (LN + QKV
  kernel, plain attention core, out-projection + residual kernel), then the
  MLP kernel;
- ``calibration_forward``, the plain mirror of the int8 path that records
  the activation ranges of its quant sites.
"""

from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from nova_pointcloud_tpu_torch.models.embeddings import timestep_freq_embed
from nova_pointcloud_tpu_torch.models.layers import _compute_dtype, dense, silu
from nova_pointcloud_tpu_torch.ops.attention import (dot_product_attention,
                                                     make_attention_fn)
from nova_pointcloud_tpu_torch.ops.kernels import fused_block
from nova_pointcloud_tpu_torch.ops.kernels.fused_block import (
    fused_attention_block, fused_ln_int8_matmul, fused_ln_int8_mlp,
    int8_matmul_residual)
from nova_pointcloud_tpu_torch.ops.pointops import cdist, knn
from nova_pointcloud_tpu_torch.ops.quantization import (
    int8_matmul, quantize_serving_params, quantize_weight)
from nova_pointcloud_tpu_torch.utils.device import resolve_device

# name -> (depth, embed_dim, num_heads), as the JAX registry
PC_ARCHES = {
    "pc_d8w768": (8, 768, 12),
    "pc_d32w768": (32, 768, 12),
    "pc_d32w1024": (32, 1024, 16),
    "pc_d32w1536": (32, 1536, 16),
    "pc_d48w768": (48, 768, 12),
    "pc_d48w1024": (48, 1024, 16),
    "pc_d48w1536": (48, 1536, 16),
    "pc_d2w64": (2, 64, 2),  # tests
    "pc_d4w256": (4, 256, 4),  # conditioning micro-A/B
}
LN_EPS = 1e-6
FUSED_ATTENTION_MAX_BYTES = 14 * 2**20  # the JAX model's fused / split rule
CLUSTER_DROPOUT = 0.1  # the JAX ClusterBlock's rate, whatever the model's dropout
BLOCK_DROPOUT_SITES = ("attn", "resid1", "mlp", "resid2")


def dropout_keep(generator: Optional[torch.Generator], shape, rate: float,
                 device) -> Optional[torch.Tensor]:
    """A keep mask (bool, ``shape``) with P(keep) = 1 - rate, drawn by
    ``torch.bernoulli`` from ``generator``; None at rate 0 (no dropout)."""
    if rate == 0.0:
        return None
    if generator is None:
        raise ValueError("live dropout needs a generator or given masks")
    p = torch.full(tuple(shape), 1.0 - rate, device=device)
    return torch.bernoulli(p, generator=generator).bool()


def apply_dropout(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """flax ``Dropout``: ``where(keep, x / (1 - rate), 0)``."""
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def attention_dropout_multiplier(keep: Optional[torch.Tensor], rate: float,
                                 dtype: torch.dtype) -> Optional[torch.Tensor]:
    """flax's attention-dropout multiplier ``keep / keep_prob`` in ``dtype``
    from a (1, 1, Lq, Lk) keep mask; it scales the attention weights of
    every batch element and head alike."""
    if keep is None:
        return None
    return keep.to(dtype) / torch.tensor(1.0 - rate, dtype=dtype, device=keep.device)


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm, dtype=None) -> torch.Tensor:
    """flax ``LayerNorm``: statistics in float32, eps 1e-6."""
    dt = _compute_dtype(x, norm.weight, dtype)
    y = F.layer_norm(x.float(), (x.shape[-1],), norm.weight.float(),
                     norm.bias.float(), LN_EPS)
    return y.to(dt)


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention``: self-attention, or with
    ``kv`` attention of the queries ``x`` over the keys / values ``kv``.

    ``attn_impl``: the dispatcher policy of ``ops/attention.py`` ("auto",
    "pallas", "sdpa" / "xla"); ``None`` is flax's default core with no
    dispatcher (the ClusterBlock's 8-token attention, the AR refiner's
    masked attentions). A ``mask`` (True = attend, broadcast to (B, H, Lq,
    Lk)) sets the masked logits to the most negative float, as flax does,
    not to -inf: a query with every key masked gets a uniform softmax, not
    NaN."""

    def __init__(self, dim: int, num_heads: int, device=None,
                 attn_impl: Optional[str] = None):
        super().__init__()
        self.num_heads = num_heads
        self.attention_fn = (dot_product_attention if attn_impl is None
                             else make_attention_fn(attn_impl))
        self.query = nn.Linear(dim, dim, device=device)
        self.key = nn.Linear(dim, dim, device=device)
        self.value = nn.Linear(dim, dim, device=device)
        self.out = nn.Linear(dim, dim, device=device)

    def forward(self, x: torch.Tensor, dtype=None,
                dropout_mult: Optional[torch.Tensor] = None,
                kv: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``dropout_mult``: the attention-dropout multiplier (training)."""
        kv = x if kv is None else kv
        b, t, d = x.shape
        hd = d // self.num_heads
        q = dense(x, self.query, dtype).reshape(b, t, self.num_heads, hd)
        k = dense(kv, self.key, dtype).reshape(b, kv.shape[1], self.num_heads, hd)
        v = dense(kv, self.value, dtype).reshape(b, kv.shape[1], self.num_heads, hd)
        out = self.attention_fn(q, k, v, mask=mask, dropout_mult=dropout_mult)
        return dense(out.reshape(b, t, d), self.out, dtype)


class DepthAwarePosEncoding(nn.Module):
    """Sincos encoding of xyz with learnable per-axis scales."""

    def __init__(self, embed_dim: int, device=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.axis_scales = nn.Parameter(torch.ones(3, device=device))

    def forward(self, coords: torch.Tensor) -> torch.Tensor:
        scaled = coords * self.axis_scales.to(coords.dtype)
        d6 = self.embed_dim // 6
        div = 10000.0 ** (torch.arange(d6, dtype=torch.float32,
                                       device=coords.device) * 6 / self.embed_dim)
        parts = []
        for axis in range(3):
            angle = scaled[..., axis:axis + 1] / div
            parts += [torch.sin(angle), torch.cos(angle)]
        pe = torch.cat(parts, dim=-1)
        return F.pad(pe, (0, self.embed_dim - pe.shape[-1]))


class ClusterBlock(nn.Module):
    """Learnable soft spatial clustering: coords (B, N, 3) -> (B, 1, D)."""

    def __init__(self, embed_dim: int, num_heads: int, num_clusters: int = 8,
                 device=None):
        super().__init__()
        self.cluster_centers = nn.Parameter(torch.zeros(num_clusters, 3, device=device))
        self.feat_fc1 = nn.Linear(3, 64, device=device)
        self.feat_ln1 = nn.LayerNorm(64, eps=LN_EPS, device=device)
        self.feat_fc2 = nn.Linear(64, embed_dim, device=device)
        self.feat_ln2 = nn.LayerNorm(embed_dim, eps=LN_EPS, device=device)
        self.cluster_attn = MultiHeadAttention(embed_dim, num_heads, device)
        self.out_proj = nn.Linear(embed_dim, embed_dim, device=device)

    def forward(self, coords: torch.Tensor, dtype=None,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``keep``: the (B, K, 64) dropout keep mask after ``feat_ln1``
        (training), at rate ``CLUSTER_DROPOUT``."""
        dt = torch.promote_types(coords.dtype, self.cluster_centers.dtype)
        coords = coords.to(dt)
        centers = self.cluster_centers.to(dt)
        d = cdist(coords, centers[None].expand(coords.shape[0], -1, -1))
        w = torch.softmax(-d, dim=-1)  # (B, N, K)
        wsum = torch.sum(w, dim=1) + 1e-8  # (B, K)
        wcenters = torch.einsum("bnk,bnd->bkd", w, coords) / wsum[..., None]
        h = torch.relu(layer_norm(dense(wcenters, self.feat_fc1), self.feat_ln1))
        h = apply_dropout(h, keep, CLUSTER_DROPOUT)
        h = layer_norm(dense(h, self.feat_fc2), self.feat_ln2)
        h = self.cluster_attn(h, dtype)
        h = dense(h, self.out_proj, dtype)
        return torch.mean(h, dim=1, keepdim=True)


def _amax(v: torch.Tensor) -> torch.Tensor:
    return torch.amax(torch.abs(v)).float()


class PreLNBlock(nn.Module):
    """norm_first TransformerEncoderLayer equivalent (relu MLP); ``dropout``
    is the rate of its four dropout sites in training."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 attn_core: str = "bf16", device=None, attn_impl: str = "auto",
                 dropout: float = 0.1):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.num_heads, self.dropout = num_heads, dropout
        self.attn_core = attn_core
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.attn = MultiHeadAttention(dim, num_heads, device, attn_impl)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.fc1 = nn.Linear(dim, hidden, device=device)
        self.fc2 = nn.Linear(hidden, dim, device=device)

    def draw_dropout(self, generator: Optional[torch.Generator], x_shape,
                     device) -> Dict[str, Optional[torch.Tensor]]:
        """This block's keep masks for input shape (B, T, D), drawn in the
        order attention weights (1, 1, T, T), attention residual (B, T, D),
        MLP hidden (B, T, hidden), MLP residual (B, T, D)."""
        b, t, d = x_shape
        shapes = {"attn": (1, 1, t, t), "resid1": (b, t, d),
                  "mlp": (b, t, self.fc1.out_features), "resid2": (b, t, d)}
        return {site: dropout_keep(generator, shapes[site], self.dropout, device)
                for site in BLOCK_DROPOUT_SITES}

    def forward(self, x: torch.Tensor, qparams: Optional[Dict] = None,
                dtype=None, drop: Optional[Dict[str, Optional[torch.Tensor]]] = None
                ) -> torch.Tensor:
        """``drop``: keep masks by site (training; a missing site has no
        dropout)."""
        if qparams is not None:
            return self.int8_forward(x, qparams)
        drop = drop or {}
        h = layer_norm(x, self.norm1)
        mult = attention_dropout_multiplier(drop.get("attn"), self.dropout,
                                            _compute_dtype(h, self.attn.query.weight, dtype))
        h = self.attn(h, dtype, dropout_mult=mult)
        x = x + apply_dropout(h, drop.get("resid1"), self.dropout)
        h = layer_norm(x, self.norm2)
        h = apply_dropout(torch.relu(dense(h, self.fc1, dtype)), drop.get("mlp"), self.dropout)
        h = dense(h, self.fc2, dtype)
        return x + apply_dropout(h, drop.get("resid2"), self.dropout)

    def _qkv_bias(self) -> torch.Tensor:
        a = self.attn
        return torch.cat([a.query.bias, a.key.bias, a.value.bias])

    def int8_forward(self, x: torch.Tensor, q: Dict) -> torch.Tensor:
        """Serving path: the attention and MLP sub-blocks as fused int8
        kernels, with this block's pre-quantized weights ``q`` (and its
        calibrated ``a_*`` scales, when present)."""
        x = self._int8_attention(x, q)
        return fused_ln_int8_mlp(
            x, self.norm2.weight, self.norm2.bias, q["fc1_q"], q["fc1_s"],
            self.fc1.bias, q["fc2_q"], q["fc2_s"], self.fc2.bias,
            a_in=q.get("a_ln2"), a_mid=q.get("a_mid"))

    def _int8_attention(self, x: torch.Tensor, q: Dict) -> torch.Tensor:
        b, t, d = x.shape
        if fused_block.attention_block_vmem_bytes(t, d) <= FUSED_ATTENTION_MAX_BYTES:
            return fused_attention_block(
                x, self.norm1.weight, self.norm1.bias, q["wqkv_q"], q["wqkv_s"],
                self._qkv_bias(), q["out_q"], q["out_s"], self.attn.out.bias,
                num_heads=self.num_heads, a_in=q.get("a_ln1"), a_av=q.get("a_av"),
                core=self.attn_core, a_smax=q.get("a_smax"))
        # long sequences (per-point tokens): the split path, as the JAX model.
        # Its two kernels quantize per row (the calibrated a_ln1 / a_av /
        # a_smax are unused here); the core between them is plain, in the
        # activation dtype throughout (scores and softmax too).
        qkv = fused_ln_int8_matmul(x, self.norm1.weight, self.norm1.bias,
                                   q["wqkv_q"], q["wqkv_s"], self._qkv_bias())
        hd = d // self.num_heads
        qh, kh, vh = [a.reshape(b, t, self.num_heads, hd)
                      for a in torch.chunk(qkv, 3, dim=-1)]
        scores = torch.einsum("bqhd,bkhd->bhqk", qh * (hd ** -0.5), kh)
        probs = torch.softmax(scores, dim=-1).to(vh.dtype)
        av = torch.einsum("bhqk,bkhd->bqhd", probs, vh).reshape(b, t, d)
        return int8_matmul_residual(av, x, q["out_q"], q["out_s"], self.attn.out.bias)

    def calibration_forward(self, x: torch.Tensor
                            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Plain mirror of the int8 serving path (per-row dynamic quant) that
        returns the per-site ranges: max|.| at the post-LN1 input
        (``a_ln1``), the attention output (``a_av``), the post-LN2 input
        (``a_ln2``), the post-relu mid (``a_mid``), and the max attention
        logit (``a_smax``)."""
        d, heads = x.shape[-1], self.num_heads
        a = self.attn
        stats = {}
        xf = x.float()
        h = layer_norm(xf, self.norm1)
        stats["a_ln1"] = _amax(h)
        wqkv = torch.cat([a.query.weight.t(), a.key.weight.t(),
                          a.value.weight.t()], dim=1)
        qkv = int8_matmul(h, quantize_weight(wqkv), torch.float32) \
            + self._qkv_bias().float()
        b, t, _ = qkv.shape
        hd = d // heads
        q, k, v = [c.reshape(b, t, heads, hd) for c in torch.chunk(qkv, 3, dim=-1)]
        logits = torch.einsum("bqhd,bkhd->bhqk", q * (hd ** -0.5), k)
        stats["a_smax"] = torch.amax(logits).float()
        probs = torch.softmax(logits, dim=-1)
        av = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t, d)
        stats["a_av"] = _amax(av)
        xf = xf + (int8_matmul(av, quantize_weight(a.out.weight.t()), torch.float32)
                   + a.out.bias.float())
        h2 = layer_norm(xf, self.norm2)
        stats["a_ln2"] = _amax(h2)
        m = torch.relu(int8_matmul(h2, quantize_weight(self.fc1.weight.t()),
                                   torch.float32) + self.fc1.bias.float())
        stats["a_mid"] = _amax(m)
        o = int8_matmul(m, quantize_weight(self.fc2.weight.t()), torch.float32) \
            + self.fc2.bias.float()
        return (xf + o).to(x.dtype), stats


BlockDraws = Union[int, Dict[str, Optional[torch.Tensor]]]


def _run_block(block: PreLNBlock, h: torch.Tensor, dtype, draws: BlockDraws) -> torch.Tensor:
    """One training block: its masks given, or drawn from a generator seeded
    with ``draws`` here, inside the (checkpointed) call, so that a recompute
    draws them again bitwise."""
    if isinstance(draws, int):
        g = torch.Generator(device=h.device).manual_seed(draws)
        draws = block.draw_dropout(g, h.shape, h.device)
    return block(h, None, dtype, draws)


class BlockStack(nn.Module):
    """Depth-stacked PreLN blocks: a Python loop over ``layers``.

    qparams / stats trees carry a leading depth axis under ``"block"``, as
    the JAX ``nn.scan`` stack's do. ``remat``: in training, each block is
    recomputed in the backward (``torch.utils.checkpoint``, non-reentrant),
    as the JAX stack's ``nn.remat``."""

    def __init__(self, depth: int, dim: int, num_heads: int,
                 attn_core: str = "bf16", device=None, attn_impl: str = "auto",
                 dropout: float = 0.1, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList(
            PreLNBlock(dim, num_heads, attn_core=attn_core, device=device,
                       attn_impl=attn_impl, dropout=dropout)
            for _ in range(depth))

    def forward(self, h: torch.Tensor, qparams: Optional[Dict] = None,
                dtype=None, drop: Optional[List[BlockDraws]] = None) -> torch.Tensor:
        """``drop``: training, one entry a block: its keep masks by site, or
        an int seed its masks are drawn from."""
        stacked = None if qparams is None else qparams["block"]
        for i, block in enumerate(self.layers):
            if drop is not None:
                if self.remat and torch.is_grad_enabled():
                    h = checkpoint(_run_block, block, h, dtype, drop[i], use_reentrant=False)
                else:
                    h = _run_block(block, h, dtype, drop[i])
                continue
            q = None if stacked is None else {k: v[i] for k, v in stacked.items()}
            h = block(h, q, dtype)
        return h

    def calibration_forward(self, h: torch.Tensor):
        per = []
        for block in self.layers:
            h, s = block.calibration_forward(h)
            per.append(s)
        return h, {"block": {k: torch.stack([s[k] for s in per]) for k in per[0]}}


class NOVAPointCloudTransformer(nn.Module):
    """Unified pc diffusion backbone; (B, N, 3) noisy points -> (B, N, 3) pred.

    ``quantize`` selects the int8 serving path (the fused kernels) for the
    block stack; its qparams come from the caller (the pipeline quantizes
    once per call) or are built in the forward. ``attn_impl`` is the float
    path's attention policy (ops/attention.py). ``dropout`` (the blocks'
    rate) and ``remat`` act in training only (``deterministic=False``).
    ``device``: ``cuda`` unless ``"cpu"`` is asked for (utils/device.py)."""

    def __init__(self, arch: str = "pc_d8w768", point_cloud_size: int = 2048,
                 patch_size: int = 1, text_token_dim: Optional[int] = None,
                 text_pool: str = "masked", num_clusters: int = 8,
                 use_depth_pe: bool = False, dropout: float = 0.1, remat: bool = False,
                 quantize: bool = False, attn_impl: str = "auto", attn_core: str = "bf16",
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        if arch not in PC_ARCHES:
            raise KeyError(f"unknown pc arch {arch!r}; known: {sorted(PC_ARCHES)}")
        if text_pool not in ("masked", "mean"):
            raise ValueError(f"text_pool must be 'masked' or 'mean', got {text_pool!r}")
        dev = resolve_device(device)
        depth, dim, heads = PC_ARCHES[arch]
        self.arch, self.patch_size = arch, patch_size
        self.point_cloud_size = point_cloud_size
        self.text_token_dim, self.text_pool = text_token_dim, text_pool
        self.quantize, self.attn_core, self.dtype = quantize, attn_core, dtype
        self.attn_impl, self.dropout, self.remat = attn_impl, dropout, remat
        self.point_embed = nn.Linear(patch_size * 3, dim, device=dev)
        self.pos_embed = nn.Parameter(torch.zeros(1, self.num_tokens, dim, device=dev))
        self.depth_pe = DepthAwarePosEncoding(dim, dev) if use_depth_pe else None
        self.cluster = ClusterBlock(dim, heads, num_clusters, dev)
        self.time_fc1 = nn.Linear(256, dim, device=dev)
        self.time_fc2 = nn.Linear(dim, dim, device=dev)
        self.text_embed = (nn.Linear(text_token_dim, dim, device=dev)
                           if text_token_dim else None)
        self.blocks = BlockStack(depth, dim, heads, attn_core, dev, attn_impl, dropout, remat)
        self.final_norm = nn.LayerNorm(dim, eps=LN_EPS, device=dev)
        self.output_proj = nn.Linear(dim, patch_size * 3, device=dev)

    @property
    def num_tokens(self) -> int:
        return self.point_cloud_size // self.patch_size

    @property
    def device(self) -> torch.device:
        return self.pos_embed.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "NOVAPointCloudTransformer":
        """Seeded random init after the flax initializers: Dense kernels
        lecun-normal (std 1/sqrt(fan_in), untruncated), zero biases, unit
        LayerNorms, pos_embed N(0, 0.02), cluster centers N(0, 0.1), and the
        zero-init output head. ``generator`` lives on the model's device."""
        def normal(p, std):
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device,
                                dtype=torch.float32) * std)

        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                normal(mod.weight, mod.in_features ** -0.5)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        normal(self.pos_embed, 0.02)
        normal(self.cluster.cluster_centers, 0.1)
        if self.depth_pe is not None:
            self.depth_pe.axis_scales.fill_(1.0)
        self.output_proj.weight.zero_()
        return self

    def _embed(self, x: torch.Tensor, timestep: torch.Tensor,
               text_embeds: Optional[torch.Tensor],
               cluster_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.dtype
        b, n, _ = x.shape
        p = self.patch_size
        tok = x.reshape(b, n // p, p * 3)
        coords = torch.mean(x.reshape(b, n // p, p, 3), dim=2)  # patch centers
        h = dense(tok, self.point_embed, dt)
        h = h + self.pos_embed[:, : h.shape[1]].to(h.dtype)
        if self.depth_pe is not None:
            h = h + self.depth_pe(coords).to(h.dtype)
        h = h + self.cluster(coords, dt, cluster_keep).to(h.dtype)
        t_freq = timestep_freq_embed(timestep.float(), 256)
        t_emb = dense(t_freq.to(h.dtype), self.time_fc1, dt)
        t_emb = dense(F.silu(t_emb), self.time_fc2, dt)
        h = h + t_emb[:, None, :]
        if text_embeds is not None and self.text_embed is not None:
            t = dense(text_embeds, self.text_embed, dt)
            if self.text_pool == "masked":
                # pool over real token slots (encoders pad with zero rows)
                live = torch.any(text_embeds != 0, dim=-1, keepdim=True).to(t.dtype)
                denom = torch.clamp(torch.sum(live, dim=1, keepdim=True), min=1.0)
                pooled = torch.sum(t * live, dim=1, keepdim=True) / denom
            else:
                pooled = torch.mean(t, dim=1, keepdim=True)
            h = h + pooled
        return h

    def _head(self, h: torch.Tensor, shape) -> torch.Tensor:
        h = layer_norm(h, self.final_norm, self.dtype)
        return dense(h, self.output_proj, self.dtype).reshape(shape).float()

    def draw_dropout(self, generator: Optional[torch.Generator], batch: int
                     ) -> Dict[str, object]:
        """One training forward's dropout draws from ``generator``: the
        ClusterBlock's (B, K, 64) keep mask, then one seed a block (none at
        ``dropout`` 0)."""
        cluster = dropout_keep(generator, (batch, self.cluster.cluster_centers.shape[0],
                                           self.cluster.feat_fc1.out_features),
                               CLUSTER_DROPOUT, self.device)
        depth = len(self.blocks.layers)
        if self.dropout == 0.0:
            return {"cluster": cluster, "blocks": [{} for _ in range(depth)]}
        if generator is None:
            raise ValueError("live dropout needs a generator or given masks")
        seeds = torch.randint(0, 2 ** 62, (depth,), generator=generator,
                              device=generator.device).tolist()
        return {"cluster": cluster, "blocks": seeds}

    def forward(self, x: torch.Tensor, timestep: torch.Tensor,
                text_embeds: Optional[torch.Tensor] = None,
                qparams: Optional[Dict] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                dropout_masks: Optional[Dict] = None) -> torch.Tensor:
        """``qparams``: the tree of ``quantize_serving_params`` (optionally
        merged with calibrated act scales); used when ``quantize`` is set.

        ``deterministic=False`` is the training forward (the JAX model's
        ``deterministic=False``): differentiable, with dropout drawn from
        ``generator`` (:meth:`draw_dropout`) unless ``dropout_masks`` gives
        them: ``{"cluster": (B, K, 64) keep mask or None, "blocks": one
        entry a block, its keep masks by site (``BLOCK_DROPOUT_SITES``) or
        an int seed}``."""
        if not deterministic:
            return self._train_forward(x, timestep, text_embeds, generator, dropout_masks)
        with torch.no_grad():
            return self._serve(x, timestep, text_embeds, qparams)

    def _train_forward(self, x, timestep, text_embeds, generator, dropout_masks):
        if self.quantize:
            raise ValueError("the training forward runs the float model (quantize=False)")
        if dropout_masks is None:
            dropout_masks = self.draw_dropout(generator, x.shape[0])
        h = self._embed(x, timestep, text_embeds, dropout_masks.get("cluster"))
        h = self.blocks(h, None, self.dtype, drop=dropout_masks["blocks"])
        return self._head(h, x.shape)

    def _serve(self, x, timestep, text_embeds, qparams):
        h = self._embed(x, timestep, text_embeds)
        if self.quantize:
            if qparams is None:
                qparams = quantize_serving_params(self)
            h = self.blocks(h, qparams["blocks"]["layers"], self.dtype)
        else:
            h = self.blocks(h, None, self.dtype)
        return self._head(h, x.shape)

    @torch.no_grad()
    def calibration_forward(self, x: torch.Tensor, timestep: torch.Tensor,
                            text_embeds: Optional[torch.Tensor] = None):
        """Forward through the blocks' calibration mirrors; returns the
        prediction and the act-stats tree (``{"blocks": {"layers":
        {"block": {site: (depth,)}}}}``, the JAX collection's layout)."""
        h = self._embed(x, timestep, text_embeds)
        h, stats = self.blocks.calibration_forward(h)
        return self._head(h, x.shape), {"blocks": {"layers": stats}}


class EdgeAligner(nn.Module):
    """Cross-subset boundary blending: each point's edge feature is its
    feature minus the mean of its k nearest neighbours' (``k = min(8, N)``,
    the kNN over all the points given, including not-yet-generated ones);
    the current subset attends over the neighbour subsets' edge features,
    masked by ``neigh_valid``, plus a linear lift of its xyz."""

    def __init__(self, embed_dim: int, num_heads: int = 8, k: int = 8, device=None):
        super().__init__()
        self.k = k
        self.biattn = MultiHeadAttention(embed_dim, num_heads, device)
        self.spatial_embed = nn.Linear(3, embed_dim, device=device)

    def edge_features(self, points: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
        k = min(self.k, points.shape[1])
        _, idx = knn(points, points, k)  # (B, N, k)
        rows = torch.arange(feats.shape[0], device=feats.device)[:, None, None]
        neigh = feats[rows, idx]  # (B, N, k, D)
        return feats - torch.mean(neigh, dim=2)

    def forward(self, cur_points: torch.Tensor, cur_feats: torch.Tensor,
                neigh_points: torch.Tensor, neigh_feats: torch.Tensor,
                neigh_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        cur_edge = self.edge_features(cur_points, cur_feats)
        neigh_edge = self.edge_features(neigh_points, neigh_feats)
        mask = None if neigh_valid is None else neigh_valid[:, None, None, :] > 0
        aligned = self.biattn(cur_edge, kv=neigh_edge, mask=mask)
        return aligned + dense(cur_points, self.spatial_embed)


class ARSubsetDiffusion(nn.Module):
    """Subset-level AR conditioning: a context token (the masked mean of the
    generated subsets' self-attention), the edge alignment against them
    (both gated off while nothing is generated) and a progress embedding,
    added to the current subset's features."""

    def __init__(self, embed_dim: int, num_heads: int = 12, device=None):
        super().__init__()
        self.biattn = MultiHeadAttention(embed_dim, num_heads, device)
        self.time_fc1 = nn.Linear(1, embed_dim, device=device)
        self.time_fc2 = nn.Linear(embed_dim, embed_dim, device=device)
        self.edge_aligner = EdgeAligner(embed_dim, 8, device=device)

    def forward(self, cur_feats: torch.Tensor, gen_feats: torch.Tensor, progress: torch.Tensor,
                cur_points: torch.Tensor, gen_points: torch.Tensor,
                gen_valid: torch.Tensor) -> torch.Tensor:
        """cur_feats (B, S, D); gen_feats (B, M, D), gen_valid (B, M);
        progress (B,). Returns (B, S, D)."""
        valid = gen_valid > 0
        mask = valid[:, None, None, :] & valid[:, None, :, None]
        agg = self.biattn(gen_feats, mask=mask)
        denom = torch.sum(gen_valid, dim=1, keepdim=True)[..., None] + 1e-8
        context = torch.sum(agg * gen_valid[..., None], dim=1, keepdim=True) / denom
        t_emb = dense(progress[..., None].to(cur_feats.dtype), self.time_fc1)
        t_emb = dense(silu(t_emb), self.time_fc2)
        aligned = self.edge_aligner(cur_points, cur_feats, gen_points, gen_feats, gen_valid)
        has_any = (torch.sum(gen_valid, dim=1) > 0).to(cur_feats.dtype)[:, None, None]
        out = cur_feats + aligned * has_any + context * has_any
        return out + t_emb[:, None, :]


class ARRefiner(nn.Module):
    """The subset AR refinement head of the dynamic-partition mode: lift the
    subset's points (one ``lift`` shared with the generated points),
    condition on the generated subsets (:class:`ARSubsetDiffusion`), run
    ``depth`` pre-LN blocks (dropout 0) and add a zero-initialised linear
    head's xyz to the input points. ``device``: ``cuda`` unless ``"cpu"``
    is asked for."""

    def __init__(self, embed_dim: int = 256, num_heads: int = 8, depth: int = 2, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.depth = depth
        self.lift = nn.Linear(3, embed_dim, device=dev)
        self.ar = ARSubsetDiffusion(embed_dim, num_heads, dev)
        for i in range(depth):
            self.add_module(f"blocks_{i}", PreLNBlock(embed_dim, num_heads, device=dev,
                                                      dropout=0.0))
        self.head = nn.Linear(embed_dim, 3, device=dev)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ARRefiner":
        """Seeded random init after the flax initializers (lecun-normal
        kernels, zero biases, unit LayerNorms) with the zero head."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator,
                                             device=mod.weight.device) * mod.in_features ** -0.5)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        self.head.weight.zero_()
        return self

    def forward(self, cur_points: torch.Tensor, gen_points: torch.Tensor,
                gen_valid: torch.Tensor, progress: torch.Tensor) -> torch.Tensor:
        """cur_points (B, S, 3), gen_points (B, M, 3), gen_valid (B, M),
        progress (B,) -> refined cur_points (B, S, 3)."""
        cur_feats = dense(cur_points, self.lift)
        gen_feats = dense(gen_points, self.lift)
        h = self.ar(cur_feats, gen_feats, progress, cur_points, gen_points, gen_valid)
        for i in range(self.depth):
            h = getattr(self, f"blocks_{i}")(h)
        delta = dense(h, self.head)
        return cur_points + delta.to(cur_points.dtype)
