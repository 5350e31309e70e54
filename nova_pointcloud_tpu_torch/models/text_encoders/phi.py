"""Phi-2 prompt encoder (port of
``nova_pointcloud_tpu/models/text_encoders/phi.py``).

A Phi decoder used as a prompt encoder: token embedding, blocks of parallel
attention and MLP behind one shared pre-LN, a partial rotary embedding on
the first ``rotary_dim`` dims of each head (HF's rotate-half layout), causal
attention with the padding keys masked, a final LN; the last hidden states
are the prompt embeddings. Head dim 80 (2560 / 32) is off the flash route,
as in the JAX package: the attention core is the plain ``sdpa``, whose
fully masked rows (an all-padding prompt) give zeros.

Module and parameter names follow the flax tree, so
``models/convert.convert_params`` carries a JAX param tree across (the
scanned ``layers/block/...`` becomes ``layers.{i}....``);
:func:`load_torch_phi_weights` maps HF ``PhiModel`` / ``PhiForCausalLM``
names straight onto the port's state-dict keys. :class:`PhiTextEncoder`
wraps a tokenizer (any object with the HF call signature) and the model
behind ``encode(prompts) -> (embeds, lengths)``, the API of
``DummyTextEncoder``.
"""

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nova_pointcloud_tpu_torch.models.layers import dense, layer_norm
from nova_pointcloud_tpu_torch.ops.attention import sdpa
from nova_pointcloud_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class PhiConfig:
    """The HF PhiConfig fields the encoder needs (phi-2 defaults)."""

    vocab_size: int = 51200
    hidden_size: int = 2560
    intermediate_size: int = 10240
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    partial_rotary_factor: float = 0.4
    rope_theta: float = 10000.0
    layer_norm_eps: float = 1e-5
    max_position_embeddings: int = 2048

    @classmethod
    def from_hf(cls, config: Dict) -> "PhiConfig":
        """The fields of an HF ``config.json`` that this config has."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in config.items() if k in names})

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.partial_rotary_factor)


def _phi_rope(positions: torch.Tensor, rotary_dim: int, theta: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos / sin tables (L, rotary_dim) in HF's half-split layout."""
    exps = torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                        device=positions.device) / rotary_dim
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=positions.device),
                          exps)
    angle = positions[:, None].float() * inv  # (L, rd / 2)
    emb = torch.cat([angle, angle], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _apply_phi_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                    rotary_dim: int) -> torch.Tensor:
    """Rotate the first ``rotary_dim`` dims of (B, H, L, hd) x (HF
    rotate_half); cos and sin are cast to x's dtype before the products."""
    rot, rest = x[..., :rotary_dim], x[..., rotary_dim:]
    half = rotary_dim // 2
    rotated = torch.cat([-rot[..., half:], rot[..., :half]], dim=-1)
    rot = rot * cos.to(x.dtype) + rotated * sin.to(x.dtype)
    return torch.cat([rot, rest], dim=-1)


class PhiAttention(nn.Module):
    def __init__(self, config: PhiConfig):
        super().__init__()
        self.config = config
        d = config.hidden_size
        self.q_proj, self.k_proj, self.v_proj, self.dense = (nn.Linear(d, d) for _ in range(4))

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, l, _ = x.shape
        shape = (b, l, cfg.num_attention_heads, cfg.head_dim)
        q, k, v = (dense(x, lin).reshape(shape).transpose(1, 2)
                   for lin in (self.q_proj, self.k_proj, self.v_proj))
        cos, sin = _phi_rope(torch.arange(l, device=x.device), cfg.rotary_dim, cfg.rope_theta)
        q = _apply_phi_rope(q, cos, sin, cfg.rotary_dim)
        k = _apply_phi_rope(k, cos, sin, cfg.rotary_dim)
        o = sdpa(q, k, v, mask_bias).transpose(1, 2).reshape(b, l, cfg.hidden_size)
        return dense(o, self.dense)


class PhiBlock(nn.Module):
    """Parallel attention + MLP with one shared input LN."""

    def __init__(self, config: PhiConfig):
        super().__init__()
        self.config = config
        d = config.hidden_size
        self.input_layernorm = nn.LayerNorm(d, eps=config.layer_norm_eps)
        self.self_attn = PhiAttention(config)
        self.fc1 = nn.Linear(d, config.intermediate_size)
        self.fc2 = nn.Linear(config.intermediate_size, d)

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor) -> torch.Tensor:
        h = layer_norm(x, self.input_layernorm, self.config.layer_norm_eps)
        attn = self.self_attn(h, mask_bias)
        m = dense(F.gelu(dense(h, self.fc1), approximate="tanh"), self.fc2)
        return x + attn + m


class PhiEncoderModel(nn.Module):
    """Token ids -> last hidden states, computed in the weights' dtype
    (float32 as served). ``device``: ``cuda`` unless ``"cpu"`` is asked
    for."""

    def __init__(self, config: PhiConfig = PhiConfig(), device=None):
        super().__init__()
        self.config = config
        with torch.device(resolve_device(device)):
            self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size)
            self.layers = nn.ModuleList(PhiBlock(config)
                                        for _ in range(config.num_hidden_layers))
            self.final_layernorm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.weight.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "PhiEncoderModel":
        """Seeded random init after the flax initializers: Dense kernels
        normal with std 1/sqrt(fan_in), zero biases, the embedding normal
        with std 1/sqrt(hidden) (flax ``Embed``'s), unit LayerNorms.
        ``generator`` lives on the model's device."""
        def normal(p, std):
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device,
                                dtype=torch.float32) * std)

        normal(self.embed_tokens.weight, self.config.hidden_size ** -0.5)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                normal(mod.weight, mod.in_features ** -0.5)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        return self

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """input_ids (B, L) int; attention_mask (B, L), 0 = padding."""
        cfg = self.config
        dev = self.device
        input_ids = torch.as_tensor(input_ids, device=dev)
        x = F.embedding(input_ids.long(), self.embed_tokens.weight)
        l = input_ids.shape[1]
        causal = torch.ones((l, l), dtype=torch.bool, device=dev).tril()
        bias = torch.zeros((l, l), device=dev).masked_fill(~causal, -math.inf)[None, None]
        if attention_mask is not None:
            keep = torch.as_tensor(attention_mask, device=dev) > 0
            key_bias = torch.zeros(keep.shape, device=dev).masked_fill(~keep, -math.inf)
            bias = bias + key_bias[:, None, None, :]
        for block in self.layers:
            x = block(x, bias)
        return layer_norm(x, self.final_layernorm, cfg.layer_norm_eps)


def load_torch_phi_weights(model: PhiEncoderModel, state_dict) -> Dict[str, torch.Tensor]:
    """A HF Phi state_dict (``model.embed_tokens`` / ``model.layers.N.
    {input_layernorm, self_attn.{q,k,v}_proj, self_attn.dense, mlp.fc1,
    mlp.fc2}`` / ``model.final_layernorm``; torch tensors or numpy) -> the
    port model's state_dict, float32, for ``model.load_state_dict``. A bare
    ``PhiModel`` save, whose names lack the ``model.`` prefix that
    ``PhiForCausalLM`` checkpoints carry, is read the same."""
    bare = not any(k.startswith("model.") for k in state_dict)

    def get(name):
        t = state_dict[name[len("model."):] if bare else name]
        if isinstance(t, torch.Tensor):
            return t.detach().float().cpu()
        return torch.from_numpy(np.asarray(t, np.float32))

    out = {"embed_tokens.weight": get("model.embed_tokens.weight")}
    for pname in ("weight", "bias"):
        out[f"final_layernorm.{pname}"] = get(f"model.final_layernorm.{pname}")
        for i in range(model.config.num_hidden_layers):
            src, dst = f"model.layers.{i}", f"layers.{i}"
            out[f"{dst}.input_layernorm.{pname}"] = get(f"{src}.input_layernorm.{pname}")
            for proj in ("q_proj", "k_proj", "v_proj", "dense"):
                out[f"{dst}.self_attn.{proj}.{pname}"] = get(f"{src}.self_attn.{proj}.{pname}")
            for fc in ("fc1", "fc2"):
                out[f"{dst}.{fc}.{pname}"] = get(f"{src}.mlp.{fc}.{pname}")
    return out


class PhiTextEncoder:
    """Tokenizer + encoder behind ``encode(prompts) -> (embeds, lengths)``:
    prompts padded (and truncated) to ``num_tokens``, float32 hidden states
    (B, num_tokens, hidden) and the prompts' token counts (B,) int32, both
    numpy. The model runs where its weights live."""

    def __init__(self, model: PhiEncoderModel, tokenizer, num_tokens: int = 256):
        self.model, self.tokenizer, self.num_tokens = model, tokenizer, num_tokens

    @property
    def host_offload(self) -> bool:
        return False

    @host_offload.setter
    def host_offload(self, value: bool) -> None:
        if value:
            raise NotImplementedError("host offload of the text encoder's weights is not "
                                      "ported yet: ROADMAP.md, module queue, parallelism "
                                      "and infra")

    @torch.no_grad()
    def encode(self, prompts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        enc = self.tokenizer(list(prompts), padding="max_length", truncation=True,
                             max_length=self.num_tokens, return_tensors="np")
        mask = np.asarray(enc["attention_mask"])
        out = self.model(torch.from_numpy(np.asarray(enc["input_ids"], np.int64)),
                         torch.from_numpy(mask.astype(np.int64)))
        return out.float().cpu().numpy(), mask.sum(-1).astype(np.int32)

    def __call__(self, prompts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        return self.encode(prompts)
