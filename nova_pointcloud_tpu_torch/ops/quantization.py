"""Int8 (w8a8) quantization for serving, as plain torch.

Port of ``nova_pointcloud_tpu/ops/quantization.py``: the PreLN-block
(point-cloud), ViT-block and DiffusionMLP-block branches of
``quantize_serving_params``, and the calibration merge. Symmetric
quantization:

    y = (q(x) @ q(W)) * s_x * s_w,   q(v) = round(v / s) in [-127, 127]

Weights are quantized once per output channel ((in, out) layout, as the JAX
kernels take them); activations per row at run time. Rounding is
half-to-even (``torch.round``), values clip to +-127.

Integer products here are the plain reference, not a kernel: they run as a
float64 matmul, which is exact for int8 operands at any width this model has
(|sum| <= 127^2 * K < 2^53), on the CPU and on the card alike.
"""

from typing import Tuple

import torch

ACT_SITE_NAMES = (
    "a_ln1", "a_av", "a_ln2", "a_mid",  # PreLNBlock (models/pointcloud.py)
    "a_x", "a_gelu",                    # ViT Block MLP
    "a_z", "a_h", "a_silu",             # DiffusionBlock
    "a_q", "a_k",                       # q/k amax (int8 static score core)
    "a_smax",                           # max attention logit: a softmax
)                                       # offset, NOT an amax (no margin)

# q/k amax is content-sensitive; extra serving headroom (see the JAX module)
QK_EXTRA_MARGIN = 1.2


def int_dot(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> integer-valued float32 product ``a8 @ b8``.

    Equals ``dot_general(..., preferred_element_type=int32).astype(f32)``:
    the float64 sum is exact and rounds once to float32, as int32 -> f32
    does."""
    return torch.matmul(a8.double(), b8.double()).float()


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 quantization of (in, out) kernels."""
    w = w.float()
    amax = torch.amax(torch.abs(w), dim=0)
    scales = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(w / scales), -127, 127).to(torch.int8)
    return q, scales


def quantize_weight_nd(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """quantize_weight for kernels with leading stack axes: (..., in, out) ->
    int8 (..., in, out) + scales (..., out)."""
    w = w.float()
    amax = torch.amax(torch.abs(w), dim=-2, keepdim=True)
    scales = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(w / scales), -127, 127).to(torch.int8)
    return q, scales.squeeze(-2)


def quantize_activations(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last-dim) symmetric int8 quantization: divides by the scale."""
    x = x.float()
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scales = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(x / scales), -127, 127).to(torch.int8)
    return q, scales


def quantize_static(x: torch.Tensor, amax) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor int8 with a calibrated amax: MULTIPLIES by the reciprocal
    of ``max(amax/127, 1e-8)``, as the JAX kernels' ``_quant_static``."""
    s = torch.clamp(torch.as_tensor(amax, dtype=torch.float32,
                                    device=x.device) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(x.float() * (1.0 / s)), -127, 127).to(torch.int8)
    return q, s


def int8_matmul(x: torch.Tensor, wq: Tuple[torch.Tensor, torch.Tensor],
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """x (..., in) @ int8 weights -> (..., out), per-row activation quant."""
    values, scales = wq
    xq, sx = quantize_activations(x)
    acc = int_dot(xq, values)
    return (acc * sx * scales).to(out_dtype)


def quantize_weight_kmajor(w_out_in: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_weight_nd(w_out_in.transpose(-1, -2))`` from a torch
    (..., out, in) weight, laid out K-major: the int8 result has the (..., in,
    out) shape and values of the JAX tree, with ``in`` contiguous, which is
    the layout the CUDA kernels read (no per-call transpose)."""
    w = w_out_in.float()
    amax = torch.amax(torch.abs(w), dim=-1, keepdim=True)
    scales = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(w / scales), -127, 127).to(torch.int8)
    return q.transpose(-1, -2), scales.squeeze(-1)


def stack_layers(leaves):
    """Stack per-layer leaves (or trees of them) on a new depth axis, keeping
    K-major int8 weights K-major."""
    if isinstance(leaves[0], dict):
        return {k: stack_layers([t[k] for t in leaves]) for k in leaves[0]}
    if leaves[0].dtype == torch.int8:
        return torch.stack([q.transpose(-1, -2) for q in leaves]).transpose(-1, -2)
    return torch.stack(leaves)


def _is_preln_block(module) -> bool:
    return all(hasattr(module, k) for k in ("attn", "fc1", "fc2", "norm1", "norm2"))


def _is_vit_block(module) -> bool:
    """A models/vit.Block (post-LN, MLP under ``mlp``)."""
    return (all(hasattr(module, k) for k in ("attn", "mlp", "norm1", "norm2"))
            and hasattr(module.mlp, "fc1"))


def _quantize_vit_block(block) -> dict:
    """ViT Block -> serving q-leaves: the fused post-LN MLP's weights and the
    attention's int8 qkv / out projections (nested under ``attn``)."""
    q = {}
    q["fc1_q"], q["fc1_s"] = quantize_weight_kmajor(block.mlp.fc1.weight)
    q["fc2_q"], q["fc2_s"] = quantize_weight_kmajor(block.mlp.fc2.weight)
    attn = {}
    attn["qkv_q"], attn["qkv_s"] = quantize_weight_kmajor(block.attn.qkv.weight)
    attn["proj_q"], attn["proj_s"] = quantize_weight_kmajor(block.attn.proj.weight)
    q["attn"] = attn
    return q


def _is_diffusion_block(module) -> bool:
    """A models/diffusion_mlp.DiffusionBlock."""
    return (all(hasattr(module, k) for k in ("norm1", "proj", "norm2"))
            and hasattr(module.proj, "fc1") and hasattr(module.norm1, "proj"))


def _quantize_diffusion_block(block) -> dict:
    """DiffusionBlock -> q-leaves for fused_int8_diffusion_block."""
    q = {}
    q["stats_q"], q["stats_s"] = quantize_weight_kmajor(block.norm1.proj.weight)
    q["fc1_q"], q["fc1_s"] = quantize_weight_kmajor(block.proj.fc1.weight)
    q["fc2_q"], q["fc2_s"] = quantize_weight_kmajor(block.proj.fc2.weight)
    return q




def _quantize_preln_block(block) -> dict:
    """One PreLNBlock -> the serving q-leaves read by the fused kernels:
    int8 (in, out) weights (K-major) and f32 per-channel scales."""
    a = block.attn
    wqkv = torch.cat([a.query.weight, a.key.weight, a.value.weight])  # (3D, D)
    q = {}
    q["wqkv_q"], q["wqkv_s"] = quantize_weight_kmajor(wqkv)
    q["out_q"], q["out_s"] = quantize_weight_kmajor(a.out.weight)
    q["fc1_q"], q["fc1_s"] = quantize_weight_kmajor(block.fc1.weight)
    q["fc2_q"], q["fc2_s"] = quantize_weight_kmajor(block.fc2.weight)
    return q


_BLOCK_KINDS = ((_is_preln_block, _quantize_preln_block),
                (_is_vit_block, _quantize_vit_block),
                (_is_diffusion_block, _quantize_diffusion_block))


@torch.no_grad()
def quantize_serving_params(module: torch.nn.Module) -> dict:
    """Build the "qparams" tree: pre-quantized int8 weights for every
    PreLNBlock, ViT Block and DiffusionBlock, at the block's module path.

    Mirrors the JAX tree: a ``ModuleList`` of blocks (the port's counterpart
    of the scanned stack) gives ``{"block": {leaf: (depth, ...)}}``, so the
    port's tree has the JAX tree's keys and shapes. Run once per pipeline
    call, outside the step loop."""
    for is_kind, quantize in _BLOCK_KINDS:
        if is_kind(module):
            return quantize(module)
    if isinstance(module, torch.nn.ModuleList):
        for is_kind, quantize in _BLOCK_KINDS:
            if len(module) and all(is_kind(m) for m in module):
                return {"block": stack_layers([quantize(m) for m in module])}
        return {}
    out = {}
    for name, child in module.named_children():
        sub = quantize_serving_params(child)
        if sub:
            out[name] = sub
    return out


def merge_act_scales(qparams, act_stats, margin: float = 1.0):
    """Fold a calibration run's activation stats into a qparams tree.

    ``a_smax`` is a logit (no margin); ``a_q``/``a_k`` take the extra q/k
    margin; every other site takes ``margin``."""

    def merge(q, s):
        if not isinstance(s, dict):
            return q
        out = dict(q) if isinstance(q, dict) else {}
        for k, v in s.items():
            if k in ACT_SITE_NAMES:
                if k == "a_smax":
                    m = 1.0
                elif k in ("a_q", "a_k"):
                    m = margin * QK_EXTRA_MARGIN
                else:
                    m = margin
                out[k] = torch.as_tensor(v, dtype=torch.float32) * m
            else:
                out[k] = merge(out.get(k, {}), v)
        return out

    return merge(qparams, act_stats)


def max_merge_stats(a, b):
    """Running max of two act_stats trees; a key in only one tree is kept."""
    if isinstance(a, dict) or isinstance(b, dict):
        out = {}
        for k in set(a) | set(b):
            if k in a and k in b:
                out[k] = max_merge_stats(a[k], b[k])
            else:
                out[k] = a[k] if k in a else b[k]
        return out
    return torch.maximum(a, b)
