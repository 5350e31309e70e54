"""Fused int8 serving kernels of the PreLN block, for Hopper.

Counterpart of ``nova_pointcloud_tpu/ops/pallas/fused_block.py``. Each TPU
kernel of the PreLN block's serving paths has here

- a wrapper with the JAX function's signature, which launches the CUDA
  kernel (``csrc/<name>.cu``, built at first use by ``_build.py``) for a
  CUDA tensor, and runs the plain version for a CPU tensor;
- a plain PyTorch version of the same function (``*_plain``), which the CPU
  tests hold against the JAX kernels in interpret mode and which
  ``chip_smoke.py`` holds the CUDA kernels against on the card;
- a launch count in ``LAUNCHES``, raised by one each time the wrapper
  launches its kernel and nowhere else.

A CUDA launch never falls back: a shape the kernel does not take raises.
``use_plain_kernels()`` routes CUDA tensors to the plain versions, to run a
whole path with and without its kernels; the pipeline never turns it on.

    fused_ln_int8_mlp:     y = x + (q8(relu((q8(LN(x)) @ W1)·sx·s1 + b1)) @ W2)·sx2·s2 + b2
    fused_attention_block: y = x + q8(softmax(q kᵀ/√hd) v) @ Wo·sxo·so + bo,
                           q|k|v = q8(LN(x)) @ Wqkv·sx·s + b
    fused_ln_int8_matmul:  y = (q8(LN(x)) @ W)·sx·s + b          (split path, QKV)
    int8_matmul_residual:  y = res + (q8(x) @ W)·sx·s + b        (split path, out)

and the NOVA blocks' kernels:

    fused_int8_mlp_postln:      y = x + LN_eps(q8(gelu(q8(x) @ W1·sx·s1 + b1)) @ W2·sa·s2 + b2)
    fused_int8_diffusion_block: (scale|shift|gate) = q8(silu(zc)) @ Ws·sz·ss + bs,
                                h = LN(x)·(1 + scale) + shift,
                                o = q8(silu(q8(h) @ W1·sh·s1 + b1)) @ W2·sa·s2 + b2,
                                y = LN_eps(o)·gate + x
    int8_linear:                y = cast(q8(x) @ W·sx·s) + cast(b)   (ViT attention
                                projections; plain XLA in the JAX model, no TPU kernel)

The pc blocks' LayerNorm eps is 1e-6 (flax's default); the NOVA kernels take
their post-norm eps from the caller (1e-5, torch's default, in the models) and
keep 1e-6 for the AdaLN. gelu is exact-erf gelu with erf by the
Abramowitz-Stegun polynomial of the JAX kernel (``_erf``), silu is
``x / (1 + exp(-x))``. Quant sites are static (calibrated amax, multiply by
1/s) when their ``a_*`` are given, else per row (divide by s); the two
split-path kernels and ``int8_linear`` quantize per row only. The JAX
functions' ``block_m`` (a TPU tile height) is dropped: the CUDA kernels mask
ragged rows themselves.
"""

import ctypes
import functools

import torch

from nova_pointcloud_tpu_torch.ops.kernels._launch import (  # noqa: F401
    LAUNCHES, dtype_flag as _dtype_flag, lib as _load_lib,
    plain_route as _plain_route,
    ptr as _ptr, reset_launch_counts, run as _run, sms as _sms, stream as _stream,
    use_plain_kernels)
from nova_pointcloud_tpu_torch.ops.quantization import (int8_matmul, int_dot,
                                                        quantize_activations,
                                                        quantize_static)

ATTN_CORES = ("f32", "bf16", "int8")  # index = the kernel's core code
LN_EPS = 1e-6


def _check_act_scales(**sites):
    """Calibrated static amax scalars must be given all-or-none per kernel."""
    given = {k: v is not None for k, v in sites.items()}
    if any(given.values()) and not all(given.values()):
        missing = [k for k, g in given.items() if not g]
        raise ValueError(
            f"static activation scales are all-or-none: got "
            f"{[k for k, g in given.items() if g]} but {missing} is None — "
            f"was this site recorded during pipeline.calibrate()?")


def attention_block_vmem_bytes(t: int, d: int, sb: int = 1) -> int:
    """The JAX kernel's per-program VMEM estimate, kept so the fused/split
    decision (fused when <= 14 MiB) is the JAX model's
    (models/pointcloud.PreLNBlock)."""
    return (sb * (4 * t * d          # x (f32 working copy)
                  + 4 * t * 3 * d    # dequantized qkv
                  + 4 * t * d)       # concatenated head outputs
            + 2 * 4 * t * t          # scores/probs in flight
            + 4 * d * d              # wqkv + wo int8
            + 4 * 10 * max(d, 128))  # scale/bias rows, sx columns, slack


# -- plain versions ------------------------------------------------------------

def _normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def _ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
        eps: float = LN_EPS) -> torch.Tensor:
    return _normalize(x, eps) * scale.float() + bias.float()


def _erf(x: torch.Tensor) -> torch.Tensor:
    """erf by Abramowitz-Stegun 7.1.26 (max error 1.5e-7), the JAX kernel's
    polynomial: the CUDA kernel uses it too, so both sides quantize the same
    gelu values."""
    sign = torch.sign(x)
    ax = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return sign * (1.0 - poly * torch.exp(-ax * ax))


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + _erf(x * (2.0 ** -0.5)))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x / (1.0 + torch.exp(-x))


def _quant(x: torch.Tensor, amax):
    return quantize_activations(x) if amax is None else quantize_static(x, amax)


def fused_ln_int8_mlp_plain(x, ln_scale, ln_bias, w1q, s1, b1, w2q, s2, b2,
                            a_in=None, a_mid=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_ln_int8_mlp`."""
    _check_act_scales(a_in=a_in, a_mid=a_mid)
    shape = x.shape
    xf = x.reshape(-1, shape[-1]).float()
    h = _ln(xf, ln_scale, ln_bias)
    q, sx = _quant(h, a_in)
    a = int_dot(q, w1q) * sx * s1.float() + b1.float()
    a = torch.clamp(a, min=0.0)  # relu
    q2, sx2 = _quant(a, a_mid)
    o = int_dot(q2, w2q) * sx2 * s2.float() + b2.float()
    return (xf + o).to(x.dtype).reshape(shape)


def _attn_core(q, k, v, scale: float, core: str, smax=None) -> torch.Tensor:
    """softmax(q kᵀ·scale) v over (..., T, hd), as the JAX _attn_core_head."""
    if core == "int8":
        q8, sq = quantize_activations(q * scale)
        k8, sk = quantize_activations(k)
        s = int_dot(q8, k8.transpose(-1, -2)) * sq * sk.transpose(-1, -2)
    elif core == "bf16":
        s = torch.matmul(q.to(torch.bfloat16).float(),
                         k.to(torch.bfloat16).float().transpose(-1, -2)) * scale
    else:
        s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if smax is None:
        p = torch.softmax(s, dim=-1)
    else:
        e = torch.exp(torch.clamp(s - smax, max=20.0))
        p = e / torch.clamp(torch.sum(e, dim=-1, keepdim=True), min=1e-30)
    if core == "int8":
        v8, sv = quantize_activations(v)
        p8, sp = quantize_activations(p * sv.transpose(-1, -2))
        return int_dot(p8, v8) * sp
    if core == "bf16":
        return torch.matmul(p.to(torch.bfloat16).float(), v.to(torch.bfloat16).float())
    return torch.matmul(p, v)


def fused_attention_block_plain(x, ln_scale, ln_bias, wqkv_q, wqkv_s, bqkv,
                                wo_q, wo_s, bo, num_heads: int, a_in=None,
                                a_av=None, core: str = "f32",
                                a_smax=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_attention_block`."""
    _check_act_scales(a_in=a_in, a_av=a_av)
    if core not in ATTN_CORES:
        raise ValueError(f"core must be one of {ATTN_CORES}, got {core!r}")
    b, t, d = x.shape
    hd = d // num_heads
    xf = x.reshape(b * t, d).float()
    h = _ln(xf, ln_scale, ln_bias)
    q8, sx = _quant(h, a_in)
    qkv = int_dot(q8, wqkv_q) * sx * wqkv_s.float() + bqkv.float()  # (b*t, 3d)
    q, k, v = qkv.reshape(b, t, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    smax = None if a_smax is None else torch.as_tensor(
        a_smax, dtype=torch.float32, device=x.device)
    av = _attn_core(q, k, v, hd ** -0.5, core, smax)  # (b, H, t, hd)
    av = av.permute(0, 2, 1, 3).reshape(b * t, d)
    q8o, sxo = _quant(av, a_av)
    o = int_dot(q8o, wo_q) * sxo * wo_s.float() + bo.float()
    return (xf + o).reshape(b, t, d).to(x.dtype)


def fused_ln_int8_matmul_plain(x, ln_scale, ln_bias, wq, s, b) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_ln_int8_matmul`."""
    xf = x.reshape(-1, x.shape[-1]).float()
    q, sx = quantize_activations(_ln(xf, ln_scale, ln_bias))
    y = int_dot(q, wq) * sx * s.float() + b.float()
    return y.to(x.dtype).reshape(x.shape[:-1] + (wq.shape[-1],))


def int8_matmul_residual_plain(x, residual, wq, s, b) -> torch.Tensor:
    """Plain PyTorch version of :func:`int8_matmul_residual`."""
    q, sx = quantize_activations(x.reshape(-1, x.shape[-1]))
    a = int_dot(q, wq) * sx * s.float() + b.float()
    rf = residual.reshape(-1, wq.shape[-1]).float()
    return (rf + a).to(residual.dtype).reshape(residual.shape)


def fused_int8_mlp_postln_plain(x, w1q, s1, b1, w2q, s2, b2, ln_scale, ln_bias,
                                a_x=None, a_gelu=None, ln_eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_int8_mlp_postln`."""
    _check_act_scales(a_x=a_x, a_gelu=a_gelu)
    shape = x.shape
    xf = x.reshape(-1, shape[-1]).float()
    q, sx = _quant(xf, a_x)
    a = gelu_erf(int_dot(q, w1q) * sx * s1.float() + b1.float())
    q2, sx2 = _quant(a, a_gelu)
    o = int_dot(q2, w2q) * sx2 * s2.float() + b2.float()
    o = _ln(o, ln_scale, ln_bias, ln_eps)
    return (xf + o).to(x.dtype).reshape(shape)


def fused_int8_diffusion_block_plain(x, zc, wstats_q, stats_s, stats_b, w1q, s1, b1,
                                     w2q, s2, b2, n2_scale, n2_bias, a_z=None, a_h=None,
                                     a_silu=None, n2_eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_int8_diffusion_block`."""
    _check_act_scales(a_z=a_z, a_h=a_h, a_silu=a_silu)
    shape, d = x.shape, x.shape[-1]
    xf = x.reshape(-1, d).float()
    z = silu(zc.reshape(-1, d).float())
    qz, sz = _quant(z, a_z)
    stats = int_dot(qz, wstats_q) * sz * stats_s.float() + stats_b.float()
    scale, shift, gate = stats[:, :d], stats[:, d:2 * d], stats[:, 2 * d:]
    h = _normalize(xf, LN_EPS) * (1.0 + scale) + shift  # AdaLN-zero: no affine
    qh, sh = _quant(h, a_h)
    a = silu(int_dot(qh, w1q) * sh * s1.float() + b1.float())
    qa, sa = _quant(a, a_silu)
    o = int_dot(qa, w2q) * sa * s2.float() + b2.float()
    o = _ln(o, n2_scale, n2_bias, n2_eps)
    return (o * gate + xf).to(x.dtype).reshape(shape)


def int8_linear_plain(x, wq, s, b=None, out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`int8_linear`."""
    out_dtype = out_dtype or x.dtype
    y = int8_matmul(x, (wq, s), out_dtype)
    return y if b is None else y + b.to(out_dtype)


# -- launch plans --------------------------------------------------------------

SMEM_LIMIT = 232448  # a block's shared memory on the H100
# csrc/int8_wgmma.cuh: output tiles of 128 x 256 (or 128 x 128), k-steps of
# 128 bytes through a ring of WG_STAGES stages (a 16 KB A tile and a W tile of
# the tile's width x 128 bytes each), a full and an empty mbarrier a stage, a
# tile's column scales and biases for each of the two consumer warpgroups,
# 1 KB to align the swizzled tiles; with a TMA-store epilogue (a bf16 output
# of EPI_STORE, EPI_CAST_BIAS or EPI_RESIDUAL) an mbarrier a consumer for
# the residual's load and each consumer's 64 x width bf16 output tile at a
# 1 KB boundary, and 3 stages for 256-wide tiles (4 do not fit)
WG_BLOCK_M, WG_BLOCK_N, WG_BLOCK_K, WG_STAGES = 128, 256, 128, 4
WG_BLOCK_NS = (256, 128)  # the tile widths the GEMM is built for


def _wg_layout(block_n: int, tma_store: bool) -> tuple:
    """(stages, shared memory bytes) of the wgmma GEMM's block."""
    stages = 3 if tma_store and block_n == 256 else WG_STAGES
    end = (stages * (WG_BLOCK_M + block_n) * WG_BLOCK_K + 2 * stages * 8
           + 2 * 2 * block_n * 4)
    if tma_store:
        end = -(-(end + 2 * 8) // 1024) * 1024 + 2 * 64 * block_n * 2
    return stages, end + 1024


WG_SMEM = _wg_layout(WG_BLOCK_N, False)[1]


@functools.lru_cache(maxsize=256)
def gemm_plan(m: int, n: int, k: int, sms: int, block_n: int = WG_BLOCK_N,
              tma_store: bool = False) -> dict:
    """The launch plan of one product on the wgmma GEMM (``csrc/
    int8_wgmma.cuh``, which checks the grid and the bytes): a persistent grid
    of at most one block an SM (``sms``) over the (m, n) tiles of 128 x
    ``block_n``; ``tma_store``: the epilogue's bf16 output goes out through
    shared memory by TMA (EPI_STORE, EPI_CAST_BIAS). ``waves``: tiles over
    blocks. Cached (a wrapper asks for it at every call): the same dict for
    the same arguments, to be read, not changed."""
    if block_n not in WG_BLOCK_NS:
        raise ValueError(f"the wgmma GEMM takes tiles {WG_BLOCK_NS} wide, got {block_n}")
    m_tiles, n_tiles = -(-m // WG_BLOCK_M), -(-n // block_n)
    tiles = m_tiles * n_tiles
    grid = min(tiles, sms)
    stages, smem = _wg_layout(block_n, tma_store)
    return dict(m_tiles=m_tiles, n_tiles=n_tiles, tiles=tiles, k_tiles=k // WG_BLOCK_K,
                block_n=block_n, tma_store=tma_store, grid=(grid,), stages=stages,
                smem_bytes=smem, tiles_per_block=-(-tiles // grid), waves=tiles / grid)


@functools.lru_cache(maxsize=256)
def store_plan(m: int, n: int, k: int, sms: int, tma_store: bool) -> dict:
    """The product of :func:`int8_linear` and :func:`fused_ln_int8_matmul`
    (a store epilogue, by TMA for a bf16 output) and of
    :func:`int8_matmul_residual` (the residual epilogue, its bf16 residual
    in and output out by TMA) on the wgmma GEMM:
    :func:`gemm_plan` with 128 x 128 tiles where their columns of rounds
    (rounds: tiles a block; columns: rounds x the tile width), a tenth
    dearer each, still come under the 128 x 256 tiles' (a narrow tile reads
    its A tile for half the columns), else 128 x 256: the narrow tiles fill
    the last wave of a few waves better (PERF.md: both widths' times at
    these shapes on the H100). Cached, as :func:`gemm_plan`."""
    wide = gemm_plan(m, n, k, sms, 256, tma_store)
    narrow = gemm_plan(m, n, k, sms, 128, tma_store)
    if 11 * narrow["tiles_per_block"] * 128 < 10 * wide["tiles_per_block"] * 256:
        return narrow
    return wide


@functools.lru_cache(maxsize=256)
def mlp_plan(m: int, d: int, f: int, sms: int) -> dict:
    """:func:`fused_ln_int8_mlp`'s two products: fc1 (m, d) x (d, f) and fc2
    (m, f) x (f, d)."""
    return dict(fc1=gemm_plan(m, f, d, sms), fc2=gemm_plan(m, d, f, sms))


# csrc/fused_attention_block.cu. The bf16 core at T = ATTN_T runs the QKV
# product and the attention in one kernel, attn_qkv_core_kernel<hd>: one
# tile is a sample's ATTN_T rows x one head's q, k and v columns (3 x hd);
# k-steps of 128 bytes through a ring of 4 stages at hd 64, 3 at hd 96 (a
# 16 KB A tile and three hd x 128-byte weight boxes each), K and V of the
# tile in bf16, a full and an empty mbarrier a stage, the tile's 3 hd column
# scales and biases for each of the two consumer warpgroups, 1 KB to align
# the swizzled tiles. At any other T the bf16 core is the split route: the
# QKV product to a bf16 (M, 3D) qkv on the wgmma GEMM, then
# attn_core_bf16_kernel<hd> (a block of 128 threads a (64 query rows, head,
# sample), K and V chunks of 64 keys in rows of hd + 8 bf16). The f32 and
# int8 cores: the QKV product to an f32 qkv, then a block of T threads a
# (head, sample), the int8 core's K / V codes and row scales in dynamic
# shared memory.
ATTN_T = 128
ATTN_HDS = (64, 96)
ATTN_MAX_VMEM_BYTES = 14 * 2**20  # the JAX model's fused / split rule
QKVC_STAGES = {64: 4, 96: 3}
QKVC_SMEM = {hd: (QKVC_STAGES[hd] * (ATTN_T + 3 * hd) * WG_BLOCK_K + 2 * ATTN_T * hd * 2
                  + 2 * QKVC_STAGES[hd] * 8 + 2 * 2 * 3 * hd * 4 + 1024) for hd in ATTN_HDS}
CORE16_BLOCK_Q, CORE16_BLOCK_KEYS, CORE16_THREADS = 64, 64, 128
CORE16_SMEM = {hd: 2 * CORE16_BLOCK_KEYS * (hd + 8) * 2 for hd in ATTN_HDS}


def _attn_dims(t: int, d: int, heads: int) -> int:
    """The head dim, or NotImplementedError for what the CUDA kernels do not
    take: head dims other than 64 and 96, D off 128, and T outside 1 ..
    the JAX model's fused rule (``attention_block_vmem_bytes`` <= 14 MiB;
    above it the model takes the split path)."""
    hd = d // heads if heads > 0 and d % heads == 0 else 0
    if (hd not in ATTN_HDS or d % WG_BLOCK_K or t < 1
            or attention_block_vmem_bytes(t, d) > ATTN_MAX_VMEM_BYTES):
        raise NotImplementedError(
            f"the CUDA attention-block kernels take head dim {ATTN_HDS[0]} or "
            f"{ATTN_HDS[1]}, D a multiple of {WG_BLOCK_K} and 1 <= T up to the fused "
            f"rule's bound (attention_block_vmem_bytes <= 14 MiB), got T={t}, D={d}, "
            f"heads={heads} (ROADMAP queue 2)")
    return hd


@functools.lru_cache(maxsize=256)
def attn_block_plan(b: int, t: int, d: int, heads: int, sms: int) -> dict:
    """:func:`fused_attention_block`'s launch plan. ``route``: "fused" at T =
    ATTN_T, else "split", the bf16 core's; ``core``, that route's core: at
    T = ATTN_T the one kernel for the QKV product and the attention (a
    persistent grid of at most one block an SM over the b x heads (sample,
    head) tiles, head fastest), else attn_core_bf16_kernel (a block a (64
    query rows, head, sample)), checked by ``csrc/fused_attention_block.cu``;
    ``qkv_bf16``, the split route's QKV product on the wgmma GEMM (a bf16
    output stored by TMA: :func:`store_plan`), else None; ``qkv``, the QKV
    product of the f32 and int8 cores on the wgmma GEMM; ``scalar``, their
    core kernel by core; ``out``, the out-projection. Raises
    NotImplementedError for what the kernels do not take. Cached, as
    :func:`gemm_plan`."""
    hd = _attn_dims(t, d, heads)
    m, tiles = b * t, b * heads
    if t == ATTN_T:
        grid = min(tiles, sms)
        core = dict(tiles=tiles, block_m=ATTN_T, block_n=3 * hd, k_tiles=d // WG_BLOCK_K,
                    grid=(grid,), stages=QKVC_STAGES[hd], smem_bytes=QKVC_SMEM[hd],
                    tiles_per_block=-(-tiles // grid))
    else:
        q_tiles = -(-t // CORE16_BLOCK_Q)
        core = dict(q_tiles=q_tiles, grid=(tiles * q_tiles,), threads=CORE16_THREADS,
                    key_chunks=-(-t // CORE16_BLOCK_KEYS), smem_bytes=CORE16_SMEM[hd])
    scalar = {c: dict(grid=(tiles,), threads=t,
                      smem_bytes=2 * t * hd + 8 * t if c == "int8" else 0)
              for c in ("f32", "int8")}
    return dict(route="fused" if t == ATTN_T else "split", head_dim=hd, core=core,
                qkv_bf16=None if t == ATTN_T else store_plan(m, 3 * d, d, sms, True),
                qkv=gemm_plan(m, 3 * d, d, sms), scalar=scalar, out=gemm_plan(m, d, d, sms))


# csrc/fused_int8_mlp_postln.cu, fc2_postln_kernel: the wgmma GEMM's tiles and
# ring, 4 column vectors (scales, biases, LN weights and biases) a consumer,
# the row sums of two exchanges for two tile parities and their mbarriers;
# a cluster of D / 256 blocks, at most the portable 8
PLN_MAX_CLUSTER = 8
PLN_SMEM = (WG_STAGES * (WG_BLOCK_M + WG_BLOCK_N) * WG_BLOCK_K + 2 * WG_STAGES * 8
            + 2 * 4 * WG_BLOCK_N * 4 + 2 * 2 * 2 * 64 * 4 + 2 * 2 * 2 * 8 + 1024)


def _postln_dims(d: int, f: int) -> int:
    """The cluster size of the post-LN fc2 for width d (f: the mid width)."""
    if d % WG_BLOCK_N or d // WG_BLOCK_N > PLN_MAX_CLUSTER or f % WG_BLOCK_K:
        raise NotImplementedError(
            f"the CUDA post-LN MLP kernel spreads a row over a cluster of D / "
            f"{WG_BLOCK_N} blocks: D must be a multiple of {WG_BLOCK_N} up to "
            f"{PLN_MAX_CLUSTER * WG_BLOCK_N}, got D={d}, F={f}")
    return d // WG_BLOCK_N


@functools.lru_cache(maxsize=256)
def mlp_postln_plan(m: int, d: int, f: int, sms: int, clusters: int) -> dict:
    """:func:`fused_int8_mlp_postln`'s launch plan: ``fc1`` on the wgmma
    GEMM; ``fc2``, the product with the post-LN and the residual in its
    epilogue, as clusters of D / 256 blocks (block rank r owns the n-tile r
    of its cluster's m-tile; the clusters walk the m-tiles). ``clusters``:
    how many such clusters the card runs at once
    (cudaOccupancyMaxActiveClusters, ``_clusters``). ``waves``: m-tiles
    over active clusters. Raises NotImplementedError for what the kernel
    does not take. Cached, as :func:`gemm_plan`."""
    size = _postln_dims(d, f)
    if clusters < 1:
        raise NotImplementedError(f"the card runs no cluster of {size} fc2 blocks")
    m_tiles = -(-m // WG_BLOCK_M)
    active = min(m_tiles, clusters)
    fc2 = dict(m_tiles=m_tiles, n_tiles=size, k_tiles=f // WG_BLOCK_K, cluster=size,
               clusters=active, grid=(active * size,), stages=WG_STAGES, smem_bytes=PLN_SMEM,
               waves=m_tiles / active, tiles_per_cluster=-(-m_tiles // active))
    return dict(fc1=gemm_plan(m, f, d, sms), fc2=fc2)


# csrc/fused_int8_diffusion_block.cu: 256 threads, activation row chunks of
# 128 rows through a ring of 4 stages of 128 bytes of k (rows padded by 16),
# at most 2 groups of 8 output columns a block, 10 column vectors of those
# groups, workspace arrays at 256-byte boundaries
DFB_WARPS, DFB_ROWS, DFB_BLOCK_K, DFB_STAGES, DFB_MAX_GROUPS = 8, 128, 128, 4, 2
DFB_COLUMN_VECTORS, DFB_WS_ALIGN = 10, 256
# (name, bytes an element, per row or per element); "mid" on the per-row path only
DFB_WORKSPACE = (("qz", 1, "md"), ("qh", 1, "md"), ("qa", 1, "md"), ("sz", 4, "m"),
                 ("sh", 4, "m"), ("sa", 4, "m"), ("mu", 4, "m"), ("rstd", 4, "m"),
                 ("gate", 4, "md"), ("o", 4, "md"), ("mid", 4, "md"))


def _align(n: int, a: int) -> int:
    return -(-n // a) * a


def _diffusion_smem(d: int, gpb: int) -> int:
    ring = DFB_STAGES * DFB_ROWS * (DFB_BLOCK_K + 16)
    off_bar = _align(5 * gpb * 8 * (d + 16), 128) + max(ring, DFB_WARPS * d * 4)
    return off_bar + 32 + DFB_COLUMN_VECTORS * DFB_MAX_GROUPS * 8 * 4


@functools.lru_cache(maxsize=256)
def diffusion_plan(m: int, d: int, sms: int, static: bool) -> dict:
    """The launch plan of :func:`fused_int8_diffusion_block`'s one launch, as
    ``csrc/fused_int8_diffusion_block.cu`` lays it out (and checks): one
    block an SM at most. The blocks split each product's output columns into
    units of ``groups_per_block`` groups of 8 and, where the units still
    cover the columns with two row parts (and there are 32 rows or more),
    the rows into two parts of ``part_rows``, so a block streams half the
    activations. Shared memory: the block's weight rows (5 x 8 a group: the
    stats' scale, shift and gate, fc1, fc2) at D + 16 bytes each, then the
    activation ring (or, in the row phases, a staged row a warp), three
    mbarriers, the block's column vectors. Also the phases and the grid
    barriers between them, and the workspace's arrays at 256-byte
    boundaries. Cached, as :func:`gemm_plan`."""
    groups = d // 8
    grid = min(sms, groups)
    gpb2 = -(-groups // (grid // 2)) if grid % 2 == 0 else DFB_MAX_GROUPS + 1
    parts = 2 if (m >= 32 and gpb2 <= DFB_MAX_GROUPS
                  and _diffusion_smem(d, gpb2) <= SMEM_LIMIT) else 1
    gpb = -(-groups // (grid // parts))
    offsets, end = {}, 0
    for name, size, per in DFB_WORKSPACE:
        if name == "mid" and static:
            continue
        offsets[name] = _align(end, DFB_WS_ALIGN)
        end = offsets[name] + size * (m * d if per == "md" else m)
    phases = ["silu_quant_z+ln_stats_x", "stats+adaln", "fc1", "fc2", "postln_gate"]
    if not static:
        phases[2:2] = ["quant_h"]
        phases[4:4] = ["quant_a"]
    part_rows = m if parts == 1 else _align(-(-m // 2), 16)
    return dict(grid=(grid,), groups=groups, groups_per_block=gpb, row_parts=parts,
                part_rows=part_rows, busy_blocks=parts * -(-groups // gpb),
                weight_slab_bytes=5 * gpb * 8 * (d + 16), smem_bytes=_diffusion_smem(d, gpb),
                phases=phases, barriers=len(phases) - 1,
                row_chunks=-(-part_rows // DFB_ROWS), workspace=offsets, workspace_bytes=end)


# -- CUDA wrappers -------------------------------------------------------------

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_long
_ARGTYPES = {
    "fused_ln_int8_mlp": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P,
                          _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "fused_attention_block": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P,
                              _P, _P, _P, _P, _P, _P, _I, _F, _P, _P, _P, _P,
                              _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "fused_ln_int8_matmul": [_P, _I, _I, _I, _I, _P, _P, _P, _I, _P, _P, _P,
                             _P, _P, _I, _I, _I, _P],
    "int8_matmul_residual": [_P, _I, _I, _I, _I, _P, _I, _P, _I, _P, _P, _P,
                             _P, _P, _I, _I, _I, _P],
    "fused_int8_mlp_postln": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _F, _P, _P,
                              _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _P],
    "fused_int8_diffusion_block": [_P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I,
                                   _F, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L,
                                   _P, _I, _I, _P],
    "int8_linear": [_P, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}


def _lib(name: str):
    return _load_lib(name, _ARGTYPES[name])


def _vectors(dev, *vs):
    """LN params and biases on ``dev`` (the kernels read them through a
    pointer on x's card), contiguous, all float32 or all bfloat16."""
    if len({v.dtype for v in vs}) != 1:
        raise TypeError(f"LN params and biases must share one dtype, got "
                        f"{[v.dtype for v in vs]}")
    if any(v.device != dev for v in vs):
        raise ValueError(f"LN params and biases must be on {dev}, got "
                         f"{[str(v.device) for v in vs]}")
    return [v.contiguous() for v in vs], _dtype_flag(vs[0], "LN params and biases")


def _int8_weight(w, shape, dev, what):
    """(in, out) int8 weight -> the kernels' K-major (out, in) contiguous
    operand: free for the pre-quantized serving weights, which are K-major
    already (ops/quantization.quantize_weight_kmajor); a copy otherwise."""
    if w.dtype != torch.int8 or tuple(w.shape) != shape or w.device != dev:
        raise ValueError(f"{what} must be int8 {shape} on {dev}, got "
                         f"{w.dtype} {tuple(w.shape)} on {w.device}")
    return w.t().contiguous()


def _lengths(n, **vs):
    """Each given vector (per-channel scales, biases, LN params) holds ``n``
    values: the kernels read ``n`` of each."""
    for what, v in vs.items():
        if v is not None and v.numel() != n:
            raise ValueError(f"{what} must hold {n} values, got shape {tuple(v.shape)}")


def _f32(v, dev):
    if (isinstance(v, torch.Tensor) and v.dtype == torch.float32 and v.device == dev
            and v.is_contiguous()):
        return v  # the serving path's case: no new tensor
    return torch.as_tensor(v, dtype=torch.float32, device=dev).contiguous()


def _amax(a, dev):
    """A calibrated amax as the kernels read it: one float32 on ``dev``."""
    if a is None:
        return None
    a = _f32(a, dev)
    return a if a.numel() == 1 else a.reshape(())


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it at a 16-byte boundary (TMA and bulk copies
    read from 16-byte-aligned addresses only)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.lru_cache(maxsize=None)
def _active_clusters(index: int, size: int) -> int:
    so, fn = _load_lib("fused_int8_mlp_postln_clusters", [_I, _P], "fused_int8_mlp_postln")
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        _run(so, fn, [size, ctypes.addressof(n)])
    return n.value


def _clusters(dev, size: int) -> int:
    """How many clusters of ``size`` blocks of the post-LN fc2 kernel the
    card that holds ``dev`` runs at once (cudaOccupancyMaxActiveClusters)."""
    return _active_clusters(dev.index if dev.index is not None else torch.cuda.current_device(),
                            size)


def fused_ln_int8_mlp(x: torch.Tensor, ln_scale, ln_bias, w1q, s1, b1, w2q,
                      s2, b2, a_in=None, a_mid=None) -> torch.Tensor:
    """x (..., D) -> x + MLP(LN(x)) with int8 products, in x's dtype.

    w1q (D, F) int8 with per-channel scales s1 (F,); w2q (F, D) / s2 (D,).
    ``a_in`` / ``a_mid``: calibrated amax of the post-LN input and the
    post-relu mid activation (static quant), or both None (per row). On a
    CUDA tensor both products run on the wgmma GEMM as :func:`mlp_plan` lays
    them out."""
    if _plain_route(x):
        return fused_ln_int8_mlp_plain(x, ln_scale, ln_bias, w1q, s1, b1, w2q,
                                       s2, b2, a_in, a_mid)
    _check_act_scales(a_in=a_in, a_mid=a_mid)
    dev, shape = x.device, x.shape
    d = shape[-1]
    f = w1q.shape[-1]
    if d % 128 or f % 128:
        raise NotImplementedError(
            f"the CUDA MLP kernel needs D and F multiples of 128, got D={d}, F={f}")
    xf = _aligned(x.reshape(-1, d).contiguous())
    m = xf.shape[0]
    x_bf16 = _dtype_flag(xf, "x")
    w1q = _aligned(_int8_weight(w1q, (d, f), dev, "w1q"))
    w2q = _aligned(_int8_weight(w2q, (f, d), dev, "w2q"))
    _lengths(f, s1=s1, b1=b1)
    _lengths(d, s2=s2, b2=b2, ln_scale=ln_scale, ln_bias=ln_bias)
    s1, s2 = _f32(s1, dev), _f32(s2, dev)
    (ln_w, ln_b, b1, b2), vec_bf16 = _vectors(dev, ln_scale, ln_bias, b1, b2)
    a_in, a_mid = _amax(a_in, dev), _amax(a_mid, dev)
    plan = mlp_plan(m, d, f, _sms(dev))
    q1 = torch.empty((m, d), dtype=torch.int8, device=dev)
    sx1 = torch.empty((m,), dtype=torch.float32, device=dev)
    q2 = torch.empty((m, f), dtype=torch.int8, device=dev)
    mid = None if a_in is not None else torch.empty((m, f), dtype=torch.float32, device=dev)
    sx2 = torch.empty((m,), dtype=torch.float32, device=dev)
    y = torch.empty_like(xf)
    lib, fn = _lib("fused_ln_int8_mlp")
    _run(lib, fn, [
        _ptr(xf), x_bf16, m, d, f, _ptr(ln_w), _ptr(ln_b), _ptr(b1), _ptr(b2),
        vec_bf16, _ptr(w1q), _ptr(s1), _ptr(w2q), _ptr(s2), _ptr(a_in),
        _ptr(a_mid), _ptr(q1), _ptr(sx1), _ptr(q2), _ptr(mid), _ptr(sx2),
        _ptr(y), plan["fc1"]["grid"][0], plan["fc2"]["grid"][0], plan["fc1"]["smem_bytes"],
        _stream(dev)])
    LAUNCHES["fused_ln_int8_mlp"] += 1
    return y.reshape(shape)


def fused_attention_block(x: torch.Tensor, ln_scale, ln_bias, wqkv_q, wqkv_s,
                          bqkv, wo_q, wo_s, bo, num_heads: int, a_in=None,
                          a_av=None, core: str = "f32",
                          a_smax=None) -> torch.Tensor:
    """The whole PreLN attention sub-block, x (B, T, D) -> (B, T, D).

    wqkv_q (D, 3D) int8 + per-channel scales wqkv_s (3D,); wo_q (D, D) int8
    + wo_s (D,). ``a_in`` / ``a_av``: calibrated amax of the post-LN input
    and the attention output (static quant), or both None (per row).
    ``core``: precision of the attention-core products ("f32", "bf16",
    "int8"). ``a_smax``: calibrated max logit replacing the row max. On a
    CUDA tensor, at head dim 64 or 96 and T up to the fused rule's bound,
    the bf16 core's QKV product and attention run as one kernel that keeps
    q, k and v on chip at T = 128, else through a bf16 qkv
    (:func:`attn_block_plan`)."""
    if _plain_route(x):
        return fused_attention_block_plain(x, ln_scale, ln_bias, wqkv_q, wqkv_s,
                                           bqkv, wo_q, wo_s, bo, num_heads,
                                           a_in, a_av, core, a_smax)
    _check_act_scales(a_in=a_in, a_av=a_av)
    if core not in ATTN_CORES:
        raise ValueError(f"core must be one of {ATTN_CORES}, got {core!r}")
    dev = x.device
    b, t, d = x.shape
    hd = _attn_dims(t, d, num_heads)
    x = _aligned(x.contiguous())
    x_bf16 = _dtype_flag(x, "x")
    wqkv_q = _aligned(_int8_weight(wqkv_q, (d, 3 * d), dev, "wqkv_q"))
    wo_q = _aligned(_int8_weight(wo_q, (d, d), dev, "wo_q"))
    _lengths(3 * d, wqkv_s=wqkv_s, bqkv=bqkv)
    _lengths(d, wo_s=wo_s, bo=bo, ln_scale=ln_scale, ln_bias=ln_bias)
    wqkv_s, wo_s = _f32(wqkv_s, dev), _f32(wo_s, dev)
    (ln_w, ln_b, bqkv, bo), vec_bf16 = _vectors(dev, ln_scale, ln_bias, bqkv, bo)
    a_in, a_av, a_smax = _amax(a_in, dev), _amax(a_av, dev), _amax(a_smax, dev)
    plan = attn_block_plan(b, t, d, num_heads, _sms(dev))
    m = b * t
    q1 = torch.empty((m, d), dtype=torch.int8, device=dev)
    sx1 = torch.empty((m,), dtype=torch.float32, device=dev)
    # the one-kernel route keeps q, k and v on chip: no (m, 3d) tensor; the
    # split route's qkv is bf16, the f32 and int8 cores' f32
    if core != "bf16":
        core_plan, qkv_plan = plan["scalar"][core], plan["qkv"]
        qkv = torch.empty((m, 3 * d), dtype=torch.float32, device=dev)
    elif plan["route"] == "split":
        core_plan, qkv_plan = plan["core"], plan["qkv_bf16"]
        qkv = torch.empty((m, 3 * d), dtype=torch.bfloat16, device=dev)
    else:
        core_plan, qkv_plan, qkv = plan["core"], plan["qkv"], None
    av8 = torch.empty((m, d), dtype=torch.int8, device=dev)
    avf = None if a_av is not None else torch.empty((m, d), dtype=torch.float32, device=dev)
    sxo = torch.empty((m,), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    lib, fn = _lib("fused_attention_block")
    _run(lib, fn, [
        _ptr(x), x_bf16, b, t, d, num_heads, _ptr(ln_w), _ptr(ln_b),
        _ptr(bqkv), _ptr(bo), vec_bf16, _ptr(wqkv_q), _ptr(wqkv_s), _ptr(wo_q),
        _ptr(wo_s), _ptr(a_in), _ptr(a_av), _ptr(a_smax),
        ATTN_CORES.index(core), float(hd ** -0.5),
        _ptr(q1), _ptr(sx1), _ptr(qkv), _ptr(av8), _ptr(avf), _ptr(sxo), _ptr(y),
        core_plan["grid"][0], core_plan["smem_bytes"], qkv_plan["grid"][0],
        qkv_plan["block_n"], qkv_plan["smem_bytes"], plan["out"]["grid"][0],
        plan["out"]["smem_bytes"], _stream(dev)])
    LAUNCHES["fused_attention_block"] += 1
    return y


ROW_MAX_K = 56 * 1024  # csrc/quant.cuh kRowOpMaxK: a row staged in shared memory


def _gemm_dims(k: int, n: int, what: str) -> None:
    if k % 128 or n % 128 or k > ROW_MAX_K:
        raise NotImplementedError(
            f"the CUDA {what} kernel needs in and out widths that are multiples "
            f"of 128 and an in width <= {ROW_MAX_K} (the row pass stages one row "
            f"in shared memory), got in={k}, out={n}")


def fused_ln_int8_matmul(x: torch.Tensor, ln_scale, ln_bias, wq, s, b) -> torch.Tensor:
    """LN(x) -> per-row int8 quant -> one int8 product: x (..., D) ->
    (..., O) in x's dtype.

    wq (D, O) int8 with per-channel scales s (O,), bias b (O,). The QKV
    projection of the split serving path: O = 3D, head-split by the caller.
    On a CUDA tensor the product runs on the wgmma GEMM as
    :func:`store_plan` lays it out."""
    if _plain_route(x):
        return fused_ln_int8_matmul_plain(x, ln_scale, ln_bias, wq, s, b)
    dev, d = x.device, x.shape[-1]
    n = wq.shape[-1]
    _gemm_dims(d, n, "fused_ln_int8_matmul")
    xf = _aligned(x.reshape(-1, d).contiguous())
    m = xf.shape[0]
    x_bf16 = _dtype_flag(xf, "x")
    wq = _aligned(_int8_weight(wq, (d, n), dev, "wq"))
    _lengths(n, s=s, b=b)
    _lengths(d, ln_scale=ln_scale, ln_bias=ln_bias)
    s = _f32(s, dev)
    (ln_w, ln_b, b), vec_bf16 = _vectors(dev, ln_scale, ln_bias, b)
    plan = store_plan(m, n, d, _sms(dev), bool(x_bf16))
    q = torch.empty((m, d), dtype=torch.int8, device=dev)
    sx = torch.empty((m,), dtype=torch.float32, device=dev)
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    so, fn = _lib("fused_ln_int8_matmul")
    _run(so, fn, [_ptr(xf), x_bf16, m, d, n, _ptr(ln_w), _ptr(ln_b), _ptr(b),
                  vec_bf16, _ptr(wq), _ptr(s), _ptr(q), _ptr(sx), _ptr(y),
                  plan["grid"][0], plan["block_n"], plan["smem_bytes"], _stream(dev)])
    LAUNCHES["fused_ln_int8_matmul"] += 1
    return y.reshape(x.shape[:-1] + (n,))


def int8_matmul_residual(x: torch.Tensor, residual: torch.Tensor, wq, s,
                         b) -> torch.Tensor:
    """residual + (q8(x) @ wq)·sx·s + b in float32, cast to residual's dtype.

    x (..., D_in); residual (..., D_out); wq (D_in, D_out) int8, scales s and
    bias b (D_out,). The attention out-projection of the split serving path.
    On a CUDA tensor the product runs on the wgmma GEMM as :func:`store_plan`
    lays it out, the residual added in its epilogue (a bf16 residual loaded,
    and y stored, through shared memory by TMA)."""
    if _plain_route(x):
        return int8_matmul_residual_plain(x, residual, wq, s, b)
    dev, k = x.device, x.shape[-1]
    n = wq.shape[-1]
    _gemm_dims(k, n, "int8_matmul_residual")
    xf = _aligned(x.reshape(-1, k).contiguous())
    m = xf.shape[0]
    if (residual.shape[-1] != n or residual.numel() != m * n
            or residual.device != dev):
        raise ValueError(f"x {tuple(x.shape)} and residual {tuple(residual.shape)} must "
                         f"share their leading dims and device, the residual {n} wide")
    rf = _aligned(residual.reshape(-1, n).contiguous())
    x_bf16, r_bf16 = _dtype_flag(xf, "x"), _dtype_flag(rf, "residual")
    wq = _aligned(_int8_weight(wq, (k, n), dev, "wq"))
    _lengths(n, s=s, b=b)
    s = _f32(s, dev)
    (b,), b_bf16 = _vectors(dev, b)
    plan = store_plan(m, n, k, _sms(dev), bool(r_bf16))
    q = torch.empty((m, k), dtype=torch.int8, device=dev)
    sx = torch.empty((m,), dtype=torch.float32, device=dev)
    y = torch.empty_like(rf)
    so, fn = _lib("int8_matmul_residual")
    _run(so, fn, [_ptr(xf), x_bf16, m, k, n, _ptr(rf), r_bf16, _ptr(b), b_bf16,
                  _ptr(wq), _ptr(s), _ptr(q), _ptr(sx), _ptr(y), plan["grid"][0],
                  plan["block_n"], plan["smem_bytes"], _stream(dev)])
    LAUNCHES["int8_matmul_residual"] += 1
    return y.reshape(residual.shape)


def fused_int8_mlp_postln(x: torch.Tensor, w1q, s1, b1, w2q, s2, b2, ln_scale, ln_bias,
                          a_x=None, a_gelu=None, ln_eps: float = 1e-6) -> torch.Tensor:
    """The NOVA ViT block's post-norm MLP residual, x (..., D) -> x +
    LN(MLP(x)) with int8 products and exact-erf gelu, in x's dtype.

    w1q (D, F) int8 with per-channel scales s1 (F,); w2q (F, D) / s2 (D,).
    ``a_x`` / ``a_gelu``: calibrated amax of the block input and the post-gelu
    mid activation (static quant), or both None (per row). ``ln_eps``: the
    post-norm's eps. On a CUDA tensor fc2 runs as clusters of D / 256
    blocks with the post-LN and the residual in its epilogue
    (:func:`mlp_postln_plan`)."""
    if _plain_route(x):
        return fused_int8_mlp_postln_plain(x, w1q, s1, b1, w2q, s2, b2, ln_scale,
                                           ln_bias, a_x, a_gelu, ln_eps)
    _check_act_scales(a_x=a_x, a_gelu=a_gelu)
    dev, shape = x.device, x.shape
    d, f = shape[-1], w1q.shape[-1]
    _gemm_dims(d, f, "fused_int8_mlp_postln")
    _gemm_dims(f, d, "fused_int8_mlp_postln")
    size = _postln_dims(d, f)
    xf = _aligned(x.reshape(-1, d).contiguous())
    m = xf.shape[0]
    x_bf16 = _dtype_flag(xf, "x")
    w1q = _aligned(_int8_weight(w1q, (d, f), dev, "w1q"))
    w2q = _aligned(_int8_weight(w2q, (f, d), dev, "w2q"))
    _lengths(f, s1=s1, b1=b1)
    _lengths(d, s2=s2, b2=b2, ln_scale=ln_scale, ln_bias=ln_bias)
    s1, s2 = _f32(s1, dev), _f32(s2, dev)
    (b1, b2, ln_w, ln_b), vec_bf16 = _vectors(dev, b1, b2, ln_scale, ln_bias)
    a_x, a_gelu = _amax(a_x, dev), _amax(a_gelu, dev)
    plan = mlp_postln_plan(m, d, f, _sms(dev), _clusters(dev, size))
    q1 = torch.empty((m, d), dtype=torch.int8, device=dev)
    sx1 = torch.empty((m,), dtype=torch.float32, device=dev)
    q2 = torch.empty((m, f), dtype=torch.int8, device=dev)
    mid = None if a_x is not None else torch.empty((m, f), dtype=torch.float32, device=dev)
    sx2 = torch.empty((m,), dtype=torch.float32, device=dev)
    y = torch.empty_like(xf)
    fc1, fc2 = plan["fc1"], plan["fc2"]
    so, fn = _lib("fused_int8_mlp_postln")
    _run(so, fn, [
        _ptr(xf), x_bf16, m, d, f, _ptr(b1), _ptr(b2), _ptr(ln_w), _ptr(ln_b), vec_bf16,
        float(ln_eps), _ptr(w1q), _ptr(s1), _ptr(w2q), _ptr(s2), _ptr(a_x), _ptr(a_gelu),
        _ptr(q1), _ptr(sx1), _ptr(q2), _ptr(mid), _ptr(sx2), _ptr(y), fc1["grid"][0],
        fc1["smem_bytes"], fc2["grid"][0], fc2["cluster"], fc2["smem_bytes"], _stream(dev)])
    LAUNCHES["fused_int8_mlp_postln"] += 1
    return y.reshape(shape)


def fused_int8_diffusion_block(x: torch.Tensor, zc: torch.Tensor, wstats_q, stats_s,
                               stats_b, w1q, s1, b1, w2q, s2, b2, n2_scale, n2_bias,
                               a_z=None, a_h=None, a_silu=None,
                               n2_eps: float = 1e-6) -> torch.Tensor:
    """One DiffusionMLP block (AdaLN-zero gated residual MLP), x, zc (..., D)
    -> (..., D) in x's dtype, with int8 products.

    wstats_q (D, 3D) int8 + stats_s / stats_b (3D,): the AdaLN stats
    projection; w1q, w2q (D, D) + scales and biases: the silu MLP; n2_*: the
    post-norm's affine params, ``n2_eps`` its eps (the AdaLN keeps 1e-6).
    ``a_z`` / ``a_h`` / ``a_silu``: calibrated amax of silu(zc), the modulated
    hidden and the post-silu mid (static quant), or all None (per row)."""
    if _plain_route(x):
        return fused_int8_diffusion_block_plain(x, zc, wstats_q, stats_s, stats_b, w1q,
                                                s1, b1, w2q, s2, b2, n2_scale, n2_bias,
                                                a_z, a_h, a_silu, n2_eps)
    _check_act_scales(a_z=a_z, a_h=a_h, a_silu=a_silu)
    dev, shape = x.device, x.shape
    d = shape[-1]
    _gemm_dims(d, 3 * d, "fused_int8_diffusion_block")
    xf = _aligned(x.reshape(-1, d).contiguous())
    zf = _aligned(zc.reshape(-1, d).contiguous())
    m = xf.shape[0]
    if zf.shape[0] != m or zf.device != dev:
        raise ValueError(f"x {tuple(x.shape)} and zc {tuple(zc.shape)} must share their "
                         f"shape and device")
    plan = diffusion_plan(m, d, _sms(dev), static=a_z is not None)
    if plan["groups_per_block"] > DFB_MAX_GROUPS or plan["smem_bytes"] > SMEM_LIMIT:
        raise NotImplementedError(
            f"the CUDA diffusion-block kernel takes at most {DFB_MAX_GROUPS} groups of 8 "
            f"columns a block in {SMEM_LIMIT} bytes of shared memory, got D={d}: "
            f"{plan['groups_per_block']} groups, {plan['smem_bytes']} bytes")
    wstats_q = _aligned(_int8_weight(wstats_q, (d, 3 * d), dev, "wstats_q"))
    w1q = _aligned(_int8_weight(w1q, (d, d), dev, "w1q"))
    w2q = _aligned(_int8_weight(w2q, (d, d), dev, "w2q"))
    _lengths(3 * d, stats_s=stats_s, stats_b=stats_b)
    _lengths(d, s1=s1, b1=b1, s2=s2, b2=b2, n2_scale=n2_scale, n2_bias=n2_bias)
    stats_s, s1, s2 = _f32(stats_s, dev), _f32(s1, dev), _f32(s2, dev)
    (bs, b1, b2, n2_w, n2_b), vec_bf16 = _vectors(dev, stats_b, b1, b2, n2_scale, n2_bias)
    a_z, a_h, a_silu = _amax(a_z, dev), _amax(a_h, dev), _amax(a_silu, dev)
    # one allocation: y, then the kernel's workspace
    y_bytes = m * d * xf.element_size()
    ws_at = _align(y_bytes, DFB_WS_ALIGN)
    buf = torch.empty((ws_at + plan["workspace_bytes"],), dtype=torch.uint8, device=dev)
    y = buf[:y_bytes].view(xf.dtype).view(m, d)
    so, fn = _lib("fused_int8_diffusion_block")
    _run(so, fn, [
        _ptr(xf), _dtype_flag(xf, "x"), _ptr(zf), _dtype_flag(zf, "zc"), m, d, _ptr(bs),
        _ptr(b1), _ptr(b2), _ptr(n2_w), _ptr(n2_b), vec_bf16, float(n2_eps),
        _ptr(wstats_q), _ptr(stats_s), _ptr(w1q), _ptr(s1), _ptr(w2q), _ptr(s2),
        _ptr(a_z), _ptr(a_h), _ptr(a_silu), _ptr(buf) + ws_at, plan["workspace_bytes"],
        _ptr(y), plan["grid"][0], plan["smem_bytes"], _stream(dev)])
    LAUNCHES["fused_int8_diffusion_block"] += 1
    return y.reshape(shape)


def int8_linear(x: torch.Tensor, wq, s, b=None, out_dtype=None) -> torch.Tensor:
    """Per-row int8 quant of x (..., K), one int8 product with wq (K, N) and
    per-channel scales s (N,), cast to ``out_dtype`` (default x's dtype), then
    the bias b (N,) or None added in that dtype: the JAX ViT attention's
    ``_int8_proj`` rounding order (the product is rounded before the bias).
    On a CUDA tensor the product runs on the wgmma GEMM as
    :func:`store_plan` lays it out."""
    if _plain_route(x):
        return int8_linear_plain(x, wq, s, b, out_dtype)
    out_dtype = out_dtype or x.dtype
    dev, k = x.device, x.shape[-1]
    n = wq.shape[-1]
    _gemm_dims(k, n, "int8_linear")
    xf = _aligned(x.reshape(-1, k).contiguous())
    m = xf.shape[0]
    x_bf16 = _dtype_flag(xf, "x")
    wq = _aligned(_int8_weight(wq, (k, n), dev, "wq"))
    _lengths(n, s=s, b=b)
    s = _f32(s, dev)
    b_bf16 = 0
    if b is not None:
        (b,), b_bf16 = _vectors(dev, b)
    y = torch.empty((m, n), dtype=out_dtype, device=dev)
    y_bf16 = _dtype_flag(y, "out_dtype")
    plan = store_plan(m, n, k, _sms(dev), bool(y_bf16))
    q = torch.empty((m, k), dtype=torch.int8, device=dev)
    sx = torch.empty((m,), dtype=torch.float32, device=dev)
    so, fn = _lib("int8_linear")
    _run(so, fn, [_ptr(xf), x_bf16, m, k, n, _ptr(b), b_bf16, _ptr(wq), _ptr(s), _ptr(q),
                  _ptr(sx), _ptr(y), y_bf16, plan["grid"][0], plan["block_n"],
                  plan["smem_bytes"], _stream(dev)])
    LAUNCHES["int8_linear"] += 1
    return y.reshape(x.shape[:-1] + (n,))
