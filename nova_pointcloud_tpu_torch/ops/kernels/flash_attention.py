"""Flash attention (forward and backward) for Hopper.

Counterpart of ``nova_pointcloud_tpu/ops/pallas/flash_attention.py``
``flash_attention``: ``softmax(q kᵀ/√d + bias) v`` by online softmax over key
tiles with float32 accumulation, the (Lq, Lk) scores never in device memory,
and the row log-sum-exp ``lse`` saved for the backward pass, which
recomputes the probabilities from it (the JAX ``_flash_bwd``).

- :func:`flash_attention` has the JAX function's signature (its TPU block
  sizes ``blk_q`` / ``blk_k`` are dropped: the CUDA kernels mask ragged
  tails themselves). It is differentiable: for CUDA tensors the forward
  launches ``csrc/flash_attention.cu`` and the backward the kernels of
  ``csrc/flash_attention_bwd.cu``: in bf16 the prep kernel (delta and lse
  rows), the one-pass dkvq kernel (wgmma and TMA: dK, dV, and dQ summed into
  an f32 workspace) and the cast of that workspace to dq; in f32 the prep
  kernel and the SIMT dK/dV and dQ kernels. For CPU tensors the forward runs
  :func:`flash_attention_plain` and the backward
  :func:`flash_attention_bwd_plain`. It never falls back from a kernel to its
  plain version: what a kernel does not take raises.
- :func:`flash_attention_plain` is the plain PyTorch forward, differentiable
  by autograd, returning ``(o, lse)``; :func:`flash_attention_bwd_plain` is
  the plain backward, written as the JAX kernels' math;
  :func:`bwd_prep_plain` and :func:`bwd_dq_cast_plain` are the plain
  versions of the prep and cast kernels, :func:`bwd_plan` the bf16 launch
  plan.
- ``LAUNCHES[name]`` counts each kernel's launches: ``flash_attention``;
  ``flash_attention_bwd_prep``, ``flash_attention_bwd_dkvq``,
  ``flash_attention_bwd_dq_cast`` (bf16); ``flash_attention_dkv``,
  ``flash_attention_dq`` (f32).

The CUDA kernels take float32 or bfloat16 q, k, v of one dtype with head dim
64 (other head dims raise), any Lq and Lk, and the three bias forms of the TPU
kernel. Biases are mask constants: their gradient is zero, as the JAX VJP
declares it.

Bias forms (4-D, as the JAX function): ``None``; a key bias ``(B or 1, 1, 1,
Lk)``, read in the kernel with the batch index (no per-head copies); a full
bias ``(1, 1, Lq, Lk)`` shared by every batch and head. ``-inf`` entries
mask; a row whose keys are all masked gives ``o = 0`` and ``lse = +1e30``,
and no gradient.

:func:`flash_attention_static` is the serving attention of the NOVA ViT after
calibration (the JAX ``flash_attention_static``): the calibrated max logit
``smax`` replaces the running max, ``p = bf16(exp(min(s - smax, 20)))`` is
summed into both ``p v`` and the denominator, and the score product is bf16
or, with the calibrated ``a_q`` / ``a_k``, int8. Its CUDA kernel
(``csrc/flash_attention_static.cu``) takes head dim 64 and a key bias or none;
:func:`flash_attention_static_plain` is its plain version, and
``LAUNCHES["flash_attention_static"]`` counts its launches. Forward only.
"""

import ctypes
from typing import Optional, Tuple

import torch

from nova_pointcloud_tpu_torch.ops.kernels._launch import (LAUNCHES, dtype_flag, lib,
                                                           plain_route, ptr, run)
from nova_pointcloud_tpu_torch.ops.quantization import int_dot

NEG_INF = -1e30
CUDA_HEAD_DIM = 64

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _F, _P, _P, _P]


def _normalize_bias(bias: Optional[torch.Tensor], b: int, lq: int, lk: int
                    ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """4-D bias -> (key bias (B, Lk), full bias (Lq, Lk)), one of them set,
    with the JAX function's shape rules and errors."""
    if bias is None:
        return None, None
    if bias.ndim != 4:
        raise ValueError(f"bias must be 4D, got {tuple(bias.shape)}")
    if bias.shape[1] != 1:
        raise ValueError("per-head bias unsupported in the flash kernel")
    if bias.shape[-1] not in (1, lk):
        raise ValueError(f"bias last dim must be 1 or Lk={lk}, got "
                         f"{tuple(bias.shape)} (broadcastable-but-mismatched "
                         f"shapes belong on the sdpa path)")
    if bias.shape[2] == 1:  # (B or 1, 1, 1, Lk)
        return torch.broadcast_to(bias[:, 0, 0, :], (b, lk)), None
    if bias.shape[0] == 1 and bias.shape[2] == lq:  # (1, 1, Lq, Lk)
        return None, torch.broadcast_to(bias[0, 0], (lq, lk))
    raise ValueError(f"unsupported bias shape {tuple(bias.shape)}")


def _plain(q, k, v, key_bias, full_bias):
    d = q.shape[-1]
    s = torch.matmul(q.float() * d ** -0.5, k.float().transpose(-1, -2))  # (B, H, Lq, Lk)
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    if full_bias is not None:
        s = s + full_bias.float()
    m = torch.clamp(torch.amax(s, dim=-1, keepdim=True), min=NEG_INF)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    dead = l == 0.0  # every key masked by -inf
    safe = torch.where(dead, torch.ones_like(l), l)
    o = torch.matmul(p, v.float()) / safe
    lse = torch.where(dead, torch.full_like(l, -NEG_INF), m + torch.log(safe))
    return o.to(q.dtype), lse[..., 0]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the flash kernel: q, k, v (B, H, L, D) ->
    o (B, H, Lq, D) in q's dtype and lse (B, H, Lq) float32. Float32 scores
    and sums; differentiable by autograd."""
    key_bias, full_bias = _normalize_bias(bias, q.shape[0], q.shape[2], k.shape[2])
    return _plain(q, k, v, key_bias, full_bias)


def _strided(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernel reads it: last dim contiguous, the other strides
    and the base address multiples of 16 bytes; a copy only when needed."""
    per16 = 16 // t.element_size()
    ok = (t.stride(3) == 1 and all(s % per16 == 0 for s in t.stride()[:3])
          and t.data_ptr() % 16 == 0)
    return t if ok else t.contiguous()


def _launch(q, k, v, key_bias, full_bias):
    b, h, lq, d = q.shape
    lk = k.shape[2]
    dev = q.device
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v must share one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    is_bf16 = dtype_flag(q, "q, k, v")
    if d != CUDA_HEAD_DIM:
        raise NotImplementedError(
            f"the CUDA flash kernel takes head dim {CUDA_HEAD_DIM}, got {d}")
    if k.shape != (b, h, lk, d) or v.shape != k.shape or k.device != dev or v.device != dev:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         f"must be (B, H, L, D) on one device")
    q, k, v = _strided(q), _strided(k), _strided(v)
    o = torch.empty_like(q)  # q's strides: a (B, L, H, D) view stays one
    if o.stride(3) != 1:
        o = torch.empty(q.shape, dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=dev)
    strides = (ctypes.c_long * 12)(*[s for t in (q, k, v, o) for s in t.stride()[:3]])
    if key_bias is not None:
        key_bias = key_bias.to(device=dev, dtype=torch.float32).contiguous()
    if full_bias is not None:
        full_bias = full_bias.to(device=dev, dtype=torch.float32).contiguous()
    so, fn = lib("flash_attention", _ARGTYPES)
    run(so, fn, [ptr(q), ptr(k), ptr(v), is_bf16, b, h, lq, lk, d,
                 ctypes.addressof(strides), ptr(key_bias), ptr(full_bias),
                 float(d ** -0.5), ptr(o), ptr(lse),
                 torch.cuda.current_stream(dev).cuda_stream])
    LAUNCHES["flash_attention"] += 1
    return o, lse


_BWD_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _F, _P, _P,
                 _P, _P]  # the f32 kernels
_PREP_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P]
_DKVQ_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _F, _P, _P, _P,
                  _I, _I, _I, _P]
_CAST_ARGTYPES = [_P, _I, _I, _I, _I, _I, _P, _F, _P, _P]
_LQ_PAD = 128  # lse / delta / dq workspace rows are padded to a multiple of this
LOG2E = 1.4426950408889634
# the bf16 kernel's tiling (csrc/flash_attention_bwd.cu): blocks of 128 keys,
# two warpgroups of 64 keys each; each streams query tiles of 64 through its
# own ring of BWD_STAGES stages
BWD_BLOCK_K, BWD_BLOCK_Q, BWD_STAGES = 128, 64, 2

BWD_KERNELS = ("flash_attention_bwd_prep", "flash_attention_bwd_dkvq",
               "flash_attention_bwd_dq_cast")  # bf16, in launch order
BWD_F32_KERNELS = ("flash_attention_bwd_prep", "flash_attention_dkv", "flash_attention_dq")


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              key_bias: Optional[torch.Tensor],
                              full_bias: Optional[torch.Tensor], o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernels (the JAX ``_flash_bwd``):
    q, k, v, o, do (B, H, L, D), the saved lse (B, H, Lq), ``key_bias``
    (B, Lk) / ``full_bias`` (Lq, Lk) or None -> (dq, dk, dv) in the inputs'
    dtypes. Float32 throughout: ``delta = sum(do * o)`` from the saved output,
    ``p = exp(s - lse)``, ``dv = pᵀ do``, ``ds = p (do vᵀ - delta) / √d``,
    ``dk = dsᵀ q``, ``dq = ds k``. A row with lse = 1e30 (every key masked)
    has p = 0 and gives nothing."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = torch.sum(dof * o.float(), dim=-1, keepdim=True)
    s = torch.matmul(qf * scale, kf.transpose(-1, -2))
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    if full_bias is not None:
        s = s + full_bias.float()
    p = torch.exp(s - lse[..., None])
    dv = torch.matmul(p.transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dq = torch.matmul(ds, kf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bwd_prep_plain(o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor, lqp: int,
                   log2: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the prep kernel: o, do (B, H, Lq, D), lse (B, H, Lq)
    -> (lse rows, delta rows), each (B*H, lqp) float32, padded with 1e30 and
    0. ``delta = sum(do * o)`` in float32 in the JAX function's order on the
    CPU (XLA: each half of the head dim summed in sequence from 0, then the
    two halves), so it equals ``jnp.sum(dout.f32 * out.f32, -1)`` bit for
    bit at head dim 64; lse in units of log 2 when ``log2``."""
    b, h, lq, d = o.shape
    prod = (do.float() * o.float()).reshape(b * h, lq, d)
    halves = []
    for part in (prod[..., :d // 2], prod[..., d // 2:]):
        acc = torch.zeros(part.shape[:-1], dtype=torch.float32, device=o.device)
        for i in range(part.shape[-1]):
            acc = acc + part[..., i]
        halves.append(acc)
    delta = (torch.zeros_like(halves[0]) + halves[0]) + halves[1]
    rows = lse.reshape(b * h, lq).float()
    if log2:
        rows = rows * torch.tensor(LOG2E, dtype=torch.float32, device=o.device)
    pad = (0, lqp - lq)
    return (torch.nn.functional.pad(rows, pad, value=-NEG_INF),
            torch.nn.functional.pad(delta, pad))


def bwd_dq_cast_plain(ws: torch.Tensor, b: int, h: int, lq: int, scale: float) -> torch.Tensor:
    """Plain version of the cast kernel: the f32 dq workspace (B*H, Lqp, D)
    times ``scale`` (the softmax scale, which the dkvq kernel leaves out of
    ds) -> dq (B, H, Lq, D) bf16, allocated in the (B, L, H, D) layout."""
    d = ws.shape[-1]
    dq = torch.empty((b, lq, h, d), dtype=torch.bfloat16, device=ws.device).transpose(1, 2)
    dq.copy_(ws[:, :lq].reshape(b, h, lq, d) * torch.tensor(scale, dtype=torch.float32))
    return dq


def bwd_plan(b: int, h: int, lq: int, lk: int) -> dict:
    """The bf16 backward's launch plan, as ``csrc/flash_attention_bwd.cu``
    lays out the dkvq kernel's shared memory (which checks it), for each of
    its two warpgroups: K and V of its 64 keys, its query-tile ring (q, do;
    lse and delta rows), its ds hi / lo tiles, two f32 dq buffers, its
    mbarriers; and 1024 bytes to align the swizzled tiles."""
    tile = 64 * CUDA_HEAD_DIM * 2
    rows_at = (4 * tile + 2 * BWD_STAGES * 2 * tile + 4 * tile
               + 4 * BWD_BLOCK_Q * CUDA_HEAD_DIM * 4)
    bars_at = rows_at + 2 * BWD_STAGES * 2 * BWD_BLOCK_Q * 4
    smem = -(-(bars_at + 2 * (BWD_STAGES + 1) * 8) // 16) * 16 + 1024
    lqp = -(-lq // _LQ_PAD) * _LQ_PAD
    key_tiles = -(-lk // BWD_BLOCK_K)
    return dict(lqp=lqp, key_tiles=key_tiles, q_tiles=-(-lq // BWD_BLOCK_Q),
                grid=(key_tiles, b * h), smem_bytes=smem, workspace=(b * h, lqp, CUDA_HEAD_DIM))


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _bwd_operands(q, k, v, key_bias, full_bias, o, lse, do):
    """Every check of the backward kernels, then their launches in order
    (name, argtypes, ctypes arguments, the tensors behind the pointers) and
    the outputs (dq, dk, dv) they write. bf16: prep, dkvq, cast; f32: prep,
    dK/dV, dQ."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    dev = q.device
    if not (q.dtype == k.dtype == v.dtype == o.dtype == do.dtype):
        raise TypeError(f"q, k, v, o, do must share one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}, {o.dtype}, {do.dtype}")
    is_bf16 = dtype_flag(q, "q, k, v")
    if d != CUDA_HEAD_DIM:
        raise NotImplementedError(
            f"the CUDA flash backward kernels take head dim {CUDA_HEAD_DIM}, got {d}")
    if (k.shape != (b, h, lk, d) or v.shape != k.shape or o.shape != q.shape
            or do.shape != q.shape or lse.shape != (b, h, lq)
            or any(t.device != dev for t in (k, v, o, do, lse))):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"o {tuple(o.shape)}, do {tuple(do.shape)}, lse {tuple(lse.shape)} "
                         f"must be (B, H, L, D) (lse (B, H, Lq)) on one device")
    if lse.dtype != torch.float32:
        raise TypeError(f"lse must be float32, got {lse.dtype}")
    plan = bwd_plan(b, h, lq, lk)
    if is_bf16 and (b * h > 65535 or b * h * plan["lqp"] >= 2 ** 31):
        raise ValueError(f"B*H = {b * h} over the grid's 65535 rows, or B*H*Lq over the "
                         f"dq workspace map's 2^31 rows")
    q, k, v, o, do = (_strided(t) for t in (q, k, v, o, do))
    lse = lse.contiguous()
    lqp = plan["lqp"]
    f32 = dict(dtype=torch.float32, device=dev)
    lse_rows, delta = torch.empty((b * h, lqp), **f32), torch.empty((b * h, lqp), **f32)
    dq, dk, dv = (torch.empty((b, n, h, d), dtype=q.dtype, device=dev).transpose(1, 2)
                  for n in (lq, lk, lk))
    if key_bias is not None:
        key_bias = key_bias.to(device=dev, dtype=torch.float32).contiguous()
    if full_bias is not None:
        full_bias = full_bias.to(device=dev, dtype=torch.float32).contiguous()
    stream = _stream(dev)

    def strides(*ts):
        return (ctypes.c_long * (3 * len(ts)))(*[s for t in ts for s in t.stride()[:3]])

    prep_s = strides(o, do)
    launches = [("flash_attention_bwd_prep", _PREP_ARGTYPES,
                 [ptr(o), ptr(do), ptr(lse), is_bf16, b, h, lq, lqp, d,
                  ctypes.addressof(prep_s), is_bf16, ptr(lse_rows), ptr(delta), stream],
                 (o, do, lse, lse_rows, delta, prep_s))]
    scale = float(d ** -0.5)
    if is_bf16:
        ws = torch.zeros(plan["workspace"], **f32)
        main_s, cast_s = strides(q, k, v, do, dk, dv), strides(dq)
        launches += [
            ("flash_attention_bwd_dkvq", _DKVQ_ARGTYPES,
             [ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse_rows), ptr(delta), b, h, lq, lk, lqp, d,
              ctypes.addressof(main_s), ptr(key_bias), ptr(full_bias), scale, ptr(ws), ptr(dk),
              ptr(dv), plan["key_tiles"], plan["q_tiles"], plan["smem_bytes"], stream],
             (q, k, v, do, lse_rows, delta, key_bias, full_bias, ws, main_s)),
            ("flash_attention_bwd_dq_cast", _CAST_ARGTYPES,
             [ptr(ws), b, h, lq, lqp, d, ctypes.addressof(cast_s), scale, ptr(dq), stream],
             (ws, cast_s))]
    else:
        all_s = strides(q, k, v, do, dq, dk, dv)
        args = [ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse_rows), ptr(delta), is_bf16, b, h, lq,
                lk, lqp, d, ctypes.addressof(all_s), ptr(key_bias), ptr(full_bias), scale,
                ptr(dq), ptr(dk), ptr(dv), stream]
        keep = (q, k, v, do, lse_rows, delta, key_bias, full_bias, all_s)
        launches += [(name, _BWD_ARGTYPES, args, keep) for name in BWD_F32_KERNELS[1:]]
    return launches, (dq, dk, dv)


def run_bwd(launches, names=None) -> None:
    """Launch the prepared backward kernels in order (only the named ones
    if ``names`` is given)."""
    for name, argtypes, args, _ in launches:
        if names is None or name in names:
            so, fn = lib(name, argtypes, library="flash_attention_bwd")
            run(so, fn, args)
            LAUNCHES[name] += 1


def _launch_bwd(q, k, v, key_bias, full_bias, o, lse, do):
    """The backward kernels; every check before the first launch."""
    launches, grads = _bwd_operands(q, k, v, key_bias, full_bias, o, lse, do)
    run_bwd(launches)
    return grads


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its backward: the CUDA kernels for CUDA tensors,
    the plain versions for CPU tensors (or inside ``use_plain_kernels()``),
    chosen once in the forward. ``lse`` carries no gradient; the biases get
    a zero one."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, full_bias):
        ctx.plain = plain_route(q)
        if ctx.plain:
            o, lse = _plain(q, k, v, key_bias, full_bias)
        else:
            o, lse = _launch(q, k, v, key_bias, full_bias)
        ctx.save_for_backward(q, k, v, key_bias, full_bias, o, lse)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, grad_o, grad_lse):
        q, k, v, key_bias, full_bias, o, lse = ctx.saved_tensors
        bwd = flash_attention_bwd_plain if ctx.plain else _launch_bwd
        dq, dk, dv = bwd(q, k, v, key_bias, full_bias, o, lse, grad_o)

        def zero(bias, i):
            return torch.zeros_like(bias) if ctx.needs_input_grad[i] else None

        return dq, dk, dv, zero(key_bias, 3), zero(full_bias, 4)


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             bias: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention` returning ``(o, lse)``; lse (B, H, Lq) float32."""
    key_bias, full_bias = _normalize_bias(bias, q.shape[0], q.shape[2], k.shape[2])
    return _FlashAttention.apply(q, k, v, key_bias, full_bias)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v: (B, H, L, D) -> (B, H, Lq, D) in q's dtype.

    bias: None | (B or 1, 1, 1, Lk) key bias | (1, 1, Lq, Lk) full bias;
    other shapes raise ``ValueError`` (they belong on the sdpa path). Biases
    are mask constants: their gradient is zero."""
    return flash_attention_with_lse(q, k, v, bias)[0]


# -- static-offset serving attention ------------------------------------------

_STATIC_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _F, _P, _P,
                    _P, _I, _P]


def _static_key_bias(bias: Optional[torch.Tensor], b: int, lk: int) -> Optional[torch.Tensor]:
    """None or a key bias (B or 1, 1, 1, Lk) -> None or (B, Lk) float32."""
    if bias is None:
        return None
    if bias.ndim != 4 or bias.shape[1] != 1 or bias.shape[2] != 1:
        raise ValueError(f"static kernel needs a key bias, got {tuple(bias.shape)}")
    return torch.broadcast_to(bias[:, 0, 0, :], (b, lk)).float()


def _int8_core(a_q, a_k) -> bool:
    return a_q is not None and a_k is not None


def flash_attention_static_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, smax,
                                 bias: Optional[torch.Tensor] = None, a_q=None,
                                 a_k=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention_static`."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    dev = q.device
    kb = _static_key_bias(bias, b, lk)
    if kb is None:
        kb = torch.zeros((b, lk), dtype=torch.float32, device=dev)
    kb = (kb - torch.as_tensor(smax, dtype=torch.float32, device=dev))[:, None, None, :]
    if _int8_core(a_q, a_k):
        aq = torch.clamp(torch.as_tensor(a_q, dtype=torch.float32, device=dev), min=1e-30)
        ak = torch.clamp(torch.as_tensor(a_k, dtype=torch.float32, device=dev), min=1e-30)
        c127 = torch.tensor(127.0, device=dev)
        qx = torch.clamp(torch.round(q.float() * (c127 / aq)), -127, 127).to(torch.int8)
        kx = torch.clamp(torch.round(k.float() * (c127 / ak)), -127, 127).to(torch.int8)
        s = int_dot(qx, kx.transpose(-1, -2)) * (aq * ak / (127.0 * 127.0) * d ** -0.5) + kb
    else:
        qs = (q.to(torch.bfloat16).float() * d ** -0.5).to(torch.bfloat16).float()
        s = torch.matmul(qs, k.to(torch.bfloat16).float().transpose(-1, -2)) + kb
    p = torch.exp(torch.clamp(s, max=20.0)).to(torch.bfloat16).float()
    o = torch.matmul(p, v.to(torch.bfloat16).float())
    l = torch.sum(p, dim=-1, keepdim=True)
    return (o / torch.clamp(l, min=1e-30)).to(q.dtype)


def flash_attention_static(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, smax,
                           bias: Optional[torch.Tensor] = None, a_q=None,
                           a_k=None) -> torch.Tensor:
    """Serving attention with a calibrated static softmax offset.

    q, k, v: (B, H, L, D) -> (B, H, Lq, D) in q's dtype. ``smax``: the
    calibrated max attention logit (scalar); scores are offset by it and
    clipped at +20 before exp. ``bias``: None or a key bias (B, 1, 1, Lk).
    ``a_q`` / ``a_k``: calibrated amax of q and k; with both given the score
    product runs in int8. Forward only. On the card the output is allocated
    in the (B, L, H, D) layout and returned as its (B, H, L, D) view, so the
    caller's merge of the heads is free."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    kb = _static_key_bias(bias, b, lk)
    if plain_route(q):
        return flash_attention_static_plain(q, k, v, smax, bias, a_q, a_k)
    dev = q.device
    if d != CUDA_HEAD_DIM:
        raise NotImplementedError(
            f"the CUDA static attention kernel takes head dim {CUDA_HEAD_DIM}, got {d}")
    if k.shape != (b, h, lk, d) or v.shape != k.shape or k.device != dev or v.device != dev:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         f"must be (B, H, L, D) on one device")
    int8_core = _int8_core(a_q, a_k)
    out_bf16 = dtype_flag(q, "q")
    dtype_flag(k, "k")
    if not int8_core:  # the bf16 score core reads bf16 q and k (as the JAX function)
        q, k = q.to(torch.bfloat16), k.to(torch.bfloat16)
    elif q.dtype != k.dtype:
        raise TypeError(f"q and k must share one dtype, got {q.dtype}, {k.dtype}")
    q, k, v = _strided(q), _strided(k), _strided(v.to(torch.bfloat16))
    o = torch.empty((b, lq, h, d), dtype=torch.bfloat16 if out_bf16 else torch.float32,
                    device=dev).transpose(1, 2)
    f32 = dict(dtype=torch.float32, device=dev)
    smax = torch.as_tensor(smax, **f32).reshape(()).contiguous()
    kb = None if kb is None else kb.contiguous()
    a_q8 = a_k8 = q8 = k8 = None
    if int8_core:
        a_q8 = torch.as_tensor(a_q, **f32).reshape(()).contiguous()
        a_k8 = torch.as_tensor(a_k, **f32).reshape(()).contiguous()
        q8 = torch.empty((b, h, lq, d), dtype=torch.int8, device=dev)
        k8 = torch.empty((b, h, lk, d), dtype=torch.int8, device=dev)
    strides = (ctypes.c_long * 12)(*[s for t in (q, k, v, o) for s in t.stride()[:3]])
    so, fn = lib("flash_attention_static", _STATIC_ARGTYPES)
    run(so, fn, [ptr(q), ptr(k), ptr(v), dtype_flag(q, "q"), b, h, lq, lk, d,
                 ctypes.addressof(strides), ptr(kb), ptr(smax), ptr(a_q8), ptr(a_k8),
                 float(d ** -0.5), ptr(q8), ptr(k8), ptr(o), out_bf16,
                 torch.cuda.current_stream(dev).cuda_stream])
    LAUNCHES["flash_attention_static"] += 1
    return o
