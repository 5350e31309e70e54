"""Flash attention (forward and backward) for Hopper.

Counterpart of ``nova_pointcloud_tpu/ops/pallas/flash_attention.py``
``flash_attention``: ``softmax(q kᵀ/√d + bias) v`` by online softmax over key
tiles with float32 accumulation, the (Lq, Lk) scores never in device memory,
and the row log-sum-exp ``lse`` saved for the backward pass, which
recomputes the probabilities from it (the JAX ``_flash_bwd``).

- :func:`flash_attention` has the JAX function's signature (its TPU block
  sizes ``blk_q`` / ``blk_k`` are dropped: the CUDA kernels mask ragged
  tails themselves). It is differentiable: for CUDA tensors the forward
  launches ``csrc/flash_attention.cu`` (bf16: the wgmma and TMA main loop of
  ``csrc/flash_fwd.cuh``, launched as :func:`fwd_plan` lays it out; f32: a
  register-tiled SIMT kernel in f32 FFMA, launched as :func:`fwd_f32_plan`
  lays it out) and the backward the kernels of
  ``csrc/flash_attention_bwd.cu``: in bf16 the prep kernel (delta and lse
  rows), the one-pass dkvq kernel (wgmma and TMA: dK, dV, and dQ summed into
  an f32 workspace) and the cast of that workspace to dq, or at head dim 96
  the prep kernel, the dkv kernel (dK, dV) and the dq kernel (dQ, written
  in bf16), launched as :func:`bwd96_plan` lays them out; in f32 the prep
  kernel and the one-pass register-tiled SIMT kernel (f32 FFMA; dQ added
  into the zeroed dq), launched as :func:`bwd_f32_plan` lays it out, or at
  head dim 96 the prep kernel, the dkv_f32 kernel (dK, dV) and the dq_f32
  kernel (dQ, written once), register-tiled SIMT too, launched as
  :func:`bwd96_f32_plan` lays them out. For CPU tensors the forward runs
  :func:`flash_attention_plain` and the backward
  :func:`flash_attention_bwd_plain`. It never falls back from a kernel to its
  plain version: what a kernel does not take raises.
- :func:`flash_attention_plain` is the plain PyTorch forward, differentiable
  by autograd, returning ``(o, lse)``; :func:`flash_attention_bwd_plain` is
  the plain backward, written as the JAX kernels' math;
  :func:`bwd_prep_plain` and :func:`bwd_dq_cast_plain` are the plain
  versions of the prep and cast kernels, :func:`bwd_plan` the bf16 launch
  plan, :func:`bwd96_plan` the bf16 one at head dim 96, :func:`bwd_f32_plan`
  and :func:`bwd96_f32_plan` the f32 ones; :func:`fwd_plan` and
  :func:`fwd_f32_plan` the forward's.
- ``LAUNCHES[name]`` counts each kernel's launches: ``flash_attention``;
  ``flash_attention_bwd_prep``, ``flash_attention_bwd_dkvq``,
  ``flash_attention_bwd_dq_cast`` (bf16); ``flash_attention_bwd_dkv``,
  ``flash_attention_bwd_dq`` (bf16 at head dim 96, after the prep kernel);
  ``flash_attention_bwd_f32`` (f32, after the prep kernel);
  ``flash_attention_bwd_dkv_f32``, ``flash_attention_bwd_dq_f32`` (f32 at
  head dim 96, after the prep kernel).

The CUDA kernels take float32 or bfloat16 q, k, v of one dtype with head dim
64 or 96 (the NOVA-1.4B ViTs); any other head dim raises before any launch
(ROADMAP.md, queue 2). Any Lq and Lk,
and the three bias forms of the TPU kernel. Biases are mask constants: their
gradient is zero, as the JAX VJP declares it.

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
(``csrc/flash_attention_static.cu``: the forward's main loop without the
running max, bf16 or s8 wgmma for the scores) takes head dim 64 or 96 with
either score core, and a key bias or none;
:func:`flash_attention_static_plain` is its plain version, and
``LAUNCHES["flash_attention_static"]`` counts its launches. Forward only.
"""

import ctypes
from typing import Optional, Tuple

import torch

from nova_pointcloud_tpu_torch.ops.kernels._launch import (LAUNCHES, dtype_flag, lib,
                                                           plain_route, ptr, run)
from nova_pointcloud_tpu_torch.ops.kernels._launch import sms as _sms, stream as _stream
from nova_pointcloud_tpu_torch.ops.quantization import int_dot

NEG_INF = -1e30
CUDA_HEAD_DIMS = (64, 96)  # every kernel's, in f32 and bf16, with either score core
ONE_PASS_HEAD_DIM = 64  # the one-pass backward kernels' (bf16 dkvq, f32)
_STILL_TO_PORT = "still to port: ROADMAP.md, queue 2"

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_long
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _L, _P, _F, _P, _P, _I, _I, _P]
# the forward kernels' tiling (csrc/flash_fwd.cuh's Tiling, shared by
# flash_attention and flash_attention_static): a persistent grid of work
# items of 64 query rows a warpgroup, key tiles of 128 through a ring of
# stages; head dim -> (warpgroups, stages): three and four at 64, two and
# three at 96 (its 48 accumulators of O a thread need the registers of 256
# threads, its 48 KB K + V stages the room of three)
FWD_BLOCK_K = 128
FWD_TILING = {64: (3, 4), 96: (2, 3)}
FWD_WARPGROUPS, FWD_STAGES = FWD_TILING[64]
FWD_BLOCK_Q = 64 * FWD_WARPGROUPS
# the f32 forward kernel's (csrc/flash_attention.cu, flash_fwd_f32_kernel):
# one block of 128 threads a (query tile, batch*head), key tiles of 64; head
# dim -> query rows a block (8 a thread at 64, 4 at 96)
FWD_F32_BLOCK_QS = {64: 128, 96: 64}
FWD_F32_BLOCK_Q = FWD_F32_BLOCK_QS[64]
FWD_F32_BLOCK_K, FWD_F32_THREADS = 64, 128


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
    and the base address multiples of 16 bytes; a copy (a new, aligned
    allocation) only when needed."""
    per16 = 16 // t.element_size()
    ok = (t.stride(3) == 1 and all(s % per16 == 0 for s in t.stride()[:3])
          and t.data_ptr() % 16 == 0)
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def fwd_plan(b: int, h: int, lq: int, lk: int, sms: int, d: int = 64) -> dict:
    """The launch plan of the forward kernels (``flash_attention``'s bf16
    route and ``flash_attention_static``, both score cores) at head dim
    ``d`` (64 or 96), as ``csrc/flash_fwd.cuh`` lays out its shared memory
    (the kernel checks the grid and the bytes): two q slots of 64 rows per
    warpgroup, ``stages`` stages of a K and a V tile of 128 keys and their
    128 key-bias values (int8 tiles use part of that room), the mbarriers
    (one a stage, two a warpgroup) and release counts, a 256-byte tile of
    ones (the static kernel's row sums on the tensor cores), and 1024 bytes
    to align the swizzled tiles. One block per SM (``sms``) walks the
    (batch, head, 64 x ``warpgroups``-row) items."""
    warpgroups, stages = FWD_TILING[d]
    block_q = 64 * warpgroups
    q_slot, kv_slot, kb_slot = 64 * d * 2, FWD_BLOCK_K * d * 2, FWD_BLOCK_K * 4
    cnt_at = (2 * warpgroups * q_slot + stages * (2 * kv_slot + kb_slot)
              + (stages + 2 * warpgroups) * 8)
    q_tiles, key_tiles = -(-lq // block_q), -(-lk // FWD_BLOCK_K)
    items = b * h * q_tiles
    grid = min(items, sms)
    return dict(q_tiles=q_tiles, key_tiles=key_tiles, items=items, grid=(grid,),
                stages=stages, warpgroups=warpgroups, threads=128 * warpgroups,
                smem_bytes=-(-(cnt_at + 4 * stages) // 128) * 128 + 256 + 1024,
                last_keys=lk - (key_tiles - 1) * FWD_BLOCK_K,
                tiles_per_block=-(-items // grid) * key_tiles)


def fwd_f32_plan(b: int, h: int, lq: int, lk: int, d: int = 64) -> dict:
    """The launch plan of ``flash_attention``'s f32 route at head dim ``d``
    (64 or 96), as ``csrc/flash_attention.cu`` lays out
    ``flash_fwd_f32_kernel``'s shared memory (the kernel checks the grid and
    the bytes): q as ``block_q`` / 64 tiles of 64 rows x d f32, one K and one
    V tile of 64 keys, P as ``block_q`` / 64 tiles of 64 x 64, the key
    tile's 64 bias values, two mbarriers, and 1024 bytes to align the
    swizzled tiles: two blocks an SM at either head dim. One block a
    (``block_q``-row query tile, batch*head): 128 rows at 64, 64 at 96."""
    block_q = FWD_F32_BLOCK_QS[d]
    tile, p_tile = 64 * d * 4, 64 * 64 * 4
    q_tiles, key_tiles = -(-lq // block_q), -(-lk // FWD_F32_BLOCK_K)
    return dict(q_tiles=q_tiles, key_tiles=key_tiles, grid=(b * h * q_tiles,),
                threads=FWD_F32_THREADS, block_q=block_q,
                smem_bytes=(block_q // 64) * (tile + p_tile) + 2 * tile + FWD_F32_BLOCK_K * 4
                + 2 * 8 + 1024,
                last_keys=lk - (key_tiles - 1) * FWD_F32_BLOCK_K)


def _key_bias_rows(kb: Optional[torch.Tensor], lk: int, dev) -> Tuple[Optional[torch.Tensor], int]:
    """A (B, Lk) key bias as the forward kernels bulk-copy it: float32 rows,
    16-byte aligned, at a row stride that is a multiple of 4 floats (0 for
    one row shared by every batch); a copy padded to a multiple of 4 keys
    only when the view is not so. -> (rows, row stride)."""
    if kb is None:
        return None, 0
    kb = kb.to(device=dev, dtype=torch.float32)
    if (lk % 4 == 0 and kb.stride(1) == 1 and kb.stride(0) % 4 == 0
            and kb.data_ptr() % 16 == 0):
        return kb, kb.stride(0)
    rows = torch.zeros((kb.shape[0], -(-lk // 4) * 4), dtype=torch.float32, device=dev)
    rows[:, :lk] = kb
    return rows, rows.stride(0)


def _checked_plan(b: int, h: int, lq: int, lk: int, dev, f32: bool = False, d: int = 64
                  ) -> dict:
    """:func:`fwd_plan` on ``dev``'s card at head dim ``d``
    (:func:`fwd_f32_plan` for the f32 route); raises where the kernel's int
    counts of items and key tiles, or of blocks, would overflow."""
    if f32:
        plan = fwd_f32_plan(b, h, lq, lk, d)
        if plan["grid"][0] >= 2 ** 31:
            raise ValueError(f"{plan['grid'][0]} blocks: over the kernel's int range")
        return plan
    plan = fwd_plan(b, h, lq, lk, _sms(dev), d)
    if plan["items"] * plan["key_tiles"] >= 2 ** 31:
        raise ValueError(f"{plan['items']} work items of {plan['key_tiles']} key tiles: over the "
                         f"kernel's int range")
    return plan


def _check_head_dim(d: int, what: str) -> None:
    """Raise, before any launch, for a head dim the flash kernels do not
    take: 64 and 96, in f32 and bf16."""
    if d not in CUDA_HEAD_DIMS:
        raise NotImplementedError(
            f"the CUDA {what} takes head dim {' or '.join(map(str, CUDA_HEAD_DIMS))}, got {d}: "
            f"{_STILL_TO_PORT}")


def _launch(q, k, v, key_bias, full_bias):
    """The forward kernel; every check before the launch."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    dev = q.device
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v must share one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    is_bf16 = dtype_flag(q, "q, k, v")
    _check_head_dim(d, "flash kernel")
    if k.shape != (b, h, lk, d) or v.shape != k.shape or k.device != dev or v.device != dev:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         f"must be (B, H, L, D) on one device")
    if key_bias is not None and full_bias is not None:
        raise ValueError("a key bias and a full bias cannot be combined")
    plan = _checked_plan(b, h, lq, lk, dev, f32=not is_bf16, d=d)
    q, k, v = _strided(q), _strided(k), _strided(v)
    o = torch.empty_like(q)  # q's strides: a (B, L, H, D) view stays one
    if o.stride(3) != 1:
        o = torch.empty(q.shape, dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=dev)
    strides = (ctypes.c_long * 12)(*[s for t in (q, k, v, o) for s in t.stride()[:3]])
    kb, kb_sb = _key_bias_rows(key_bias, lk, dev)
    if full_bias is not None:
        full_bias = full_bias.to(device=dev, dtype=torch.float32).contiguous()
    so, fn = lib("flash_attention", _ARGTYPES)
    run(so, fn, [ptr(q), ptr(k), ptr(v), is_bf16, b, h, lq, lk, d,
                 ctypes.addressof(strides), ptr(kb), kb_sb, ptr(full_bias),
                 float(d ** -0.5), ptr(o), ptr(lse), plan["grid"][0], plan["smem_bytes"],
                 _stream(dev)])
    LAUNCHES["flash_attention"] += 1
    return o, lse


_PREP_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P]
_DKVQ_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _F, _P, _P, _P,
                  _I, _I, _I, _P]  # the f32 kernel's too
_CAST_ARGTYPES = [_P, _I, _I, _I, _I, _I, _P, _F, _P, _P]
_DKV_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _F, _P, _P, _I, _I,
                 _P]
_DQ_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _F, _P, _I, _I, _P]
_LQ_PAD = 128  # lse / delta / dq workspace rows are padded to a multiple of this
LOG2E = 1.4426950408889634
# the bf16 kernel's tiling (csrc/flash_attention_bwd.cu): blocks of 128 keys,
# two warpgroups of 64 keys each; each streams query tiles of 64 through its
# own ring of BWD_STAGES stages
BWD_BLOCK_K, BWD_BLOCK_Q, BWD_STAGES = 128, 64, 2
# the f32 kernel's: blocks of 64 keys and 128 threads, query tiles of 64
# through one buffer; shared memory: K, V, the tile's q and do, P (then the
# tile's dq part) and dS as 64 x 64 f32 tiles, the tile's lse and delta rows,
# two mbarriers, 1 KB to align the swizzled tiles: two blocks an SM
BWD_F32_BLOCK_K, BWD_F32_BLOCK_Q, BWD_F32_THREADS = 64, 64, 128

# the head-dim-96 bf16 kernels' (the dkv and dq kernels): one warpgroup a
# block, tiles of 64 rows (three 32-column panels) through two stages;
# shared memory: dkv K, V and two stages of q, do and their lse / delta
# rows, dq q, do and two stages of K, V; three mbarriers; 1 KB to align
BWD96_BLOCK, BWD96_STAGES, BWD96_THREADS = 64, 2, 128
# the head-dim-96 f32 kernels' (dkv_f32, dq_f32): the same blocks and stages,
# 256 threads (eight warps of register-tiled SIMT products) a block
BWD96_F32_THREADS = 256

BWD_KERNELS = ("flash_attention_bwd_prep", "flash_attention_bwd_dkvq",
               "flash_attention_bwd_dq_cast")  # bf16, in launch order
BWD96_KERNELS = ("flash_attention_bwd_prep", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq")  # bf16 at head dim 96
BWD_F32_KERNELS = ("flash_attention_bwd_prep", "flash_attention_bwd_f32")
BWD96_F32_KERNELS = ("flash_attention_bwd_prep", "flash_attention_bwd_dkv_f32",
                     "flash_attention_bwd_dq_f32")  # f32 at head dim 96


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
    bit at head dim 64 (the kernel's order at 96 too: halves of 48); lse in
    units of log 2 when ``log2``."""
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
    tile = 64 * ONE_PASS_HEAD_DIM * 2
    rows_at = (4 * tile + 2 * BWD_STAGES * 2 * tile + 4 * tile
               + 4 * BWD_BLOCK_Q * ONE_PASS_HEAD_DIM * 4)
    bars_at = rows_at + 2 * BWD_STAGES * 2 * BWD_BLOCK_Q * 4
    smem = -(-(bars_at + 2 * (BWD_STAGES + 1) * 8) // 16) * 16 + 1024
    lqp = -(-lq // _LQ_PAD) * _LQ_PAD
    key_tiles = -(-lk // BWD_BLOCK_K)
    return dict(lqp=lqp, key_tiles=key_tiles, q_tiles=-(-lq // BWD_BLOCK_Q),
                grid=(key_tiles, b * h), smem_bytes=smem, workspace=(b * h, lqp, ONE_PASS_HEAD_DIM))


def bwd96_plan(b: int, h: int, lq: int, lk: int) -> dict:
    """The head-dim-96 bf16 backward's launch plan, as
    ``csrc/flash_attention_bwd.cu`` lays out the dkv and dq kernels' shared
    memory (which check it): one block of a warpgroup per (64 keys, B*H) for
    dkv, per (64 queries, B*H) for dq; 12 KB tiles of 64 x 96 bf16."""
    tile = BWD96_BLOCK * 96 * 2
    rows = BWD96_STAGES * 2 * BWD96_BLOCK * 4
    bars = (BWD96_STAGES + 1) * 8
    key_tiles, q_tiles = -(-lk // BWD96_BLOCK), -(-lq // BWD96_BLOCK)
    return dict(lqp=-(-lq // _LQ_PAD) * _LQ_PAD, key_tiles=key_tiles, q_tiles=q_tiles,
                dkv_grid=(key_tiles, b * h), dq_grid=(q_tiles, b * h), threads=BWD96_THREADS,
                dkv_smem=-(-(2 * tile + BWD96_STAGES * 2 * tile + rows + bars) // 16) * 16 + 1024,
                dq_smem=-(-(2 * tile + BWD96_STAGES * 2 * tile + bars) // 16) * 16 + 1024)


def bwd_f32_plan(b: int, h: int, lq: int, lk: int) -> dict:
    """The f32 backward's launch plan, as ``csrc/flash_attention_bwd.cu``
    lays out the f32 kernel's shared memory (which checks it): K and V of
    its 64 keys, the query tile's q and do, P (then the tile's dq part) and
    dS, six 64 x 64 f32 tiles; the tile's lse and delta rows; two mbarriers;
    1024 bytes to align the swizzled tiles. ``workspace``: the dq the
    kernel adds into, zeroed, in the (B, L, H, D) layout (no other
    scratch)."""
    tile = BWD_F32_BLOCK_Q * ONE_PASS_HEAD_DIM * 4
    smem = 6 * tile + 2 * BWD_F32_BLOCK_Q * 4 + 2 * 8 + 1024
    key_tiles = -(-lk // BWD_F32_BLOCK_K)
    return dict(lqp=-(-lq // _LQ_PAD) * _LQ_PAD, key_tiles=key_tiles,
                q_tiles=-(-lq // BWD_F32_BLOCK_Q), grid=(key_tiles, b * h),
                threads=BWD_F32_THREADS, smem_bytes=smem, workspace=(b, lq, h, ONE_PASS_HEAD_DIM))


def bwd96_f32_plan(b: int, h: int, lq: int, lk: int) -> dict:
    """The f32 backward's launch plan at head dim 96, as
    ``csrc/flash_attention_bwd.cu`` lays out the dkv_f32 and dq_f32 kernels'
    shared memory (which check it): one block of 256 threads per (64 keys,
    B*H) for dkv_f32 (K, V, two stages of q, do and their lse / delta rows,
    P and dS), per (64 queries, B*H) for dq_f32 (q, do, two stages of K, V,
    dS); 24 KB tiles of 64 x 96 f32, 16 KB of P or dS; three mbarriers; 1 KB
    to align. No workspace: each kernel writes its outputs once."""
    tile, s_tile = BWD96_BLOCK * 96 * 4, BWD96_BLOCK * BWD96_BLOCK * 4
    rows = BWD96_STAGES * 2 * BWD96_BLOCK * 4
    bars = (BWD96_STAGES + 1) * 8
    key_tiles, q_tiles = -(-lk // BWD96_BLOCK), -(-lq // BWD96_BLOCK)
    ring = 2 * tile + BWD96_STAGES * 2 * tile
    return dict(lqp=-(-lq // _LQ_PAD) * _LQ_PAD, key_tiles=key_tiles, q_tiles=q_tiles,
                dkv_grid=(key_tiles, b * h), dq_grid=(q_tiles, b * h),
                threads=BWD96_F32_THREADS,
                dkv_smem=-(-(ring + 2 * s_tile + rows + bars) // 16) * 16 + 1024,
                dq_smem=-(-(ring + s_tile + bars) // 16) * 16 + 1024)


def _bwd_operands(q, k, v, key_bias, full_bias, o, lse, do):
    """Every check of the backward kernels, then their launches in order
    (name, argtypes, ctypes arguments, the tensors behind the pointers) and
    the outputs (dq, dk, dv) they write. bf16: prep, dkvq, cast (head dim
    96: prep, dkv, dq); f32: prep, the one-pass f32 kernel (head dim 96:
    prep, dkv_f32, dq_f32)."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    dev = q.device
    if not (q.dtype == k.dtype == v.dtype == o.dtype == do.dtype):
        raise TypeError(f"q, k, v, o, do must share one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}, {o.dtype}, {do.dtype}")
    is_bf16 = dtype_flag(q, "q, k, v")
    _check_head_dim(d, "flash backward kernels")
    hd96 = d == 96
    if (k.shape != (b, h, lk, d) or v.shape != k.shape or o.shape != q.shape
            or do.shape != q.shape or lse.shape != (b, h, lq)
            or any(t.device != dev for t in (k, v, o, do, lse))):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"o {tuple(o.shape)}, do {tuple(do.shape)}, lse {tuple(lse.shape)} "
                         f"must be (B, H, L, D) (lse (B, H, Lq)) on one device")
    if lse.dtype != torch.float32:
        raise TypeError(f"lse must be float32, got {lse.dtype}")
    plan = ((bwd96_plan if is_bf16 else bwd96_f32_plan) if hd96
            else bwd_plan if is_bf16 else bwd_f32_plan)(b, h, lq, lk)
    if b * h > 65535 or (is_bf16 and b * h * plan["lqp"] >= 2 ** 31):
        raise ValueError(f"B*H = {b * h} over the grid's 65535 rows, or B*H*Lq over the "
                         f"dq workspace map's 2^31 rows")
    q, k, v, o, do = (_strided(t) for t in (q, k, v, o, do))
    lse = lse.contiguous()
    lqp = plan["lqp"]
    f32 = dict(dtype=torch.float32, device=dev)
    lse_rows, delta = torch.empty((b * h, lqp), **f32), torch.empty((b * h, lqp), **f32)
    dk, dv = (torch.empty((b, lk, h, d), dtype=q.dtype, device=dev).transpose(1, 2)
              for _ in range(2))
    # the one-pass f32 kernel adds its dq parts into dq itself
    dq = (torch.zeros if not is_bf16 and not hd96 else torch.empty)(
        (b, lq, h, d), dtype=q.dtype, device=dev).transpose(1, 2)
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
    if hd96 and not is_bf16:
        all_s = strides(q, k, v, do, dq, dk, dv)
        args = [ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse_rows), ptr(delta), b, h, lq, lk, lqp, d,
                ctypes.addressof(all_s), ptr(key_bias), ptr(full_bias), scale, ptr(dq), ptr(dk),
                ptr(dv), plan["key_tiles"], plan["q_tiles"]]
        held = (q, k, v, do, lse_rows, delta, key_bias, full_bias, all_s)
        launches += [("flash_attention_bwd_dkv_f32", _DKVQ_ARGTYPES,
                      args + [plan["dkv_smem"], stream], held),
                     ("flash_attention_bwd_dq_f32", _DKVQ_ARGTYPES,
                      args + [plan["dq_smem"], stream], held)]
    elif hd96:
        main_s = strides(q, k, v, do, dk, dv)
        dq_s = strides(q, k, v, do, dq)
        common = [ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse_rows), ptr(delta), b, h, lq, lk, lqp,
                  d]
        launches += [
            ("flash_attention_bwd_dkv", _DKV_ARGTYPES,
             common + [ctypes.addressof(main_s), ptr(key_bias), ptr(full_bias), scale, ptr(dk),
                       ptr(dv), plan["key_tiles"], plan["dkv_smem"], stream],
             (q, k, v, do, lse_rows, delta, key_bias, full_bias, main_s)),
            ("flash_attention_bwd_dq", _DQ_ARGTYPES,
             common + [ctypes.addressof(dq_s), ptr(key_bias), ptr(full_bias), scale, ptr(dq),
                       plan["q_tiles"], plan["dq_smem"], stream],
             (q, k, v, do, lse_rows, delta, key_bias, full_bias, dq_s))]
    elif is_bf16:
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
        launches.append(
            ("flash_attention_bwd_f32", _DKVQ_ARGTYPES,
             [ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse_rows), ptr(delta), b, h, lq, lk, lqp, d,
              ctypes.addressof(all_s), ptr(key_bias), ptr(full_bias), scale, ptr(dq), ptr(dk),
              ptr(dv), plan["key_tiles"], plan["q_tiles"], plan["smem_bytes"], stream],
             (q, k, v, do, lse_rows, delta, key_bias, full_bias, dq, all_s)))
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
    ins = (q, k, v, key_bias, full_bias)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ins):
        return _FlashAttention.apply(*ins)
    # nothing to differentiate (serving): the same kernel without the
    # autograd node, whose bookkeeping costs host time on every call
    return _plain(*ins) if plain_route(q) else _launch(*ins)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v: (B, H, L, D) -> (B, H, Lq, D) in q's dtype.

    bias: None | (B or 1, 1, 1, Lk) key bias | (1, 1, Lq, Lk) full bias;
    other shapes raise ``ValueError`` (they belong on the sdpa path). Biases
    are mask constants: their gradient is zero."""
    return flash_attention_with_lse(q, k, v, bias)[0]


# -- static-offset serving attention ------------------------------------------

_STATIC_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _L, _P, _P, _P, _F, _P, _P,
                    _P, _I, _I, _I, _P]


def _static_key_bias(bias: Optional[torch.Tensor], b: int, lk: int) -> Optional[torch.Tensor]:
    """None or a key bias (B or 1, 1, 1, Lk) -> None or (B, Lk) float32."""
    if bias is None:
        return None
    if bias.ndim != 4 or bias.shape[1] != 1 or bias.shape[2] != 1:
        raise ValueError(f"static kernel needs a key bias, got {tuple(bias.shape)}")
    return torch.broadcast_to(bias[:, 0, 0, :], (b, lk)).float()


def _int8_core(a_q, a_k) -> bool:
    """True for the int8 score core; a_q and a_k come together or not at all."""
    if (a_q is None) != (a_k is None):
        raise ValueError("the int8 score core needs both a_q and a_k, got "
                         f"a_q={'set' if a_q is not None else None}, "
                         f"a_k={'set' if a_k is not None else None}")
    return a_q is not None


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


def _launch_static(q, k, v, smax, kb, a_q, a_k):
    """The static kernel (and, for the int8 core, its quant pass); every
    check before the launch. kb: None or the (B, Lk) key bias."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    dev = q.device
    int8_core = _int8_core(a_q, a_k)
    _check_head_dim(d, "static attention kernel")
    if k.shape != (b, h, lk, d) or v.shape != k.shape or k.device != dev or v.device != dev:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         f"must be (B, H, L, D) on one device")
    out_bf16 = dtype_flag(q, "q")
    dtype_flag(k, "k")
    if not int8_core:  # the bf16 score core reads bf16 q and k (as the JAX function)
        q, k = q.to(torch.bfloat16), k.to(torch.bfloat16)
    elif q.dtype != k.dtype:
        raise TypeError(f"q and k must share one dtype, got {q.dtype}, {k.dtype}")
    plan = _checked_plan(b, h, lq, lk, dev, d=d)
    q, k, v = _strided(q), _strided(k), _strided(v.to(torch.bfloat16))
    o = torch.empty((b, lq, h, d), dtype=torch.bfloat16 if out_bf16 else torch.float32,
                    device=dev).transpose(1, 2)
    f32 = dict(dtype=torch.float32, device=dev)
    smax = torch.as_tensor(smax, **f32).reshape(()).contiguous()
    kb, kb_sb = _key_bias_rows(kb, lk, dev)
    a_q8 = a_k8 = q8 = k8 = None
    if int8_core:
        a_q8 = torch.as_tensor(a_q, **f32).reshape(()).contiguous()
        a_k8 = torch.as_tensor(a_k, **f32).reshape(()).contiguous()
        q8 = torch.empty((b, h, lq, d), dtype=torch.int8, device=dev)
        k8 = torch.empty((b, h, lk, d), dtype=torch.int8, device=dev)
    strides = (ctypes.c_long * 12)(*[s for t in (q, k, v, o) for s in t.stride()[:3]])
    so, fn = lib("flash_attention_static", _STATIC_ARGTYPES)
    run(so, fn, [ptr(q), ptr(k), ptr(v), dtype_flag(q, "q"), b, h, lq, lk, d,
                 ctypes.addressof(strides), ptr(kb), kb_sb, ptr(smax), ptr(a_q8), ptr(a_k8),
                 float(d ** -0.5), ptr(q8), ptr(k8), ptr(o), out_bf16, plan["grid"][0],
                 plan["smem_bytes"], _stream(dev)])
    LAUNCHES["flash_attention_static"] += 1
    return o


def flash_attention_static(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, smax,
                           bias: Optional[torch.Tensor] = None, a_q=None,
                           a_k=None) -> torch.Tensor:
    """Serving attention with a calibrated static softmax offset.

    q, k, v: (B, H, L, D) -> (B, H, Lq, D) in q's dtype. ``smax``: the
    calibrated max attention logit (scalar); scores are offset by it and
    clipped at +20 before exp. ``bias``: None or a key bias (B, 1, 1, Lk).
    ``a_q`` / ``a_k``: calibrated amax of q and k; with both given the score
    product runs in int8 (one without the other raises). Forward only. On
    the card the output is allocated in the (B, L, H, D) layout and returned
    as its (B, H, L, D) view, so the caller's merge of the heads is free."""
    kb = _static_key_bias(bias, q.shape[0], k.shape[2])
    _int8_core(a_q, a_k)
    if plain_route(q):
        return flash_attention_static_plain(q, k, v, smax, bias, a_q, a_k)
    return _launch_static(q, k, v, smax, kb, a_q, a_k)
