"""The forward flash kernels' pieces around their CUDA code, on the CPU: the
launch plan of ``flash_attention``'s bf16 route and of
``flash_attention_static`` (both score cores), and of the f32 route's kernel,
at the ported paths' shapes and at ragged ones, the launch arguments the
wrappers hand over (with the
launch itself replaced by a recorder), the checks that raise before any
launch, and the identity the bf16 score core rests on: with d = 64 the
softmax scale is 2^-3, so ``bf16(q * 2^-3) kᵀ`` equals ``(q kᵀ) * 2^-3``
bit for bit and the kernel may put the scale on the f32 scores.

Tolerances: none; the plan is integer arithmetic and the identity is exact.
"""

import ctypes

import numpy as np
import pytest
import torch

from nova_pointcloud_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
from nova_pointcloud_tpu_torch.ops.kernels import flash_attention as tfa

SMS = 132  # the H100's streaming multiprocessors: one persistent block each
SMEM_LIMIT = 232448  # a block's shared memory on the H100
# csrc/flash_fwd.cuh: two 8 KB q slots per warpgroup (3), 4 stages of a
# 16 KB K and a 16 KB V tile and 512 bytes of key bias, 10 mbarriers, 4
# release counts, 256 bytes of ones at a 128-byte boundary, 1 KB to align
# the swizzled tiles
SMEM = 183680


def _blhd(rng, b, h, l, d=64, dtype=torch.bfloat16):
    """(B, H, L, D) as the model hands it over: a view of (B, L, H, D)."""
    x = torch.from_numpy(rng.standard_normal((b, l, h, d)).astype(np.float32)).to(dtype)
    return x.transpose(1, 2)


PLANS = [  # (b, h, lq, lk): q tiles, key tiles, items, grid, last tile's keys, tiles a block
    ((16, 12, 2048, 2048), (11, 16, 2112, 132, 128, 256)),  # per-point float serving
    ((8, 16, 1280, 1280), (7, 10, 896, 132, 128, 70)),      # t2i full phase, training
    ((8, 16, 768, 768), (4, 6, 512, 132, 128, 24)),         # t2i gather buckets
    ((8, 16, 512, 512), (3, 4, 384, 132, 128, 12)),
    ((8, 16, 384, 384), (2, 3, 256, 132, 128, 6)),
    ((8, 16, 288, 288), (2, 3, 256, 132, 32, 6)),           # the video encoder
    ((2, 12, 333, 1531), (2, 12, 48, 48, 123, 12)),         # ragged checks
    ((2, 12, 1000, 1531), (6, 12, 144, 132, 123, 24)),
]


@pytest.mark.parametrize("shape,want", PLANS, ids=[str(s) for s, _ in PLANS])
def test_fwd_plan(shape, want):
    plan = tfa.fwd_plan(*shape, SMS)
    got = tuple(plan[k] for k in ("q_tiles", "key_tiles", "items"))
    assert got == want[:3]
    assert plan["grid"] == (want[3],) and plan["last_keys"] == want[4]
    assert plan["tiles_per_block"] == want[5]
    assert plan["stages"] == tfa.FWD_STAGES == 4
    assert plan["smem_bytes"] == SMEM <= SMEM_LIMIT
    b, h, lq, lk = shape
    assert plan["q_tiles"] * tfa.FWD_BLOCK_Q >= lq > (plan["q_tiles"] - 1) * tfa.FWD_BLOCK_Q
    assert 0 < plan["last_keys"] <= tfa.FWD_BLOCK_K


# csrc/flash_attention.cu, flash_fwd_f32_kernel: q as two 16 KB tiles, one
# 16 KB K and one 16 KB V tile, P as two 16 KB tiles, 256 bytes of key bias,
# two mbarriers, 1 KB to align the swizzled tiles
F32_SMEM = 99600
F32_PLANS = [  # (b, h, lq, lk): q tiles, key tiles, grid, last tile's keys
    ((8, 16, 1280, 1280), (10, 20, 1280, 64)),  # the f32 training step
    ((2, 12, 1000, 1531), (8, 24, 192, 59)),    # ragged checks
    ((2, 12, 515, 1000), (5, 16, 120, 40)),
    ((2, 12, 37, 45), (1, 1, 24, 45)),          # under one tile
]


@pytest.mark.parametrize("shape,want", F32_PLANS, ids=[str(s) for s, _ in F32_PLANS])
def test_fwd_f32_plan(shape, want):
    plan = tfa.fwd_f32_plan(*shape)
    assert (plan["q_tiles"], plan["key_tiles"], plan["grid"], plan["last_keys"]) == (
        want[0], want[1], (want[2],), want[3])
    assert plan["threads"] == tfa.FWD_F32_THREADS == 128
    assert plan["smem_bytes"] == F32_SMEM <= SMEM_LIMIT
    # two blocks an SM: 228 KB of shared memory, 1 KB of it reserved a block
    assert 2 * (plan["smem_bytes"] + 1024) <= 228 * 1024
    b, h, lq, lk = shape
    assert plan["grid"][0] == b * h * plan["q_tiles"]
    assert plan["q_tiles"] * tfa.FWD_F32_BLOCK_Q >= lq > (plan["q_tiles"] - 1) * tfa.FWD_F32_BLOCK_Q
    assert 0 < plan["last_keys"] <= tfa.FWD_F32_BLOCK_K


class _Recorder:
    """Stands in for the ctypes launch: records each call's name and
    arguments, and the strides array while it lives."""

    def __init__(self):
        self.calls = []

    def lib(self, name, argtypes, library=None):
        assert library is None
        return name, argtypes

    def run(self, so, fn, args):
        name, argtypes = so, fn
        assert len(args) == len(argtypes), name
        arr = ctypes.cast(args[9], ctypes.POINTER(ctypes.c_long))
        self.calls.append((name, args, [arr[i] for i in range(12)]))


@pytest.fixture
def rec(monkeypatch):
    r = _Recorder()
    monkeypatch.setattr(tfa, "lib", r.lib)
    monkeypatch.setattr(tfa, "run", r.run)
    monkeypatch.setattr(tfa, "_stream", lambda dev: 0)
    monkeypatch.setattr(tfa, "_sms", lambda dev: SMS)
    yield r
    reset_launch_counts()


@pytest.mark.parametrize("shape", [s for s, _ in PLANS], ids=[str(s) for s, _ in PLANS])
@pytest.mark.parametrize("bias", ["none", "key"])
def test_forward_launch_follows_the_plan(rec, shape, bias):
    b, h, lq, lk = shape
    rng = np.random.default_rng(lq + lk)
    q, k, v = _blhd(rng, b, h, lq), _blhd(rng, b, h, lk), _blhd(rng, b, h, lk)
    kb = torch.zeros((b, lk)) if bias == "key" else None
    o, lse = tfa._launch(q, k, v, kb, None)
    plan = tfa.fwd_plan(b, h, lq, lk, SMS)
    (name, args, strides), = rec.calls
    assert name == "flash_attention" and LAUNCHES["flash_attention"] == 1
    assert args[3:9] == [1, b, h, lq, lk, 64]
    assert args[16:18] == [plan["grid"][0], plan["smem_bytes"]]
    # q, k, v, o: (batch, head, row) strides of (B, L, H, D) views, read in place
    assert strides == [s for n in (lq, lk, lk, lq) for s in (n * h * 64, 64, h * 64)]
    assert args[0] == q.data_ptr() and args[14] == o.data_ptr() and args[15] == lse.data_ptr()
    assert o.shape == q.shape and o.stride() == q.stride() and lse.shape == (b, h, lq)
    if bias == "key":
        # rows of Lk rounded up to 4 floats, 16-byte aligned: the kernel
        # bulk-copies a tile's 128 values
        assert args[11] % 4 == 0 and args[11] >= lk and args[10] % 16 == 0
        assert (args[11] == lk) == (lk % 4 == 0)  # copied only when Lk % 4 != 0
    else:
        assert args[10] is None and args[11] == 0


@pytest.mark.parametrize("shape", [s for s, _ in F32_PLANS], ids=[str(s) for s, _ in F32_PLANS])
@pytest.mark.parametrize("bias", ["none", "key", "full"])
def test_f32_forward_launch_follows_the_plan(rec, shape, bias):
    """The f32 route launches with fwd_f32_plan's grid and bytes (not the
    bf16 plan's), reading q, k, v and writing o as the model's (B, L, H, D)
    views in place."""
    b, h, lq, lk = shape
    rng = np.random.default_rng(lq * 3 + lk)
    q, k, v = (_blhd(rng, b, h, n, dtype=torch.float32) for n in (lq, lk, lk))
    kb = torch.zeros((b, lk)) if bias == "key" else None
    fbias = torch.zeros((lq, lk)) if bias == "full" else None
    o, lse = tfa._launch(q, k, v, kb, fbias)
    plan = tfa.fwd_f32_plan(b, h, lq, lk)
    (name, args, strides), = rec.calls
    assert name == "flash_attention" and LAUNCHES["flash_attention"] == 1
    assert args[3:9] == [0, b, h, lq, lk, 64]
    assert args[16:18] == [plan["grid"][0], plan["smem_bytes"]]
    assert args[16:18] != [tfa.fwd_plan(b, h, lq, lk, SMS)["grid"][0],
                           tfa.fwd_plan(b, h, lq, lk, SMS)["smem_bytes"]]
    assert strides == [s for n in (lq, lk, lk, lq) for s in (n * h * 64, 64, h * 64)]
    assert args[:3] == [q.data_ptr(), k.data_ptr(), v.data_ptr()]
    assert args[14] == o.data_ptr() and args[15] == lse.data_ptr()
    assert o.shape == q.shape and o.stride() == q.stride() and o.dtype == torch.float32
    assert lse.shape == (b, h, lq) and lse.dtype == torch.float32
    assert args[13] == 0.125
    if bias == "key":  # rows of Lk rounded up to 4 floats, 16-byte aligned
        assert args[11] % 4 == 0 and args[11] >= lk and args[10] % 16 == 0
    else:
        assert args[10] is None and args[11] == 0
    if bias == "full":  # (Lq, Lk) f32, contiguous
        assert args[12] == fbias.data_ptr()
    else:
        assert args[12] is None


@pytest.mark.parametrize("core", ["bf16", "int8"])
@pytest.mark.parametrize("shape", [s for s, _ in PLANS], ids=[str(s) for s, _ in PLANS])
def test_static_launch_follows_the_plan(rec, shape, core):
    b, h, lq, lk = shape
    rng = np.random.default_rng(lq * lk)
    # one (B, L, 3, H, 64) projection, as the ViT hands it over
    qkv = torch.from_numpy(rng.standard_normal((b, lq, 3, h, 64)).astype(np.float32))
    qkv = qkv.to(torch.bfloat16)
    q = qkv[:, :, 0].transpose(1, 2)
    k, v = _blhd(rng, b, h, lk), _blhd(rng, b, h, lk)
    kw = dict(a_q=torch.tensor(4.5), a_k=torch.tensor(4.0)) if core == "int8" else {}
    o = tfa._launch_static(q, k, v, torch.tensor(9.0), torch.zeros((b, lk)), kw.get("a_q"),
                           kw.get("a_k"))
    plan = tfa.fwd_plan(b, h, lq, lk, SMS)
    (name, args, strides), = rec.calls
    assert name == "flash_attention_static" and LAUNCHES["flash_attention_static"] == 1
    assert args[3:9] == [1, b, h, lq, lk, 64]
    assert args[20:22] == [plan["grid"][0], plan["smem_bytes"]]
    assert args[15] == 0.125  # d^-0.5 = 2^-3: the kernel puts it on the f32 scores
    assert strides[:3] == [lq * 3 * h * 64, 64, 3 * h * 64]  # q read in place from qkv
    assert strides[9:] == [lq * h * 64, 64, h * 64]  # o written in (B, L, H, D)
    assert o.shape == (b, h, lq, 64) and o.dtype == torch.bfloat16
    assert o.transpose(1, 2).is_contiguous()
    if core == "int8":  # the quant pass's contiguous codes
        assert args[13] is not None and args[14] is not None
        assert args[16] is not None and args[17] is not None
    else:
        assert args[13] is None and args[14] is None and args[16] is None


def _raises_before_launch(rec, exc, fn):
    with pytest.raises(exc):
        fn()
    assert rec.calls == []
    assert LAUNCHES["flash_attention"] == LAUNCHES["flash_attention_static"] == 0


def test_argument_checks_raise_before_any_launch(rec):
    rng = np.random.default_rng(7)
    b, h, lq, lk = 2, 3, 200, 300
    q, k, v = _blhd(rng, b, h, lq), _blhd(rng, b, h, lk), _blhd(rng, b, h, lk)
    smax = torch.tensor(9.0)
    # dtype
    _raises_before_launch(rec, TypeError, lambda: tfa._launch(q.half(), k.half(), v.half(),
                                                              None, None))
    _raises_before_launch(rec, TypeError, lambda: tfa._launch(q, k.float(), v, None, None))
    _raises_before_launch(rec, TypeError, lambda: tfa._launch_static(
        q.half(), k, v, smax, None, None, None))
    # head dim: 64 or 96 (either dtype, either static score core); any
    # other head dim raises
    for d in (80, 128):
        qd, kd, vd = (_blhd(rng, b, h, n, d) for n in (lq, lk, lk))
        _raises_before_launch(rec, NotImplementedError,
                              lambda: tfa._launch(qd, kd, vd, None, None))
        _raises_before_launch(rec, NotImplementedError,
                              lambda: tfa._launch_static(qd, kd, vd, smax, None, None, None))
    # bias forms: per-head, mismatched, a full bias on the static kernel
    for bias in (torch.zeros((b, h, 1, lk)), torch.zeros((b, 1, 1, lk + 1))):
        _raises_before_launch(rec, ValueError,
                              lambda: tfa.flash_attention_with_lse(q, k, v, bias))
    _raises_before_launch(rec, ValueError, lambda: tfa.flash_attention_static(
        q, k, v, smax, torch.zeros((1, 1, lq, lk))))
    _raises_before_launch(rec, ValueError, lambda: tfa._launch(
        q, k, v, torch.zeros((b, lk)), torch.zeros((lq, lk))))
    # shapes
    _raises_before_launch(rec, ValueError, lambda: tfa._launch(q, k, v[:, :, :-1], None, None))
    # a missing a_k (or a_q): the int8 core needs both
    for kw in (dict(a_q=torch.tensor(4.0)), dict(a_k=torch.tensor(4.0))):
        _raises_before_launch(rec, ValueError,
                              lambda: tfa.flash_attention_static(q, k, v, smax, **kw))
        _raises_before_launch(rec, ValueError, lambda: tfa._launch_static(
            q, k, v, smax, None, kw.get("a_q"), kw.get("a_k")))
    # the f32 route: head dim, shapes, a bias pair, and a grid over the
    # kernel's int range (expanded views: no memory behind them)
    qf, kf, vf = q.float(), k.float(), v.float()
    _raises_before_launch(rec, ValueError, lambda: tfa._launch(qf, kf, vf[:, :, :-1], None, None))
    _raises_before_launch(rec, ValueError, lambda: tfa._launch(
        qf, kf, vf, torch.zeros((b, lk)), torch.zeros((lq, lk))))
    big = torch.zeros((1, 1, 1, 64)).expand(2 ** 14, 2 ** 10, 2 ** 14, 64)  # 2^31 blocks
    assert tfa.fwd_f32_plan(*big.shape[:3], big.shape[2])["grid"][0] == 2 ** 31
    _raises_before_launch(rec, ValueError, lambda: tfa._launch(big, big, big, None, None))
    # at head dim 96 the f32 route and the static int8 score core pass every
    # check: their launches are reached
    q96, k96, v96 = (_blhd(rng, b, h, n, 96) for n in (lq, lk, lk))
    tfa._launch(q96.float(), k96.float(), v96.float(), None, None)
    tfa._launch_static(q96, k96, v96, smax, None, torch.tensor(4.5), torch.tensor(4.0))
    assert [c[0] for c in rec.calls] == ["flash_attention", "flash_attention_static"]


def test_unaligned_views_are_copied_before_the_launch(rec):
    """TMA needs 16-byte strides and base addresses: a view that lacks them
    reaches the kernel as an aligned copy (the kernel's map encoder rejects
    what slips through)."""
    rng = np.random.default_rng(8)
    b, h, lq, lk = 2, 3, 200, 300
    base = torch.from_numpy(rng.standard_normal((b, h, lq + 1, 64)).astype(np.float32))
    base = base.to(torch.bfloat16).reshape(-1)
    q = base[1:1 + b * h * lq * 64].view(b, h, lq, 64)  # base address 2 bytes off
    k, v = (torch.from_numpy(rng.standard_normal((b, h, lk, 68)).astype(np.float32))
            .to(torch.bfloat16)[..., :64] for _ in range(2))  # rows of 136 bytes
    assert q.data_ptr() % 16 != 0 and k.stride(2) * 2 % 16 != 0
    tfa._launch(q, k, v, None, None)
    (_, args, strides), = rec.calls
    assert args[0] != q.data_ptr() and args[0] % 16 == 0
    assert all(s * 2 % 16 == 0 for s in strides)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_core_scale_folds_after_the_product_bitwise(seed):
    """bf16(q * 2^-3) kᵀ == (q kᵀ) * 2^-3 in f32, bit for bit: the product of
    a power of 2 and a bf16 value is exact in bf16 and in f32 (bf16 has
    f32's exponent range; these values stay far from subnormals), so each
    f32 partial sum scales exactly."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((8, 333, 64)).astype(np.float32) * 3)
    k = torch.from_numpy(rng.standard_normal((8, 515, 64)).astype(np.float32) * 3)
    q, k = q.to(torch.bfloat16).float(), k.to(torch.bfloat16).float()
    scaled_q = (q * 0.125).to(torch.bfloat16).float()
    assert torch.equal(scaled_q, q * 0.125)  # the rounding to bf16 is exact
    a = torch.matmul(scaled_q, k.transpose(-1, -2))
    bq = torch.matmul(q, k.transpose(-1, -2)) * 0.125
    np.testing.assert_array_equal(a.numpy().view(np.uint32), bq.numpy().view(np.uint32))


@pytest.mark.parametrize("lk", [1280, 1531])
def test_key_bias_rows(lk):
    """The key bias as the kernels bulk-copy it: the caller's rows when they
    are 16-byte aligned float32 rows of a multiple of 4 keys, else a copy
    padded to one."""
    kb = torch.randn((3, lk))
    rows, stride = tfa._key_bias_rows(kb, lk, kb.device)
    assert stride % 4 == 0 and rows.data_ptr() % 16 == 0
    assert torch.equal(rows[:, :lk], kb)
    if lk % 4 == 0:
        assert rows.data_ptr() == kb.data_ptr() and stride == lk
    else:
        assert stride == -(-lk // 4) * 4 and torch.all(rows[:, lk:] == 0)
    shared = torch.broadcast_to(kb[:1], (3, lk))  # one row for every batch
    rows, stride = tfa._key_bias_rows(shared, lk, kb.device)
    assert (stride == 0) == (lk % 4 == 0)
    assert torch.equal(rows[:, :lk], shared)
