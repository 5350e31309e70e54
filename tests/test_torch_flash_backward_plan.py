"""The flash backward's pieces around its CUDA kernels, on the CPU: the
prep kernel's plain version (delta and lse rows) against the JAX function's
delta, the cast kernel's plain version, and the wrapper's launch plans (the
bf16 one-pass kernel's and the f32 one-pass kernel's: tiles, grid, shared
memory, the dq it adds into) and launch sequences with the launch itself
replaced by a recorder.

Tolerances: none. delta is held to JAX's ``jnp.sum(dout.f32 * out.f32, -1)``
bit for bit (the plain version sums in XLA's order on the CPU, each half of
the head dim in sequence, then the halves); the cast is a rounding of f32 to
bf16, held to ``Tensor.to`` exactly.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nova_pointcloud_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
from nova_pointcloud_tpu_torch.ops.kernels import flash_attention as tfa


def _blhd(rng, b, h, l, d, dtype):
    """(B, H, L, D) as the model hands it over: a view of (B, L, H, D)."""
    x = torch.from_numpy(rng.standard_normal((b, l, h, d)).astype(np.float32)).to(dtype)
    return x.transpose(1, 2)


@pytest.mark.parametrize("lq", [64, 77, 200])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prep_plain_delta_equals_jax_bitwise(dtype, lq):
    rng = np.random.default_rng(lq)
    b, h, d = 2, 3, 64
    o, do = _blhd(rng, b, h, lq, d, dtype), _blhd(rng, b, h, lq, d, dtype)
    lse = torch.from_numpy(rng.standard_normal((b, h, lq)).astype(np.float32))
    lse[1, 2, 5] = 1e30  # a row whose keys are all masked
    lqp = -(-lq // 128) * 128
    for log2 in (False, True):
        lse_rows, delta = tfa.bwd_prep_plain(o, do, lse, lqp, log2)
        assert lse_rows.shape == delta.shape == (b * h, lqp)
        assert lse_rows.dtype == delta.dtype == torch.float32
        jo, jdo = (jnp.asarray(t.float().contiguous().numpy()).astype(
            jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32) for t in (o, do))
        ref = np.asarray(jnp.sum(jdo.astype(jnp.float32) * jo.astype(jnp.float32), axis=-1))
        got = delta[:, :lq].reshape(b, h, lq).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
        assert torch.all(delta[:, lq:] == 0.0)
        assert torch.all(lse_rows[:, lq:] == 1e30)
        want = lse.reshape(b * h, lq) * (torch.tensor(tfa.LOG2E) if log2 else 1.0)
        assert torch.equal(lse_rows[:, :lq], want)


def test_cast_plain_is_exact_in_the_model_layout():
    rng = np.random.default_rng(3)
    b, h, lq, lqp = 2, 3, 77, 128
    ws = torch.from_numpy(rng.standard_normal((b * h, lqp, 64)).astype(np.float32))
    dq = tfa.bwd_dq_cast_plain(ws, b, h, lq, 0.125)
    assert dq.shape == (b, h, lq, 64) and dq.dtype == torch.bfloat16
    assert dq.transpose(1, 2).is_contiguous()  # written in (B, L, H, D)
    want = (ws[:, :lq].reshape(b, h, lq, 64) / 8).to(torch.bfloat16)  # the scale of head dim 64
    assert torch.equal(dq, want)


@pytest.mark.parametrize("b,h,lq,lk,want", [
    (8, 16, 1280, 1280, dict(lqp=1280, key_tiles=10, q_tiles=20, grid=(10, 128),
                             workspace=(128, 1280, 64))),
    (2, 16, 1000, 1531, dict(lqp=1024, key_tiles=12, q_tiles=16, grid=(12, 32),
                             workspace=(32, 1024, 64))),
])
def test_bwd_plan(b, h, lq, lk, want):
    plan = tfa.bwd_plan(b, h, lq, lk)
    for key, val in want.items():
        assert plan[key] == val, key
    # per warpgroup: K, V (16 KB), two stages of q and do (32 KB), ds hi / lo
    # (16 KB), two f32 dq buffers (32 KB), lse / delta rows (1 KB), 3
    # mbarriers; 1 KB to align: the kernel checks the same number
    assert plan["smem_bytes"] == 199728 <= 232448  # a block's limit on the H100
    assert plan["q_tiles"] * tfa.BWD_BLOCK_Q <= plan["lqp"]


class _Recorder:
    """Stands in for the ctypes launch: records each call's name and
    arguments."""

    def __init__(self):
        self.calls = []
        self.strides = None

    def lib(self, name, argtypes, library=None):
        assert library == "flash_attention_bwd"
        return name, argtypes

    def run(self, so, fn, args):
        name, argtypes = so, fn
        assert len(args) == len(argtypes), name
        self.calls.append((name, args))
        if name == "flash_attention_bwd_dkvq":  # read while the array lives
            arr = ctypes.cast(args[12], ctypes.POINTER(ctypes.c_long))
            self.strides = [arr[i] for i in range(18)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_launch_sequence_follows_the_plan(monkeypatch, dtype):
    rec = _Recorder()
    monkeypatch.setattr(tfa, "lib", rec.lib)
    monkeypatch.setattr(tfa, "run", rec.run)
    monkeypatch.setattr(tfa, "_stream", lambda dev: 0)
    rng = np.random.default_rng(4)
    b, h, lq, lk = 2, 16, 1000, 1531
    q, o, do = (_blhd(rng, b, h, lq, 64, dtype) for _ in range(3))
    k, v = (_blhd(rng, b, h, lk, 64, dtype) for _ in range(2))
    lse = torch.zeros((b, h, lq))
    kb = torch.zeros((b, lk))
    try:
        dq, dk, dv = tfa._launch_bwd(q, k, v, kb, None, o, lse, do)
        plan = tfa.bwd_plan(b, h, lq, lk)
        names = [n for n, _ in rec.calls]
        want = tfa.BWD_KERNELS if dtype == torch.bfloat16 else tfa.BWD_F32_KERNELS
        assert names == list(want)
        assert {n: LAUNCHES[n] for n in set(want)} == {n: 1 for n in want}
        prep = rec.calls[0][1]
        assert prep[3:9] == [int(dtype == torch.bfloat16), b, h, lq, plan["lqp"], 64]
        assert prep[10] == int(dtype == torch.bfloat16)  # lse in units of log 2 for bf16
        if dtype == torch.bfloat16:
            main = rec.calls[1][1]
            assert main[6:12] == [b, h, lq, lk, plan["lqp"], 64]
            assert main[19:22] == [plan["key_tiles"], plan["q_tiles"], plan["smem_bytes"]]
            # q, k, v, do, dk, dv: (batch, head, row) strides of (B, L, H, D) views
            assert rec.strides == [
                s for n in (lq, lk, lk, lq, lk, lk) for s in (n * h * 64, 64, h * 64)]
            cast = rec.calls[2][1]
            assert cast[1:6] == [b, h, lq, plan["lqp"], 64]
            launches, _ = tfa._bwd_operands(q, k, v, kb, None, o, lse, do)
            ws = launches[1][3][8]
            assert ws.shape == plan["workspace"] and ws.dtype == torch.float32
            assert launches[1][2][16] == launches[2][2][0] == ws.data_ptr()  # dkvq -> cast
            assert main[15] == cast[7] == 0.125  # the scale: left out of ds, put on dq
            assert not torch.any(ws)  # zeroed: the kernel adds into it
        for g, ref in ((dq, q), (dk, k), (dv, v)):
            assert g.shape == ref.shape and g.dtype == dtype
            assert g.transpose(1, 2).is_contiguous()
    finally:
        reset_launch_counts()


@pytest.mark.parametrize("b,h,lq,lk,want", [
    (8, 16, 1280, 1280, dict(lqp=1280, key_tiles=20, q_tiles=20, grid=(20, 128),
                             workspace=(8, 1280, 16, 64))),
    (2, 16, 1000, 1531, dict(lqp=1024, key_tiles=24, q_tiles=16, grid=(24, 32),
                             workspace=(2, 1000, 16, 64))),
    (1, 1, 1, 1, dict(lqp=128, key_tiles=1, q_tiles=1, grid=(1, 1), workspace=(1, 1, 1, 64))),
])
def test_bwd_f32_plan(b, h, lq, lk, want):
    plan = tfa.bwd_f32_plan(b, h, lq, lk)
    for key, val in want.items():
        assert plan[key] == val, key
    # K, V, the tile's q and do, P (then its dq part) and dS: six 64 x 64 f32
    # tiles (96 KB); lse / delta rows (512 bytes); 2 mbarriers; 1 KB to
    # align: the kernel checks the same number, and two blocks (each with
    # the 1 KB the card keeps a block) fit in an SM's 228 KB
    assert plan["smem_bytes"] == 99856 <= 232448
    assert 2 * (plan["smem_bytes"] + 1024) <= 233472
    assert plan["threads"] == 128
    assert plan["key_tiles"] * tfa.BWD_F32_BLOCK_K >= lk > (plan["key_tiles"] - 1) * 64
    assert plan["q_tiles"] * tfa.BWD_F32_BLOCK_Q <= plan["lqp"]


class _F32Recorder(_Recorder):
    """Also reads the f32 kernel's 21 strides while the array lives."""

    def run(self, so, fn, args):
        super().run(so, fn, args)
        if so == "flash_attention_bwd_f32":
            arr = ctypes.cast(args[12], ctypes.POINTER(ctypes.c_long))
            self.strides = [arr[i] for i in range(21)]


@pytest.mark.parametrize("bias", ["none", "key", "full"])
def test_f32_launch_follows_the_plan(monkeypatch, bias):
    rec = _F32Recorder()
    monkeypatch.setattr(tfa, "lib", rec.lib)
    monkeypatch.setattr(tfa, "run", rec.run)
    monkeypatch.setattr(tfa, "_stream", lambda dev: 0)
    rng = np.random.default_rng(5)
    b, h, lq, lk = 2, 16, 1000, 1531
    q, o, do = (_blhd(rng, b, h, lq, 64, torch.float32) for _ in range(3))
    k, v = (_blhd(rng, b, h, lk, 64, torch.float32) for _ in range(2))
    lse = torch.zeros((b, h, lq))
    kb = torch.zeros((b, lk)) if bias == "key" else None
    fbias = torch.zeros((lq, lk)) if bias == "full" else None
    try:
        launches, (dq, dk, dv) = tfa._bwd_operands(q, k, v, kb, fbias, o, lse, do)
        tfa.run_bwd(launches)
        plan = tfa.bwd_f32_plan(b, h, lq, lk)
        assert [n for n, _ in rec.calls] == list(tfa.BWD_F32_KERNELS)
        assert LAUNCHES["flash_attention_bwd_f32"] == 1
        assert LAUNCHES["flash_attention_bwd_dkvq"] == LAUNCHES["flash_attention_bwd_dq_cast"] == 0
        main = rec.calls[1][1]
        assert main[6:12] == [b, h, lq, lk, plan["lqp"], 64]
        assert main[19:22] == [plan["key_tiles"], plan["q_tiles"], plan["smem_bytes"]]
        assert main[15] == 0.125  # the scale, folded into ds
        # q, k, v, do, dq, dk, dv: (batch, head, row) strides of (B, L, H, D) views
        assert rec.strides == [
            s for n in (lq, lk, lk, lq, lq, lk, lk) for s in (n * h * 64, 64, h * 64)]
        assert main[13] == (None if kb is None else launches[1][3][6].data_ptr())
        assert main[14] == (None if fbias is None else launches[1][3][7].data_ptr())
        # the kernel adds into dq itself: zeroed, the plan's workspace, in
        # the (B, L, H, D) layout; no other scratch
        assert main[16] == dq.data_ptr() and not torch.any(dq)
        assert dq.transpose(1, 2).shape == plan["workspace"]
        assert main[17:19] == [dk.data_ptr(), dv.data_ptr()]
        for g, ref in ((dq, q), (dk, k), (dv, v)):
            assert g.shape == ref.shape and g.dtype == torch.float32
            assert g.transpose(1, 2).is_contiguous()
    finally:
        reset_launch_counts()
