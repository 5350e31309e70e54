"""The backward of the port's flash attention (its plain version, as the CPU
runs it) vs the JAX package's custom VJP, whose dK/dV and dQ Pallas kernels
run in interpret mode, on the same numpy inputs.

Tolerances. f32: both sides recompute p from f32 scores and the saved lse
and take f32 sums, the JAX kernels over key / query blocks, the plain
version in one pass: max |diff| <= 1e-5 max |grad| (measured <= 6.5e-7
relative). bf16: both round the f32 gradients to bf16, the JAX kernels from
their own bf16 forward; the port's bf16 gradients are held to the JAX bf16
run's own distance from the f32 run on the same bf16 inputs (no farther from
f32 than 1.25x it, from the JAX bf16 result than 2x it).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nova_pointcloud_tpu.ops.pallas.flash_attention import flash_attention as jflash
from nova_pointcloud_tpu_torch.ops.kernels import LAUNCHES
from nova_pointcloud_tpu_torch.ops.kernels import flash_attention as tfa

NEG = -np.inf


def _qkv(seed, b=2, h=2, lq=96, lk=96, d=64):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, h, lq, d)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, h, lk, d)) * 0.5).astype(np.float32)
    v = rng.standard_normal((b, h, lk, d)).astype(np.float32)
    do = rng.standard_normal((b, h, lq, d)).astype(np.float32)
    return q, k, v, do


def _bias(kind, seed, b, lq, lk):
    rng = np.random.default_rng(seed)
    if kind == "none":
        return None
    if kind == "key":  # -inf on ~40% of the keys; sample 0 fully masked
        m = np.where(rng.random((b, 1, 1, lk)) > 0.4, 0.0, NEG).astype(np.float32)
        m[0] = NEG
        return m + np.where(np.isinf(m), 0.0, 0.1 * rng.standard_normal(m.shape)).astype(
            np.float32)
    if kind == "full":  # block-causal in blocks of 24, shared by batch and heads
        blk = np.arange(lq)[:, None] // 24 >= np.arange(lk)[None, :] // 24
        return np.where(blk, 0.0, NEG).astype(np.float32)[None, None]
    raise AssertionError(kind)


def _jax_grads(q, k, v, bias, do, dtype=jnp.float32, **kw):
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    jb = None if bias is None else jnp.asarray(bias)
    with pltpu.force_tpu_interpret_mode():
        o, vjp = jax.vjp(lambda a, b_, c: jflash(a, b_, c, bias=jb, **kw), *args)
        grads = vjp(jnp.asarray(do, dtype))
    return [np.asarray(jnp.asarray(g, jnp.float32)) for g in grads]


def _port_grads(q, k, v, bias, do, dtype=torch.float32):
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias)
    o, lse = tfa.flash_attention_plain(tq, tk, tv, tb)
    kb, fb = tfa._normalize_bias(tb, q.shape[0], q.shape[2], k.shape[2])
    grads = tfa.flash_attention_bwd_plain(tq, tk, tv, kb, fb, o, lse,
                                          torch.from_numpy(do).to(dtype))
    assert [g.dtype for g in grads] == [dtype] * 3
    return [g.float().numpy() for g in grads]


# lengths off the JAX blocks (64) and the CUDA tiles (64 keys, 128 queries)
@pytest.mark.parametrize("lq,lk", [(96, 96), (77, 131)])
@pytest.mark.parametrize("kind", ["none", "key", "full"])
def test_plain_backward_matches_jax_kernels(kind, lq, lk):
    q, k, v, do = _qkv(3, lq=lq, lk=lk)
    bias = _bias(kind, 5, q.shape[0], lq, lk)
    ref = _jax_grads(q, k, v, bias, do, blk_q=64, blk_k=64)
    got = _port_grads(q, k, v, bias, do)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, r, atol=1e-5 * np.abs(r).max(), rtol=0, err_msg=name)
    if kind == "key":  # the fully masked sample gives no gradient at all
        for g in got:
            assert np.all(g[0] == 0.0)


def test_bf16_backward_held_to_jax_bf16_distance():
    q, k, v, do = _qkv(6, lq=96, lk=160)
    bias = _bias("key", 7, 2, 96, 160)
    rnd = [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (q, k, v, do)]
    ref32 = _jax_grads(*rnd[:3], bias, rnd[3], blk_q=64, blk_k=64)
    ref16 = _jax_grads(*rnd[:3], bias, rnd[3], dtype=jnp.bfloat16, blk_q=64, blk_k=64)
    got = _port_grads(*rnd[:3], bias, rnd[3], dtype=torch.bfloat16)
    for name, g, r16, r32 in zip(("dq", "dk", "dv"), got, ref16, ref32):
        noise = np.abs(r16 - r32).mean()
        assert noise > 0, name
        assert np.abs(g - r32).mean() <= 1.25 * noise, name
        assert np.abs(g - r16).mean() <= 2 * noise, name


@pytest.mark.parametrize("kind", ["none", "key", "full"])
def test_plain_backward_equals_autograd_through_plain_forward(kind):
    """The autograd route on CPU tensors (plain forward, plain backward)
    against autograd through the plain forward's own ops."""
    q, k, v, do = (torch.from_numpy(a) for a in _qkv(8, lq=70, lk=90))
    bias = _bias(kind, 9, 2, 70, 90)
    tb = None if bias is None else torch.from_numpy(bias)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    o, _ = tfa.flash_attention_plain(*ins, tb)
    ref = torch.autograd.grad(o, ins, do)
    ins2 = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(tfa.flash_attention(*ins2, tb), ins2, do)
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-5, rtol=1e-5)
    assert not any(LAUNCHES.values())


@pytest.mark.parametrize("kind", ["key", "full"])
def test_bias_cotangent_is_zero(kind):
    """Biases are mask constants: the kernel's VJP gives them zero, in both
    packages."""
    q, k, v, do = _qkv(10, lq=64, lk=80)
    bias = _bias(kind, 11, 2, 64, 80)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda b_: jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           bias=b_, blk_q=64, blk_k=64), jnp.asarray(bias))
        (jgb,) = vjp(jnp.asarray(do))
    assert np.all(np.asarray(jgb) == 0.0)
    tb = torch.from_numpy(bias).requires_grad_()
    o = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), tb)
    (gb,) = torch.autograd.grad(o, tb, torch.from_numpy(do))
    assert gb.shape == tb.shape and torch.all(gb == 0.0)


def test_cuda_backward_checks_before_launch(monkeypatch):
    """What the backward kernels do not take raises before anything is
    built or launched (the kernel route is forced here on CPU tensors, which
    it never is outside this test): the launch raises if it is reached."""
    monkeypatch.setattr(tfa, "plain_route", lambda x: False)
    monkeypatch.setattr(tfa, "flash_attention_bwd_plain", None)  # must not be called
    monkeypatch.setattr(tfa, "_stream", lambda dev: 0)

    class Launched(Exception):
        pass

    def launched(*a, **kw):
        raise Launched(a[0])

    monkeypatch.setattr(tfa, "lib", launched)
    monkeypatch.setattr(tfa, "run", launched)

    def args(d=64, dtype=torch.float32, lk=8, lse_dtype=torch.float32, **over):
        q = torch.zeros((1, 2, 8, d), dtype=dtype)
        kv = torch.zeros((1, 2, lk, d), dtype=dtype)
        a = dict(q=q, k=kv, v=kv, key_bias=None, full_bias=None, o=q,
                 lse=torch.zeros((1, 2, 8), dtype=lse_dtype), do=q)
        a.update(over)
        return a

    for d in (32, 128):
        with pytest.raises(NotImplementedError, match="head dim 64"):
            tfa._launch_bwd(**args(d=d))
    with pytest.raises(TypeError, match="share one dtype"):
        tfa._launch_bwd(**args(do=torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16)))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa._launch_bwd(**args(dtype=torch.float16))
    with pytest.raises(ValueError, match="one device"):
        tfa._launch_bwd(**args(v=torch.zeros((1, 2, 9, 64))))
    with pytest.raises(ValueError, match="one device"):
        tfa._launch_bwd(**args(lse=torch.zeros((1, 2, 7))))
    with pytest.raises(TypeError, match="lse must be float32"):
        tfa._launch_bwd(**args(lse_dtype=torch.float64))
    for dtype in (torch.bfloat16, torch.float32):  # the bf16 and f32 argument lists
        for d in (32, 80, 128):
            with pytest.raises(NotImplementedError, match="head dim 64"):
                tfa._launch_bwd(**args(d=d, dtype=dtype))
        with pytest.raises(ValueError, match="one device"):
            tfa._launch_bwd(**args(dtype=dtype, lse=torch.zeros((1, 2, 9))))
        # every check passed: the first thing reached is the prep kernel's launch
        with pytest.raises(Launched, match="flash_attention_bwd_prep"):
            tfa._launch_bwd(**args(dtype=dtype))
    # head dim 96 in bf16 (the dkvq96 route) and f32 (the f32_96 route)
    # passes its checks too
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(Launched, match="flash_attention_bwd_prep"):
            tfa._launch_bwd(**args(d=96, dtype=dtype))
    # the bf16 grid holds B*H <= 65535 rows
    wide = torch.zeros((1, 65536, 1, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="65535"):
        tfa._launch_bwd(q=wide, k=wide, v=wide, key_bias=None, full_bias=None, o=wide,
                        lse=torch.zeros((1, 65536, 1)), do=wide)
    # the autograd node takes the kernel route it chose in the forward
    x = torch.zeros((1, 2, 8, 32))
    ctx = types.SimpleNamespace(plain=False, needs_input_grad=(True,) * 3 + (False,) * 2,
                                saved_tensors=(x, x, x, None, None, x, torch.zeros((1, 2, 8))))
    with pytest.raises(NotImplementedError, match="head dim 64"):
        tfa._FlashAttention.backward(ctx, x, None)
    assert not any(LAUNCHES.values())
