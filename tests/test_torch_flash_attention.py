"""The port's flash attention (its plain PyTorch version, as the CPU runs it)
and attention dispatcher vs the JAX package, on the same numpy inputs.

The JAX kernel runs in Pallas interpret mode, as tests/test_flash_attention.py
runs it. Tolerance: both sides take f32 scores and f32 sums, the JAX kernel
by online softmax over key blocks, the plain version in one pass, so outputs
(|o| <= ~1.5) differ by f32 rounding in another order: measured <= 2.7e-7 here
(lse <= 5.5e-7 against a float64 log-sum-exp);
atol 2e-5 allows for longer rows and fails on a wrong scale, bias or mask.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nova_pointcloud_tpu.ops import attention as jattn
from nova_pointcloud_tpu.ops.pallas.flash_attention import flash_attention as jflash
from nova_pointcloud_tpu_torch.ops import attention as tattn
from nova_pointcloud_tpu_torch.ops.kernels import LAUNCHES
from nova_pointcloud_tpu_torch.ops.kernels import flash_attention as tfa

ATOL = 2e-5
NEG = -np.inf


def _qkv(seed, b=2, h=3, lq=160, lk=160, d=64):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, h, lq, d)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, h, lk, d)) * 0.5).astype(np.float32)
    v = rng.standard_normal((b, h, lk, d)).astype(np.float32)
    return q, k, v


def _bias(kind, seed, b, lq, lk):
    rng = np.random.default_rng(seed)
    if kind == "none":
        return None
    if kind == "key":  # visibility mask: -inf on ~40% of the keys
        return np.where(rng.random((b, 1, 1, lk)) > 0.4, 0.0, NEG).astype(np.float32)
    if kind == "key_shared":  # one row for every sample, finite values
        return rng.standard_normal((1, 1, 1, lk)).astype(np.float32)
    if kind == "full":  # block-causal in blocks of 40, shared by batch and heads
        blk = np.arange(lq)[:, None] // 40 >= np.arange(lk)[None, :] // 40
        return np.where(blk, 0.0, NEG).astype(np.float32)[None, None]
    if kind == "full_col":  # (1, 1, Lq, 1): broadcast over keys
        return rng.standard_normal((1, 1, lq, 1)).astype(np.float32)
    if kind == "late":  # the first 96 keys masked: whole leading key blocks are dead
        m = np.zeros((b, 1, 1, lk), np.float32)
        m[..., :96] = NEG
        return m
    raise AssertionError(kind)


def _logits(q, k, bias):
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64) * q.shape[-1] ** -0.5,
                  k.astype(np.float64))
    return s if bias is None else s + bias.astype(np.float64)


def _run_jax(q, k, v, bias, **kw):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 bias=None if bias is None else jnp.asarray(bias), **kw))


# lengths off the JAX block sizes (64) and off the CUDA tiles; Lq != Lk
@pytest.mark.parametrize("lq,lk", [(160, 160), (64, 200), (77, 131)])
@pytest.mark.parametrize("kind", ["none", "key", "key_shared", "full", "full_col", "late"])
def test_plain_matches_jax_kernel(kind, lq, lk):
    q, k, v = _qkv(3, lq=lq, lk=lk)
    bias = _bias(kind, 5, q.shape[0], lq, lk)
    ref = _run_jax(q, k, v, bias, blk_q=64, blk_k=64)
    tb = None if bias is None else torch.from_numpy(bias)
    got, lse = tfa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)), tb)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    # lse against the log-sum-exp of the f64 logits
    s = _logits(q, k, bias)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, atol=ATOL, rtol=1e-6)
    # the wrapper on CPU tensors is the plain version and counts no launch
    wrapped = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), tb)
    assert torch.equal(wrapped, got) and not any(LAUNCHES.values())


def test_fully_masked_rows_give_zero_and_big_lse():
    q, k, v = _qkv(4)
    bias = np.full((2, 1, 1, 160), NEG, np.float32)
    bias[1, ..., 7] = 0.0  # sample 1 keeps one key; sample 0 none
    ref = _run_jax(q, k, v, bias, blk_q=64, blk_k=64)
    got, lse = tfa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                         torch.from_numpy(bias))
    assert torch.isfinite(got).all() and torch.isfinite(lse).all()
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    assert np.all(got[0].numpy() == 0.0) and np.all(lse[0].numpy() == np.float32(1e30))
    np.testing.assert_allclose(got[1].numpy(), np.broadcast_to(v[1][:, 7:8], v[1].shape),
                               atol=ATOL)


def test_bf16_inputs_match_jax_kernel():
    q, k, v = _qkv(6, lq=96, lk=160)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        ref = jflash(jq, jk, jv, blk_q=64, blk_k=64)
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
                  for a in (jq, jk, jv))
    got, _ = tfa.flash_attention_plain(tq, tk, tv)
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    # both round the same f32 result to bf16: at most one bf16 ulp at |o| < 1
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=2.0 ** -8, rtol=0)


@pytest.mark.parametrize("shape,match", [
    ((2, 160), "4D"), ((2, 3, 1, 160), "per-head"), ((1, 1, 160, 80), "last dim"),
    ((2, 1, 160, 160), "unsupported bias shape"), ((1, 1, 7, 160), "unsupported bias shape")])
def test_bias_shapes_the_kernel_refuses(shape, match):
    """The JAX entry's ValueErrors, from the port's and from JAX's."""
    q, k, v = _qkv(1)
    bias = np.zeros(shape, np.float32)
    with pytest.raises(ValueError, match=match):
        tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), torch.from_numpy(bias))
    with pytest.raises(ValueError, match=match):
        _run_jax(q, k, v, bias)


def test_plain_version_is_differentiable():
    """Gradients of the plain version against autograd through sdpa (the
    training slice's backward kernels will be held to the plain version)."""
    q, k, v = (torch.from_numpy(a[:, :, :48]).requires_grad_() for a in _qkv(8))
    bias = torch.from_numpy(_bias("key", 9, 2, 48, 48))
    o, lse = tfa.flash_attention_plain(q, k, v, bias)
    g = torch.autograd.grad(torch.sin(o).sum(), (q, k, v))
    g_ref = torch.autograd.grad(torch.sin(tattn.sdpa(q, k, v, bias)).sum(), (q, k, v))
    for a, b in zip(g, g_ref):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-4)


def test_cuda_wrapper_checks_before_launch(monkeypatch):
    """What the CUDA kernel does not take raises before anything is built
    (the kernel route is forced here on CPU tensors, which it never is
    outside this test)."""
    lib_before = tfa.lib
    monkeypatch.setattr(tfa, "plain_route", lambda x: False)
    x = torch.zeros((1, 2, 8, 64))
    for dtype in (torch.float32, torch.bfloat16):  # either dtype: 64 or 96
        for d in (32, 80, 128):
            with pytest.raises(NotImplementedError, match="head dim 64 or 96"):
                tfa.flash_attention(*(torch.zeros((1, 2, 8, d), dtype=dtype),) * 3)

    class Launched(Exception):
        pass

    def launched(name, *a, **kw):
        raise Launched(name)

    # float32 at head dim 96 passes every check: the launch is reached
    monkeypatch.setattr(tfa, "lib", launched)
    with pytest.raises(Launched, match="flash_attention"):
        tfa.flash_attention(*(torch.zeros((1, 2, 8, 96)),) * 3)
    monkeypatch.setattr(tfa, "lib", lib_before)
    with pytest.raises(TypeError, match="share one dtype"):
        tfa.flash_attention(x, x.to(torch.bfloat16), x)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.flash_attention(*(x.to(torch.float16),) * 3)
    with pytest.raises(ValueError, match="one device"):
        tfa.flash_attention(x, x[:, :1], x)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention(*(torch.empty((1, 1, 8, 64), device="meta"),) * 3)
    assert not any(LAUNCHES.values())


# -- sdpa and the dispatcher ---------------------------------------------------

@pytest.mark.parametrize("kind", ["none", "key", "full"])
def test_sdpa_matches_jax(kind):
    q, k, v = _qkv(11, lq=40, lk=56)
    bias = _bias(kind, 12, 2, 40, 56)
    if kind == "key":
        bias[0] = NEG  # a fully masked sample: the NaN guard gives zeros
    ref = np.asarray(jattn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                None if bias is None else jnp.asarray(bias)))
    got = tattn.sdpa(*map(torch.from_numpy, (q, k, v)),
                     None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


_Q = (2, 4, 2048, 64)
_BIASES = [None, (2, 1, 1, 2048), (1, 1, 1, 2048), (1, 1, 2048, 2048), (1, 1, 2048, 1),
           (2, 1, 7, 2048), (2, 4, 1, 2048), (2, 1, 2048, 2048), (2048, 2048)]


@pytest.mark.parametrize("impl", ["auto", "pallas", "sdpa", "xla"])
@pytest.mark.parametrize("lk", [128, 1023, 1024, 2048, 16384, 16385, 65536])
def test_routing_matches_jax_over_lengths(impl, lk):
    q = jnp.zeros((1, 2, 64, 64), jnp.bfloat16)
    k = jnp.zeros((1, 2, lk, 64), jnp.bfloat16)
    with mock.patch.object(jax, "default_backend", lambda: "tpu"):
        want = jattn._use_pallas(q, k, None, impl)
    assert tattn.flash_route(64, lk, 64, None, impl, on_card=True) == want
    off = jattn._use_pallas(q, k, None, impl)  # the JAX package off its accelerator
    assert tattn.flash_route(64, lk, 64, None, impl, on_card=False) == off
    assert off == (impl == "pallas")


@pytest.mark.parametrize("bias_shape", _BIASES)
@pytest.mark.parametrize("impl", ["auto", "pallas", "sdpa"])
def test_routing_matches_jax_over_bias_shapes(impl, bias_shape):
    q, k = jnp.zeros(_Q, jnp.bfloat16), jnp.zeros(_Q, jnp.bfloat16)
    bias = None if bias_shape is None else jnp.zeros(bias_shape)
    with mock.patch.object(jax, "default_backend", lambda: "tpu"):
        want = jattn._use_pallas(q, k, bias, impl)
    assert tattn.flash_route(_Q[2], _Q[2], _Q[3], bias_shape, impl, on_card=True) == want
    tq = torch.empty(_Q, device="meta")  # not on the card: only "pallas" routes
    tb = None if bias_shape is None else torch.empty(bias_shape, device="meta")
    assert tattn._use_flash(tq, tq, tb, impl) == (impl == "pallas")


@pytest.mark.parametrize("impl", ["auto", "pallas", "sdpa"])
def test_attention_matches_jax(impl):
    """The dispatcher end to end; "pallas" forces the kernel route on both
    sides (interpret mode there, the plain version here)."""
    q, k, v = _qkv(13, lq=64, lk=96)
    bias = _bias("key", 14, 2, 64, 96)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(bias), impl=impl))
    got = tattn.attention(*map(torch.from_numpy, (q, k, v)), torch.from_numpy(bias), impl=impl)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("impl", ["auto", "pallas"])
@pytest.mark.parametrize("with_mask", [False, True])
def test_attention_fn_matches_flax_adapter(impl, with_mask):
    """make_attention_fn vs make_flax_attention_fn on (B, L, H, D)."""
    q, k, v = (np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in _qkv(15, lq=72, lk=72))
    mask = None
    if with_mask:
        mask = np.random.default_rng(16).random((2, 1, 1, 72)) > 0.3
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jattn.make_flax_attention_fn(impl)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            mask=None if mask is None else jnp.asarray(mask), deterministic=True))
    got = tattn.make_attention_fn(impl)(*map(torch.from_numpy, (q, k, v)),
                                        mask=None if mask is None else torch.from_numpy(mask))
    assert got.shape == ref.shape == q.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


def test_attention_fn_keeps_a_callers_bias_off_the_kernel(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("the kernel route must not be taken for a caller's bias")

    monkeypatch.setattr(tattn, "flash_attention", boom)
    x = torch.zeros((1, 16, 2, 32))
    out = tattn.make_attention_fn("pallas")(x, x, x, bias=torch.zeros((1, 1, 1, 16)))
    assert out.shape == x.shape


@pytest.mark.parametrize("impl", ["ring", "ring:sequence"])
def test_ring_is_not_ported(impl):
    x = torch.zeros((1, 2, 8, 16))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tattn.attention(x, x, x, impl=impl)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tattn.make_attention_fn(impl)
