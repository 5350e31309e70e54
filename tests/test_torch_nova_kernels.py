"""The NOVA slice's kernels (plain PyTorch versions, as the CPU runs them) vs
the JAX Pallas kernels in interpret mode, on the same numpy inputs.

Tolerance: both sides quantize the same f32 values with the same rounding
(static sites multiply by 1/s, per-row sites divide), with the same erf
polynomial in gelu, so every int8 code agrees on these inputs and the f32
outputs (O(1)) differ only by f32 summation order and an ulp of exp / rsqrt:
atol 1e-4 (ATOL). One int8 code that differs moves a row by ~1e-3 or more and
fails it. The int8 codes of each quant site are also compared directly.
The static attention rounds p to bf16 on both sides: a p on a rounding edge
may round the other way (2^-8 relative on one weight), so its outputs are
held to atol 2e-3 on O(1) values with 99% of them within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nova_pointcloud_tpu.ops.pallas import fused_block as jfb
from nova_pointcloud_tpu.ops.pallas import flash_attention as jfa
from nova_pointcloud_tpu.ops.quantization import (int8_matmul as jint8_matmul,
                                                  quantize_weight as jquantize_weight)
from nova_pointcloud_tpu_torch.ops.kernels import LAUNCHES
from nova_pointcloud_tpu_torch.ops.kernels import flash_attention as tfa
from nova_pointcloud_tpu_torch.ops.kernels import fused_block as tfb

ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _qw(rng, shape, std):
    w = jquantize_weight(jnp.asarray(rng.standard_normal(shape) * std, jnp.float32))
    return np.asarray(w.values), np.asarray(w.scales)


def _mlp_operands(seed, m=40, d=64, f=256):
    rng = np.random.default_rng(seed)
    fl = np.float32
    x = (rng.standard_normal((2, m // 2, d)) * 0.7).astype(fl)
    w1, s1 = _qw(rng, (d, f), 0.15)
    b1 = (rng.standard_normal(f) * 0.05).astype(fl)
    w2, s2 = _qw(rng, (f, d), 0.08)
    b2 = (rng.standard_normal(d) * 0.05).astype(fl)
    lns = (rng.standard_normal(d) * 0.1 + 1.0).astype(fl)
    lnb = (rng.standard_normal(d) * 0.1).astype(fl)
    return [x, w1, s1, b1, w2, s2, b2, lns, lnb]


@pytest.mark.parametrize("static_acts", [False, True])
@pytest.mark.parametrize("ln_eps", [1e-5, 1e-6])
def test_mlp_postln_matches_jax(static_acts, ln_eps):
    ops = _mlp_operands(seed=31)
    kw = dict(a_x=np.float32(2.5), a_gelu=np.float32(1.8)) if static_acts else {}
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jfb.fused_int8_mlp_postln(
            *[jnp.asarray(o) for o in ops], block_m=16, ln_eps=ln_eps,
            **{k: jnp.asarray(v) for k, v in kw.items()}))
    got = tfb.fused_int8_mlp_postln(*[_t(o) for o in ops], ln_eps=ln_eps,
                                    **{k: torch.tensor(v) for k, v in kw.items()})
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    assert not any(LAUNCHES.values())


@pytest.mark.parametrize("static_acts", [False, True])
def test_mlp_postln_int8_codes_match_jax(static_acts):
    """The two quant sites' codes, site by site: x, then gelu of the first
    product (the A-S erf on both sides)."""
    x, w1, s1, b1 = _mlp_operands(seed=32)[:4]
    xf = x.reshape(-1, x.shape[-1])
    if static_acts:
        jq = lambda v, a: jfb._quant_static(v, jnp.float32(a))  # noqa: E731
        tq = lambda v, a: tfb.quantize_static(v, torch.tensor(a))  # noqa: E731
    else:
        jq = lambda v, a: jfb._quant_rows(v)  # noqa: E731
        tq = lambda v, a: tfb.quantize_activations(v)  # noqa: E731
    qj, sj = jq(jnp.asarray(xf), 2.5)
    qt, st = tq(_t(xf), 2.5)
    assert np.array_equal(np.asarray(qj), qt.numpy())
    aj = jax.lax.dot_general(qj, jnp.asarray(w1), (((1,), (0,)), ((), ())),
                             preferred_element_type=jnp.int32)
    aj = aj.astype(jnp.float32) * sj * jnp.asarray(s1) + jnp.asarray(b1)
    aj = 0.5 * aj * (1.0 + jfb._erf(aj * (2.0 ** -0.5)))
    at = tfb.gelu_erf(tfb.int_dot(qt, _t(w1)) * st * _t(s1) + _t(b1))
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=1e-6, rtol=0)
    assert np.array_equal(np.asarray(jq(aj, 1.8)[0]), tq(at, 1.8)[0].numpy())


def _diff_operands(seed, m=30, d=64):
    rng = np.random.default_rng(seed)
    fl = np.float32
    x = (rng.standard_normal((3, m // 3, d)) * 0.8).astype(fl)
    zc = (rng.standard_normal((3, m // 3, d)) * 1.2).astype(fl)
    ws, ss = _qw(rng, (d, 3 * d), 0.12)
    bs = (rng.standard_normal(3 * d) * 0.1).astype(fl)
    w1, s1 = _qw(rng, (d, d), 0.15)
    b1 = (rng.standard_normal(d) * 0.05).astype(fl)
    w2, s2 = _qw(rng, (d, d), 0.15)
    b2 = (rng.standard_normal(d) * 0.05).astype(fl)
    n2s = (rng.standard_normal(d) * 0.1 + 1.0).astype(fl)
    n2b = (rng.standard_normal(d) * 0.1).astype(fl)
    return [x, zc, ws, ss, bs, w1, s1, b1, w2, s2, b2, n2s, n2b]


@pytest.mark.parametrize("static_acts", [False, True])
@pytest.mark.parametrize("m", [30, 9])
def test_diffusion_block_matches_jax(static_acts, m):
    ops = _diff_operands(seed=41, m=m)
    kw = (dict(a_z=np.float32(3.0), a_h=np.float32(4.0), a_silu=np.float32(2.0))
          if static_acts else {})
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jfb.fused_int8_diffusion_block(
            *[jnp.asarray(o) for o in ops], block_m=16, n2_eps=1e-5,
            **{k: jnp.asarray(v) for k, v in kw.items()}))
    got = tfb.fused_int8_diffusion_block(*[_t(o) for o in ops], n2_eps=1e-5,
                                         **{k: torch.tensor(v) for k, v in kw.items()})
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kernel", ["mlp_postln", "diffusion"])
def test_nova_kernels_bf16_match_jax(kernel):
    """bf16 activations and bf16 vectors, the card's serving dtypes."""
    if kernel == "mlp_postln":
        ops = _mlp_operands(seed=33)
        kw = dict(a_x=np.float32(2.5), a_gelu=np.float32(1.8))
        jfn, tfn, extra = jfb.fused_int8_mlp_postln, tfb.fused_int8_mlp_postln, \
            dict(ln_eps=1e-5)
        vec = (3, 6, 7, 8)
        acts = (0,)
    else:
        ops = _diff_operands(seed=43)
        kw = dict(a_z=np.float32(3.0), a_h=np.float32(4.0), a_silu=np.float32(2.0))
        jfn, tfn, extra = (jfb.fused_int8_diffusion_block, tfb.fused_int8_diffusion_block,
                           dict(n2_eps=1e-5))
        vec = (4, 7, 10, 11, 12)
        acts = (0, 1)
    jops = [jnp.asarray(o, jnp.bfloat16) if i in vec + acts else jnp.asarray(o)
            for i, o in enumerate(ops)]
    tops = [torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)
            if i in vec + acts else _t(ops[i]) for i, j in enumerate(jops)]
    with pltpu.force_tpu_interpret_mode():
        ref = jfn(*jops, **extra, **{k: jnp.asarray(v) for k, v in kw.items()})
    got = tfn(*tops, **extra, **{k: torch.tensor(v) for k, v in kw.items()})
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    # one bf16 ulp at |y| < 8 is <= 3.2e-2; the same f32 value rounds alike
    np.testing.assert_allclose(got.float().numpy(), ref, atol=3.2e-2, rtol=0)
    assert np.mean(got.float().numpy() == ref) > 0.99


def test_nova_kernels_static_sites_are_all_or_none():
    ops = [_t(o) for o in _mlp_operands(seed=1)]
    with pytest.raises(ValueError, match="all-or-none"):
        tfb.fused_int8_mlp_postln(*ops, a_x=torch.tensor(1.0))
    ops = [_t(o) for o in _diff_operands(seed=1)]
    with pytest.raises(ValueError, match="all-or-none"):
        tfb.fused_int8_diffusion_block(*ops, a_z=torch.tensor(1.0), a_h=torch.tensor(1.0))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False])
def test_int8_linear_matches_jax_projection(out_dtype, bias):
    """The ViT attention's int8 projection: int8_matmul to the output dtype,
    then the bias added in that dtype (vit.Attention._int8_proj)."""
    rng = np.random.default_rng(51)
    x = (rng.standard_normal((2, 9, 64)) * 0.6).astype(np.float32)
    w = jquantize_weight(jnp.asarray(rng.standard_normal((64, 192)) * 0.1, jnp.float32))
    b = (rng.standard_normal(192) * 0.3).astype(np.float32)
    jdt = jnp.dtype(out_dtype)
    ref = jint8_matmul(jnp.asarray(x), w, jdt)
    if bias:
        ref = ref + jnp.asarray(b, jnp.bfloat16).astype(ref.dtype)
    tdt = getattr(torch, out_dtype)
    got = tfb.int8_linear(_t(x), _t(w.values), _t(w.scales),
                          _t(b).to(torch.bfloat16) if bias else None, tdt)
    assert got.dtype == tdt and got.shape == ref.shape
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def _attn_operands(seed, b=2, h=2, lq=40, lk=40, d=64):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, h, lq, d)) * 0.9).astype(np.float32)
    k = (rng.standard_normal((b, h, lk, d)) * 0.9).astype(np.float32)
    v = rng.standard_normal((b, h, lk, d)).astype(np.float32)
    return q, k, v


def _attn_bias(kind, b, lk, seed=3):
    if kind == "none":
        return None
    rng = np.random.default_rng(seed)
    keep = rng.random((b, 1, 1, lk)) > 0.35
    keep[..., 0] = True
    bias = np.where(keep, 0.0, -np.inf).astype(np.float32)
    if kind == "dead":  # every key of sample 0 masked: its rows give 0
        bias[0] = -np.inf
    return bias


@pytest.mark.parametrize("core", ["bf16", "int8"])
@pytest.mark.parametrize("bias_kind", ["none", "visibility", "dead"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_static_attention_matches_jax(core, bias_kind, dtype):
    q, k, v = _attn_operands(seed=61)
    bias = _attn_bias(bias_kind, 2, 40)
    smax = np.float32(6.5)
    kw = dict(a_q=np.float32(3.1), a_k=np.float32(2.9)) if core == "int8" else {}
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
                  for a in (jq, jk, jv))
    with pltpu.force_tpu_interpret_mode():
        ref = jfa.flash_attention_static(
            jq, jk, jv, jnp.asarray(smax), None if bias is None else jnp.asarray(bias),
            blk_q=16, **{n: jnp.asarray(a) for n, a in kw.items()})
    got = tfa.flash_attention_static(tq, tk, tv, torch.tensor(smax),
                                     None if bias is None else _t(bias),
                                     **{n: torch.tensor(a) for n, a in kw.items()})
    assert got.dtype == tdt and got.shape == ref.shape
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.float().numpy()
    atol = 2e-3 if dtype == "float32" else 3.2e-2  # + one bf16 ulp of the output
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)
    assert np.mean(np.abs(got - ref) <= (ATOL if dtype == "float32" else 0)) > 0.99
    if bias_kind == "dead":
        assert np.all(got[0] == 0) and np.all(ref[0] == 0)
    assert not any(LAUNCHES.values())


def test_static_attention_refuses_other_biases():
    q, k, v = (_t(a) for a in _attn_operands(seed=1))
    with pytest.raises(ValueError, match="key bias"):
        tfa.flash_attention_static(q, k, v, torch.tensor(1.0), torch.zeros(1, 1, 40, 40))
