"""Port's fused-block kernels (plain PyTorch versions, as the CPU runs them)
vs the JAX Pallas kernels in interpret mode, on the same numpy inputs.

Tolerance: both sides quantize the same f32 values with the same rounding
(half-to-even, static sites multiplying by 1/s, per-row sites dividing), so
on these inputs every int8 code agrees and the outputs (O(1)) differ only by
f32 summation order: measured <= 2.4e-7. atol 1e-4 allows for that order
and fails on a single int8 code that differs (~1e-3 here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nova_pointcloud_tpu.ops.pallas import fused_block as jfb
from nova_pointcloud_tpu.ops.quantization import quantize_weight as jquantize_weight
from nova_pointcloud_tpu_torch.ops.kernels import fused_block as tfb

ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _attn_operands(seed, b=2, t=32, d=64):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = (rng.standard_normal((b, t, d)) * 0.5).astype(f)
    lns = (rng.standard_normal(d) * 0.1 + 1.0).astype(f)
    lnb = (rng.standard_normal(d) * 0.1).astype(f)
    wqkv = jquantize_weight(jnp.asarray(rng.standard_normal((d, 3 * d)) * 0.1, jnp.float32))
    bqkv = (rng.standard_normal(3 * d) * 0.02).astype(f)
    wo = jquantize_weight(jnp.asarray(rng.standard_normal((d, d)) * 0.1, jnp.float32))
    bo = (rng.standard_normal(d) * 0.02).astype(f)
    return [x, lns, lnb, np.asarray(wqkv.values), np.asarray(wqkv.scales), bqkv,
            np.asarray(wo.values), np.asarray(wo.scales), bo]


@pytest.mark.parametrize("core", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("static_acts", [False, True])
@pytest.mark.parametrize("smax", [False, True])
def test_attention_block_matches_jax(core, static_acts, smax):
    ops = _attn_operands(seed=3)
    kw = {}
    if static_acts:
        kw.update(a_in=np.float32(4.0), a_av=np.float32(1.5))
    if smax:
        kw["a_smax"] = np.float32(3.0)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jfb.fused_attention_block(
            *[jnp.asarray(o) for o in ops], num_heads=2, core=core,
            **{k: jnp.asarray(v) for k, v in kw.items()}))
    got = tfb.fused_attention_block(*[_t(o) for o in ops], num_heads=2, core=core,
                                    **{k: torch.tensor(v) for k, v in kw.items()})
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    assert tfb.LAUNCHES == {"fused_attention_block": 0, "fused_ln_int8_mlp": 0}


def _mlp_operands(seed, m=48, d=64, f=256):
    rng = np.random.default_rng(seed)
    fl = np.float32
    x = (rng.standard_normal((2, m // 2, d)) * 0.5).astype(fl)
    lns = (rng.standard_normal(d) * 0.1 + 1.0).astype(fl)
    lnb = (rng.standard_normal(d) * 0.1).astype(fl)
    w1 = jquantize_weight(jnp.asarray(rng.standard_normal((d, f)) * 0.1, jnp.float32))
    b1 = (rng.standard_normal(f) * 0.02).astype(fl)
    w2 = jquantize_weight(jnp.asarray(rng.standard_normal((f, d)) * 0.05, jnp.float32))
    b2 = (rng.standard_normal(d) * 0.02).astype(fl)
    return [x, lns, lnb, np.asarray(w1.values), np.asarray(w1.scales), b1,
            np.asarray(w2.values), np.asarray(w2.scales), b2]


@pytest.mark.parametrize("static_acts", [False, True])
def test_mlp_matches_jax(static_acts):
    ops = _mlp_operands(seed=5)
    kw = dict(a_in=np.float32(4.0), a_mid=np.float32(2.5)) if static_acts else {}
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jfb.fused_ln_int8_mlp(
            *[jnp.asarray(o) for o in ops], block_m=16,
            **{k: jnp.asarray(v) for k, v in kw.items()}))
    got = tfb.fused_ln_int8_mlp(*[_t(o) for o in ops],
                                **{k: torch.tensor(v) for k, v in kw.items()})
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kernel", ["attention", "mlp"])
def test_bf16_activations_match_jax(kernel):
    """bf16 x in, bf16 y out (the card's serving dtype); static sites."""
    if kernel == "attention":
        ops = _attn_operands(seed=9)
        kw = dict(num_heads=2, core="bf16", a_in=np.float32(4.0),
                  a_av=np.float32(1.5), a_smax=np.float32(3.0))
        jfn, tfn = jfb.fused_attention_block, tfb.fused_attention_block
    else:
        ops = _mlp_operands(seed=9)
        kw = dict(a_in=np.float32(4.0), a_mid=np.float32(2.5))
        jfn, tfn = jfb.fused_ln_int8_mlp, tfb.fused_ln_int8_mlp
    statics = {k: v for k, v in kw.items() if k.startswith("a_")}
    other = {k: v for k, v in kw.items() if k not in statics}
    xj = jnp.asarray(ops[0], jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        ref = jfn(xj, *[jnp.asarray(o) for o in ops[1:]], **other,
                  **{k: jnp.asarray(v) for k, v in statics.items()})
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    got = tfn(xt, *[_t(o) for o in ops[1:]], **other,
              **{k: torch.tensor(v) for k, v in statics.items()})
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    # one bf16 ulp at |y| < 4 is <= 1.6e-2: rounding the same f32 value
    # gives the same bf16, a value on a rounding edge may land one ulp off
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=1.6e-2, rtol=0)
    assert np.mean(got.float().numpy() == np.asarray(ref.astype(jnp.float32))) > 0.99


def test_static_quant_sites_are_all_or_none():
    ops = [_t(o) for o in _mlp_operands(seed=1)]
    with pytest.raises(ValueError, match="all-or-none"):
        tfb.fused_ln_int8_mlp(*ops, a_in=torch.tensor(1.0))
    ops = [_t(o) for o in _attn_operands(seed=1)]
    with pytest.raises(ValueError, match="all-or-none"):
        tfb.fused_attention_block(*ops, num_heads=2, a_av=torch.tensor(1.0))


@pytest.mark.parametrize("t,d", [(128, 1024), (64, 64), (1024, 768), (2048, 1024)])
def test_vmem_gate_matches_jax(t, d):
    assert tfb.attention_block_vmem_bytes(t, d) == jfb.attention_block_vmem_bytes(t, d)
