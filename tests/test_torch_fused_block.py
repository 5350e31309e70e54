"""Port's fused-block kernels (plain PyTorch versions, as the CPU runs them)
vs the JAX Pallas kernels in interpret mode, on the same numpy inputs.

Tolerance: both sides quantize the same f32 values with the same rounding
(half-to-even, static sites multiplying by 1/s, per-row sites dividing), so
on these inputs every int8 code agrees and the outputs (O(1)) differ only by
f32 summation order: measured <= 2.4e-7. atol 1e-4 allows for that order
and fails on a single int8 code that differs (~1e-3 here). The one known
exception, a bf16 element at exactly half its row's amax, has a test of its
own (test_half_amax_tie_is_pinned).
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
    assert set(tfb.LAUNCHES) >= {"fused_attention_block", "fused_ln_int8_mlp"}
    assert not any(tfb.LAUNCHES.values())


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


@pytest.mark.parametrize("t,d", [(128, 1024), (64, 64), (1024, 768), (2048, 1024)]
                         + [(t, d) for d in (768, 1024, 1536) for t in (161, 162, 435, 436, 607, 608, 2048)])
def test_vmem_gate_matches_jax(t, d):
    assert tfb.attention_block_vmem_bytes(t, d) == jfb.attention_block_vmem_bytes(t, d)


def _proj_operands(seed, lead=(2, 24), d_in=64, d_out=192):
    """x, LN params, int8 (d_in, d_out) weight with scales, bias, residual."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = (rng.standard_normal(lead + (d_in,)) * 0.5).astype(f)
    lns = (rng.standard_normal(d_in) * 0.1 + 1.0).astype(f)
    lnb = (rng.standard_normal(d_in) * 0.1).astype(f)
    w = jquantize_weight(jnp.asarray(rng.standard_normal((d_in, d_out)) * 0.1, jnp.float32))
    b = (rng.standard_normal(d_out) * 0.02).astype(f)
    res = (rng.standard_normal(lead + (d_out,)) * 0.5).astype(f)
    return x, lns, lnb, np.asarray(w.values), np.asarray(w.scales), b, res


BF16_SEED = 24


def _bf16(a):
    """numpy f32 -> (jax bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


# rows = 48, 35 and 7: one, two and no whole blocks of block_m=16 plus a tail
@pytest.mark.parametrize("lead", [(2, 24), (5, 7), (7,)])
def test_ln_int8_matmul_matches_jax(lead):
    x, lns, lnb, wq, ws, b, _ = _proj_operands(seed=21, lead=lead)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jfb.fused_ln_int8_matmul(
            *[jnp.asarray(o) for o in (x, lns, lnb, wq, ws, b)], block_m=16))
    got = tfb.fused_ln_int8_matmul(*[_t(o) for o in (x, lns, lnb, wq, ws, b)])
    assert got.dtype == torch.float32 and got.shape == ref.shape == lead + (192,)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    # every int8 code agrees: the per-row quant of LN(x) is the same function
    q_ref, _ = jfb._quant_rows(jfb._ln(jnp.asarray(x), jnp.asarray(lns), jnp.asarray(lnb)))
    q_got, _ = tfb.quantize_activations(tfb._ln(_t(x), _t(lns), _t(lnb)))
    assert np.array_equal(np.asarray(q_ref), q_got.numpy())
    assert not any(tfb.LAUNCHES.values())


@pytest.mark.parametrize("lead", [(2, 24), (5, 7), (7,)])
def test_int8_matmul_residual_matches_jax(lead):
    x, _, _, wq, ws, b, res = _proj_operands(seed=22, lead=lead, d_in=64, d_out=64)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jfb.int8_matmul_residual(
            *[jnp.asarray(o) for o in (x, res, wq, ws, b)], block_m=16))
    got = tfb.int8_matmul_residual(*[_t(o) for o in (x, res, wq, ws, b)])
    assert got.dtype == torch.float32 and got.shape == ref.shape == res.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    q_ref, _ = jfb._quant_rows(jnp.asarray(x))
    q_got, _ = tfb.quantize_activations(_t(x))
    assert np.array_equal(np.asarray(q_ref), q_got.numpy())


@pytest.mark.parametrize("kernel,x_bf16,res_bf16", [
    ("ln_matmul", True, None), ("residual", True, True),
    ("residual", True, False), ("residual", False, True)])
def test_split_path_kernels_bf16_match_jax(kernel, x_bf16, res_bf16):
    """bf16 activations, and x / residual of differing dtypes: the output
    takes x's dtype (LN + matmul) or the residual's (out-projection).

    The seed below has no row with an element at exactly half the row's
    amax; test_half_amax_tie_is_pinned holds the seeds that have one."""
    x, lns, lnb, wq, ws, b, res = _proj_operands(
        seed=BF16_SEED, d_out=192 if kernel == "ln_matmul" else 64)
    xj, xt = _bf16(x) if x_bf16 else (jnp.asarray(x), _t(x))
    if kernel == "ln_matmul":
        with pltpu.force_tpu_interpret_mode():
            ref = jfb.fused_ln_int8_matmul(xj, *[jnp.asarray(o) for o in (lns, lnb, wq, ws, b)])
        got = tfb.fused_ln_int8_matmul(xt, *[_t(o) for o in (lns, lnb, wq, ws, b)])
        want = torch.bfloat16
    else:
        rj, rt = _bf16(res) if res_bf16 else (jnp.asarray(res), _t(res))
        with pltpu.force_tpu_interpret_mode():
            ref = jfb.int8_matmul_residual(xj, rj, *[jnp.asarray(o) for o in (wq, ws, b)])
        got = tfb.int8_matmul_residual(xt, rt, *[_t(o) for o in (wq, ws, b)])
        want = torch.bfloat16 if res_bf16 else torch.float32
    assert got.dtype == want and got.shape == ref.shape
    ref = np.asarray(ref.astype(jnp.float32))
    if want == torch.float32:
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    else:  # one bf16 ulp at |y| < 4, as test_bf16_activations_match_jax
        np.testing.assert_allclose(got.float().numpy(), ref, atol=1.6e-2, rtol=0)
        assert np.mean(got.float().numpy() == ref) > 0.99


@pytest.mark.parametrize("seed,row", [(23, (0, 12)), (26, (0, 2))])
def test_half_amax_tie_is_pinned(seed, row):
    """A bf16 row holding an element at exactly half its amax: x / s is
    63.49999.. with s = amax / 127 divided as written, and exactly 63.5 (half
    to even: 64) with s = amax * (1 / 127), one f32 ulp lower, which is what
    XLA's jit makes of the division on the CPU. The port divides as written,
    as the JAX function run eagerly does: codes and scales equal eager JAX
    everywhere. The jitted kernel differs from both by that one code, in
    that one row, and nowhere else. Which of the two a TPU computes is not
    known here."""
    import jax

    x, _, _, wq, ws, b, res = _proj_operands(seed=seed, d_in=64, d_out=64)
    xj, xt = _bf16(x)
    q_eager, s_eager = (np.asarray(a) for a in jfb._quant_rows(xj))
    q_jit, s_jit = (np.asarray(a) for a in jax.jit(jfb._quant_rows)(xj))
    q_port, s_port = (a.numpy() for a in tfb.quantize_activations(xt))
    assert np.array_equal(q_port, q_eager) and np.array_equal(s_port, s_eager)
    xf = np.asarray(xj.astype(jnp.float32))
    half_amax = 2 * np.abs(xf) == np.abs(xf).max(-1, keepdims=True)
    differs = q_jit != q_eager
    assert differs.sum() == 1 and differs[row].sum() == 1
    assert half_amax[differs].all()  # only such an element can flip
    assert np.all(np.abs(q_jit.astype(int) - q_eager) <= 1)
    assert np.all(s_jit <= s_eager) and np.all(s_eager - s_jit <= np.spacing(s_jit))
    # the kernels: the tie's row is off by that code's weight row, the rest agree
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jfb.int8_matmul_residual(
            xj, *[jnp.asarray(o) for o in (res, wq, ws, b)], block_m=16))
    got = tfb.int8_matmul_residual(xt, *[_t(o) for o in (res, wq, ws, b)]).numpy()
    err = np.abs(got - ref).max(-1)
    assert err[row] > ATOL
    code_weight = s_eager[row][0] * np.abs(wq[differs[row].argmax()] * ws).max()
    assert err[row] <= 1.01 * code_weight + ATOL
    err[row] = 0
    assert err.max() <= ATOL
