"""Head dim 96 in the f32 flash kernels and in the static attention's int8
score core, on the CPU.

- The static attention's plain version with the int8 score core (the
  calibrated a_q / a_k) against the JAX ``flash_attention_static`` in Pallas
  interpret mode at d = 96: no bias and a visibility bias with a fully masked
  sample, at lengths off every tile.
- A calibrated int8 image-encoder step of the test-only vit_d2w192 NOVA
  with ``attn_core="int8"`` (every layer on the int8 score core at d = 96)
  against the JAX model on the same weights and calibration.
- The launch plans of the f32 forward (``fwd_f32_plan``) and of the f32
  backward's one-pass f32_96 kernel (``bwd96_f32_plan``) at d = 96, at the
  NOVA-1.4B paths' shapes and ragged ones, within a block's shared memory.
- The launch arguments of the head-dim-96 instances (the f32 forward, the
  f32 backward's one pass after the prep kernel, the bf16 backward's prep,
  dkvq96 and cast in every bias form, the static int8 core) with ``lib`` /
  ``run`` / ``_stream`` monkeypatched, so CPU tensors take the CUDA route up
  to the recorded launch.

Tolerances: the int8 core as the head-dim-64 static test states them
(tests/test_torch_nova_kernels.py: p rounds to bf16 on both sides, so a p on
a rounding edge may round the other way): atol 2e-3, 99% within 1e-4; the
model step as tests/test_torch_head_dim96.py's calibrated step: atol 3e-3,
97% within 1e-4.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nova_pointcloud_tpu.models.nova import NOVATransformer as JNOVA
from nova_pointcloud_tpu.ops import quantization as jquant
from nova_pointcloud_tpu.ops.pallas import flash_attention as jfa
from nova_pointcloud_tpu.schedulers import flow_match as jfm
from nova_pointcloud_tpu_torch.models import vit as tvit
from nova_pointcloud_tpu_torch.models.convert import convert_params, convert_tree
from nova_pointcloud_tpu_torch.models.nova import NOVATransformer as TNOVA
from nova_pointcloud_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
from nova_pointcloud_tpu_torch.ops.kernels import flash_attention as tfa
from tests.test_torch_head_dim96 import (D, LK, LQ, SMEM_LIMIT, SMS, W96, _encoder_inputs,
                                         _jit_apply, _params, _qkv, _w96_arches)
from tests.test_torch_nova import _apply_int8, _np, _t

assert _w96_arches  # the autouse fixture: vit_d2w192 / mlp_d2w192 in both registries


def _visibility(seed, b, lk):
    keep = np.random.default_rng(seed).random((b, 1, 1, lk)) > 0.35
    keep[1] = False  # a fully masked sample gives 0
    return np.where(keep, 0.0, -np.inf).astype(np.float32)


@pytest.mark.parametrize("bias_kind", ["none", "visibility"])
def test_static_int8_core_plain_matches_jax_kernel(bias_kind):
    """Both sides quantize q and k with the static scales 127 / a_q, 127 /
    a_k, take the int32 product and fold a_q a_k / 127^2 * 96^-0.5 into one
    f32 factor."""
    q, k, v, _ = _qkv(17, lq=LQ, lk=LK)
    bias = _visibility(18, 2, LK) if bias_kind == "visibility" else None
    smax = np.float32(6.5)
    a_q, a_k = np.float32(np.abs(q).max() * 1.05), np.float32(np.abs(k).max() * 1.05)
    with pltpu.force_tpu_interpret_mode():
        ref = jfa.flash_attention_static(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(smax),
                                         None if bias is None else jnp.asarray(bias), blk_q=16,
                                         a_q=jnp.asarray(a_q), a_k=jnp.asarray(a_k))
    got = tfa.flash_attention_static(*map(torch.from_numpy, (q, k, v)), torch.tensor(smax),
                                     None if bias is None else torch.from_numpy(bias),
                                     a_q=torch.tensor(a_q), a_k=torch.tensor(a_k))
    ref, got = np.asarray(ref), got.numpy()
    assert got.shape == ref.shape == (2, 2, LQ, D)
    np.testing.assert_allclose(got, ref, atol=2e-3, rtol=0)
    assert np.mean(np.abs(got - ref) <= 1e-4) > 0.99
    # the int8 core is not the bf16 one (the check is not vacuous)
    bf16 = tfa.flash_attention_static(*map(torch.from_numpy, (q, k, v)), torch.tensor(smax),
                                      None if bias is None else torch.from_numpy(bias)).numpy()
    assert not np.array_equal(bf16, got)
    if bias is not None:
        assert np.all(got[1] == 0) and np.all(ref[1] == 0)
    assert not any(LAUNCHES.values())


def test_calibrated_int8_core_step_matches_jax(monkeypatch):
    """The int8 image-encoder pass with calibrated static sites and
    attn_core="int8": every layer's attention on the static int8 score core
    at d = 96 with the calibration's amax of q and k."""
    params = _params()
    cfg = dict(W96, attn_impl="auto")
    jm = JNOVA(**cfg, noise_scheduler=jfm.FlowMatchEulerScheduler(), quantize=True,
               attn_core="int8")
    tm = TNOVA(**cfg, quantize=True, attn_core="int8", device="cpu")
    tm.load_state_dict(convert_params(params), strict=True)
    tokens, mask, cond = _encoder_inputs(10)
    args = (jnp.asarray(tokens), jnp.asarray(mask), jnp.asarray(cond))
    _, vs = _jit_apply(jm, jm.encode_image_step, mutable=["act_stats"])({"params": params},
                                                                          *args)
    jq = jquant.merge_act_scales(jquant.quantize_serving_params(params),
                                 jax.tree.map(np.asarray, vs["act_stats"]), 1.05)
    ref = _apply_int8(jm, params, jq, jm.encode_image_step, *args)
    calls, static = [], tvit.flash_attention_static

    def counted(q, *a, **kw):
        calls.append((q.shape[-1], kw.get("a_q") is not None and kw.get("a_k") is not None))
        return static(q, *a, **kw)

    monkeypatch.setattr(tvit, "flash_attention_static", counted)
    got = tm.encode_image_step(_t(tokens), _t(mask), _t(cond),
                               qparams=convert_tree(jax.tree.map(np.asarray, jq)))
    assert calls == [(D, True)] * 2  # the encoder and decoder halves, each on the int8 core
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=3e-3, rtol=0)
    assert np.mean(np.abs(_np(got) - np.asarray(ref)) <= 1e-4) > 0.97
    assert not any(LAUNCHES.values())


# -- the launch plans ----------------------------------------------------------------

# (b, h, lq, lk): the 1.4B paths' attentions in f32 and ragged ones
F32_SHAPES = [(2, 16, 5120, 5120),   # the 1024px call's image encoder, CFG rows
              (2, 16, 1280, 1280),   # its video encoder: 256 text + 1024 video tokens
              (2, 16, 2253, 2253),   # the training step's encoder half: 1024 + 1229 keys
              (2, 16, 1056, 1056),   # the training step's video encoder: 32 + 1024
              (1, 16, 5120, 5120),   # the training step at batch 1
              (2, 16, 1000, 1531), (1, 1, 37, 45)]


@pytest.mark.parametrize("shape", F32_SHAPES, ids=[str(s) for s in F32_SHAPES])
def test_fwd_f32_plan_at_head_dim_96(shape):
    """64 query rows a block (4 a thread), q as one 24 KB tile, K and V 24 KB
    each, P 16 KB, the key tile's 256 bytes of bias, two mbarriers, 1 KB to
    align: 91,408 bytes, two blocks an SM; head dim 64 keeps its plan."""
    b, h, lq, lk = shape
    plan = tfa.fwd_f32_plan(b, h, lq, lk, d=D)
    assert plan["block_q"] == 64 and plan["threads"] == 128
    assert plan["smem_bytes"] == 91408 <= SMEM_LIMIT
    assert 2 * (plan["smem_bytes"] + 1024) <= 228 * 1024
    assert plan["q_tiles"] == -(-lq // 64) and plan["grid"] == (b * h * plan["q_tiles"],)
    assert plan["key_tiles"] == -(-lk // 64) and 0 < plan["last_keys"] <= 64
    p64 = tfa.fwd_f32_plan(b, h, lq, lk)
    assert (p64["block_q"], p64["smem_bytes"], p64["q_tiles"]) == (128, 99600, -(-lq // 128))


@pytest.mark.parametrize("shape", F32_SHAPES, ids=[str(s) for s in F32_SHAPES])
def test_bwd96_f32_plan(shape):
    """f32_96: K and V (24 KB each), two stages of q and do, P and dS (16 KB
    each), the tile's dQ part (24 KB), the stages' lse and delta rows, three
    mbarriers and the ticket word, 1 KB to align: 206,880 bytes, one block
    of 256 threads an SM. One block per (64 keys, B*H) on a 1-D grid; dq
    (the kernel adds into it) zeroed by the wrapper, the counters by the
    entry point."""
    b, h, lq, lk = shape
    plan = tfa.bwd96_f32_plan(b, h, lq, lk)
    assert plan["smem_bytes"] == 206880 <= SMEM_LIMIT and plan["threads"] == 256
    assert (plan["key_tiles"], plan["q_tiles"]) == (-(-lk // 64), -(-lq // 64))
    assert plan["grid"] == (plan["key_tiles"] * b * h,)
    assert plan["counters"] == (1 + b * h * plan["q_tiles"],)
    assert plan["workspace"] == (b, lq, h, D)
    assert plan["lqp"] % 128 == 0 and plan["lqp"] >= lq


# -- the launch arguments ------------------------------------------------------------

class _Recorder:
    """Stands in for the ctypes launch: each call's name, arguments and its
    strides array (read while it lives)."""

    def __init__(self, n_strides):
        self.calls, self.n = [], n_strides

    def lib(self, name, argtypes, library=None):
        return name, argtypes

    def run(self, so, fn, args):
        name, argtypes = so, fn
        assert len(args) == len(argtypes), name
        # the strides pointer's place and length
        at, n = {"flash_attention_bwd_prep": (9, 6), "flash_attention_bwd_dq_cast": (6, 3)}.get(
            name, (12 if name.startswith("flash_attention_bwd") else 9, self.n))
        arr = ctypes.cast(args[at], ctypes.POINTER(ctypes.c_long))
        self.calls.append((name, args, [arr[i] for i in range(n)]))


def _blhd(rng, b, h, n, dtype=torch.float32):
    """A (B, H, L, 96) view of a (B, L, H, 96) tensor, as the model's
    projections hand it over."""
    x = torch.from_numpy(rng.standard_normal((b, n, h, D)).astype(np.float32))
    return x.to(dtype).transpose(1, 2)


@pytest.fixture
def record(monkeypatch):
    def make(n_strides):
        r = _Recorder(n_strides)
        monkeypatch.setattr(tfa, "lib", r.lib)
        monkeypatch.setattr(tfa, "run", r.run)
        monkeypatch.setattr(tfa, "_stream", lambda dev: 0)
        monkeypatch.setattr(tfa, "_sms", lambda dev: SMS)
        return r
    yield make
    reset_launch_counts()


@pytest.mark.parametrize("bias", ["none", "key", "full"])
def test_f32_forward_launch_at_head_dim_96(record, bias):
    rec = record(12)
    b, h, lq, lk = 2, 3, 77, 131
    rng = np.random.default_rng(lq)
    q, k, v = _blhd(rng, b, h, lq), _blhd(rng, b, h, lk), _blhd(rng, b, h, lk)
    kb = torch.zeros((b, lk)) if bias == "key" else None
    fb = torch.zeros((lq, lk)) if bias == "full" else None
    o, lse = tfa._launch(q, k, v, kb, fb)
    plan = tfa.fwd_f32_plan(b, h, lq, lk, d=D)
    (name, args, strides), = rec.calls
    assert name == "flash_attention" and LAUNCHES["flash_attention"] == 1
    assert args[3:9] == [0, b, h, lq, lk, D]
    assert args[13] == pytest.approx(D ** -0.5) and args[13] != 0.125
    assert args[16:18] == [plan["grid"][0], plan["smem_bytes"]] == [b * h * 2, 91408]
    assert strides[:3] == [lq * h * D, D, h * D]  # q read in place in (B, L, H, D)
    assert o.shape == (b, h, lq, D) and o.dtype == torch.float32 and lse.shape == (b, h, lq)
    assert args[14] == o.data_ptr() and args[15] == lse.data_ptr()
    assert (args[10] is not None) == (bias == "key") and (args[12] is not None) == (bias == "full")


@pytest.mark.parametrize("bias", ["none", "key", "full"])
def test_f32_backward_launches_at_head_dim_96(record, bias):
    """prep (natural lse), then f32_96 with the f32 one-pass kernel's
    argument list (21 strides) and the counters (which the entry point
    zeroes), its plan's tiles and bytes; dq zeroed (the kernel adds its
    parts into it, no workspace)."""
    rec = record(21)
    b, h, lq, lk = 2, 3, 77, 131
    rng = np.random.default_rng(lk)
    q, k, v = _blhd(rng, b, h, lq), _blhd(rng, b, h, lk), _blhd(rng, b, h, lk)
    kb = torch.zeros((b, lk)) if bias == "key" else None
    fb = torch.zeros((lq, lk)) if bias == "full" else None
    launches, (dq, dk, dv) = tfa._bwd_operands(q, k, v, kb, fb, q, torch.zeros((b, h, lq)), q)
    assert not dq.any()
    counters = launches[1][3][10]
    assert counters.shape == tfa.bwd96_f32_plan(b, h, lq, lk)["counters"]
    assert counters.dtype == torch.int32
    tfa.run_bwd(launches)
    plan = tfa.bwd96_f32_plan(b, h, lq, lk)
    assert [c[0] for c in rec.calls] == list(tfa.BWD96_F32_KERNELS)
    assert [LAUNCHES[n] for n in tfa.BWD96_F32_KERNELS] == [1, 1]
    prep = rec.calls[0][1]
    assert prep[3:9] == [0, b, h, lq, plan["lqp"], D] and prep[10] == 0  # natural units
    (name, args, strides), = rec.calls[1:]
    assert args[6:12] == [b, h, lq, lk, plan["lqp"], D]
    assert args[15] == pytest.approx(D ** -0.5)
    assert args[16:20] == [dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), counters.data_ptr()]
    assert args[20:23] == [plan["key_tiles"], plan["q_tiles"], plan["smem_bytes"]]
    assert strides[:3] == [lq * h * D, D, h * D]
    assert strides[12:] == [lq * h * D, D, h * D, lk * h * D, D, h * D, lk * h * D, D, h * D]
    assert (args[13] is not None) == (bias == "key") and (args[14] is not None) == (bias == "full")
    for g, n in ((dq, lq), (dk, lk), (dv, lk)):
        assert g.shape == (b, h, n, D) and g.dtype == torch.float32
        assert g.transpose(1, 2).is_contiguous()


@pytest.mark.parametrize("bias", ["none", "key", "full"])
def test_bf16_backward_launches_at_head_dim_96(record, bias):
    """prep (lse in units of log 2), dkvq96 (18 strides: q, k, v, do, dk,
    dv; the workspace, which key tile 0's parts are stored into, and the
    counters, which the entry point zeroes; its plan's tiles and bytes),
    then the cast of the workspace at d = 96 into dq in the (B, L, H, D)
    layout."""
    rec = record(18)
    b, h, lq, lk = 2, 3, 77, 131
    rng = np.random.default_rng(lq * lk)
    q, k, v = (_blhd(rng, b, h, n, torch.bfloat16) for n in (lq, lk, lk))
    kb = torch.zeros((b, lk)) if bias == "key" else None
    fb = torch.zeros((lq, lk)) if bias == "full" else None
    launches, (dq, dk, dv) = tfa._bwd_operands(q, k, v, kb, fb, q, torch.zeros((b, h, lq)), q)
    ws, counters = launches[1][3][8], launches[1][3][10]
    assert (ws.shape, ws.dtype, counters.dtype) == (tuple(tfa.bwd96_plan(b, h, lq, lk)["workspace"]),
                                                    torch.float32, torch.int32)
    tfa.run_bwd(launches)
    plan = tfa.bwd96_plan(b, h, lq, lk)
    assert [c[0] for c in rec.calls] == list(tfa.BWD96_KERNELS)
    assert [LAUNCHES[n] for n in tfa.BWD96_KERNELS] == [1, 1, 1]
    prep = rec.calls[0][1]
    assert prep[3:9] == [1, b, h, lq, plan["lqp"], D] and prep[10] == 1  # units of log 2
    _, args, strides = rec.calls[1]
    assert args[6:12] == [b, h, lq, lk, plan["lqp"], D]
    assert args[16:20] == [ws.data_ptr(), dk.data_ptr(), dv.data_ptr(), counters.data_ptr()]
    assert args[20:23] == [plan["key_tiles"], plan["q_tiles"], plan["smem_bytes"]]
    assert strides[:3] == [lq * h * D, D, h * D] and strides[12:] == [lk * h * D, D, h * D] * 2
    assert (args[13] is not None) == (bias == "key") and (args[14] is not None) == (bias == "full")
    _, cast, cast_strides = rec.calls[2]
    assert cast[:6] == [ws.data_ptr(), b, h, lq, plan["lqp"], D] and cast[8] == dq.data_ptr()
    assert cast_strides == [lq * h * D, D, h * D]
    for g, n in ((dq, lq), (dk, lk), (dv, lk)):
        assert g.shape == (b, h, n, D) and g.dtype == torch.bfloat16
        assert g.transpose(1, 2).is_contiguous()


@pytest.mark.parametrize("qk_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", ["none", "key"])
def test_static_int8_core_launch_at_head_dim_96(record, qk_dtype, bias):
    """The int8 score core at 96: Tiling<96>'s plan, the amax scalars and the
    quant pass's code buffers given, the scale 96^-0.5 (no power of 2)."""
    rec = record(12)
    b, h, lq, lk = 2, 3, 77, 131
    rng = np.random.default_rng(lq + lk)
    q, k = _blhd(rng, b, h, lq, qk_dtype), _blhd(rng, b, h, lk, qk_dtype)
    v = _blhd(rng, b, h, lk, torch.bfloat16)
    kb = torch.zeros((b, lk)) if bias == "key" else None
    o = tfa._launch_static(q, k, v, torch.tensor(9.0), kb, torch.tensor(4.5), torch.tensor(4.0))
    plan = tfa.fwd_plan(b, h, lq, lk, SMS, d=D)
    (name, args, strides), = rec.calls
    assert name == "flash_attention_static" and LAUNCHES["flash_attention_static"] == 1
    assert args[3:9] == [int(qk_dtype == torch.bfloat16), b, h, lq, lk, D]
    assert all(args[i] is not None for i in (12, 13, 14, 16, 17))  # smax, a_q, a_k, q8, k8
    assert args[15] == D ** -0.5
    assert args[20:22] == [plan["grid"][0], plan["smem_bytes"]] and plan["smem_bytes"] == 199552
    assert strides[:3] == [lq * h * D, D, h * D]  # q read in place: no bf16 copy for int8
    assert o.shape == (b, h, lq, D) and o.dtype == qk_dtype
    assert (args[10] is not None) == (bias == "key")
