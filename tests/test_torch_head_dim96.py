"""Head dim 96 (the NOVA-1.4B ViTs: width 1536 over 16 heads) in the port,
on the CPU.

- The plain versions of the flash forward, its backward and the static
  attention against the JAX Pallas kernels in interpret mode at d = 96, on
  the same numpy inputs: no bias, a key bias (a fully masked sample), a full
  bias, lengths off every tile.
- The launch plans of the head-dim-96 CUDA kernels (the forward's two
  warpgroups and three stages, the backward's one-pass dkvq96 kernel with
  its workspace and turn counters) within the card's shared memory, at the
  NOVA-1.4B paths' shapes and ragged ones.
- A small NOVA at head dim 96 against the JAX model, on convert.py's
  weights: one serving step (the image encoder with every attention on the
  flash route, and the diffusion head), the calibrated int8 step (the static
  attention's bf16 core at d = 96) and one training step's loss and
  gradients (the flash forward and backward). The arch "vit_d2w192" (2
  layers, width 192, 2 heads) and "mlp_d2w192" are test-only: each test adds
  them to both packages' registries with ``monkeypatch.setitem``.

Tolerances, as the head-dim-64 files state them: the f32 forward atol 2e-5
on O(1) outputs (tests/test_torch_flash_attention.py); the f32 backward max
|diff| <= 1e-5 max |grad| (tests/test_torch_flash_backward.py); the static
attention atol 2e-3 with 99% within 1e-4 (p rounds to bf16 on both sides,
tests/test_torch_nova_kernels.py); the model's float step atol 2e-5, its
int8 step atol 3e-3 with 97% within 1e-4 (tests/test_torch_nova.py); the
training loss within 1e-5 relative and every gradient within 1e-4 relative
L2 (tests/test_torch_nova_train_step.py).
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nova_pointcloud_tpu.models import nova as jnova_mod
from nova_pointcloud_tpu.models.nova import NOVATransformer as JNOVA
from nova_pointcloud_tpu.ops import quantization as jquant
from nova_pointcloud_tpu.ops.pallas import flash_attention as jfa
from nova_pointcloud_tpu.pipelines.builder import init_transformer
from nova_pointcloud_tpu.schedulers import flow_match as jfm
from nova_pointcloud_tpu_torch.engine.lr_schedules import constant_lr
from nova_pointcloud_tpu_torch.engine.optim import build_optimizer
from nova_pointcloud_tpu_torch.models import nova as tnova_mod
from nova_pointcloud_tpu_torch.models.convert import convert_params, convert_tree
from nova_pointcloud_tpu_torch.models.nova import NOVATransformer as TNOVA
from nova_pointcloud_tpu_torch.ops.kernels import LAUNCHES
from nova_pointcloud_tpu_torch.ops.kernels import flash_attention as tfa
from nova_pointcloud_tpu_torch.pipelines.train_nova import NOVATrainT2IPipeline
from nova_pointcloud_tpu_torch.schedulers.flow_match import FlowMatchEulerScheduler
from tests.test_torch_flash_attention import _bias as _fwd_bias
from tests.test_torch_flash_backward import _bias as _bwd_bias
from tests.test_torch_nova import _apply_int8, _head_inputs, _nonzero, _np, _t
from tests.test_torch_nova_train_step import _CAP, _CapturingScheduler, _intercept

D = 96
SMEM_LIMIT = 232448  # a block's shared memory on the H100
SMS = 132
ARCHES = {"vit_d2w192": (2, 192, 2)}  # head dim 192 / 2 = 96
MLP = {"mlp_d2w192": (2, 192)}
W96 = dict(arch=("vit_d2w192", "vit_d2w192", "mlp_d2w192"), image_dim=4,
           image_base_size=(4, 4), video_base_size=(1, 2, 2), patch_size=2, text_token_dim=16,
           text_token_len=4)


@pytest.fixture(autouse=True)
def _w96_arches(monkeypatch):
    for mod in (jnova_mod, tnova_mod):
        for name, spec in ARCHES.items():
            monkeypatch.setitem(mod.VIT_ARCHES, name, spec)
        for name, spec in MLP.items():
            monkeypatch.setitem(mod.MLP_ARCHES, name, spec)


def _qkv(seed, b=2, h=2, lq=96, lk=96, d=D):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, h, lq, d)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, h, lk, d)) * 0.5).astype(np.float32)
    v = rng.standard_normal((b, h, lk, d)).astype(np.float32)
    do = rng.standard_normal((b, h, lq, d)).astype(np.float32)
    return q, k, v, do


# -- the kernels' plain versions against the JAX kernels ---------------------------

# Lq != Lk, both off the JAX blocks (64) and the CUDA tiles (64 / 128 rows)
LQ, LK = 77, 131


@pytest.mark.parametrize("kind", ["none", "key", "full"])
def test_forward_plain_matches_jax_kernel(kind):
    lq, lk = LQ, LK
    q, k, v, _ = _qkv(3, lq=lq, lk=lk)
    bias = _fwd_bias(kind, 5, 2, lq, lk)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             bias=None if bias is None else jnp.asarray(bias),
                                             blk_q=64, blk_k=64))
    tb = None if bias is None else torch.from_numpy(bias)
    got, lse = tfa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)), tb)
    assert got.shape == ref.shape == (2, 2, lq, D) and lse.shape == (2, 2, lq)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)
    assert not any(LAUNCHES.values())


@pytest.mark.parametrize("kind", ["none", "key", "full"])
def test_backward_plain_matches_jax_kernels(kind):
    lq, lk = LQ, LK
    q, k, v, do = _qkv(4, lq=lq, lk=lk)
    bias = _bwd_bias(kind, 6, 2, lq, lk)
    args = [jnp.asarray(a) for a in (q, k, v)]
    jb = None if bias is None else jnp.asarray(bias)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a, b_, c: jfa.flash_attention(a, b_, c, bias=jb, blk_q=64,
                                                             blk_k=64), *args)
        ref = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias)
    o, lse = tfa.flash_attention_plain(tq, tk, tv, tb)
    kb, fb = tfa._normalize_bias(tb, 2, lq, lk)
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, kb, fb, o, lse, torch.from_numpy(do))
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        g = g.numpy()
        assert g.shape == r.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, r, atol=1e-5 * np.abs(r).max(), rtol=0, err_msg=name)
        if kind == "key":  # the fully masked sample gives no gradient
            assert np.all(g[0] == 0.0)


@pytest.mark.parametrize("bias_kind", ["none", "visibility"])
def test_static_plain_matches_jax_kernel(bias_kind):
    """The bf16 score core: both sides round q * 96^-0.5 to bf16 before the
    product (not a power of 2: the scale cannot move onto the f32 scores)."""
    lq, lk = LQ, LK
    q, k, v, _ = _qkv(7, lq=lq, lk=lk)
    bias = None
    if bias_kind == "visibility":
        keep = np.random.default_rng(8).random((2, 1, 1, lk)) > 0.35
        keep[1] = False  # a fully masked sample gives 0
        bias = np.where(keep, 0.0, -np.inf).astype(np.float32)
    smax = np.float32(6.5)
    with pltpu.force_tpu_interpret_mode():
        ref = jfa.flash_attention_static(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(smax),
                                         None if bias is None else jnp.asarray(bias), blk_q=16)
    got = tfa.flash_attention_static(*map(torch.from_numpy, (q, k, v)), torch.tensor(smax),
                                     None if bias is None else torch.from_numpy(bias))
    ref, got = np.asarray(ref), got.numpy()
    assert got.shape == ref.shape == (2, 2, lq, D)
    np.testing.assert_allclose(got, ref, atol=2e-3, rtol=0)
    assert np.mean(np.abs(got - ref) <= 1e-4) > 0.99
    if bias is not None:
        assert np.all(got[1] == 0) and np.all(ref[1] == 0)
    assert not any(LAUNCHES.values())


def test_static_plain_rounds_the_scaled_q_to_bf16():
    """At d = 96 the bf16 core's product is bf16(q * 96^-0.5) kᵀ, not (q kᵀ)
    * 96^-0.5 (which the CUDA kernel may use at d = 64 only, where the
    scale is 2^-3): the two differ, so the kernel scales q in shared memory
    and the check is not vacuous."""
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((4, 77, D)).astype(np.float32) * 3)
    k = torch.from_numpy(rng.standard_normal((4, 131, D)).astype(np.float32) * 3)
    q, k = q.to(torch.bfloat16).float(), k.to(torch.bfloat16).float()
    scale = torch.tensor(D ** -0.5, dtype=torch.float32)
    a = torch.matmul((q * scale).to(torch.bfloat16).float(), k.transpose(-1, -2))
    b = torch.matmul(q, k.transpose(-1, -2)) * scale
    assert not torch.equal(a, b)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2.0 ** -7 * b.abs().max())


# -- the launch plans ----------------------------------------------------------------

# (b, h, lq, lk): the 1.4B paths' attentions and ragged ones
SHAPES = [(2, 16, 5120, 5120),   # the 1024px call's image encoder, CFG rows
          (2, 16, 1280, 1280),   # its video encoder: 256 text + 1024 video tokens
          (2, 16, 1536, 1536),   # the gather phases' first bucket
          (4, 16, 5120, 5120),   # training at batch 2 (x loss_repeat rows of the head only)
          (2, 16, 1000, 1531), (1, 1, 37, 45)]


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_forward_plan_at_head_dim_96(shape):
    """Two warpgroups (128-row items), three stages of 48 KB of K and V and
    their key bias, four 12 KB q slots, 7 mbarriers, 2 release counts
    (rounded to 128 bytes), 256 bytes of ones, 1 KB to align: 199,552 bytes,
    the same plan for the static kernel (it launches fwd_plan too)."""
    b, h, lq, lk = shape
    plan = tfa.fwd_plan(b, h, lq, lk, SMS, d=D)
    assert plan["warpgroups"] == 2 and plan["threads"] == 256 and plan["stages"] == 3
    assert plan["smem_bytes"] == 199552 <= SMEM_LIMIT
    assert plan["q_tiles"] == -(-lq // 128) and plan["key_tiles"] == -(-lk // 128)
    assert plan["items"] == b * h * plan["q_tiles"] and plan["grid"] == (min(plan["items"], SMS),)
    assert 0 < plan["last_keys"] <= 128
    # head dim 64 keeps its tiling
    p64 = tfa.fwd_plan(b, h, lq, lk, SMS)
    assert (p64["warpgroups"], p64["stages"], p64["smem_bytes"]) == (3, 4, 183680)


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_backward_plan_at_head_dim_96(shape):
    """The dkvq96 kernel: K and V of each warpgroup's 64 keys (12 KB tiles),
    three stages of q and do (72 KB), each warpgroup's dS^T tiles hi / lo
    (32 KB), two 24 KB dQ buffers, the stages' lse and delta rows, eleven
    mbarriers and the ticket word, 1 KB to align: 207,456 bytes, one block
    of 256 threads (two warpgroups) an SM. One block per (128 keys, B*H) on a 1-D grid;
    the f32 workspace (B*H, Lqp, 96) and the counters (the ticket and a
    turn per (B*H, 64-query tile))."""
    b, h, lq, lk = shape
    plan = tfa.bwd96_plan(b, h, lq, lk)
    assert plan["smem_bytes"] == 207456 <= SMEM_LIMIT and plan["threads"] == 256
    assert (plan["key_tiles"], plan["q_tiles"]) == (-(-lk // 128), -(-lq // 64))
    assert plan["grid"] == (plan["key_tiles"] * b * h,)
    assert plan["lqp"] % 128 == 0 and plan["lqp"] >= lq > plan["lqp"] - 128
    assert plan["workspace"] == (b * h, plan["lqp"], D)
    assert plan["counters"] == (1 + b * h * plan["q_tiles"],)
    assert plan["q_tiles"] * 64 <= plan["lqp"]  # every tile's store / reduce-add lands in it
    # the head-dim-64 route keeps its plan (its one-pass kernel would not fit at 96)
    assert tfa.bwd_plan(b, h, lq, lk)["smem_bytes"] == 199728


def test_head_dim_96_launch_sequence(monkeypatch):
    """bf16 at d = 96 launches prep, dkvq96 (its plan's tiles and bytes, the
    workspace, which key tile 0's parts are stored into and so needs no
    zeroing, the counters, which the entry point zeroes, dk and dv) and the
    cast of that workspace to dq at d = 96; f32 at 96 prep and f32_96;
    d = 80 raises first."""
    calls = []
    monkeypatch.setattr(tfa, "lib", lambda name, argtypes, library=None: (name, argtypes))
    monkeypatch.setattr(tfa, "run", lambda so, fn, args: calls.append((so, len(fn), args)))
    monkeypatch.setattr(tfa, "_stream", lambda dev: 0)
    b, h, lq, lk = 2, 3, 77, 131
    q = torch.zeros((b, lq, h, D), dtype=torch.bfloat16).transpose(1, 2)
    kv = torch.zeros((b, lk, h, D), dtype=torch.bfloat16).transpose(1, 2)
    launches, (dq, dk, dv) = tfa._bwd_operands(q, kv, kv, None, None, q,
                                               torch.zeros((b, h, lq)), q)
    tfa.run_bwd(launches)
    plan = tfa.bwd96_plan(b, h, lq, lk)
    assert [c[0] for c in calls] == list(tfa.BWD96_KERNELS)
    assert all(n == len(args) for _, n, args in calls)
    ws, counters = launches[1][3][8], launches[1][3][10]
    assert ws.shape == plan["workspace"] and ws.dtype == torch.float32 and ws.is_contiguous()
    assert counters.shape == plan["counters"] and counters.dtype == torch.int32
    main = calls[1][2]
    assert main[6:12] == [b, h, lq, lk, plan["lqp"], D] and main[15] == pytest.approx(D ** -0.5)
    assert main[16:20] == [ws.data_ptr(), dk.data_ptr(), dv.data_ptr(), counters.data_ptr()]
    assert main[20:23] == [plan["key_tiles"], plan["q_tiles"], plan["smem_bytes"]]
    cast = calls[2][2]
    assert cast[:6] == [ws.data_ptr(), b, h, lq, plan["lqp"], D] and cast[8] == dq.data_ptr()
    assert dq.shape == (b, h, lq, D) and dq.transpose(1, 2).is_contiguous()
    assert [LAUNCHES[n] for n in tfa.BWD96_KERNELS] == [1, 1, 1]
    # f32 at head dim 96 reaches its own kernels (prep, f32_96)
    tfa._launch_bwd(q.float(), kv.float(), kv.float(), None, None, q.float(),
                    torch.zeros((b, h, lq)), q.float())
    assert [c[0] for c in calls[3:]] == list(tfa.BWD96_F32_KERNELS)
    x80 = torch.zeros((1, 2, 8, 80), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfa._launch_bwd(x80, x80, x80, None, None, x80, torch.zeros((1, 2, 8)), x80)
    assert len(calls) == 5
    for n in tfa.BWD96_KERNELS + tfa.BWD96_F32_KERNELS:
        LAUNCHES[n] = 0


# -- a small NOVA at head dim 96 --------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _params():
    """Seeded W96 weights (every zero-initialised leaf filled), built once."""
    jm = JNOVA(**W96, noise_scheduler=jfm.FlowMatchEulerScheduler())
    return _nonzero(jax.tree.map(np.asarray, init_transformer(jm, seed=0)), 1)


def _models(quantize=False, attn_impl="pallas"):
    """(jax model, jax params, torch model) at W96 on _params()."""
    cfg = dict(W96, attn_impl=attn_impl)
    params = _params()
    jm = JNOVA(**cfg, noise_scheduler=jfm.FlowMatchEulerScheduler(), quantize=quantize)
    tm = TNOVA(**cfg, quantize=quantize, device="cpu")
    tm.load_state_dict(convert_params(params), strict=True)
    assert tm.head_dim_i == tm.head_dim_v == D
    return jm, params, tm


def _jit_apply(jm, fn, **kw):
    """``jm.apply`` of ``fn`` jitted (interpret-mode Pallas runs an eager
    call op by op)."""
    return jax.jit(lambda v, *a: jm.apply(v, *a, method=fn, **kw))


def _encoder_inputs(seed, b=2, n_visible=6):
    rng = np.random.default_rng(seed)
    tokens = rng.standard_normal((b, 16, 192)).astype(np.float32)
    cond = rng.standard_normal((b, 4, 192)).astype(np.float32)
    mask = np.ones((b, 16, 1), np.float32)
    for i in range(b):
        mask[i, rng.permutation(16)[: n_visible - i], 0] = 0.0
    return tokens, mask, cond


def test_serving_step_matches_jax():
    """One image-encoder pass (the masked encoder half's key bias and the
    decoder half, every layer on the flash route) and one diffusion-head
    eval, f32."""
    jm, params, tm = _models()
    tokens, mask, cond = _encoder_inputs(9)
    with pltpu.force_tpu_interpret_mode():
        ref = _jit_apply(jm, jm.encode_image_step)({"params": params}, jnp.asarray(tokens),
                                                   jnp.asarray(mask), jnp.asarray(cond))
    got = tm.encode_image_step(_t(tokens), _t(mask), _t(cond))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=2e-5, rtol=0)
    x, t, z = _head_inputs(8, d=192)
    ref = _jit_apply(jm, jm.denoise_step)({"params": params}, *(jnp.asarray(a) for a in (x, t, z)))
    got = tm.denoise_step(_t(x), _t(t), _t(z))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=2e-5, rtol=0)
    assert not any(LAUNCHES.values())


def test_calibrated_int8_step_matches_jax():
    """The int8 image-encoder pass with calibrated static sites (the JAX
    mirror's stats), so every layer runs the static attention's bf16 core
    at d = 96 and the static int8 MLP."""
    jm, params, tm = _models(quantize=True, attn_impl="auto")
    tokens, mask, cond = _encoder_inputs(10)
    args = (jnp.asarray(tokens), jnp.asarray(mask), jnp.asarray(cond))
    _, vs = _jit_apply(jm, jm.encode_image_step, mutable=["act_stats"])({"params": params},
                                                                          *args)
    jq = jquant.merge_act_scales(jquant.quantize_serving_params(params),
                                 jax.tree.map(np.asarray, vs["act_stats"]), 1.05)
    ref = _apply_int8(jm, params, jq, jm.encode_image_step, *args)
    got = tm.encode_image_step(_t(tokens), _t(mask), _t(cond),
                               qparams=convert_tree(jax.tree.map(np.asarray, jq)))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=3e-3, rtol=0)
    assert np.mean(np.abs(_np(got) - np.asarray(ref)) <= 1e-4) > 0.97
    assert not any(LAUNCHES.values())


def _batch():
    rng = np.random.default_rng(0)
    lat = (2, 8, 8, 4)
    return {"moments": np.concatenate([rng.standard_normal(lat) * 0.8, np.full(lat, -6.0)],
                                      -1).astype(np.float16),
            "text_embeds": rng.standard_normal((2, 4, 16)).astype(np.float32)}


def test_training_loss_and_gradients_match_jax(monkeypatch):
    """One training step's loss and every gradient, attn_impl="pallas" on both
    sides (the flash forward and backward at d = 96 in every layer); the JAX
    step's draws go to the port (tests/test_torch_nova_train_step.py)."""
    from nova_pointcloud_tpu.engine.lr_schedules import constant_lr as jconstant_lr
    from nova_pointcloud_tpu.engine.optim import build_optimizer as jbuild_optimizer
    from nova_pointcloud_tpu.pipelines.train_nova import NOVATrainT2IPipeline as JPipe

    params = _params()
    cfg = dict(W96, attn_impl="pallas")
    jm = JNOVA(**cfg, noise_scheduler=_CapturingScheduler())
    jpipe = JPipe(jm, params, optimizer=jbuild_optimizer(params, jconstant_lr(1e-3)),
                  output_dir=None, ema_decay=None, resume=False)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    _, key = jax.random.split(jax.random.PRNGKey(0))

    def loss_and_draws(p, b, k):
        _CAP.clear()
        with nn.intercept_methods(_intercept):
            total, _ = jpipe.loss_fn(p, b, k)
        return total, dict(_CAP)

    with pltpu.force_tpu_interpret_mode():
        (loss, draws), grads = jax.jit(jax.value_and_grad(loss_and_draws, has_aux=True))(
            params, batch, key)
    eps = np.asarray(jax.random.normal(jax.random.split(key, 5)[0], (2, 8, 8, 4), jnp.float32))
    te = _batch()["text_embeds"]
    port_draws = {"latent_eps": eps, "mask": np.asarray(draws["mask"]),
                  "timesteps": np.asarray(draws["timesteps"]), "noise": np.asarray(draws["noise"]),
                  "drop": np.array([np.any(np.asarray(draws["dropped"][i]) != te[i])
                                    for i in range(2)])}

    calls = []
    bwd = tfa.flash_attention_bwd_plain
    monkeypatch.setattr(tfa, "flash_attention_bwd_plain",
                        lambda *a: calls.append(a[0].shape[-1]) or bwd(*a))
    tm = TNOVA(**cfg, noise_scheduler=FlowMatchEulerScheduler(), device="cpu")
    tm.load_state_dict(convert_params(params), strict=True)
    pipe = NOVATrainT2IPipeline(tm, optimizer=build_optimizer(tm, constant_lr(1e-3)))
    got, _ = pipe.loss_fn({k: torch.from_numpy(v) for k, v in _batch().items()}, None,
                          draws={k: torch.from_numpy(np.array(v)) for k, v in port_draws.items()})
    got.backward()
    assert calls == [D] * 4  # 2 video + 2 image layers, each through the flash backward
    np.testing.assert_allclose(float(got), float(loss), rtol=1e-5)
    jgrads = convert_params(jax.tree.map(np.asarray, grads))
    for name, p in tm.named_parameters():
        r = jgrads[name].numpy()
        g = np.zeros_like(r) if p.grad is None else p.grad.numpy()
        if not np.any(r):  # video_patch_embed: created at T = 1, unused
            assert not np.any(g), name
            continue
        err = np.linalg.norm(g - r) / np.linalg.norm(r)
        assert err <= 1e-4, (name, err)
    assert not any(LAUNCHES.values())
