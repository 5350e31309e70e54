"""The NOVA t2i slice of the port vs the JAX package on the CPU: each ported
module against its JAX counterpart on the same numpy inputs and weights
(converted by models/convert.py). The whole sampler is held against a replay
of the JAX algorithm in test_torch_nova_sampler.py, with these helpers.

Tolerances. Float f32 paths: the same math in another summation order, atol
2e-5 on O(1) values (5e-5 through the whole sampler, as a mean). Float bf16
paths: op by op the port rounds as flax does (every bf16 op of one block
agrees bitwise with the JAX block run eagerly), but XLA's jit drops some
f32 -> bf16 -> f32 round trips inside fused stacks, so whole paths differ by
bf16 rounding noise; they are held to the JAX bf16 path's own distance from
the f32 result on the same bf16 weights: the port's bf16 output is no
farther from it than 1.25x that, and no farther from the JAX bf16 output
than 2x that. int8 paths agree code for code at module level (atol 1e-4, as
the kernel tests); whole int8 trajectories (and the calibration stats they
produce) are held to a measured floor: the path against itself with the AR
noise moved by 1e-6 (f32-ulp differences flip int8 codes, and the AR steps
carry each flip on).
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nova_pointcloud_tpu.models import embeddings as jemb
from nova_pointcloud_tpu.models import guidance as jguid
from nova_pointcloud_tpu.models import normalization as jnorm
from nova_pointcloud_tpu.models.nova import NOVATransformer as JNOVA
from nova_pointcloud_tpu.ops import masking as jmask
from nova_pointcloud_tpu.ops import quantization as jquant
from nova_pointcloud_tpu.pipelines.builder import init_transformer
from nova_pointcloud_tpu.schedulers import flow_match as jfm
from nova_pointcloud_tpu_torch.models import embeddings as temb
from nova_pointcloud_tpu_torch.models import guidance as tguid
from nova_pointcloud_tpu_torch.models import normalization as tnorm
from nova_pointcloud_tpu_torch.models.convert import convert_params, convert_tree
from nova_pointcloud_tpu_torch.models.nova import NOVATransformer as TNOVA
from nova_pointcloud_tpu_torch.ops import masking as tmask
from nova_pointcloud_tpu_torch.ops import quantization as tquant
from nova_pointcloud_tpu_torch.ops.kernels import LAUNCHES
from nova_pointcloud_tpu_torch.pipelines.nova import bucket_plan
from nova_pointcloud_tpu_torch.schedulers import flow_match as tfm

ARCH = ("vit_d2w64", "vit_d2w64", "mlp_d2w64")
SMALL = dict(arch=ARCH, image_dim=4, image_base_size=(4, 4), video_base_size=(1, 2, 2),
             patch_size=2, text_token_dim=16, text_token_len=4)
# 8x8 image patches: 64 tokens, the smallest size with the sampler's bucket phases
SAMPLER = dict(SMALL, image_base_size=(8, 8))


def _np(t):
    return t.detach().float().cpu().numpy()


def _t(a):
    return torch.from_numpy(np.array(a))


def _tpu_backend():
    """The JAX package takes its int8 branches on a TPU only: pretend."""
    return mock.patch.object(jax, "default_backend", lambda: "tpu")


def _nonzero(params, seed, std=0.05):
    """Seeded non-zero values for every zero-initialised leaf (biases, the
    AdaLN projections), so no block is an identity and every bias counts."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * std).astype(np.float32)
                        if not np.any(np.asarray(a)) else np.asarray(a, np.float32), params)


@functools.lru_cache(maxsize=None)
def _cached_models(cfg_items, seed, quantize, bf16, attn_core):
    return _build_models(dict(cfg_items), seed, quantize, bf16, attn_core)


@functools.lru_cache(maxsize=None)
def _cached_params(cfg_items, seed):
    """A configuration's JAX params (numpy), initialised once a process:
    its variants (``quantize``, bf16 compute, ``attn_core``) initialise the
    same tree to the same values."""
    jm = JNOVA(**dict(cfg_items), noise_scheduler=jfm.FlowMatchEulerScheduler())
    return _nonzero(jax.tree.map(np.asarray, init_transformer(jm, seed=seed)), seed + 1)


def _models(cfg=SMALL, seed=0, quantize=False, bf16=False, attn_core="bf16"):
    """(jax model, jax params, torch model) on the same weights; built once
    per configuration (the tests do not modify them)."""
    return _cached_models(tuple(cfg.items()), seed, quantize, bf16, attn_core)


def _build_models(cfg, seed, quantize, bf16, attn_core):
    dt = jnp.bfloat16 if bf16 else None
    jm = JNOVA(**cfg, noise_scheduler=jfm.FlowMatchEulerScheduler(), quantize=quantize,
               dtype=dt, attn_core=attn_core)
    params = _cached_params(tuple(cfg.items()), seed)
    if bf16:
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    tm = TNOVA(**cfg, quantize=quantize, dtype=torch.bfloat16 if bf16 else None,
               attn_core=attn_core, device="cpu")
    sd = convert_params(jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.float32)), params))
    tm.load_state_dict(sd, strict=True)
    if bf16:
        tm.to(torch.bfloat16)
    return jm, params, tm


# -- schedulers, masking, guidance ------------------------------------------------

@pytest.mark.parametrize("steps,shift", [(25, 1.0), (25, 3.0), (7, 0.5)])
def test_flow_match_schedule_and_step_match_jax(steps, shift):
    js, ts = jfm.FlowMatchEulerScheduler(shift=shift), tfm.FlowMatchEulerScheduler(shift=shift)
    a, b = js.set_timesteps(steps), ts.set_timesteps(steps)
    assert np.array_equal(a.sigmas, b.sigmas) and np.array_equal(a.timesteps, b.timesteps)
    rng = np.random.default_rng(0)
    x, pred = rng.standard_normal((2, 3, 16), np.float32), rng.standard_normal((2, 3, 16), np.float32)
    for j in (0, steps - 1):
        ref = js.step(jnp.asarray(pred), j, jnp.asarray(x), a)
        np.testing.assert_array_equal(_np(ts.step(_t(pred), j, _t(x), b)), np.asarray(ref))


@pytest.mark.parametrize("steps,n", [(64, 1024), (16, 1024), (8, 64), (3, 16)])
def test_mask_schedule_matches_jax(steps, n):
    assert np.array_equal(tmask.cosine_pred_counts(steps, n), jmask.cosine_pred_counts(steps, n))
    counts = jmask.cosine_pred_counts(steps, n)
    counts = counts[counts > 0]
    for x, y in zip(tmask.pred_boundaries(counts), jmask.pred_boundaries(counts)):
        assert np.array_equal(x, y)


def test_bucket_plan_matches_the_bench_shape():
    """64 AR steps over 1024 tokens: 63 non-empty steps in four phases, the
    last (the full masking path, 1280 keys with the prefix) from step 42."""
    counts = tmask.cosine_pred_counts(64, 1024)
    counts = counts[counts > 0]
    starts, pad_p = tmask.pred_boundaries(counts)
    plan = bucket_plan(starts, 1024)
    assert len(counts) == 63 and pad_p == 25
    assert [b for _, _, b in plan] == [128, 256, 512, None]
    assert plan[-1] == (42, 63, None)


def test_pred_slice_scatter_and_visibility_match_jax():
    rng = np.random.default_rng(3)
    order = np.argsort(rng.random((3, 20)), axis=1).astype(np.int32)
    for start, count, pad in ((0, 4, 6), (17, 3, 6), (14, 6, 6)):
        ji, jv = jmask.pred_slice(jnp.asarray(order), start, count, pad)
        ti, tv = tmask.pred_slice(_t(order).long(), start, count, pad)
        assert np.array_equal(np.asarray(ji), ti.numpy()) and np.array_equal(np.asarray(jv), tv.numpy())
        np.testing.assert_array_equal(tmask.scatter_mask(ti, tv, 20).numpy(),
                                      np.asarray(jmask.scatter_mask(ji, jv, 20)))
    vis = (rng.random((3, 20)) > 0.5).astype(np.float32)
    for pre in (0, 5):
        np.testing.assert_array_equal(tmask.visibility_bias(_t(vis), pre).numpy(),
                                      np.asarray(jmask.visibility_bias(jnp.asarray(vis), pre)))


def test_random_pred_order_is_a_permutation_per_row():
    g = torch.Generator().manual_seed(0)
    order = tmask.random_pred_order(g, 4, 64)
    assert order.shape == (4, 64)
    assert all(sorted(r.tolist()) == list(range(64)) for r in order)


@pytest.mark.parametrize("kind", ["cfg", "renorm", "trunc", "image", "stg", "off"])
def test_guidance_matches_jax(kind):
    kw = {"cfg": dict(guidance_scale=5.0), "renorm": dict(guidance_scale=5.0, guidance_renorm=0.3),
          "trunc": dict(guidance_scale=5.0, guidance_trunc=500.0),
          "image": dict(guidance_scale=4.0, image_guidance_scale=1.5),
          "stg": dict(guidance_scale=4.0, spatiotemporal_guidance_scale=1.2,
                      min_guidance_scale=1.5),
          "off": dict(guidance_scale=1.0)}[kind]
    jg, tg = jguid.GuidanceConfig(**kw), tguid.GuidanceConfig(**kw)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 8)).astype(np.float32)
    pad = rng.standard_normal((1, 5, 8)).astype(np.float32)
    np.testing.assert_array_equal(_np(tg.expand(_t(x), _t(pad))),
                                  np.asarray(jg.expand(jnp.asarray(x), jnp.asarray(pad))))
    np.testing.assert_array_equal(_np(tg.expand_text(_t(x), _t(x * 2))),
                                  np.asarray(jg.expand_text(jnp.asarray(x), jnp.asarray(x * 2))))
    assert tg.decayed_scale(0.3) == pytest.approx(float(jg.decayed_scale(0.3)), rel=1e-6)
    xe = rng.standard_normal((2 * jg.num_passes, 5, 8)).astype(np.float32)
    for t in (900.0, 100.0):
        ref = jg.combine(jnp.asarray(xe), jg.decayed_scale(0.5), jnp.float32(t))
        np.testing.assert_allclose(_np(tg.combine(_t(xe), tg.decayed_scale(0.5), t)),
                                   np.asarray(ref), atol=1e-6, rtol=0)


# -- embeddings, normalization ----------------------------------------------------

def test_sincos_tables_and_patchify_match_jax():
    np.testing.assert_array_equal(temb.sincos_2d(64, 4, 6, (4, 4)), jemb.sincos_2d(64, 4, 6, (4, 4)))
    np.testing.assert_array_equal(temb.sincos_time(3, 1), jemb.sincos_time(3, 1))
    x = np.random.default_rng(5).standard_normal((2, 8, 12, 4)).astype(np.float32)
    p = temb.patchify(_t(x), 2)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jemb.patchify(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(temb.unpatchify(p, 2, (4, 6)).numpy(), x)


@pytest.mark.parametrize("num_stats,eps", [(3, 1e-6), (2, None)])
def test_adaln_zero_matches_jax(num_stats, eps):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    z = rng.standard_normal((2, 5, 32)).astype(np.float32)
    jmod = jnorm.AdaLayerNormZero(32, num_stats=num_stats, eps=eps)
    params = jmod.init(jax.random.PRNGKey(0), x, z)["params"]
    params = {"proj": {"kernel": rng.standard_normal((32, num_stats * 32)).astype(np.float32) * 0.2,
                       "bias": rng.standard_normal(num_stats * 32).astype(np.float32) * 0.1}}
    jy, jg = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(z))
    tmod = tnorm.AdaLayerNormZero(32, num_stats=num_stats, eps=eps, device="cpu")
    tmod.load_state_dict(convert_params(params))
    ty, tg = tmod(_t(x), _t(z))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=2e-5, rtol=0)
    assert len(tg) == len(jg) == num_stats - 2
    if num_stats == 2:
        ada = tnorm.AdaLayerNorm(32, eps=eps, device="cpu")
        ada.ada.load_state_dict(convert_params(params))
        np.testing.assert_allclose(_np(ada(_t(x), _t(z))), np.asarray(jy), atol=2e-5, rtol=0)


@pytest.mark.parametrize("bf16", [False, True])
def test_nova_embedding_methods_match_jax(bf16):
    jm, params, tm = _models(bf16=bf16)
    rng = np.random.default_rng(7)
    text = rng.standard_normal((2, 4, 16)).astype(np.float32)
    patches = rng.standard_normal((2, 16, 16)).astype(np.float32)
    canvas = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    v = {"params": params}
    atol = 2e-2 if bf16 else 2e-5
    cases = [
        (jm.apply(v, jnp.asarray(text), method=jm.embed_text), tm.embed_text(_t(text))),
        (jm.apply(v, 3, 4, method=jm.null_text), tm.null_text(3, 4)),
        (jm.apply(v, 3, method=jm.bos_frame), tm.bos_frame(3)),
        (jm.apply(v, jnp.asarray(patches), method=jm.tokens_from_patches),
         tm.tokens_from_patches(_t(patches))),
        (jm.apply(v, jnp.asarray(canvas), method=jm.image_tokens),
         tm.image_patch_embed(_t(canvas))),
    ]
    for ref, got in cases:
        assert got.shape == ref.shape
        assert got.dtype == getattr(torch, str(ref.dtype)), (got.dtype, ref.dtype)
        np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32), atol=atol, rtol=0)
    mask = (rng.random((2, 16, 1)) > 0.5).astype(np.float32)
    tok = rng.standard_normal((2, 16, 64)).astype(np.float32)
    ref = jm.apply(v, jnp.asarray(tok), jnp.asarray(mask),
                   method=lambda m, t, k: m.mask_tokens.apply_mask(t, k))
    np.testing.assert_allclose(_np(tm.mask_tokens.apply_mask(_t(tok), _t(mask))),
                               np.asarray(ref, np.float32), atol=atol, rtol=0)


# -- quantization and the converter -----------------------------------------------

def test_serving_qparams_and_act_merge_match_jax():
    """quantize_serving_params over the whole NOVA model: the JAX tree's keys
    and shapes, every int8 weight and scale equal (the port's are K-major)."""
    jm, params, tm = _models()
    jq = jax.tree.map(np.asarray, jquant.quantize_serving_params(params))
    tq = tquant.quantize_serving_params(tm)
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jq)[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path(tq)[0])
    assert set(flat_j) == set(flat_t), set(flat_j) ^ set(flat_t)
    # 2 ViTs x 2 halves x (fc1, fc2, qkv, proj) x (q, s) + 2 diffusion blocks x 3 x 2
    assert len(flat_j) == 2 * 2 * 4 * 2 + 2 * 3 * 2
    for k, v in flat_j.items():
        assert flat_t[k].shape == v.shape and np.array_equal(flat_t[k].numpy(), v), k
    stats = {"image_encoder": {"enc_layers": {"block": {
        "a_x": np.array([2.0], np.float32), "a_gelu": np.array([3.0], np.float32),
        "attn": {"a_smax": np.array([4.0], np.float32), "a_q": np.array([5.0], np.float32),
                 "a_k": np.array([6.0], np.float32)}}}},
        "image_decoder": {"blocks_0": {"a_z": np.float32(1.5)}}}
    jmerged = jax.tree.map(np.asarray, jquant.merge_act_scales(jq, stats, margin=1.05))
    tmerged = tquant.merge_act_scales(tq, convert_tree(stats), margin=1.05)
    for k, v in jax.tree_util.tree_flatten_with_path(jmerged)[0]:
        np.testing.assert_array_equal(dict(jax.tree_util.tree_flatten_with_path(tmerged)[0])[k]
                                      .numpy(), v)
    a = {"x": {"a_q": np.float32(1.0)}, "y": np.float32(2.0)}
    b = {"x": {"a_q": np.float32(3.0), "a_k": np.float32(0.5)}}
    jm_ = jquant.max_merge_stats(a, b)
    tm_ = tquant.max_merge_stats(convert_tree(a), convert_tree(b))
    assert float(tm_["x"]["a_q"]) == float(jm_["x"]["a_q"]) == 3.0 and float(tm_["y"]) == 2.0


def test_convert_maps_the_scan_stacks_and_trees():
    jm, params, tm = _models()
    sd = tm.state_dict()
    k = params["image_encoder"]["dec_layers"]["block"]["attn"]["qkv"]["kernel"]
    for i in range(k.shape[0]):
        np.testing.assert_array_equal(
            sd[f"image_encoder.dec_layers.{i}.attn.qkv.weight"].numpy(), np.asarray(k[i]).T)
    np.testing.assert_array_equal(sd["image_decoder.blocks_1.norm1.proj.weight"].numpy(),
                                  np.asarray(params["image_decoder"]["blocks_1"]["norm1"]
                                             ["proj"]["kernel"]).T)
    np.testing.assert_array_equal(sd["mask_tokens.bos_token"].numpy(),
                                  np.asarray(params["mask_tokens"]["bos_token"]))
    tree = convert_tree({"a": {"b": np.ones((2, 3), np.int8)}})
    assert tree["a"]["b"].dtype == torch.int8 and tree["a"]["b"].shape == (2, 3)


# -- the diffusion head, the ViT, the model's step methods ------------------------

def _apply_int8(jm, params, qparams, fn, *args, **kw):
    with _tpu_backend(), pltpu.force_tpu_interpret_mode():
        return jm.apply({"params": params, "qparams": qparams}, *args, method=fn, **kw)


def _head_inputs(seed, b=4, p=5, d=64, pd=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, p, pd)).astype(np.float32)
    z = rng.standard_normal((b, p, d)).astype(np.float32)
    t = np.full((b,), 437.5, np.float32)
    return x, t, z


@pytest.mark.parametrize("mode", ["float", "float_stg", "int8", "int8_static", "calibrate"])
def test_diffusion_head_matches_jax(mode):
    quantize = mode.startswith("int8") or mode == "calibrate"
    jm, params, tm = _models(quantize=quantize)
    x, t, z = _head_inputs(8)
    args = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(z))
    targs = (_t(x), _t(t), _t(z))
    if mode.startswith("float"):
        stg = 2 if mode == "float_stg" else None
        ref = jm.apply({"params": params}, *args, stg_rows=stg, method=jm.denoise_step)
        got = tm.denoise_step(*targs, stg_rows=stg)
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=2e-5, rtol=0)
        return
    if mode == "calibrate":
        ref, vs = jm.apply({"params": params}, *args, method=jm.denoise_step,
                           mutable=["act_stats"])
        got, stats = tm.denoise_step(*targs, calibrate=True)
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-4, rtol=0)
        for kpath, v in jax.tree_util.tree_flatten_with_path(vs["act_stats"])[0]:
            got_v = dict(jax.tree_util.tree_flatten_with_path(stats)[0])[kpath]
            np.testing.assert_allclose(got_v.numpy(), np.asarray(v), rtol=1e-5)
        return
    jq = jquant.quantize_serving_params(params)
    if mode == "int8_static":
        sites = {"a_z": 2.5, "a_h": 3.5, "a_silu": 1.5}
        jq = {**jq, "image_decoder": {k: {**v, **{s: jnp.float32(a) for s, a in sites.items()}}
                                      for k, v in jq["image_decoder"].items()}}
    ref = _apply_int8(jm, params, jq, jm.denoise_step, *args)
    got = tm.denoise_step(*targs, qparams=convert_tree(jax.tree.map(np.asarray, jq)))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-4, rtol=0)
    assert not any(LAUNCHES.values())


def _encoder_inputs(seed, cfg=SMALL, b=2, n_visible=6):
    rng = np.random.default_rng(seed)
    ni = cfg["image_base_size"][0] * cfg["image_base_size"][1]
    tokens = rng.standard_normal((b, ni, 64)).astype(np.float32)
    cond = rng.standard_normal((b, 4, 64)).astype(np.float32)
    mask = np.ones((b, ni, 1), np.float32)
    for i in range(b):
        mask[i, rng.permutation(ni)[: n_visible - i], 0] = 0.0
    return tokens, mask, cond


def _static_stats(jm, params, tokens, mask, cond):
    """A calibration's stats of the image encoder (the JAX mirror), so the
    int8 path runs the static-offset attention and static MLP sites."""
    _, vs = jm.apply({"params": params}, jnp.asarray(tokens), jnp.asarray(mask),
                     jnp.asarray(cond), method=jm.encode_image_step, mutable=["act_stats"])
    return jax.tree.map(np.asarray, vs["act_stats"])


@pytest.mark.parametrize("path", ["masking", "gather"])
@pytest.mark.parametrize("mode", ["float", "int8", "int8_static", "int8_core"])
def test_image_encoder_step_matches_jax(path, mode):
    """encode_image_step (the image ViT with its masked encoder half) on the
    masking path and on the bucketed gather path; int8: per-row sites and
    the dispatcher core, or calibrated static sites with the static-offset
    kernel (bf16 or int8 score core)."""
    quantize = mode != "float"
    jm, params, tm = _models(quantize=quantize,
                             attn_core="int8" if mode == "int8_core" else "bf16")
    tokens, mask, cond = _encoder_inputs(9)
    bucket = 8 if path == "gather" else None
    args = (jnp.asarray(tokens), jnp.asarray(mask), jnp.asarray(cond))
    targs = (_t(tokens), _t(mask), _t(cond))
    if mode == "float":
        ref = jm.apply({"params": params}, *args, visible_bucket=bucket,
                       method=jm.encode_image_step)
        got = tm.encode_image_step(*targs, visible_bucket=bucket)
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=2e-5, rtol=0)
        return
    jq = jquant.quantize_serving_params(params)
    if mode != "int8":
        jq = jquant.merge_act_scales(jq, _static_stats(jm, params, tokens, mask, cond), 1.05)
    ref = _apply_int8(jm, params, jq, jm.encode_image_step, *args, visible_bucket=bucket)
    got = tm.encode_image_step(*targs, visible_bucket=bucket,
                               qparams=convert_tree(jax.tree.map(np.asarray, jq)))
    # the static core rounds p to bf16 on both sides: a p on a rounding edge
    # may round the other way (see test_torch_nova_kernels.py)
    atol = 1e-4 if mode == "int8" else 3e-3
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=atol, rtol=0)
    assert np.mean(np.abs(_np(got) - np.asarray(ref)) <= 1e-4) > 0.97


def test_gather_path_equals_masking_path():
    """The port's two encoder-half paths give the same states (the JAX
    package's invariant, tests/test_mae_gather.py)."""
    _, _, tm = _models()
    tokens, mask, cond = (_t(a) for a in _encoder_inputs(10))
    a = tm.encode_image_step(tokens, mask, cond)
    b = tm.encode_image_step(tokens, mask, cond, visible_bucket=8)
    np.testing.assert_allclose(_np(a), _np(b), atol=2e-5, rtol=0)


@pytest.mark.parametrize("mode", ["float", "int8", "calibrate"])
def test_encode_video_matches_jax(mode):
    quantize = mode != "float"
    jm, params, tm = _models(quantize=quantize)
    rng = np.random.default_rng(11)
    c = rng.standard_normal((3, 4, 64)).astype(np.float32)
    bos = jm.apply({"params": params}, 3, method=jm.bos_frame)
    args = (bos, jnp.asarray(c), 1)
    targs = (tm.bos_frame(3), _t(c), 1)
    if mode == "float":
        ref = jm.apply({"params": params}, *args, method=jm.encode_video)
        got = tm.encode_video(*targs)
    elif mode == "calibrate":  # the JAX calibration runs the int8 projections on a TPU
        with _tpu_backend(), pltpu.force_tpu_interpret_mode():
            ref, vs = jm.apply({"params": params}, *args, method=jm.encode_video,
                               mutable=["act_stats"])
        got, stats = tm.encode_video(*targs, calibrate=True)
        for kpath, v in jax.tree_util.tree_flatten_with_path(vs["act_stats"])[0]:
            got_v = dict(jax.tree_util.tree_flatten_with_path(stats)[0])[kpath]
            np.testing.assert_allclose(got_v.numpy(), np.asarray(v), rtol=1e-5)
    else:
        jq = jquant.quantize_serving_params(params)
        ref = _apply_int8(jm, params, jq, jm.encode_video, *args)
        got = tm.encode_video(*targs, qparams=convert_tree(jax.tree.map(np.asarray, jq)))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-4, rtol=0)


def _f32_twin(cfg, params):
    """The JAX model in f32 on the bf16-rounded weights: the exact result a
    bf16 run approximates."""
    jm32 = JNOVA(**cfg, noise_scheduler=jfm.FlowMatchEulerScheduler())
    return jm32, jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)


def _bf16_gate(got, ref, ref32, what):
    """The port's bf16 result against the JAX bf16 one, both against the f32
    twin (see the module docstring)."""
    noise = np.abs(ref - ref32).mean()
    to_exact, to_jax = np.abs(got - ref32).mean(), np.abs(got - ref).mean()
    assert noise > 0 and to_exact <= 1.25 * noise and to_jax <= 2 * noise, \
        (what, to_exact, to_jax, noise)


def test_float_model_steps_bf16_dtype_flow():
    """bf16 params with dtype=bf16, as the bench serves: the residual stream
    keeps flax's promoted dtype (f32 from the f32 canvas and text) and the
    head's output is bf16, on both sides."""
    jm, params, tm = _models(bf16=True)
    jm32, p32 = _f32_twin(SMALL, params)
    tokens, mask, cond = _encoder_inputs(12)
    args = (jnp.asarray(tokens), jnp.asarray(mask), jnp.asarray(cond))
    ref = jm.apply({"params": params}, *args, method=jm.encode_image_step)
    ref32 = jm32.apply({"params": p32}, *args, method=jm32.encode_image_step)
    got = tm.encode_image_step(_t(tokens), _t(mask), _t(cond))
    assert got.dtype == getattr(torch, str(ref.dtype)) == torch.float32
    _bf16_gate(_np(got), np.asarray(ref, np.float32), np.asarray(ref32), "encode_image_step")
    x, t, z = _head_inputs(13)
    args = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(z))
    ref = jm.apply({"params": params}, *args, method=jm.denoise_step)
    ref32 = jm32.apply({"params": p32}, *args, method=jm32.denoise_step)
    got = tm.denoise_step(_t(x), _t(t), _t(z))
    assert got.dtype == getattr(torch, str(ref.dtype)) == torch.bfloat16
    _bf16_gate(_np(got), np.asarray(ref, np.float32), np.asarray(ref32), "denoise_step")
