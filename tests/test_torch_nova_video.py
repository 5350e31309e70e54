"""The NOVA text-to-video modules of the port vs the JAX package on the CPU:
3-axis RoPE, the motion embed, the ranked AdaLN mixer, the block-causal
bias, the KV cache and its attention, the ViT frame by frame through its
caches, and the model's video step methods (``encode_video`` at T = 3,
``frame_tokens``, ``encode_frame``, ``mix_states``, ``encode_image_step``
with RoPE), on the same numpy inputs and weights (converted by
models/convert.py, the mixer's zero-initialised projection and every zero
bias filled with seeded values first). Tolerances as test_torch_nova.py's
docstring states them: f32 atol 2e-5, int8 module paths 1e-4, bf16 held to
the JAX bf16 path's own distance from its f32 twin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nova_pointcloud_tpu.models import embeddings as jemb
from nova_pointcloud_tpu.models import normalization as jnorm
from nova_pointcloud_tpu.models.vit import VisionTransformer as JViT
from nova_pointcloud_tpu.ops import attention as jatt
from nova_pointcloud_tpu.ops import masking as jmask
from nova_pointcloud_tpu.ops import quantization as jquant
from nova_pointcloud_tpu_torch.models import embeddings as temb
from nova_pointcloud_tpu_torch.models import normalization as tnorm
from nova_pointcloud_tpu_torch.models.convert import (convert_params, convert_tree,
                                                      jax_param_paths)
from nova_pointcloud_tpu_torch.models.vit import VisionTransformer as TViT
from nova_pointcloud_tpu_torch.ops import attention as tatt
from nova_pointcloud_tpu_torch.ops import masking as tmask
from nova_pointcloud_tpu_torch.ops import quantization as tquant
from nova_pointcloud_tpu_torch.ops.kernels import LAUNCHES
from tests.test_torch_nova import (SMALL, _apply_int8, _bf16_gate, _f32_twin, _models, _np, _t,
                                   _tpu_backend)

# the t2v model's shape at test size: 3 frames of 2 x 2 video patches, 4 x 4
# image patches, the AdaLN mixer; RoPE (the osp480 model's) or absolute
# positions
VIDEO = dict(SMALL, video_base_size=(3, 2, 2), rotary_pos_embed=True, video_mixer_rank=8)
VIDEO_ABS = dict(VIDEO, rotary_pos_embed=False)
CFGS = {"rope": VIDEO, "abs": VIDEO_ABS}


def _flat(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


def _assert_close(got, ref, atol):
    """Within ``atol`` everywhere; an int8 path (atol 1e-4) may instead have
    a row whose activation sits on a rounding edge take the other int8 code
    on one side (the sum's order differs by an f32 ulp): then at most 3e-3,
    and 97% of the values within 1e-4 (as the static core's test in
    test_torch_nova.py)."""
    got, ref = _np(got), np.asarray(ref, np.float32)
    if atol < 1e-4:
        np.testing.assert_allclose(got, ref, atol=atol, rtol=0)
        return
    np.testing.assert_allclose(got, ref, atol=3e-3, rtol=0)
    assert np.mean(np.abs(got - ref) <= atol) > 0.97


def _assert_stats_equal(got, ref, rtol=1e-5):
    flat_t, flat_j = _flat(got), _flat(jax.tree.map(np.asarray, ref))
    assert set(flat_t) == set(flat_j), set(flat_t) ^ set(flat_j)
    for k, v in flat_j.items():
        np.testing.assert_allclose(flat_t[k].numpy(), v, rtol=rtol, err_msg=str(k))


# -- RoPE, motion embed, the ranked AdaLN, the block-causal bias --------------------

@pytest.mark.parametrize("head_dim,pad", [(32, 0), (32, 5), (64, 3)])
def test_rope_tables_and_rotation_match_jax(head_dim, pad):
    assert temb.rope_axis_dims(head_dim) == jemb.rope_axis_dims(head_dim)
    jp, tp = jemb.rope_positions(3, (2, 4)), temb.rope_positions(3, (2, 4))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    off = np.asarray([1.0, 0.0, 0.0], np.float32) * 2  # a later frame's positions
    jc, js = jemb.rope_weights(jp + off, head_dim, pad=pad)
    tc, ts = temb.rope_weights(tp + _t(off), head_dim, pad=pad)
    assert tc.shape == jc.shape == (1, 1, pad + 24, head_dim // 2)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=0)
    rng = np.random.default_rng(20)
    x = rng.standard_normal((2, 3, pad + 24, head_dim)).astype(np.float32)
    for jdt, tdt, atol in ((jnp.float32, torch.float32, 2e-6), (jnp.bfloat16, torch.bfloat16,
                                                                 3e-2)):
        ref = jemb.apply_rope(jnp.asarray(x, jdt), jc, js)
        got = temb.apply_rope(_t(x).to(tdt), tc, ts)
        assert got.dtype == tdt
        np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32), atol=atol, rtol=0)
    # the gather path's rows: tables without the prefix, broadcast to the batch
    cos0, sin0 = jemb.rope_weights(jp, head_dim)
    cos0, sin0 = (jnp.broadcast_to(w, (2,) + w.shape[1:]) for w in (cos0, sin0))
    ids = np.stack([rng.permutation(24)[:7] for _ in range(2)]).astype(np.int32)
    jg = jemb.gather_rope(cos0, sin0, jnp.asarray(ids), pad=pad)
    tg = temb.gather_rope(_t(np.asarray(cos0)), _t(np.asarray(sin0)), _t(ids).long(), pad=pad)
    for a, b in zip(tg, jg):
        assert a.shape == b.shape == (2, 1, pad + 7, head_dim // 2)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_motion_embed_matches_jax():
    jm, params, tm = _models(VIDEO)
    v = {"params": params}
    flow, fps = np.asarray([3.0, 7.5], np.float32), np.asarray([8.0, 24.0], np.float32)
    for args, targs in (((None, None), (None, None)),
                        ((jnp.asarray(flow), jnp.asarray(fps)), (_t(flow), _t(fps))),
                        ((jnp.full((2,), 5.0), None), (torch.full((2,), 5.0), None))):
        ref = jm.apply(v, 2, *args, method=jm.embed_motion)
        got = tm.embed_motion(2, *targs)
        assert got.shape == ref.shape == (2, 2, 64)
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=2e-5, rtol=0)


@pytest.mark.parametrize("rank,eps", [(8, None), (8, 1e-6), (None, None)])
def test_ranked_adaln_matches_jax(rank, eps):
    """AdaLayerNorm with the mixer's LoRA rank and eps=None (no norm), x
    broadcast over z's frames as the mixer calls it."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, 1, 5, 32)).astype(np.float32)
    z = rng.standard_normal((2, 3, 5, 32)).astype(np.float32)
    jmod = jnorm.AdaLayerNorm(32, rank, eps=eps)
    params = jmod.init(jax.random.PRNGKey(0), x, z)["params"]
    params = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32) * 0.2,
                          params)
    ref = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(z))
    tmod = tnorm.AdaLayerNorm(32, rank, eps=eps, device="cpu")
    tmod.load_state_dict(convert_params(params), strict=True)
    got = tmod(_t(x), _t(z))
    assert got.shape == ref.shape == (2, 3, 5, 32)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=2e-5, rtol=0)


@pytest.mark.parametrize("lens,text", [((3, 3, 3), 0), ((4, 4), 5), ((2,), 3)])
def test_block_causal_bias_matches_jax(lens, text):
    np.testing.assert_array_equal(tmask.block_causal_bias(lens, text).numpy(),
                                  np.asarray(jmask.block_causal_bias(lens, text)))


# -- the KV cache -----------------------------------------------------------------

@pytest.mark.parametrize("with_bias,bf16", [(False, False), (True, False), (True, True)])
def test_cached_attention_matches_jax(with_bias, bf16):
    """Two writes into one cache (5 then 3 positions, the second at index 5),
    each attending over the filled prefix; a key bias padded to the cache;
    bf16 queries over the f32 cache (cast to q's dtype)."""
    rng = np.random.default_rng(22)
    b, h, s, d = 2, 2, 12, 16
    jc = jatt.KVCache.create(b, h, s, d, dtype=jnp.float32)
    tc = tatt.KVCache.create(b, h, s, d, dtype=torch.float32)
    index = 0
    for lq in (5, 3):
        q, k, v = (rng.standard_normal((b, h, lq, d)).astype(np.float32) for _ in range(3))
        bias = None
        if with_bias:
            bias = np.where(rng.random((b, 1, 1, index + lq)) < 0.3, -np.inf, 0.0)
            bias[..., 0] = 0.0
            bias = bias.astype(np.float32)
        jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
        ref, jc = jatt.cached_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), jc, index,
                                        None if bias is None else jnp.asarray(bias))
        got, tc = tatt.cached_attention(*(_t(a).to(tdt) for a in (q, k, v)), tc, index,
                                        None if bias is None else _t(bias))
        assert got.dtype == tdt
        np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32),
                                   atol=2e-2 if bf16 else 2e-5, rtol=0)
        np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
        np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))
        index += lq


@pytest.mark.parametrize("rope", [False, True])
def test_vit_cached_frames_match_jax_and_block_causal(rope):
    """The ViT fed frame by frame through its KV caches (the text prefix with
    frame 0; RoPE positions per frame) against the JAX ViT doing the same,
    and against the port's own teacher-forced pass under the block-causal
    bias (the JAX package's tests/test_kvcache.py invariant, 2e-5)."""
    depth, dim, heads = 2, 64, 2
    b, nf, nv, lc, hw = 2, 3, 4, 5, (2, 2)
    rng = np.random.default_rng(23)
    frames = (rng.standard_normal((b, nf, nv, dim)) * 0.5).astype(np.float32)
    c_text = (rng.standard_normal((b, lc, dim)) * 0.5).astype(np.float32)
    jvit = JViT(depth, dim, heads)
    params = jax.tree.map(np.asarray, jax.jit(jvit.init)(
        jax.random.PRNGKey(2), jnp.asarray(frames.reshape(b, nf * nv, dim)))["params"])
    tvit = TViT(depth, dim, heads, device="cpu")
    tvit.load_state_dict(convert_params(params), strict=True)
    hd = dim // heads

    step = np.asarray([1.0, 0.0, 0.0], np.float32)  # one frame later in time

    jcaches = jvit.init_caches(b, lc + nf * nv, dtype=jnp.float32)
    tcaches = tvit.init_caches(b, lc + nf * nv)
    index, jouts, touts = 0, [], []
    for t in range(nf):
        prefix = c_text if t == 0 else None
        pad = lc if t == 0 else 0
        jr = tr = None
        if rope:
            jr = jemb.rope_weights(jemb.rope_positions(1, hw) + t * step, hd, pad=pad)
            tr = temb.rope_weights(temb.rope_positions(1, hw) + t * _t(step), hd, pad=pad)
        jo, jcaches = jvit.apply({"params": params}, jnp.asarray(frames[:, t]),
                                 c=None if prefix is None else jnp.asarray(prefix),
                                 rope=jr, caches=jcaches, cache_index=jnp.int32(index))
        to, _ = tvit(_t(frames[:, t]), c=None if prefix is None else _t(prefix), rope=tr,
                     caches=tcaches, cache_index=index)
        index += pad + nv
        jouts.append(np.asarray(jo))
        touts.append(_np(to))
    cached = np.concatenate(touts, 1)
    np.testing.assert_allclose(cached, np.concatenate(jouts, 1), atol=2e-5, rtol=0)
    full_rope = (temb.rope_weights(temb.rope_positions(nf, hw), hd, pad=lc) if rope else None)
    full, _ = tvit(_t(frames.reshape(b, nf * nv, dim)), c=_t(c_text),
                   bias=tmask.block_causal_bias((nv,) * nf, lc), rope=full_rope)
    np.testing.assert_allclose(cached, _np(full), atol=2e-5, rtol=2e-5)


# -- the model's video step methods -----------------------------------------------------

def _video_inputs(seed, b=2, t=3):
    rng = np.random.default_rng(seed)
    vid = rng.standard_normal((b, t - 1, 4, 64)).astype(np.float32)
    text = rng.standard_normal((b, 6, 64)).astype(np.float32)
    return vid, text


@pytest.mark.parametrize("cfg", ["rope", "abs"])
@pytest.mark.parametrize("mode", ["float", "int8", "calibrate"])
def test_encode_video_t3_matches_jax(cfg, mode):
    """Teacher-forced T = 3 ([BOS, frames 0..1] raw tokens, a 6-token
    prefix): the block-causal bias, RoPE or absolute positions, the mixer."""
    quantize = mode != "float"
    jm, params, tm = _models(CFGS[cfg], quantize=quantize)
    vid, text = _video_inputs(24)
    v = {"params": params}
    c_vid = jnp.concatenate([jm.apply(v, 2, method=jm.bos_frame), jnp.asarray(vid)], 1)
    tc_vid = torch.cat([tm.bos_frame(2), _t(vid)], 1)
    args, targs = (c_vid, jnp.asarray(text), 3), (tc_vid, _t(text), 3)
    if mode == "float":
        ref = jm.apply(v, *args, method=jm.encode_video)
        got = tm.encode_video(*targs)
        atol = 2e-5
    elif mode == "calibrate":
        with _tpu_backend(), pltpu.force_tpu_interpret_mode():
            ref, vs = jm.apply(v, *args, method=jm.encode_video, mutable=["act_stats"])
        got, stats = tm.encode_video(*targs, calibrate=True)
        _assert_stats_equal(stats, vs["act_stats"])
        atol = 1e-4
    else:
        jq = jquant.quantize_serving_params(params)
        ref = _apply_int8(jm, params, jq, jm.encode_video, *args)
        got = tm.encode_video(*targs, qparams=convert_tree(jax.tree.map(np.asarray, jq)))
        atol = 1e-4
    assert got.shape == ref.shape == (2, 12, 64)
    _assert_close(got, ref, atol)
    assert not any(LAUNCHES.values())


def _frame_pass(apply, m, caches, tokens0, tokens1, text, index1):
    s0, caches = apply(m.encode_frame, tokens0, text, caches, 0, 0)
    s1, caches = apply(m.encode_frame, tokens1, None, caches, index1, 1)
    return s0, s1, apply(m.mix_states, s0, s1)


def _cached_stats(jm, params, tokens0, tokens1, text):
    """The cached calibration pass of the JAX calibrate() (frame 0 with the
    prefix, then frame 1): the MLP's sites only."""
    v = {"params": params}
    caches = jm.init_video_caches(2, text.shape[1], 2)
    (_, caches), vs0 = jm.apply(v, tokens0, text, caches, 0, 0, method=jm.encode_frame,
                                mutable=["act_stats"])
    _, vs1 = jm.apply(v, tokens1, None, caches, jnp.int32(text.shape[1] + 4), 1,
                      method=jm.encode_frame, mutable=["act_stats"])
    return jquant.max_merge_stats(vs0["act_stats"], vs1["act_stats"])


@pytest.mark.parametrize("cfg", ["rope", "abs"])
@pytest.mark.parametrize("mode", ["float", "int8_static", "calibrate"])
def test_encode_frame_and_mixer_match_jax(cfg, mode):
    """Frame 0 (BOS tokens through frame_tokens, the prefix) and frame 1 (the
    patch embed of a latent frame) through the video encoder's caches, then
    the mixer on both. int8_static: qparams with calibrated softmax offsets
    (a_smax) on every layer, which a cached layer must not take to the
    static kernel; calibrate: the cached layers sow the MLP's sites only."""
    quantize = mode != "float"
    jm, params, tm = _models(CFGS[cfg], quantize=quantize)
    v = {"params": params}
    rng = np.random.default_rng(25)
    text = rng.standard_normal((2, 6, 64)).astype(np.float32)
    frame = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    jt0 = jm.apply(v, jm.apply(v, 2, method=jm.bos_frame)[:, 0], 0, 3, method=jm.frame_tokens)
    jt1 = jm.apply(v, jm.apply(v, jnp.asarray(frame), method=jm.embed_video_frame), 1, 3,
                   method=jm.frame_tokens)
    tt0 = tm.frame_tokens(tm.bos_frame(2)[:, 0], 0, 3)
    tt1 = tm.frame_tokens(tm.embed_video_frame(_t(frame)), 1, 3)
    np.testing.assert_allclose(_np(tt0), np.asarray(jt0), atol=2e-5, rtol=0)
    np.testing.assert_allclose(_np(tt1), np.asarray(jt1), atol=2e-5, rtol=0)
    if mode == "calibrate":
        with _tpu_backend(), pltpu.force_tpu_interpret_mode():
            jstats = _cached_stats(jm, params, jt0, jt1, jnp.asarray(text))
        caches = tm.init_video_caches(2, 6, 2)
        (_, caches), s0 = tm.encode_frame(tt0, _t(text), caches, 0, 0, calibrate=True)
        _, s1 = tm.encode_frame(tt1, None, caches, 10, 1, calibrate=True)
        stats = tquant.max_merge_stats(s0, s1)
        assert "attn" not in stats["video_encoder"]["enc_layers"]["block"]
        _assert_stats_equal(stats, jstats)
        return
    jq = tq = None
    if quantize:
        vid, _ = _video_inputs(26)
        c_vid = jnp.concatenate([jm.apply(v, 2, method=jm.bos_frame), jnp.asarray(vid)], 1)
        with _tpu_backend(), pltpu.force_tpu_interpret_mode():
            _, vs = jm.apply(v, c_vid[:, :1], jnp.asarray(text), 1, method=jm.encode_video,
                             mutable=["act_stats"])
        jq = jquant.merge_act_scales(jquant.quantize_serving_params(params),
                                     jax.tree.map(np.asarray, vs["act_stats"]), 1.05)
        assert "a_smax" in jq["video_encoder"]["enc_layers"]["block"]["attn"]
        tq = convert_tree(jax.tree.map(np.asarray, jq))

    def japply(fn, *a):
        if jq is None:
            return jm.apply(v, *a, method=fn)
        return _apply_int8(jm, params, jq, fn, *a)

    ref = _frame_pass(japply, jm, jm.init_video_caches(2, 6, 2), jt0, jt1, jnp.asarray(text),
                      jnp.int32(10))
    got = _frame_pass(lambda fn, *a: fn(*a, qparams=tq) if fn != tm.mix_states else fn(*a),
                      tm, tm.init_video_caches(2, 6, 2), tt0, tt1, _t(text), 10)
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (2, 4, 64)
        _assert_close(g, r, 1e-4 if quantize else 2e-5)
    assert not any(LAUNCHES.values())


def test_video_steps_bf16_match_jax():
    """bf16 weights and compute, as the bench serves: encode_video at T = 3
    and the two cached frames held to the JAX bf16 path's distance from its
    f32 twin."""
    jm, params, tm = _models(VIDEO, bf16=True)
    jm32, p32 = _f32_twin(VIDEO, params)
    vid, text = _video_inputs(27)

    def run_jax(m, p):
        v = {"params": p}
        c_vid = jnp.concatenate([m.apply(v, 2, method=m.bos_frame), jnp.asarray(vid)], 1)
        full = m.apply(v, c_vid, jnp.asarray(text), 3, method=m.encode_video)
        caches = m.init_video_caches(2, 6, 2)
        s0, caches = m.apply(v, c_vid[:, 0], jnp.asarray(text), caches, 0, 0,
                             method=m.encode_frame)
        s1, _ = m.apply(v, jnp.asarray(vid[:, 0]), None, caches, jnp.int32(10), 1,
                        method=m.encode_frame)
        return [np.asarray(a, np.float32) for a in (full, s0, s1)]

    ref, ref32 = run_jax(jm, params), run_jax(jm32, p32)
    c_vid = torch.cat([tm.bos_frame(2), _t(vid).to(torch.bfloat16)], 1)
    full = tm.encode_video(c_vid, _t(text), 3)
    caches = tm.init_video_caches(2, 6, 2)
    s0, caches = tm.encode_frame(c_vid[:, 0], _t(text), caches, 0, 0)
    s1, _ = tm.encode_frame(_t(vid[:, 0]).to(torch.bfloat16), None, caches, 10, 1)
    for name, g, r, r32 in zip(("encode_video", "frame 0", "frame 1"), (full, s0, s1), ref,
                               ref32):
        _bf16_gate(_np(g), r, r32, name)


@pytest.mark.parametrize("path", ["masking", "gather"])
@pytest.mark.parametrize("mode", ["float", "int8_static"])
def test_rope_image_step_matches_jax(path, mode):
    """encode_image_step of a RoPE model: zero-angle rows for the condition
    prefix, the gather path's tables gathered per sample."""
    from tests.test_torch_nova import _encoder_inputs, _static_stats

    quantize = mode != "float"
    jm, params, tm = _models(VIDEO, quantize=quantize)
    tokens, mask, cond = _encoder_inputs(28)
    bucket = 8 if path == "gather" else None
    args = (jnp.asarray(tokens), jnp.asarray(mask), jnp.asarray(cond))
    targs = (_t(tokens), _t(mask), _t(cond))
    if mode == "float":
        ref = jm.apply({"params": params}, *args, visible_bucket=bucket,
                       method=jm.encode_image_step)
        got = tm.encode_image_step(*targs, visible_bucket=bucket)
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=2e-5, rtol=0)
        return
    jq = jquant.merge_act_scales(jquant.quantize_serving_params(params),
                                 _static_stats(jm, params, tokens, mask, cond), 1.05)
    ref = _apply_int8(jm, params, jq, jm.encode_image_step, *args, visible_bucket=bucket)
    got = tm.encode_image_step(*targs, visible_bucket=bucket,
                               qparams=convert_tree(jax.tree.map(np.asarray, jq)))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=3e-3, rtol=0)
    assert np.mean(np.abs(_np(got) - np.asarray(ref)) <= 1e-4) > 0.97
    assert not any(LAUNCHES.values())


# -- parameters and serving trees ----------------------------------------------------------

@pytest.mark.parametrize("cfg", ["rope", "abs"])
def test_video_model_params_and_qparams_match_jax(cfg):
    """The converter maps the motion embed and the mixer (its LoRA and
    projection), a RoPE model has no position tables, jax_param_paths names
    every parameter's JAX leaf with its rank, and quantize_serving_params
    gives the JAX tree's keys and values."""
    jm, params, tm = _models(CFGS[cfg])
    flat = {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    paths = jax_param_paths(tm)
    assert len(paths) == len(dict(tm.named_parameters()))
    for name, (jpath, ndim) in paths.items():
        assert jpath in flat and flat[jpath].ndim == ndim, (name, jpath)
    sd = tm.state_dict()
    np.testing.assert_array_equal(sd["mixer.ada.lora.weight"].numpy(),
                                  flat["mixer/ada/lora/kernel"].T)
    np.testing.assert_array_equal(sd["motion_embed.fps_fc2.bias"].numpy(),
                                  flat["motion_embed/fps_fc2/bias"])
    assert any(k.startswith("video_pos_embed") for k in flat) == (cfg == "abs")
    jq = jax.tree.map(np.asarray, jquant.quantize_serving_params(params))
    flat_t = _flat(tquant.quantize_serving_params(tm))
    assert set(flat_t) == set(_flat(jq))
    for k, v in _flat(jq).items():
        assert np.array_equal(flat_t[k].numpy(), v), k


def test_build_pipeline_from_a_video_config():
    """build_pipeline over a reference-style t2v config (the osp480 yaml's
    fields at test size): the JAX builder's model settings, the sample
    scheduler, NOVAPipeline; the port's pipeline serves a call on it."""
    from nova_pointcloud_tpu.pipelines.builder import build_transformer as jbuild
    from nova_pointcloud_tpu_torch.pipelines.builder import build_pipeline
    from nova_pointcloud_tpu_torch.pipelines.nova import NOVAPipeline
    from nova_pointcloud_tpu_torch.schedulers.flow_match import FlowMatchEulerScheduler

    model_cfg = dict(image_dim=4, image_size=[64, 64], image_stride=8, text_token_dim=16,
                     text_token_len=4, rotary_pos_embed=True, video_base_size=[3, 2, 2],
                     image_base_size=[4, 4], video_mixer_rank=8, arch=list(VIDEO["arch"]))
    cfg = {"model": model_cfg, "pipeline": {"name": "NOVAPipeline"},
           "scheduler": {"_sample_class_name": "FlowMatchEulerScheduler", "shift": 3.0}}
    pipe, state = build_pipeline(cfg, seed=3, device="cpu")
    jm = jbuild(dict(model_cfg))
    tm = pipe.model
    assert isinstance(pipe, NOVAPipeline) and isinstance(pipe.scheduler, FlowMatchEulerScheduler)
    assert pipe.scheduler.shift == 3.0
    for attr in ("arch", "patch_size", "image_base_size", "video_base_size", "rotary_pos_embed",
                 "video_mixer_rank", "text_token_dim", "text_token_len", "num_video_tokens"):
        assert getattr(tm, attr) == tuple(getattr(jm, attr)) if isinstance(
            getattr(jm, attr), (list, tuple)) else getattr(tm, attr) == getattr(jm, attr), attr
    assert set(state) == set(convert_params(jax.tree.map(np.asarray, _models(VIDEO)[1])))
    text = np.random.default_rng(29).standard_normal((1, 4, 16)).astype(np.float32)
    out = pipe(prompt_embeds=text, num_inference_steps=3, num_diffusion_steps=2,
               max_latent_length=3, generator=torch.Generator().manual_seed(0))
    assert out.latents.shape == (1, 3, 8, 8, 4) and torch.isfinite(out.latents).all()
