"""The NOVA text-to-video sampler of the port (``NOVAPipeline`` at
``max_latent_length`` > 1) vs a replay of the JAX algorithm (pipelines/nova.py
``_make_sampler``'s frame loop and ``calibrate``'s KV-cached pass) through the
JAX model's public methods, with the same prediction orders and noise: the
motion tokens after the prompt, frame 0 through ``encode_frame`` with the
prefix, each later frame from the previous latents through the caches, the
mixer on frame 0's states, the raw BOS token in the image-guidance pass, the
``latents=`` prefill, the DDPM step. Tolerances as test_torch_nova.py's
docstring states them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nova_pointcloud_tpu.models import embeddings as jemb
from nova_pointcloud_tpu.models import guidance as jguid
from nova_pointcloud_tpu.ops import masking as jmask
from nova_pointcloud_tpu.ops import quantization as jquant
from nova_pointcloud_tpu.schedulers import ddpm as jddpm
from nova_pointcloud_tpu.schedulers import flow_match as jfm
from nova_pointcloud_tpu_torch.models.convert import convert_tree
from nova_pointcloud_tpu_torch.ops.kernels import LAUNCHES
from nova_pointcloud_tpu_torch.pipelines.nova import NOVAPipeline
from nova_pointcloud_tpu_torch.schedulers.ddpm import DDPMScheduler
from tests.test_torch_nova import _bf16_gate, _f32_twin, _models, _np, _tpu_backend
from tests.test_torch_nova_sampler import _jit_sow, _replay_apply
from tests.test_torch_nova_video import VIDEO, VIDEO_ABS

STEPS, DIFF, FRAMES, BATCH, TEXT = 4, 2, 3, 2, 4
DDPM_KW = dict(beta_schedule="squaredcos_cap_v2")
FLOOR_MOVES = 3  # moves of the AR noise whose largest distance is the int8 call's floor


def _plan(ni, steps):
    counts = jmask.cosine_pred_counts(steps, ni)
    counts = counts[counts > 0]
    starts, pad_p = jmask.pred_boundaries(counts)
    return counts, starts, pad_p


def _draws(jm, seed, frames=FRAMES, steps=STEPS, batch=BATCH):
    """Text, and per frame the prediction order, each AR step's initial noise
    and each diffusion step's (DDPM) noise."""
    rng = np.random.default_rng(seed)
    ni, pd = jm.num_image_tokens, jm.patch_size ** 2 * jm.image_dim
    counts, _, pad_p = _plan(ni, steps)
    text = rng.standard_normal((batch, TEXT, 16)).astype(np.float32)
    order = np.stack([np.argsort(rng.random((batch, ni)), axis=1) for _ in range(frames)])
    noise = rng.standard_normal((frames, len(counts), batch, pad_p, pd)).astype(np.float32)
    step_noise = rng.standard_normal(
        (frames, len(counts), DIFF, batch, pad_p, pd)).astype(np.float32)
    return text, order, noise, step_noise


def _jax_frame(jm, apply, cond, order, noise, step_noise, guidance, scheduler):
    """The JAX sampler's generate_frame (masking path: 16 image tokens have
    no bucket phases) with given order and noise."""
    is_flow = isinstance(scheduler, jfm.FlowMatchEulerScheduler)
    sched = scheduler.set_timesteps(DIFF)
    ni, pd = jm.num_image_tokens, jm.patch_size ** 2 * jm.image_dim
    counts, starts, pad_p = _plan(ni, STEPS)
    S, n_passes = len(counts), guidance.num_passes
    batch = cond.shape[0] // n_passes
    canvas = jnp.zeros((batch, ni, pd), jnp.float32)
    mask = jnp.ones((batch, ni, 1), jnp.float32)
    order = jnp.asarray(order, jnp.int32)
    ts = jnp.asarray(sched.timesteps, jnp.float32)
    for i in range(S):
        scale = guidance.decayed_scale((i + 1.0) / S)
        tokens = apply(jm.tokens_from_patches, canvas)
        z = apply(jm.encode_image_step, jnp.tile(tokens, (n_passes, 1, 1)),
                  jnp.tile(mask, (n_passes, 1, 1)), cond)
        ids, valid = jmask.pred_slice(order, jnp.int32(starts[i]), jnp.int32(counts[i]), pad_p)
        z_sel = jnp.take_along_axis(z, jnp.tile(ids, (n_passes, 1))[..., None], axis=1)
        x_t = jnp.asarray(noise[i])
        for j in range(DIFF):
            t = ts[j]
            pred = apply(jm.denoise_step, guidance.expand(x_t),
                         jnp.full((batch * n_passes,), t), z_sel)
            pred = guidance.combine(pred.astype(jnp.float32), scale, t)
            if is_flow:
                x_t = scheduler.step(pred, j, x_t, sched)
            else:
                x_t = scheduler.step(pred, t.astype(jnp.int32), x_t, schedule=sched,
                                     noise=jnp.asarray(step_noise[i][j]))
        pred_mask = jmask.scatter_mask(ids, valid, ni)
        onehot = jax.nn.one_hot(ids, ni, dtype=jnp.float32) * valid[..., None]
        canvas = canvas * (1.0 - pred_mask) + jnp.einsum("bpn,bpd->bnd", onehot, x_t)
        mask = mask * (1.0 - pred_mask)
    return canvas


def _jax_prompt(jm, v, text, guidance, motion_flow=5.0):
    """encode_prompt + the motion tokens of the JAX __call__."""
    b = text.shape[0]
    parts = [jm.apply(v, jnp.asarray(text), method=jm.embed_text),
             jm.apply(v, b, TEXT, method=jm.null_text)]
    if guidance.image_guidance_scale:
        parts.append(parts[1])
    c = jnp.concatenate(parts[:guidance.num_passes])
    nb = c.shape[0]
    m = jm.apply(v, nb, jnp.full((nb,), motion_flow, jnp.float32), None,
                 method=jm.embed_motion)
    return jnp.concatenate([c, m.astype(c.dtype)], axis=1)


def _jax_video(jm, v, text, order, noise, step_noise, guidance, scheduler, frames=FRAMES,
               latents=None, jit=False):
    """The JAX sampler's frame loop (T > 1) through the model's methods
    (``jit``: _replay_apply's, f32 and int8 replays)."""
    apply = _replay_apply(jm, v, jit)
    c = _jax_prompt(jm, v, text, guidance)
    nb, text_len = c.shape[:2]
    batch = nb // guidance.num_passes
    nv = jm.num_video_tokens

    def frame(cond, f):
        return _jax_frame(jm, apply, cond, order[f], noise[f], step_noise[f], guidance,
                          scheduler)

    caches = jm.init_video_caches(nb, text_len, frames)
    tokens = apply(jm.bos_frame, nb)[:, 0]
    bos_value = tokens[:1, :1]
    tokens = apply(jm.frame_tokens, tokens, 0, frames)
    if guidance.image_guidance_scale and guidance.enabled:
        raw = jnp.broadcast_to(bos_value, (batch,) + tokens.shape[1:]).astype(tokens.dtype)
        tokens = jnp.concatenate([tokens[:batch], raw, tokens[2 * batch:]], axis=0)
    states0, caches = apply(jm.encode_frame, tokens, c, caches, 0, 0)
    lat = [jemb.patchify(jnp.asarray(latents), jm.patch_size) if latents is not None
           else frame(states0, 0)]
    index = text_len + nv
    for t in range(1, frames):
        prev = jemb.unpatchify(lat[-1], jm.patch_size, jm.image_base_size)
        tok = apply(jm.frame_tokens, apply(jm.embed_video_frame, prev), t, frames)
        tok = guidance.expand(tok, padding=bos_value)
        states, caches = apply(jm.encode_frame, tok, None, caches, jnp.int32(index), t)
        cond = apply(jm.mix_states, states0, states) if jm.video_mixer_rank is not None \
            else states
        lat.append(frame(cond, t))
        index += nv
    out = jnp.stack(lat, axis=1)
    b, t = out.shape[:2]
    return np.asarray(jemb.unpatchify(out.reshape((b * t,) + out.shape[2:]), jm.patch_size,
                                      jm.image_base_size).reshape((b, t, 8, 8, 4)))


def _port(tm, scheduler=None):
    return NOVAPipeline(tm, scheduler)


def _port_call(pipe, text, order, noise, step_noise, gkw, frames=FRAMES, latents=None):
    out = pipe(prompt_embeds=text, num_inference_steps=STEPS, num_diffusion_steps=DIFF,
               max_latent_length=frames, order=order, noise=noise,
               step_noise=None if pipe.is_flow else step_noise,
               latents=None if latents is None else torch.from_numpy(latents), **gkw)
    return _np(out.latents)


CASES = {
    # name: (model config, guidance, scheduler, prefill, frames); three frames
    # once (the cache index moves on twice), two elsewhere
    "rope_cfg": (VIDEO, dict(guidance_scale=5.0), "flow", False, FRAMES),
    "abs_cfg": (VIDEO_ABS, dict(guidance_scale=5.0), "flow", False, 2),
    "image_guidance": (VIDEO, dict(guidance_scale=4.0, image_guidance_scale=1.5), "flow", False,
                       2),
    "prefill": (VIDEO, dict(guidance_scale=5.0), "flow", True, FRAMES),
    "ddpm": (VIDEO, dict(guidance_scale=5.0), "ddpm", False, 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_float_video_sampler_matches_jax_replay(case):
    """The f32 video sampler against the JAX replay: RoPE or absolute
    positions, CFG or image guidance (the raw BOS pass), the latents=
    prefill (frame 0 bitwise the given latents), DDPM with the same step
    noise."""
    cfg, gkw, sched, prefill, frames = CASES[case]
    jm, params, tm = _models(cfg)
    text, order, noise, step_noise = _draws(jm, seed=30, frames=frames)
    latents = (np.random.default_rng(31).standard_normal((BATCH, 8, 8, 4)).astype(np.float32)
               if prefill else None)
    js = jddpm.DDPMScheduler(**DDPM_KW) if sched == "ddpm" else jfm.FlowMatchEulerScheduler()
    ts = DDPMScheduler(**DDPM_KW) if sched == "ddpm" else None
    ref = _jax_video(jm, {"params": params}, text, order, noise, step_noise,
                     jguid.GuidanceConfig(**gkw), js, frames, latents=latents, jit=True)
    got = _port_call(_port(tm, ts), text, order, noise, step_noise, gkw, frames, latents)
    assert got.shape == ref.shape == (BATCH, frames, 8, 8, 4) and np.isfinite(got).all()
    assert np.abs(got - ref).mean() <= 5e-5, np.abs(got - ref).mean()
    if prefill:
        assert np.array_equal(got[:, 0], latents)
    assert not any(LAUNCHES.values())


def test_bf16_video_sampler_matches_jax_replay():
    """Two frames in bf16, held to the JAX bf16 replay's own distance from
    its f32 twin."""
    jm, params, tm = _models(VIDEO, bf16=True)
    text, order, noise, step_noise = _draws(jm, seed=32, frames=2)
    g = jguid.GuidanceConfig(guidance_scale=5.0)

    def replay(jmod, p, jit):
        return _jax_video(jmod, {"params": p}, text, order, noise, step_noise, g,
                          jfm.FlowMatchEulerScheduler(), frames=2, jit=jit)

    got = _port_call(_port(tm), text, order, noise, step_noise, dict(guidance_scale=5.0),
                     frames=2)
    assert np.isfinite(got).all()
    _bf16_gate(got, replay(jm, params, jit=False), replay(*_f32_twin(VIDEO, params), jit=True),
               "video sampler")


def test_one_frame_of_a_video_model_and_its_prefill():
    """max_latent_length=1 on a video model: the motion tokens follow the
    prompt and encode_video takes the BOS frame (as the JAX T = 1 sampler);
    with latents= the call returns them and samples nothing."""
    jm, params, tm = _models(VIDEO)
    text, order, noise, step_noise = _draws(jm, seed=33, frames=1)
    g = jguid.GuidanceConfig(guidance_scale=5.0)
    v = {"params": params}
    c = _jax_prompt(jm, v, text, g)
    cond = jm.apply(v, jm.apply(v, c.shape[0], method=jm.bos_frame), c, 1,
                    method=jm.encode_video)
    apply = lambda fn, *a, **kw: jm.apply(v, *a, method=fn, **kw)  # noqa: E731
    canvas = _jax_frame(jm, apply, cond, order[0], noise[0], None, g,
                        jfm.FlowMatchEulerScheduler())
    ref = np.asarray(jemb.unpatchify(canvas, 2, (4, 4)))
    pipe = _port(tm)
    got = _np(pipe(prompt_embeds=text, num_inference_steps=STEPS, num_diffusion_steps=DIFF,
                   guidance_scale=5.0, order=order[0], noise=noise[0]).latents)
    assert got.shape == ref.shape == (BATCH, 8, 8, 4)
    assert np.abs(got - ref).mean() <= 5e-5
    lat = torch.randn((BATCH, 8, 8, 4), generator=torch.Generator().manual_seed(0))
    assert torch.equal(pipe(prompt_embeds=text, latents=lat).latents, lat)


def _jax_calibrate_video(jm, params, text, order, noise):
    """The JAX calibrate() at max_latent_length=2 with given order and noise:
    the image trajectory (encoder passes and head evals through mutable
    act_stats), then frame 0 and the trajectory's frame as frame 1 through
    the KV caches (the prompt without motion tokens, as calibrate() builds
    it)."""
    v = {"params": params}
    g = jguid.GuidanceConfig(guidance_scale=5.0)
    sched = jfm.FlowMatchEulerScheduler().set_timesteps(DIFF)
    ni, pd = jm.num_image_tokens, jm.patch_size ** 2 * jm.image_dim
    counts, starts, pad_p = _plan(ni, STEPS)
    S = len(counts)
    c = jnp.concatenate([jm.apply(v, jnp.asarray(text), method=jm.embed_text),
                         jm.apply(v, BATCH, TEXT, method=jm.null_text)])
    nb = c.shape[0]

    jitted = {fn.__name__: _jit_sow(jm, fn) for fn in (jm.encode_image_step, jm.denoise_step)}

    def sow(fn, *a):
        if fn.__name__ in jitted:  # every AR step's calls, at one shape
            out, vs = jitted[fn.__name__](v, *a)
        else:
            out, vs = jm.apply(v, *a, method=fn, mutable=["act_stats"])
        return out, vs["act_stats"]

    cond, stats = sow(jm.encode_video, jm.apply(v, nb, method=jm.bos_frame), c, 1)
    canvas = jnp.zeros((BATCH, ni, pd), jnp.float32)
    mask = jnp.ones((BATCH, ni, 1), jnp.float32)
    for i in range(S):
        scale = g.decayed_scale((i + 1.0) / S)
        tokens = jm.apply(v, canvas, method=jm.tokens_from_patches)
        z, s = sow(jm.encode_image_step, jnp.tile(tokens, (2, 1, 1)), jnp.tile(mask, (2, 1, 1)),
                   cond)
        stats = jquant.max_merge_stats(stats, s)
        ids, valid = jmask.pred_slice(jnp.asarray(order, jnp.int32), jnp.int32(starts[i]),
                                      jnp.int32(counts[i]), pad_p)
        z_sel = jnp.take_along_axis(z, jnp.tile(ids, (2, 1))[..., None], axis=1)
        x_t = jnp.asarray(noise[i])
        for j in range(DIFF):
            t = sched.timesteps[j]
            pred, s = sow(jm.denoise_step, g.expand(x_t), jnp.full((nb,), t), z_sel)
            stats = jquant.max_merge_stats(stats, s)
            x_t = jfm.FlowMatchEulerScheduler().step(g.combine(pred.astype(jnp.float32), scale,
                                                               t), j, x_t, sched)
        pred_mask = jmask.scatter_mask(ids, valid, ni)
        onehot = jax.nn.one_hot(ids, ni, dtype=jnp.float32) * valid[..., None]
        canvas = canvas * (1.0 - pred_mask) + jnp.einsum("bpn,bpd->bnd", onehot, x_t)
        mask = mask * (1.0 - pred_mask)
    caches = jm.init_video_caches(nb, TEXT, 2)
    tok0 = jm.apply(v, jm.apply(v, nb, method=jm.bos_frame)[:, 0], 0, 2, method=jm.frame_tokens)
    (_, caches), s0 = sow(jm.encode_frame, tok0, c, caches, 0, 0)
    frame = jemb.unpatchify(canvas, jm.patch_size, jm.image_base_size)
    tok1 = jm.apply(v, jm.apply(v, frame, method=jm.embed_video_frame), 1, 2,
                    method=jm.frame_tokens)
    _, s1 = sow(jm.encode_frame, jnp.tile(tok1, (2, 1, 1)), None, caches,
                jnp.int32(TEXT + jm.num_video_tokens), 1)
    stats = jquant.max_merge_stats(stats, jquant.max_merge_stats(s0, s1))
    return jax.tree.map(np.asarray, stats)


def test_int8_video_sampler_and_calibration_match_jax_replay():
    """int8 t2v: calibrate(max_latent_length=2) against the JAX calibrate
    algorithm (the stats tree's keys exactly: the cached layers add the MLP's
    sites only; values within 2 x floor + 1e-3 of the stats' summed size),
    then one 2-frame call of each against the other, both serving the JAX
    calibration (int8 weights once per call, margin 1.05, the static-offset
    attention in the image encoder, the plain core in the cached video
    encoder). Floors are the port's own: the same with the AR noise moved by
    1e-6, gate 2 x floor + 1e-3 (as test_torch_nova_sampler.py). The call's
    floor is the largest of FLOOR_MOVES moves: frames of 4 AR steps pass
    near-ties of int8 codes that one move of the noise may not cross
    (both packages then flip the same codes and agree again), while the port
    and the JAX replay, whose sums differ by f32 ulps, may sit on either
    side of one."""
    jm, params, tm = _models(VIDEO, quantize=True)
    text, order, noise, step_noise = _draws(jm, seed=34, frames=2)
    cal_text, cal_order, cal_noise, _ = _draws(jm, seed=35, frames=1)
    rng = np.random.default_rng(36)
    with _tpu_backend(), pltpu.force_tpu_interpret_mode():
        jstats = _jax_calibrate_video(jm, params, cal_text, cal_order[0], cal_noise[0])
    pipe = _port(tm)

    def calibrate(n):
        return dict(jax.tree_util.tree_flatten_with_path(pipe.calibrate(
            prompt_embeds=cal_text, num_inference_steps=STEPS, num_diffusion_steps=DIFF,
            max_latent_length=2, order=cal_order[0], noise=n))[0])

    flat_m = calibrate(cal_noise[0] + 1e-6 * rng.standard_normal(cal_noise[0].shape)
                       .astype(np.float32))
    flat_t = calibrate(cal_noise[0])
    flat_j = jax.tree_util.tree_flatten_with_path(jstats)[0]
    assert set(flat_t) == {k for k, _ in flat_j}
    port_err = sum(np.abs(flat_t[k].numpy() - v).sum() for k, v in flat_j)
    cal_floor = sum(np.abs(flat_m[k].numpy() - flat_t[k].numpy()).sum() for k, _ in flat_j)
    scale = sum(np.abs(v).sum() for _, v in flat_j)
    assert port_err <= 2 * cal_floor + 1e-3 * scale, (port_err, cal_floor, scale)
    qp = jquant.merge_act_scales(jquant.quantize_serving_params(params), jstats, margin=1.05)
    g = jguid.GuidanceConfig(guidance_scale=5.0)
    with _tpu_backend(), pltpu.force_tpu_interpret_mode():
        ref = _jax_video(jm, {"params": params, "qparams": qp}, text, order, noise, step_noise,
                         g, jfm.FlowMatchEulerScheduler(), frames=2, jit=True)
    pipe.act_scales = convert_tree(jstats)
    got = _port_call(pipe, text, order, noise, step_noise, dict(guidance_scale=5.0), frames=2)
    floor = max(np.abs(_port_call(pipe, text, order, noise + 1e-6 * rng.standard_normal(
        noise.shape).astype(np.float32), step_noise, dict(guidance_scale=5.0), frames=2) - got
                       ).mean() for _ in range(FLOOR_MOVES))
    err = np.abs(got - ref).mean()
    assert np.isfinite(got).all() and got.std() > 0.1
    assert err <= 2 * floor + 1e-3, (err, floor)
    assert not any(LAUNCHES.values())


def test_video_pipeline_draws_from_its_generator():
    """Without order / noise the video sampler draws them (and DDPM's step
    noise) from the generator: the same seed gives the same frames, another
    seed others."""
    _, _, tm = _models(VIDEO)
    text = np.random.default_rng(37).standard_normal((BATCH, TEXT, 16)).astype(np.float32)
    for sched in (None, DDPMScheduler(**DDPM_KW)):
        pipe = _port(tm, sched)

        def run(seed):
            return _np(pipe(prompt_embeds=text, num_inference_steps=3, num_diffusion_steps=2,
                            max_latent_length=2,
                            generator=torch.Generator().manual_seed(seed)).latents)

        a, b, c = run(1), run(1), run(2)
        assert a.shape == (BATCH, 2, 8, 8, 4)
        assert np.array_equal(a, b) and not np.allclose(a, c)
