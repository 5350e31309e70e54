"""The whole NOVA t2i sampler of the port vs a replay of the JAX algorithm
(pipelines/nova.py ``_make_sampler`` / ``calibrate``) through the JAX model's
public methods, with the same prediction order and noise; tolerances as in
test_torch_nova.py's docstring.
"""

import functools

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
from nova_pointcloud_tpu.schedulers import flow_match as jfm
from nova_pointcloud_tpu_torch.models.convert import convert_tree
from nova_pointcloud_tpu_torch.ops.kernels import LAUNCHES
from nova_pointcloud_tpu_torch.pipelines.nova import NOVAPipeline, bucket_plan
from tests.test_torch_nova import (SAMPLER, _bf16_gate, _f32_twin, _models, _np,
                                   _tpu_backend)

def _plan(ni, steps, diff_steps):
    counts = jmask.cosine_pred_counts(steps, ni)
    counts = counts[counts > 0]
    starts, pad_p = jmask.pred_boundaries(counts)
    return counts, starts, pad_p


@functools.lru_cache(maxsize=None)
def _jitted(jm, name, backend):
    """``jm.apply`` of the method ``name``, jitted once a process for each
    (model, method, the backend JAX reports): the replays of one model reuse
    its compiled encoder pass and head eval (the int8 ones run with the
    backend patched to "tpu", which changes the traced path)."""
    if name == "encode_image_step":
        return jax.jit(lambda v, *a, visible_bucket=None: jm.apply(
            v, *a, method=jm.encode_image_step, visible_bucket=visible_bucket),
            static_argnames=("visible_bucket",))
    return jax.jit(lambda v, *a: jm.apply(v, *a, method=getattr(jm, name)))


def _replay_apply(jm, variables, jit=False):
    """A replay's call of a JAX model method. With ``jit``, the two calls a
    replay repeats every AR step, the encoder pass (its visible bucket
    static) and the head eval, run jitted, compiled once a shape (an eager
    flax apply dispatches op by op). For the f32 and int8 replays: jitted,
    an f32 replay's latents move by at most ~1e-5 (measured 9e-6 on the
    video sampler), its distance from the port stays ~2e-6 against the 5e-5
    gate; the int8 replays' distance from the port stays well inside their
    gates (measured on the CPU: t2i 0.0218 against 0.0881, eager 0.0335;
    t2v 1.10e-6 against 0.148, eager the same). The t2i bf16 replay too:
    jit drops some bf16 round trips, and the port stays inside its gate
    against the jitted replay (to the f32 twin 0.82 of 1.25 x the replay's
    own distance from it, to the replay 0.64 of 2 x; eager 0.79 and 0.61).
    The t2v bf16 replay stays eager (jitted, the first ratio reaches 1.00)."""
    jitted = {}
    if jit:
        jitted = {name: _jitted(jm, name, jax.default_backend())
                  for name in ("encode_image_step", "denoise_step")}

    def apply(fn, *a, **kw):
        if fn.__name__ in jitted:
            return jitted[fn.__name__](variables, *a, **kw)
        return jm.apply(variables, *a, method=fn, **kw)
    return apply


def _jax_sample(jm, variables, c_text, order, noise, steps, diff_steps, guidance, jit=False):
    """The JAX sampler's T=1 algorithm (pipelines/nova.py _make_sampler)
    through the JAX model's public methods, with given order and noise
    (``jit``: _replay_apply's, f32 and int8 replays)."""
    apply = _replay_apply(jm, variables, jit)
    sched = jfm.FlowMatchEulerScheduler().set_timesteps(diff_steps)
    ni, pd = jm.num_image_tokens, jm.patch_size ** 2 * jm.image_dim
    counts, starts, pad_p = _plan(ni, steps, diff_steps)
    S, n_passes = len(counts), guidance.num_passes
    batch = c_text.shape[0] // n_passes
    n_cfg_d = diff_steps
    if guidance.enabled and guidance.guidance_trunc > 0:
        n_cfg_d = int(np.sum(sched.timesteps >= guidance.guidance_trunc))
    phases = bucket_plan(starts, ni) or [(0, S, None)]
    cond = apply(jm.encode_video, apply(jm.bos_frame, batch * n_passes), c_text, 1)
    canvas = jnp.zeros((batch, ni, pd), jnp.float32)
    mask = jnp.ones((batch, ni, 1), jnp.float32)
    order = jnp.asarray(order, jnp.int32)
    for s_b, s_e, bucket in phases:
        for i in range(s_b, s_e):
            scale = guidance.decayed_scale((i + 1.0) / S)
            tokens = apply(jm.tokens_from_patches, canvas)
            z = apply(jm.encode_image_step, jnp.tile(tokens, (n_passes, 1, 1)),
                      jnp.tile(mask, (n_passes, 1, 1)), cond, visible_bucket=bucket)
            ids, valid = jmask.pred_slice(order, jnp.int32(starts[i]), jnp.int32(counts[i]),
                                          pad_p)
            z_sel = jnp.take_along_axis(z, jnp.tile(ids, (n_passes, 1))[..., None], axis=1)
            x_t = jnp.asarray(noise[i])
            for j in range(diff_steps):
                t = sched.timesteps[j]
                if j < n_cfg_d:
                    pred = apply(jm.denoise_step, guidance.expand(x_t),
                                 jnp.full((batch * n_passes,), t), z_sel)
                    pred = guidance.combine(pred.astype(jnp.float32), scale, t)
                else:
                    pred = apply(jm.denoise_step, x_t, jnp.full((batch,), t),
                                 z_sel[:batch]).astype(jnp.float32)
                x_t = jfm.FlowMatchEulerScheduler().step(pred, j, x_t, sched)
            pred_mask = jmask.scatter_mask(ids, valid, ni)
            onehot = jax.nn.one_hot(ids, ni, dtype=jnp.float32) * valid[..., None]
            canvas = canvas * (1.0 - pred_mask) + jnp.einsum("bpn,bpd->bnd", onehot, x_t)
            mask = mask * (1.0 - pred_mask)
    return np.asarray(jemb.unpatchify(canvas, jm.patch_size, jm.image_base_size))


def _sampler_inputs(jm, batch, steps, diff_steps, seed):
    rng = np.random.default_rng(seed)
    ni, pd = jm.num_image_tokens, jm.patch_size ** 2 * jm.image_dim
    counts, _, pad_p = _plan(ni, steps, diff_steps)
    order = np.argsort(rng.random((batch, ni)), axis=1)
    noise = rng.standard_normal((len(counts), batch, pad_p, pd)).astype(np.float32)
    text = rng.standard_normal((batch, 4, 16)).astype(np.float32)
    return text, order, noise


def _pipe(tm):
    return NOVAPipeline(tm)


STEPS, DIFF = 5, 2  # 5 AR steps over 64 tokens: all four phases (buckets 8, 16, 32, masking)
CAL_STEPS = 3


@pytest.mark.parametrize("bf16,trunc", [(False, 500.0), (True, 0.0)])
def test_float_sampler_matches_jax_replay(bf16, trunc):
    """The whole float t2i sampler (8x8 patches: bucket phases 8, 16, 32 and
    the masking path) against the JAX replay, f32 and bf16, with and without
    the guidance-truncation split."""
    jm, params, tm = _models(SAMPLER, bf16=bf16)
    text, order, noise = _sampler_inputs(jm, 2, STEPS, DIFF, seed=14)
    guidance = jguid.GuidanceConfig(guidance_scale=5.0, guidance_trunc=trunc)

    def replay(jmod, p, jit):
        c = jnp.concatenate([jmod.apply({"params": p}, jnp.asarray(text), method=jmod.embed_text),
                             jmod.apply({"params": p}, 2, 4, method=jmod.null_text)])
        return _jax_sample(jmod, {"params": p}, c, order, noise, STEPS, DIFF, guidance, jit)

    ref = replay(jm, params, jit=True)
    out = _pipe(tm)(prompt_embeds=text, num_inference_steps=STEPS, num_diffusion_steps=DIFF,
                    guidance_scale=5.0, guidance_trunc=trunc, order=order, noise=noise)
    got = _np(out.latents)
    assert got.shape == ref.shape == (2, 16, 16, 4) and np.isfinite(got).all()
    if bf16:
        _bf16_gate(got, ref, replay(*_f32_twin(SAMPLER, params), jit=True), "sampler")
    else:
        assert np.abs(got - ref).mean() <= 5e-5


def _jit_sow(jm, fn):
    """``jm.apply`` of ``fn`` with mutable act_stats, jitted: a replay calls
    the encoder pass and the head eval at one shape every AR step, and
    interpret-mode Pallas runs each eager call op by op (the stats agree
    with the eager calls' to ~3e-6 relative, far inside the floors). One
    jitted function a process for each (model, method, backend), as
    ``_jitted``."""
    return _jitted_sow(jm, fn.__name__, jax.default_backend())


@functools.lru_cache(maxsize=None)
def _jitted_sow(jm, name, backend):
    return jax.jit(lambda v, *a: jm.apply(v, *a, method=getattr(jm, name),
                                          mutable=["act_stats"]))


def _jax_calibrate(jm, params, c_text, order, noise, steps, diff_steps, scale=5.0):
    """The JAX calibrate() algorithm with given order and noise (the
    masking path, no buckets), through mutable act_stats applies."""
    v = {"params": params}
    encode_image_step, denoise_step = _jit_sow(jm, jm.encode_image_step), _jit_sow(
        jm, jm.denoise_step)
    guidance = jguid.GuidanceConfig(guidance_scale=scale)
    sched = jfm.FlowMatchEulerScheduler().set_timesteps(diff_steps)
    ni, pd = jm.num_image_tokens, jm.patch_size ** 2 * jm.image_dim
    counts, starts, pad_p = _plan(ni, steps, diff_steps)
    S, nb = len(counts), c_text.shape[0]
    batch = nb // 2
    bos = jm.apply(v, nb, method=jm.bos_frame)
    cond, vs = jm.apply(v, bos, c_text, 1, method=jm.encode_video, mutable=["act_stats"])
    stats = vs["act_stats"]
    canvas = jnp.zeros((batch, ni, pd), jnp.float32)
    mask = jnp.ones((batch, ni, 1), jnp.float32)
    for i in range(S):
        sc = guidance.decayed_scale((i + 1.0) / S)
        tokens = jm.apply(v, canvas, method=jm.tokens_from_patches)
        z, vs = encode_image_step(v, jnp.tile(tokens, (2, 1, 1)), jnp.tile(mask, (2, 1, 1)),
                                  cond)
        stats = jquant.max_merge_stats(stats, vs["act_stats"])
        ids, valid = jmask.pred_slice(jnp.asarray(order, jnp.int32), jnp.int32(starts[i]),
                                      jnp.int32(counts[i]), pad_p)
        z_sel = jnp.take_along_axis(z, jnp.tile(ids, (2, 1))[..., None], axis=1)
        x_t = jnp.asarray(noise[i])
        for j in range(diff_steps):
            t = sched.timesteps[j]
            pred, vs = denoise_step(v, guidance.expand(x_t), jnp.full((nb,), t), z_sel)
            stats = jquant.max_merge_stats(stats, vs["act_stats"])
            pred = guidance.combine(pred.astype(jnp.float32), sc, t)
            x_t = jfm.FlowMatchEulerScheduler().step(pred, j, x_t, sched)
        pred_mask = jmask.scatter_mask(ids, valid, ni)
        onehot = jax.nn.one_hot(ids, ni, dtype=jnp.float32) * valid[..., None]
        canvas = canvas * (1.0 - pred_mask) + jnp.einsum("bpn,bpd->bnd", onehot, x_t)
        mask = mask * (1.0 - pred_mask)
    return jax.tree.map(np.asarray, stats)


def test_int8_sampler_matches_jax_replay():
    """int8 t2i, calibrated: the port's calibrate() against the JAX
    calibrate algorithm, then one call of each against the other, both
    serving the JAX calibration (int8 weights once per call, margin 1.05,
    static sites, the static-offset attention). Floors are the port's own
    (the same algorithm, cheap on the CPU; the JAX replay runs its kernels
    in interpret mode): the call against itself with every AR step's noise
    moved by 1e-6, gate 2 x floor + 1e-3; the calibration's summed stat
    error against its noise moved so, gate 2 x floor + 1e-3 of the stats'
    summed size (a floor sample can be lucky: no int8 code flips)."""
    jm, params, tm = _models(SAMPLER, quantize=True)
    text, order, noise = _sampler_inputs(jm, 2, STEPS, DIFF, seed=15)
    _, _, cal_noise = _sampler_inputs(jm, 2, CAL_STEPS, DIFF, seed=18)
    rng = np.random.default_rng(19)
    v = {"params": params}
    c = jnp.concatenate([jm.apply(v, jnp.asarray(text), method=jm.embed_text),
                         jm.apply(v, 2, 4, method=jm.null_text)])
    with _tpu_backend(), pltpu.force_tpu_interpret_mode():
        jstats = _jax_calibrate(jm, params, c, order, cal_noise, CAL_STEPS, DIFF)
    pipe = _pipe(tm)

    def calibrate(n):
        return dict(jax.tree_util.tree_flatten_with_path(pipe.calibrate(
            prompt_embeds=text, num_inference_steps=CAL_STEPS, num_diffusion_steps=DIFF,
            order=order, noise=n))[0])

    flat_m = calibrate(cal_noise + 1e-6 * rng.standard_normal(cal_noise.shape).astype(np.float32))
    flat_t = calibrate(cal_noise)
    flat_j = jax.tree_util.tree_flatten_with_path(jstats)[0]
    assert set(flat_t) == {k for k, _ in flat_j}
    port_err = sum(np.abs(flat_t[k].numpy() - v).sum() for k, v in flat_j)
    cal_floor = sum(np.abs(flat_m[k].numpy() - flat_t[k].numpy()).sum() for k, _ in flat_j)
    scale = sum(np.abs(v).sum() for _, v in flat_j)
    assert port_err <= 2 * cal_floor + 1e-3 * scale, (port_err, cal_floor, scale)
    qp = jquant.merge_act_scales(jquant.quantize_serving_params(params), jstats, margin=1.05)
    with _tpu_backend(), pltpu.force_tpu_interpret_mode():
        ref = _jax_sample(jm, {"params": params, "qparams": qp}, c, order, noise, STEPS, DIFF,
                          jguid.GuidanceConfig(guidance_scale=5.0), jit=True)
    pipe.act_scales = convert_tree(jstats)

    def sample(n):
        return _np(pipe(prompt_embeds=text, num_inference_steps=STEPS,
                        num_diffusion_steps=DIFF, guidance_scale=5.0, order=order,
                        noise=n).latents)

    got = sample(noise)
    moved = sample(noise + 1e-6 * rng.standard_normal(noise.shape).astype(np.float32))
    floor, err = np.abs(moved - got).mean(), np.abs(got - ref).mean()
    assert np.isfinite(got).all() and got.std() > 0.1
    assert err <= 2 * floor + 1e-3, (err, floor)
    assert not any(LAUNCHES.values())


def test_pipeline_draws_from_its_generator():
    """Without order / noise the sampler draws both from the generator: the
    same seed gives the same latents, another seed others."""
    _, _, tm = _models(SAMPLER)
    pipe = _pipe(tm)
    text = np.random.default_rng(17).standard_normal((2, 4, 16)).astype(np.float32)

    def run(seed):
        return _np(pipe(prompt_embeds=text, num_inference_steps=4, num_diffusion_steps=2,
                        generator=torch.Generator().manual_seed(seed)).latents)

    a, b, c = run(1), run(1), run(2)
    assert np.array_equal(a, b) and not np.allclose(a, c)
