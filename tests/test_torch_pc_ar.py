"""The masked-AR point-cloud mode of the port vs the JAX package on the CPU:
``NOVAPointCloudARTransformer``'s serving methods (float, and int8 with the
JAX model on its TPU branches: Pallas in interpret mode, with
``jax.default_backend`` patched to "tpu" inside the test only), its serving
qparams, the whole ``NOVAPointCloudARPipeline`` sampler against a replay
of the JAX algorithm (pipelines/pointcloud_ar.py ``_make_sampler``) through
the JAX model's methods with the same order and noise, the training loss
and its gradient on JAX's draws, the script's optimizer against optax, and
the script's ``main`` at a tiny size. The JAX model runs with remat in
training (as the script) and without it in serving (JAX's remat cannot
trace interpret-mode Pallas).

Sizes: pc_d2w64, 128 points at patch 8 (16 tokens), text 4 x 16; the
64-token sampler case (512 points) has the cosine schedule's zero-count
first step at 16 AR steps. JAX parameters get seeded N(0, 0.05) noise on
every leaf (the head's AdaLN projections are live).

Tolerances: f32 float methods 2e-5 absolute on O(1) values (sums in
another order); int8 methods 1e-4 (the same int8 codes, f32 dequant in
another order), as tests/test_torch_nova.py; the float sampler's clouds
5e-5 mean absolute, 1e-3 max; the int8 sampler against a measured floor
(the port's call against itself with the AR noise moved by 1e-6), gate
2 x floor + 1e-3, as test_torch_nova_sampler.py; the loss 1e-5 relative
and each gradient 1e-4 relative L2 (against a thousandth of the largest
gradient's norm where its own is smaller); three optimizer steps'
parameters 1e-6 absolute plus 1e-3 of the lr.
"""

import functools
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nova_pointcloud_tpu.engine.lr_schedules import cosine_lr as jcosine_lr
from nova_pointcloud_tpu.models import guidance as jguid
from nova_pointcloud_tpu.models.pointcloud_ar import NOVAPointCloudARTransformer as JAR
from nova_pointcloud_tpu.ops import masking as jmask
from nova_pointcloud_tpu.ops import quantization as jquant
from nova_pointcloud_tpu.schedulers import ddpm as jddpm
from nova_pointcloud_tpu.schedulers import flow_match as jfm
from nova_pointcloud_tpu_torch.data.shapenet import GlobalNormalizer, make_synthetic_clouds
from nova_pointcloud_tpu_torch.models.convert import convert_params, convert_tree
from nova_pointcloud_tpu_torch.models.pointcloud_ar import NOVAPointCloudARTransformer as TAR
from nova_pointcloud_tpu_torch.ops import quantization as tquant
from nova_pointcloud_tpu_torch.ops.kernels import LAUNCHES
from nova_pointcloud_tpu_torch.pipelines.pointcloud_ar import NOVAPointCloudARPipeline
from nova_pointcloud_tpu_torch.schedulers.ddpm import DDPMScheduler
from nova_pointcloud_tpu_torch.schedulers.flow_match import FlowMatchEulerScheduler
from nova_pointcloud_tpu_torch.scripts import train_eval_pc_ar

CFG = dict(arch="pc_d2w64", point_cloud_size=128, patch_size=8, text_token_dim=16,
           text_token_len=4)
BIG = dict(CFG, point_cloud_size=512)  # 64 tokens
TEXT_LEN, TEXT_DIM = 4, 16


def _np(t):
    return t.detach().float().cpu().numpy()


def _t(a):
    return torch.from_numpy(np.array(a))


def _tpu_backend():
    """The JAX package takes its int8 branches on a TPU only: pretend."""
    return mock.patch.object(jax, "default_backend", lambda: "tpu")


def _jsched(kind):
    return jfm.FlowMatchEulerScheduler() if kind == "flow" else \
        jddpm.DDPMScheduler(beta_schedule="squaredcos_cap_v2")


def _tsched(kind):
    return FlowMatchEulerScheduler() if kind == "flow" else \
        DDPMScheduler(beta_schedule="squaredcos_cap_v2")


@functools.lru_cache(maxsize=None)
def _jax_params(cfg_items, seed=0):
    cfg = dict(cfg_items)
    jm = JAR(**cfg, noise_scheduler=_jsched("ddpm"))
    rngs = {n: jax.random.PRNGKey(seed + i)
            for i, n in enumerate(("params", "mask", "time", "noise", "dropout"))}
    params = jm.init(rngs, jnp.zeros((2, cfg["point_cloud_size"], 3)),
                     jnp.zeros((2, TEXT_LEN, TEXT_DIM)))["params"]
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(lambda p: (np.asarray(p) + rng.normal(0, 0.05, p.shape))
                        .astype(np.float32), params)


def _models(cfg=CFG, quantize=False, sched="flow", remat=False):
    """(jax model, jax params, port model) on the same weights."""
    params = _jax_params(tuple(cfg.items()))
    # JAX's remat cannot trace interpret-mode Pallas (effects in remat)
    jm = JAR(**cfg, noise_scheduler=_jsched(sched), quantize=quantize, remat=not quantize)
    tm = TAR(**cfg, noise_scheduler=_tsched(sched), quantize=quantize, remat=remat, device="cpu")
    tm.load_state_dict(convert_params(params), strict=True)
    return jm, params, tm


def _apply_int8(jm, params, fn, *args):
    qp = jquant.quantize_serving_params(params)
    with _tpu_backend(), pltpu.force_tpu_interpret_mode():
        return jm.apply({"params": params, "qparams": qp}, *args, method=fn)


# -- the model's serving methods -------------------------------------------------------

def test_serving_qparams_match_jax():
    """quantize_serving_params over the masked-AR model: the JAX tree's keys
    and shapes (the ViT's two scanned halves, the head's six blocks), every
    int8 weight and scale equal."""
    _, params, tm = _models(quantize=True)
    jq = jax.tree.map(np.asarray, jquant.quantize_serving_params(params))
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jq)[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path(tm.serving_qparams())[0])
    assert set(flat_j) == set(flat_t), set(flat_j) ^ set(flat_t)
    assert len(flat_j) == 2 * 4 * 2 + 6 * 3 * 2
    for k, v in flat_j.items():
        assert flat_t[k].shape == v.shape and np.array_equal(flat_t[k].numpy(), v), k
    assert TAR(**CFG, device="cpu").serving_qparams() is None


def test_embedding_methods_match_jax():
    jm, params, tm = _models()
    rng = np.random.default_rng(2)
    v = {"params": params}
    text = rng.standard_normal((2, TEXT_LEN, TEXT_DIM)).astype(np.float32)
    pts = rng.uniform(-1, 1, (2, 128, 3)).astype(np.float32)
    patches = np.asarray(jm.apply(v, jnp.asarray(pts), method=jm.patchify))
    np.testing.assert_array_equal(tm.patchify(_t(pts)).numpy(), patches)
    np.testing.assert_array_equal(tm.unpatchify(_t(patches)).numpy(), pts)
    cases = [(jm.apply(v, jnp.asarray(text), method=jm.embed_text), tm.embed_text(_t(text))),
             (jm.apply(v, 3, TEXT_LEN, method=jm.null_text), tm.null_text(3, TEXT_LEN)),
             (jm.apply(v, jnp.asarray(patches), method=jm.tokens_from_patches),
              tm.tokens_from_patches(_t(patches)))]
    for ref, got in cases:
        assert got.shape == ref.shape
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=2e-5, rtol=0)


def _encoder_inputs(seed, b=4, nt=16, d=64):
    """Tokens, a mask with 0 to 9 visible tokens a sample (sample 0 none,
    as the first AR step), the text prefix, patch centres."""
    rng = np.random.default_rng(seed)
    tokens = rng.standard_normal((b, nt, d)).astype(np.float32)
    mask = np.ones((b, nt, 1), np.float32)
    for i in range(1, b):
        mask[i, rng.permutation(nt)[: 3 * i], 0] = 0.0
    cond = rng.standard_normal((b, TEXT_LEN, d)).astype(np.float32)
    coords = (rng.uniform(-1, 1, (b, nt, 3)) * (1.0 - mask)).astype(np.float32)
    return tokens, mask, cond, coords


@pytest.mark.parametrize("coords", [True, False])
@pytest.mark.parametrize("mode", ["float", "int8"])
def test_encode_step_matches_jax(mode, coords):
    """The masked encoder pass (mask tokens, the position table, the
    ClusterBlock's summary of the patch centres, the ViT's masked encoder
    half over the text prefix); int8: int8_linear projections and the
    per-row fused post-LN MLP."""
    jm, params, tm = _models(quantize=mode == "int8")
    tokens, mask, cond, xyz = _encoder_inputs(3)
    args = [tokens, mask, cond] + ([xyz] if coords else [])
    if mode == "float":
        ref = jm.apply({"params": params}, *map(jnp.asarray, args), method=jm.encode_step)
        got = tm.encode_step(*map(_t, args))
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=2e-5, rtol=0)
        return
    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
    ref = _apply_int8(jm, params, jm.encode_step, *map(jnp.asarray, args))
    targs = list(map(_t, args)) + ([None] if not coords else [])
    got = tm.encode_step(*targs, qparams=tm.serving_qparams())
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-4, rtol=0)
    assert not any(LAUNCHES.values())


@pytest.mark.parametrize("mode", ["float", "int8"])
def test_denoise_step_matches_jax(mode):
    """One head eval at a padded slice of 5 tokens, per-token timesteps
    (training) and per-sample ones (sampling)."""
    jm, params, tm = _models(quantize=mode == "int8")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 5, 24)).astype(np.float32)
    z = rng.standard_normal((4, 5, 64)).astype(np.float32)
    for t in (np.full((4,), 437.0, np.float32), rng.integers(0, 1000, (4, 5)).astype(np.float32)):
        args = (x, t, z)
        if mode == "float":
            ref = jm.apply({"params": params}, *map(jnp.asarray, args), method=jm.denoise_step)
            got = tm.denoise_step(*map(_t, args))
            atol = 2e-5
        else:
            ref = _apply_int8(jm, params, jm.denoise_step, *map(jnp.asarray, args))
            got = tm.denoise_step(*map(_t, args), qparams=tm.serving_qparams())
            atol = 1e-4
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=atol, rtol=0)


# -- the whole sampler -----------------------------------------------------------------

def _jax_sample(jm, variables, c_text, order, noise, steps, diff_steps, guidance):
    """The JAX sampler's algorithm (pipelines/pointcloud_ar.py
    _make_sampler's ``sample``) through the JAX model's public methods, the
    flow-matching step, with given order and noise; returns the points."""
    apply = {m: jax.jit(lambda v, *a, m=m: jm.apply(v, *a, method=getattr(jm, m)))
             for m in ("tokens_from_patches", "encode_step", "denoise_step", "unpatchify")}
    sched = jfm.FlowMatchEulerScheduler().set_timesteps(diff_steps)
    ts = jnp.asarray(sched.timesteps, jnp.float32)
    nt, p = jm.num_tokens, jm.patch_size
    counts = jmask.cosine_pred_counts(steps, nt)
    starts, pad_p = jmask.pred_boundaries(counts)
    n_passes = guidance.num_passes
    batch = c_text.shape[0] // n_passes
    canvas = jnp.zeros((batch, nt, p * 3), jnp.float32)
    mask = jnp.ones((batch, nt, 1), jnp.float32)
    order = jnp.asarray(order, jnp.int32)
    for i in range(steps):
        scale = guidance.decayed_scale((i + 1.0) / steps)
        tokens = apply["tokens_from_patches"](variables, canvas)
        coords = jnp.mean(canvas.reshape(batch, nt, p, 3), axis=2)
        z = apply["encode_step"](variables, jnp.tile(tokens, (n_passes, 1, 1)),
                                 jnp.tile(mask, (n_passes, 1, 1)), c_text,
                                 jnp.tile(coords, (n_passes, 1, 1)))
        ids, valid = jmask.pred_slice(order, jnp.int32(starts[i]), jnp.int32(counts[i]), pad_p)
        z_sel = jnp.take_along_axis(z, jnp.tile(ids, (n_passes, 1))[..., None], axis=1)
        x_t = jnp.asarray(noise[i])
        for j in range(diff_steps):
            t = ts[j]
            pred = apply["denoise_step"](variables, guidance.expand(x_t),
                                         jnp.full((batch * n_passes,), t), z_sel)
            pred = guidance.combine(pred.astype(jnp.float32), scale, t)
            x_t = jfm.FlowMatchEulerScheduler().step(pred, j, x_t, sched)
        x_t = jnp.clip(x_t, -1.0, 1.0)
        pred_mask = jmask.scatter_mask(ids, valid, nt)
        onehot = jax.nn.one_hot(ids, nt, dtype=jnp.float32)
        canvas = canvas * (1.0 - pred_mask) + jnp.einsum("bpn,bpd->bnd",
                                                         onehot * valid[..., None], x_t)
        mask = mask * (1.0 - pred_mask)
    return np.asarray(apply["unpatchify"](variables, canvas))


def _sampler_inputs(jm, batch, steps, seed):
    rng = np.random.default_rng(seed)
    nt = jm.num_tokens
    _, pad_p = jmask.pred_boundaries(jmask.cosine_pred_counts(steps, nt))
    order = np.argsort(rng.random((batch, nt)), axis=1)
    noise = rng.standard_normal((steps, batch, pad_p, jm.patch_size * 3)).astype(np.float32)
    text = rng.standard_normal((batch, TEXT_LEN, TEXT_DIM)).astype(np.float32)
    return text, order, noise


def _jax_text(jm, params, text, guidance):
    v = {"params": params}
    c = jm.apply(v, jnp.asarray(text), method=jm.embed_text)
    if not guidance.enabled:
        return c
    return jnp.concatenate([c, jm.apply(v, c.shape[0], c.shape[1], method=jm.null_text)])


@pytest.mark.parametrize("cfg,steps,diff,gs", [(CFG, 4, 3, 5.0), (CFG, 3, 2, 1.0),
                                               (BIG, 16, 2, 5.0)])
def test_float_sampler_matches_jax_replay(cfg, steps, diff, gs):
    """The whole float masked-AR sampler, flow matching: 16 tokens at 4 and
    3 AR steps (CFG 5, and no guidance), and 64 tokens at 16 AR steps,
    whose first step predicts nothing (cosine_pred_counts(16, 64)[0] == 0)
    but runs its encoder pass and its diffusion loop."""
    jm, params, tm = _models(cfg)
    if cfg is BIG:
        assert jmask.cosine_pred_counts(steps, 64)[0] == 0
    text, order, noise = _sampler_inputs(jm, 2, steps, seed=5)
    guidance = jguid.GuidanceConfig(guidance_scale=gs)
    ref = _jax_sample(jm, {"params": params}, _jax_text(jm, params, text, guidance), order,
                      noise, steps, diff, guidance)
    pipe = NOVAPointCloudARPipeline(tm, FlowMatchEulerScheduler())
    out = pipe(prompt_embeds=text, num_inference_steps=steps, num_diffusion_steps=diff,
               guidance_scale=gs, order=order, noise=noise,
               generator=torch.Generator().manual_seed(0))
    got = out.point_clouds
    assert got.shape == ref.shape == (2, cfg["point_cloud_size"], 3)
    assert np.isfinite(got).all() and got.std() > 0.1
    err = np.abs(got - ref)
    assert err.mean() <= 5e-5 and err.max() <= 1e-3, (err.mean(), err.max())
    assert out.colors.shape == got.shape and 0.0 <= out.colors.min() <= out.colors.max() <= 1.0


def test_int8_sampler_matches_jax_replay():
    """int8 serving (per-row activations: the AR pipeline never calibrates)
    against the JAX replay on its TPU branches, gated at 2 x floor + 1e-3
    (floor: the port's call with every AR step's noise moved by 1e-6)."""
    jm, params, tm = _models(quantize=True)
    steps, diff = 3, 2
    text, order, noise = _sampler_inputs(jm, 2, steps, seed=6)
    guidance = jguid.GuidanceConfig(guidance_scale=5.0)
    c = _jax_text(jm, params, text, guidance)
    qp = jquant.quantize_serving_params(params)
    with _tpu_backend(), pltpu.force_tpu_interpret_mode():
        ref = _jax_sample(jm, {"params": params, "qparams": qp}, c, order, noise, steps, diff,
                          guidance)
    pipe = NOVAPointCloudARPipeline(tm, FlowMatchEulerScheduler())
    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))

    def sample(n):
        return pipe(prompt_embeds=text, num_inference_steps=steps, num_diffusion_steps=diff,
                    guidance_scale=5.0, order=order, noise=n).point_clouds

    got = sample(noise)
    moved = sample(noise + 1e-6 * np.random.default_rng(7).standard_normal(noise.shape)
                   .astype(np.float32))
    floor, err = np.abs(moved - got).mean(), np.abs(got - ref).mean()
    assert np.isfinite(got).all() and got.std() > 0.1
    assert err <= 2 * floor + 1e-3, (err, floor)
    assert not any(LAUNCHES.values())


def test_ddpm_sampler_draws_from_its_generator():
    """The DDPM sampler (the script's) draws the order, the noise, each
    step's noise and the colours from the generator: the same seed gives
    the same call, another seed another; the clouds stay in [-1, 1] and
    denormalize maps them through the normalizer."""
    _, _, tm = _models()
    norm = GlobalNormalizer(np.array([0.1, 0.2, 0.3]), np.array([2.0, 1.0, 0.5]))
    pipe = NOVAPointCloudARPipeline(tm, DDPMScheduler(beta_schedule="squaredcos_cap_v2"),
                                    normalizer=norm)
    text = np.random.default_rng(8).standard_normal((2, TEXT_LEN, TEXT_DIM)).astype(np.float32)

    def run(seed, **kw):
        return pipe(prompt_embeds=text, num_inference_steps=4, num_diffusion_steps=3,
                    generator=torch.Generator().manual_seed(seed), **kw)

    a, b, c = run(1), run(1), run(2)
    assert np.array_equal(a.point_clouds, b.point_clouds)
    assert np.array_equal(a.colors, b.colors)
    assert not np.allclose(a.point_clouds, c.point_clouds)
    assert np.abs(a.point_clouds).max() <= 1.0
    d = run(1, denormalize=True)
    np.testing.assert_allclose(d.point_clouds, a.point_clouds * norm.std + norm.mean,
                               atol=1e-6, rtol=0)


# -- training --------------------------------------------------------------------------

_CAP = {}


class _CapDDPM(jddpm.DDPMScheduler):
    def sample_timesteps(self, key, shape):
        _CAP["timesteps"] = t = super().sample_timesteps(key, shape)
        return t

    def add_noise(self, x0, noise, t):
        _CAP["noise"] = noise
        return super().add_noise(x0, noise, t)


class _CapFlow(jfm.FlowMatchEulerScheduler):
    def sample_timesteps(self, key, shape):
        _CAP["timesteps"] = t = super().sample_timesteps(key, shape)
        return t

    def add_noise(self, x0, noise, t):
        _CAP["noise"] = noise
        return super().add_noise(x0, noise, t)


def _intercept(next_fun, args, kwargs, context):
    out = next_fun(*args, **kwargs)
    if context.method_name == "drop_prompts":
        _CAP["dropped"] = out
    return out


def _train_batch(seed=9, b=2, n=128):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (b, n, 3)).astype(np.float32),
            rng.standard_normal((b, TEXT_LEN, TEXT_DIM)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_loss_grads(sched, seed=3):
    """The JAX loss, its gradient and its draws (mask, prompt drop,
    timesteps, noise), read out of the traced loss."""
    params = _jax_params(tuple(CFG.items()))
    jm = JAR(**CFG, noise_scheduler=_CapDDPM(beta_schedule="squaredcos_cap_v2")
             if sched == "ddpm" else _CapFlow(), remat=True)
    pts, text = _train_batch()
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    rngs = dict(zip(("mask", "time", "noise", "dropout"), ks))

    def loss(p):
        _CAP.clear()
        with fnn.intercept_methods(_intercept):
            out, vs = jm.apply({"params": p}, jnp.asarray(pts), jnp.asarray(text), rngs=rngs,
                               mutable=["intermediates"])
        return out["loss"], (dict(_CAP), vs["intermediates"]["train_mask"][0])

    (value, (cap, mask)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    drop = np.array([np.any(np.asarray(cap["dropped"][i]) != text[i]) for i in range(len(text))])
    draws = {"mask": _t(mask), "drop": torch.from_numpy(drop), "timesteps": _t(cap["timesteps"]),
             "noise": _t(cap["noise"])}
    return float(value), jax.tree.map(np.array, grads), draws


def _rel_l2(got, ref, floor=1e-30):
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), floor))


@pytest.mark.parametrize("sched,remat", [("ddpm", True), ("ddpm", False), ("flow", True)])
def test_train_loss_and_gradient_match_jax(sched, remat):
    """train_losses on JAX's draws (the script's DDPM target: the noise;
    flow matching: noise - x): the loss and every parameter's gradient."""
    loss_ref, grads_ref, draws = _jax_loss_grads(sched)
    _, _, tm = _models(sched=sched, remat=remat)
    pts, text = _train_batch()
    out = tm(_t(pts), _t(text), draws=draws)
    out["loss"].backward()
    assert abs(float(out["loss"].detach()) - loss_ref) <= 1e-5 * abs(loss_ref)
    flat = convert_params(grads_ref)
    assert set(flat) == {n for n, _ in tm.named_parameters()}
    # each tensor against its own norm, or a thousandth of the largest
    # tensor's where its own is smaller (the key projections' bias gradient
    # is 0 up to rounding: softmax ignores a constant per query)
    floor = 1e-3 * max(np.linalg.norm(g.numpy()) for g in flat.values())
    for name, p in tm.named_parameters():
        ref = flat[name].numpy()
        # the BOS token is unused: no gradient in the port, zeros in JAX
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        err = _rel_l2(got, ref, floor)
        assert err <= 1e-4, (name, err)
    assert not any(LAUNCHES.values())


def test_script_optimizer_step_matches_optax():
    """The script's chain (global-norm clip 5.0, AdamW with decay 0.01 on
    every parameter, betas 0.9 / 0.999, cosine lr with 200 warm-up steps)
    on the JAX gradient, one step from the JAX params, against optax."""
    _, grads_ref, _ = _jax_loss_grads("ddpm")
    params = _jax_params(tuple(CFG.items()))
    # a gradient over the clip, so the clip acts
    grads_ref = jax.tree.map(lambda g: g * 50.0, grads_ref)
    lr, steps = 2e-4, 4000
    schedule = jcosine_lr(lr, steps, warmup_steps=200)
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adamw(schedule, weight_decay=0.01))
    state, update = tx.init(params), jax.jit(tx.update)  # compiled once, not op by op
    for _ in range(3):
        upd, state = update(grads_ref, state, params)
        params = optax.apply_updates(params, upd)
    _, _, tm = _models()
    opt, _ = train_eval_pc_ar.build_optimizer_and_schedule(tm, lr, steps)
    flat = convert_params(grads_ref)
    for _ in range(3):
        for name, p in tm.named_parameters():
            p.grad = flat[name].clone()
        opt.step()
    want = convert_params(jax.tree.map(np.asarray, params))
    step_lr = float(schedule(2))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-6 + 1e-3 * step_lr, rtol=0, err_msg=name)


def test_script_main_on_the_cpu(tmp_path, monkeypatch):
    """The script's main at a tiny size (2 steps, the sweep over 4 prompts
    at 3 AR x 2 steps): the stats read from --stats, the results written
    to --out; its defaults are the JAX script's."""
    defaults = train_eval_pc_ar.parse_args([])
    assert (defaults.arch, defaults.max_points, defaults.patch_size, defaults.batch_size,
            defaults.max_steps, defaults.lr, defaults.stats, defaults.out) == (
        "pc_d8w768", 1024, 16, 32, 4000, 2e-4, "output/pc_r2/stats.json",
        "results/pc_ar_quality_r2.json")
    monkeypatch.setattr(train_eval_pc_ar, "EVAL_SHAPES", 4)
    monkeypatch.setattr(train_eval_pc_ar, "EVAL_AR_STEPS", 3)
    monkeypatch.setattr(train_eval_pc_ar, "EVAL_DIFF_STEPS", 2)
    stats = tmp_path / "stats.json"
    GlobalNormalizer().fit([s["points"] for s in make_synthetic_clouds(8, 64, 0)]).save(str(stats))
    out = tmp_path / "res" / "quality.json"
    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
    res = train_eval_pc_ar.main(["--arch", "pc_d2w64", "--max-points", "64", "--patch-size", "8",
                                 "--batch-size", "2", "--max-steps", "2", "--stats", str(stats),
                                 "--out", str(out)], device="cpu")
    assert out.exists() and res["steps"] == 2 and res["mode"] == "masked_ar"
    assert [r["guidance_scale"] for r in res["sweep"]] == [1.0, 2.0, 3.0, 5.0]
    assert all(np.isfinite([r["chamfer"], r["emd"]]).all() for r in res["sweep"])
    assert not any(LAUNCHES.values())
    # the training stream is Morton-sorted
    batch = next(train_eval_pc_ar.train_batches(
        make_synthetic_clouds(4, 64, 0), GlobalNormalizer.load(str(stats)),
        train_eval_pc_ar.DummyTextEncoder(256, 16), 2, 64, 0, torch.device("cpu")))
    codes = train_eval_pc_ar.morton_sort.__globals__["morton_codes"](batch["points"])
    assert bool((codes[:, 1:] >= codes[:, :-1]).all())
