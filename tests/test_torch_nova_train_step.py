"""One NOVA t2i training step of the port vs the JAX package on the CPU: a
tiny NOVA (vit_d2w64 x2, mlp_d2w64, 8x8x4 latents, batch 2) with
``attn_impl="pallas"`` on both sides, so every attention layer is the flash
kernel forward and backward (Pallas interpret mode in JAX, the plain
versions in the port). The JAX params go to the port through
``convert_params``, which also names the JAX gradient tree's leaves; the JAX
step's random draws (latent eps, prompt drop, mask, timesteps, noise) are
read out of its traced loss and handed to the port (threefry and Philox
streams never match).

Tolerances: the loss within 1e-5 relative; every gradient within 1e-4
relative L2 (f32 sums in another order through two ViTs and the head);
one Trainer step's parameters within 1e-6 of the parameter's scale or
1e-3 lr, whichever is larger (Adam's first step is ~lr * sign(g): an
element whose gradient is at the f32 noise of its neighbours' takes a step
that noise decides). The bf16-compute model (f32 master weights) is held
to the JAX bf16 run's own distance from the f32 run, as
tests/test_torch_nova.py does. Measured: loss 8e-8, gradients <= 1.6e-6;
bf16 gradients 2.2e-5 from f32 against the JAX run's 2.4e-5.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nova_pointcloud_tpu.engine.lr_schedules import constant_lr as jconstant_lr
from nova_pointcloud_tpu.engine.optim import build_optimizer as jbuild_optimizer
from nova_pointcloud_tpu.models.nova import NOVATransformer as JNOVA
from nova_pointcloud_tpu.pipelines.builder import init_transformer
from nova_pointcloud_tpu.pipelines.train_nova import NOVATrainT2IPipeline as JPipe
from nova_pointcloud_tpu.pipelines.train_nova import T2I_FROZEN, apply_freeze
from nova_pointcloud_tpu.schedulers import flow_match as jfm
from nova_pointcloud_tpu_torch.engine.lr_schedules import constant_lr
from nova_pointcloud_tpu_torch.engine.optim import build_optimizer
from nova_pointcloud_tpu_torch.models.convert import convert_params
from nova_pointcloud_tpu_torch.models.nova import NOVATransformer as TNOVA
from nova_pointcloud_tpu_torch.ops.kernels import LAUNCHES
from nova_pointcloud_tpu_torch.ops.kernels import flash_attention as tfa
from nova_pointcloud_tpu_torch.pipelines.train_nova import NOVATrainT2IPipeline, freeze_mask
from nova_pointcloud_tpu_torch.schedulers.flow_match import FlowMatchEulerScheduler

TINY = dict(arch=("vit_d2w64", "vit_d2w64", "mlp_d2w64"), image_dim=4, image_base_size=(4, 4),
            video_base_size=(1, 2, 2), patch_size=2, text_token_dim=16, text_token_len=4,
            attn_impl="pallas")
OPT = dict(weight_decay=0.02, betas=(0.9, 0.95), grad_clip=1.0)
LR = 1e-3

_CAP = {}


class _CapturingScheduler(jfm.FlowMatchEulerScheduler):
    """The JAX scheduler, recording its training draws while traced."""

    def sample_timesteps(self, key, shape):
        t = super().sample_timesteps(key, shape)
        _CAP["timesteps"] = t
        return t

    def add_noise(self, x0, noise, t):
        _CAP["noise"] = noise
        return super().add_noise(x0, noise, t)


def _intercept(next_fun, args, kwargs, context):
    out = next_fun(*args, **kwargs)
    if context.method_name == "encode_image_step":
        _CAP["mask"] = args[1]
    if context.method_name == "drop_prompts":
        _CAP["dropped"] = out
    return out


def _batch():
    rng = np.random.default_rng(0)
    lat = (2, 8, 8, 4)
    return {"moments": np.concatenate([rng.standard_normal(lat) * 0.8, np.full(lat, -6.0)],
                                      -1).astype(np.float16),
            "text_embeds": rng.standard_normal((2, 4, 16)).astype(np.float32)}


def _jax_pipe(params, bf16=False):
    jm = JNOVA(**TINY, noise_scheduler=_CapturingScheduler(),
               dtype=jnp.bfloat16 if bf16 else None)
    opt = jbuild_optimizer(params, jconstant_lr(LR), **OPT)
    return JPipe(jm, params, optimizer=opt, output_dir=None, ema_decay=None, resume=False)


def _jax_value_and_grad(pipe, params, batch, key):
    def loss_and_draws(p, b, k):
        _CAP.clear()
        with nn.intercept_methods(_intercept):
            total, _ = pipe.loss_fn(p, b, k)
        return total, dict(_CAP)

    with pltpu.force_tpu_interpret_mode():
        (loss, draws), grads = jax.jit(jax.value_and_grad(loss_and_draws, has_aux=True))(
            params, batch, key)
    return float(loss), jax.tree.map(np.asarray, draws), jax.tree.map(np.asarray, grads)


@functools.lru_cache(maxsize=None)
def _reference():
    """The JAX side, computed once: params, the first Trainer step's key and
    draws, the f32 and bf16-compute losses and gradients, and the params
    after one JAX Trainer step (seed 0, one batch). That step is the JAX
    Trainer's ``_plain_step``: the gradients above (its loss at its first
    step key) through the pipeline's optimizer (``apply_freeze`` over
    ``build_optimizer``) and ``optax.apply_updates``."""
    rng = np.random.default_rng(1)
    jm = JNOVA(**TINY, noise_scheduler=jfm.FlowMatchEulerScheduler())
    params = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.05).astype(np.float32)
                          if not np.any(a) else np.array(a, np.float32),
                          jax.tree.map(np.asarray, init_transformer(jm, seed=0)))
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    _, step_key = jax.random.split(jax.random.PRNGKey(0))  # the Trainer's first step key
    pipe = _jax_pipe(params)
    loss, draws, grads = _jax_value_and_grad(pipe, params, batch, step_key)
    loss16, _, grads16 = _jax_value_and_grad(_jax_pipe(params, bf16=True), params, batch,
                                             step_key)
    tx = apply_freeze(jbuild_optimizer(params, jconstant_lr(LR), **OPT), params, T2I_FROZEN)
    updates, _ = jax.jit(tx.update)(grads, tx.init(params), params)
    stepped = jax.tree.map(np.asarray, optax.apply_updates(params, updates))
    k_lat = jax.random.split(step_key, 5)[0]
    eps = np.asarray(jax.random.normal(k_lat, _batch()["moments"].shape[:-1] + (4,),
                                       jnp.float32))
    te = _batch()["text_embeds"]
    port_draws = {"latent_eps": eps, "mask": draws["mask"], "timesteps": draws["timesteps"],
                  "noise": draws["noise"],
                  "drop": np.array([np.any(draws["dropped"][i] != te[i]) for i in range(2)])}
    return dict(params=params, loss=loss, grads=grads, loss16=loss16, grads16=grads16,
                stepped=stepped, draws={k: torch.from_numpy(np.array(v))
                                        for k, v in port_draws.items()})


def _port(remat=False, bf16=False, **pipe_kw):
    ref = _reference()
    tm = TNOVA(**TINY, noise_scheduler=FlowMatchEulerScheduler(), remat=remat,
               dtype=torch.bfloat16 if bf16 else None, device="cpu")
    tm.load_state_dict(convert_params(ref["params"]), strict=True)
    pipe = NOVATrainT2IPipeline(tm, optimizer=build_optimizer(tm, constant_lr(LR), **OPT),
                                **pipe_kw)
    return tm, pipe


def _batch_t():
    return {k: torch.from_numpy(v) for k, v in _batch().items()}


def _port_grads(tm, pipe):
    loss, _ = pipe.loss_fn(_batch_t(), None, draws=_reference()["draws"])
    loss.backward()
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for n, p in tm.named_parameters()}
    return float(loss.detach()), grads


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_draws_exercise_the_path():
    """The JAX step's draws leave tokens visible (the gather path runs) and
    hide most (mask ratio >= 0.7)."""
    draws = _reference()["draws"]
    visible = (1 - draws["mask"][..., 0]).sum(1)
    assert 0 < int(visible[0]) <= round(0.3 * 16)
    assert draws["timesteps"].shape == (8, 16) and draws["noise"].shape == (8, 16, 16)


def test_loss_and_every_gradient_match_jax(monkeypatch):
    ref = _reference()
    calls = []
    bwd = tfa.flash_attention_bwd_plain
    monkeypatch.setattr(tfa, "flash_attention_bwd_plain",
                        lambda *a: calls.append(1) or bwd(*a))
    tm, pipe = _port()
    loss, grads = _port_grads(tm, pipe)
    # 2 video-encoder + 2 image-encoder layers, each through the flash backward
    assert len(calls) == 4
    np.testing.assert_allclose(loss, ref["loss"], rtol=1e-5)
    jgrads = convert_params(ref["grads"])
    assert set(jgrads) == set(grads)
    for name, g in grads.items():
        r = jgrads[name].numpy()
        if not np.any(r):  # video_patch_embed: created at T = 1, unused
            assert not torch.any(g), name
            continue
        assert _rel_l2(g.numpy(), r) <= 1e-4, (name, _rel_l2(g.numpy(), r))
    assert not any(LAUNCHES.values())


def test_remat_gives_the_same_gradients():
    _, g0 = _port_grads(*_port(remat=False))
    _, g1 = _port_grads(*_port(remat=True))
    for name in g0:
        np.testing.assert_allclose(g1[name].numpy(), g0[name].numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=name)


def test_trainer_step_matches_jax_trainer():
    """The parameters after one Trainer step. An element whose gradient is
    below 1e-3 of its tensor's RMS sits in Adam's eps regime (clipped by
    the global norm, within ~30 eps), where the gradients' f32 noise (~1e-6
    of the RMS; the key part of each qkv bias is all noise, its exact
    gradient 0, softmax being blind to a per-row shift) moves its step: it
    is held to one step's size only."""
    ref = _reference()
    tm, pipe = _port(ema_decay=None)
    metrics = pipe.trainer.train_step(_batch_t(), draws=ref["draws"])
    np.testing.assert_allclose(float(metrics["loss"]), ref["loss"], rtol=1e-5)
    stepped = convert_params(ref["stepped"])
    before = convert_params(ref["params"])
    grads = convert_params(ref["grads"])
    frozen = {n: not t for n, t in freeze_mask(tm, ("text_embed/norm", "video_pos_embed",
                                                    "video_patch_embed")).items()}
    for name, p in tm.named_parameters():
        r, g = stepped[name].numpy(), np.abs(grads[name].numpy())
        err = np.abs(p.detach().numpy() - r)
        live = g > 1e-3 * np.sqrt(np.mean(g ** 2))
        assert np.all(err[live] <= max(1e-6 * np.abs(r).max(), 1e-3 * LR)), name
        assert np.all(err[~live] <= 2.1 * LR), name
        assert frozen[name] == bool(torch.equal(p.detach(), before[name])), name


def test_bf16_compute_held_to_jax_bf16_distance():
    """bf16 compute on f32 master weights: the gradients (one vector) and
    the loss against the JAX bf16 run's distance from the f32 run."""
    ref = _reference()
    tm, pipe = _port(bf16=True)
    loss, grads = _port_grads(tm, pipe)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    j32, j16 = convert_params(ref["grads"]), convert_params(ref["grads16"])
    names = sorted(grads)
    got = np.concatenate([grads[n].numpy().ravel() for n in names])
    r32 = np.concatenate([j32[n].numpy().ravel() for n in names])
    r16 = np.concatenate([j16[n].numpy().ravel() for n in names])
    noise = np.abs(r16 - r32).mean()
    assert noise > 0 and np.isfinite(got).all()
    assert np.abs(got - r32).mean() <= 1.25 * noise, (np.abs(got - r32).mean(), noise)
    assert np.abs(got - r16).mean() <= 2 * noise, (np.abs(got - r16).mean(), noise)
    lnoise = abs(ref["loss16"] - ref["loss"])
    assert abs(loss - ref["loss"]) <= 1.25 * lnoise + 1e-6


def test_pipeline_trains_three_steps():
    """NOVATrainT2IPipeline.train(data, 3) with remat: a finite loss, the
    frozen parameters unmoved, every other one moved, the EMA shadow
    updated."""
    tm, pipe = _port(remat=True, log_every=1, ema_decay=0.9, ema_every=1)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    out = pipe.train(iter([_batch_t()] * 3), 3)
    assert pipe.trainer.step == 3 and np.isfinite(out["loss"])
    trainable = freeze_mask(tm, ("text_embed/norm", "video_pos_embed", "video_patch_embed"))
    assert sum(not t for t in trainable.values()) == 10
    for n, p in tm.named_parameters():
        assert trainable[n] != bool(torch.equal(p.detach(), before[n])), n
    ema = pipe.trainer.ema.params
    assert not torch.equal(ema["image_decoder.head.weight"], before["image_decoder.head.weight"])
    assert not any(LAUNCHES.values())


@pytest.mark.parametrize("kw", [dict(mesh=object()), dict(offload_opt_state=True),
                                dict(zero3=True), dict(output_dir="ckpt")])
def test_unported_trainer_options_raise(kw, tmp_path):
    """The mesh, offload and ZeRO-3 options raise; ``output_dir`` is ported
    (engine/checkpoint.py): a checkpoint saved at step 1 resumes a fresh
    trainer at step 1 with the same parameters and optimizer count."""
    if "output_dir" not in kw:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _port(**kw)
        return
    out = str(tmp_path / kw["output_dir"])
    tm, pipe = _port(output_dir=out, log_every=1, save_every=1, ema_decay=None)
    pipe.train(iter([_batch_t()]), 1)
    assert (tmp_path / "ckpt" / "checkpoints" / "checkpoint-1" / "state.pt").exists()
    tm2, pipe2 = _port(output_dir=out, ema_decay=None)
    assert pipe2.trainer.step == 1 and pipe2.trainer.optimizer.count == 1
    for (n, a), (_, b) in zip(tm.named_parameters(), tm2.named_parameters()):
        assert torch.equal(a, b), n
