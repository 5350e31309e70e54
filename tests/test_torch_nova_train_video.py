"""NOVA training beyond t2i, the port vs the JAX package on the CPU: one
t2v step (a tiny RoPE NOVA with the rank-8 AdaLN mixer and the motion
tokens: vit_d2w64 x2, mlp_d2w64, 3 frames of 8x8x4 latents, batch 2), one
c2i step on the DDPM scheduler (10 classes, batch 4), gradient accumulation
against ``optax.MultiSteps``, the latents from a VAE's ``scale`` or a
``latents`` key, and the t2v freeze mask.

The models run under ``attn_impl="auto"``, where every attention of both
sides is the plain core on the CPU (the video encoder's block-causal bias is
2-D: the JAX dispatcher never sends it to its kernel, and
``attn_impl="pallas"`` refuses it in both packages). The JAX params go to
the port through ``convert_params``; the JAX step's draws (prompt drop,
label drop, mask, timesteps, noise) are read out of its traced loss by a
capturing scheduler subclass and ``flax.linen.intercept_methods``, the
latent eps drawn in the same compiled step from the loss's own split of the
key, and all handed to the port's ``draws=`` (threefry and Philox streams
never match). The step keys are the first of ``fold_in(PRNGKey(0), i)`` whose
draws drop one prompt (t2v) or one label (c2i) of the batch, so the drops
are exercised. The JAX side is computed once per module.

Tolerances: the losses (t2v: ``loss_t2i`` and ``loss_i2i`` each) within
1e-5 relative; every gradient within 1e-4 relative L2 (f32 sums in another
order through two ViTs and the head); one Trainer step's parameters within
the t2i step test's bound (tests/test_torch_nova_train_step.py: 1e-6 of the
parameter's scale or 1e-3 lr, elements in Adam's eps regime one step's
size); the reference step is the JAX pipeline's optimizer (freeze rule
included) applied to the JAX gradients, which is the JAX Trainer's
``_plain_step``. Accumulation within 1e-6 of the parameters' scale (f32
arithmetic in another order); a resume mid-accumulation bitwise; the
latents within 1e-6 relative (f32 rounding); masks exact.
"""

import functools
import io

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nova_pointcloud_tpu.engine import lr_schedules as jlr
from nova_pointcloud_tpu.engine import optim as joptim
from nova_pointcloud_tpu.models import embeddings as jemb
from nova_pointcloud_tpu.models.autoencoders.autoencoder_kl import AutoencoderKL as JVAE
from nova_pointcloud_tpu.models.nova import NOVATransformer as JNOVA
from nova_pointcloud_tpu.pipelines import train_nova as jtrain
from nova_pointcloud_tpu.pipelines.builder import init_transformer
from nova_pointcloud_tpu.schedulers import ddpm as jddpm
from nova_pointcloud_tpu.schedulers import flow_match as jfm
from nova_pointcloud_tpu_torch.engine import lr_schedules as tlr
from nova_pointcloud_tpu_torch.engine import optim as toptim
from nova_pointcloud_tpu_torch.engine.trainer import Trainer
from nova_pointcloud_tpu_torch.models.autoencoders import AutoencoderKL as TVAE
from nova_pointcloud_tpu_torch.models.convert import convert_params, jax_param_paths
from nova_pointcloud_tpu_torch.models.nova import NOVATransformer as TNOVA
from nova_pointcloud_tpu_torch.ops.kernels import LAUNCHES
from nova_pointcloud_tpu_torch.ops.kernels import flash_attention as tfa
from nova_pointcloud_tpu_torch.pipelines import train_nova as ttrain
from nova_pointcloud_tpu_torch.schedulers.ddpm import DDPMScheduler
from nova_pointcloud_tpu_torch.schedulers.flow_match import FlowMatchEulerScheduler

ARCH = ("vit_d2w64", "vit_d2w64", "mlp_d2w64")
T2V = dict(arch=ARCH, image_dim=4, image_base_size=(4, 4), video_base_size=(3, 2, 2),
           patch_size=2, text_token_dim=16, text_token_len=4, rotary_pos_embed=True,
           video_mixer_rank=8)
C2I = dict(arch=ARCH, image_dim=4, image_base_size=(4, 4), video_base_size=(1, 2, 2),
           patch_size=2, num_classes=10)
OPT = dict(weight_decay=0.02, betas=(0.9, 0.95), grad_clip=1.0)
LR = 1e-3
B_T2V, FRAMES, B_C2I = 2, 3, 4

_CAP = {}


class _CapturingFM(jfm.FlowMatchEulerScheduler):
    """The JAX flow-matching scheduler, recording its training draws."""

    def sample_timesteps(self, key, shape):
        t = super().sample_timesteps(key, shape)
        _CAP["timesteps"] = t
        return t

    def add_noise(self, x0, noise, t):
        _CAP["noise"] = noise
        return super().add_noise(x0, noise, t)


class _CapturingDDPM(jddpm.DDPMScheduler):
    """The JAX DDPM scheduler, recording its training draws."""

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
    if isinstance(context.module, jemb.LabelEmbed) and len(args) > 1 and args[1] is not None:
        ids = args[0][:, None] if args[0].ndim == 1 else args[0]
        _CAP["label_drop"] = jax.random.uniform(args[1], ids.shape) <= context.module.dropout
    return out


def _params(jm, seed):
    """The JAX model's param tree (from ``jax.eval_shape`` of its init, as
    init_transformer calls it) filled with seeded values: N(0, 0.05^2), the
    LayerNorm scales 1 + N(0, 0.05^2); nothing zero (biases, AdaLN and mixer
    projections, the motion embed's biases all live)."""
    t = jm.video_base_size[0]
    x = jnp.zeros((1, t) + tuple(jm.latent_hw) + (jm.image_dim,))
    kw = ({"text_embeds": jnp.zeros((1, jm.text_token_len, jm.text_token_dim))}
          if jm.text_token_dim else {"labels": jnp.zeros((1,), jnp.int32)})
    rngs = {n: jax.random.PRNGKey(i) for i, n in
            enumerate(("params", "mask", "time", "noise", "dropout"))}
    shapes = jax.eval_shape(lambda r: jm.init(r, x, **kw), rngs)["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        v = (rng.standard_normal(leaf.shape) * 0.05).astype(np.float32)
        return v + np.float32(1.0) if path[-1].key == "scale" else v

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _moments(rng, lat):
    return np.concatenate([rng.standard_normal(lat) * 0.8, np.full(lat, -6.0)],
                          -1).astype(np.float16)


def _t2v_batch():
    rng = np.random.default_rng(0)
    return {"moments": _moments(rng, (B_T2V, FRAMES, 8, 8, 4)),
            "text_embeds": rng.standard_normal((B_T2V, 4, 16)).astype(np.float32),
            "motion_flow": np.array([5.0, 3.0], np.float32),
            "fps": np.array([12.0, 8.0], np.float32)}


def _c2i_batch():
    rng = np.random.default_rng(1)
    return {"moments": _moments(rng, (B_C2I, 8, 8, 4)),
            "labels": np.array([3, 7, 1, 9], np.int32)}


def _jax_step(pipe, params, batch, drops, tx=None):
    """The JAX loss, its draws and gradients (and, with ``tx``, the
    parameters after ``tx``'s update: the JAX Trainer's ``_plain_step``),
    compiled once (at XLA's backend optimization level 0: it compiles in
    about half the time), at the first step key fold_in(PRNGKey(0), i) whose
    captured draws drop some but not all of the batch (``drops(draws)``).
    The draws include the latents' normal draw, from the loss's own split
    of the key (``loss_fn``: the first of five, ``DiagonalGaussian.sample``
    over the moments' mean)."""
    def step(p, b, k):
        def loss_and_draws(p):
            _CAP.clear()
            with nn.intercept_methods(_intercept):
                total, losses = pipe.loss_fn(p, b, k)
            return total, (losses, dict(_CAP))

        (_, (losses, draws)), grads = jax.value_and_grad(loss_and_draws, has_aux=True)(p)
        m = b["moments"]
        draws["latent_eps"] = jax.random.normal(jax.random.split(k, 5)[0],
                                                m.shape[:-1] + (m.shape[-1] // 2,), jnp.float32)
        stepped = None
        if tx is not None:
            updates, _ = tx.update(grads, tx.init(p), p)
            stepped = optax.apply_updates(p, updates)
        return (losses, draws), grads, stepped

    step = jax.jit(step).lower(params, batch, jax.random.PRNGKey(0)).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    for i in range(64):
        key = jax.random.fold_in(jax.random.PRNGKey(0), i)
        (losses, draws), grads, stepped = jax.tree.map(np.asarray, step(params, batch, key))
        d = drops(draws)
        if 0 < d.sum() < d.size:
            return key, {k: float(v) for k, v in losses.items()}, draws, grads, stepped
    raise AssertionError("no step key drops part of the batch")


def _jax_pipe(cls, jm, vae=None):
    """A JAX training pipeline holding what its ``loss_fn`` and
    ``prepare_latents`` read (the model, the VAE): a whole one would build
    and compile a Trainer."""
    pipe = cls.__new__(cls)
    pipe.model, pipe.vae = jm, vae
    return pipe


def _jax_optimizer(params, frozen):
    return jtrain.apply_freeze(joptim.build_optimizer(params, jlr.constant_lr(LR), **OPT),
                               params, frozen)


@functools.lru_cache(maxsize=None)
def _t2v_reference():
    """The JAX t2v side, once: params, the step key's draws, losses and
    gradients, and the parameters after the pipeline's optimizer's step."""
    jm = JNOVA(**T2V, noise_scheduler=_CapturingFM())
    params = _params(jm, 1)
    batch = {k: jnp.asarray(v) for k, v in _t2v_batch().items()}
    pipe = _jax_pipe(jtrain.NOVATrainT2VPipeline, jm)
    te = _t2v_batch()["text_embeds"]

    def drops(d):
        return np.array([np.any(d["dropped"][i] != te[i]) for i in range(B_T2V)])

    _, losses, draws, grads, stepped = _jax_step(
        pipe, params, batch, drops, _jax_optimizer(params, jtrain.T2V_FROZEN))
    port = {"latent_eps": draws["latent_eps"], "mask": draws["mask"],
            "timesteps": draws["timesteps"], "noise": draws["noise"], "drop": drops(draws)}
    return dict(params=params, losses=losses, grads=grads, stepped=stepped,
                draws={k: torch.from_numpy(np.array(v)) for k, v in port.items()})


@functools.lru_cache(maxsize=None)
def _c2i_reference():
    """The JAX c2i side on DDPM, once: params, draws, loss and gradients."""
    jm = JNOVA(**C2I, noise_scheduler=_CapturingDDPM())
    params = _params(jm, 3)
    batch = {k: jnp.asarray(v) for k, v in _c2i_batch().items()}
    pipe = _jax_pipe(jtrain.NOVATrainC2IPipeline, jm)
    _, losses, draws, grads, _ = _jax_step(pipe, params, batch, lambda d: d["label_drop"])
    port = {"latent_eps": draws["latent_eps"], "mask": draws["mask"],
            "timesteps": draws["timesteps"], "noise": draws["noise"],
            "label_drop": draws["label_drop"]}
    return dict(params=params, losses=losses, grads=grads,
                draws={k: torch.from_numpy(np.array(v)) for k, v in port.items()})


def _port_t2v(**pipe_kw):
    tm = TNOVA(**T2V, noise_scheduler=FlowMatchEulerScheduler(), device="cpu")
    tm.load_state_dict(convert_params(_t2v_reference()["params"]), strict=True)
    opt = toptim.build_optimizer(tm, tlr.constant_lr(LR), **OPT)
    return tm, ttrain.NOVATrainT2VPipeline(tm, optimizer=opt, **pipe_kw)


def _batch_t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_grads(tm, pipe, batch, draws):
    total, losses = pipe.loss_fn(batch, None, draws=draws)
    total.backward()
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for n, p in tm.named_parameters()}
    return {k: float(v.detach()) for k, v in losses.items()}, grads


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _assert_grads(grads, jax_grads, unused=()):
    """Every gradient within 1e-4 relative L2 of JAX's; the ``unused``
    parameters' exactly 0 on both sides, every other one's nonzero."""
    ref = convert_params(jax_grads)
    assert set(ref) == set(grads)
    for name, g in grads.items():
        r = ref[name].numpy()
        if any(name.startswith(u) for u in unused):
            assert not np.any(r) and not torch.any(g), name
            continue
        assert np.any(r), name
        assert _rel_l2(g.numpy(), r) <= 1e-4, (name, _rel_l2(g.numpy(), r))


def test_t2v_draws_exercise_the_path():
    """The t2v draws: one of the two prompts dropped, tokens visible in
    every frame (the gather runs) and most hidden, the per-frame shapes."""
    d = _t2v_reference()["draws"]
    assert int(d["drop"].sum()) == 1
    visible = (1 - d["mask"][..., 0]).sum(1)
    assert d["mask"].shape == (B_T2V * FRAMES, 16, 1)
    assert bool(((visible > 0) & (visible <= round(0.3 * 16))).all())
    assert d["timesteps"].shape == (4 * B_T2V * FRAMES, 16)
    assert d["noise"].shape == (4 * B_T2V * FRAMES, 16, 16)


def test_t2v_loss_and_every_gradient_match_jax(monkeypatch):
    """loss_t2i and loss_i2i each within 1e-5, every gradient within 1e-4
    relative L2; every attention on the plain core (none on the flash
    route), no launch."""
    ref = _t2v_reference()
    monkeypatch.setattr(tfa, "flash_attention_plain", None)  # must not run
    tm, pipe = _port_t2v()
    losses, grads = _port_grads(tm, pipe, _batch_t(_t2v_batch()), ref["draws"])
    assert set(losses) == set(ref["losses"]) == {"loss_t2i", "loss_i2i"}
    for k, v in losses.items():
        np.testing.assert_allclose(v, ref["losses"][k], rtol=1e-5, err_msg=k)
    _assert_grads(grads, ref["grads"])
    assert not any(LAUNCHES.values())


def test_t2v_trainer_step_matches_jax():
    """The parameters after one Trainer step, as the t2i step test holds
    them; the text embed's norm (T2V_FROZEN) unmoved, everything else
    moved."""
    ref = _t2v_reference()
    tm, pipe = _port_t2v(ema_decay=None)
    metrics = pipe.trainer.train_step(_batch_t(_t2v_batch()), draws=ref["draws"])
    np.testing.assert_allclose(float(metrics["loss"]), sum(ref["losses"].values()), rtol=1e-5)
    stepped, before = convert_params(ref["stepped"]), convert_params(ref["params"])
    grads = convert_params(ref["grads"])
    frozen = {n: not t for n, t in ttrain.freeze_mask(tm, ttrain.T2V_FROZEN).items()}
    assert sum(frozen.values()) == 2
    for name, p in tm.named_parameters():
        r, g = stepped[name].numpy(), np.abs(grads[name].numpy())
        err = np.abs(p.detach().numpy() - r)
        live = g > 1e-3 * np.sqrt(np.mean(g ** 2))
        assert np.all(err[live] <= max(1e-6 * np.abs(r).max(), 1e-3 * LR)), name
        assert np.all(err[~live] <= 2.1 * LR), name
        assert frozen[name] == bool(torch.equal(p.detach(), before[name])), name


def test_c2i_ddpm_loss_and_every_gradient_match_jax():
    """c2i on the DDPM scheduler (x_t alone, the noise the target, the
    integer timestep to the head): one label of four dropped to the null
    class by the JAX draw; the loss within 1e-5, every gradient within 1e-4
    relative L2."""
    ref = _c2i_reference()
    assert int(ref["draws"]["label_drop"].sum()) == 1
    tm = TNOVA(**C2I, noise_scheduler=DDPMScheduler(), device="cpu")
    tm.load_state_dict(convert_params(ref["params"]), strict=True)
    pipe = ttrain.NOVATrainC2IPipeline(tm, ema_decay=None)
    assert not any(not t for t in ttrain.freeze_mask(tm, pipe.frozen).values())
    losses, grads = _port_grads(tm, pipe, _batch_t(_c2i_batch()), ref["draws"])
    assert set(losses) == {"loss"}
    np.testing.assert_allclose(losses["loss"], ref["losses"]["loss"], rtol=1e-5)
    _assert_grads(grads, ref["grads"], unused=("video_patch_embed.",))  # created at T = 1


def test_label_drop_matches_jax():
    """LabelEmbed.drop_labels with the JAX module's draw sends exactly the
    drawn ids to the null class, and its rate is the JAX default."""
    ids = np.arange(40, dtype=np.int32) % 10
    jle = jemb.LabelEmbed(64, 10)

    @jax.jit  # one program, not op by op
    def jax_side(ids, key):
        v = jle.init(jax.random.PRNGKey(0), ids)
        return v, jle.apply(v, ids, key), jax.random.uniform(key, (40, 1)) <= jle.dropout

    v, ref, drop = jax.tree.map(np.asarray, jax_side(jnp.asarray(ids), jax.random.PRNGKey(5)))
    assert 0 < drop.sum() < 40
    tle = TNOVA(**C2I, device="cpu").label_embed
    with torch.no_grad():
        tle.weight.copy_(torch.from_numpy(np.asarray(v["params"]["weight"])))
    got = tle.drop_labels(torch.from_numpy(ids), drop=torch.from_numpy(drop))
    assert torch.equal(got[:, 0], torch.from_numpy(np.where(drop[:, 0], 10, ids)))
    np.testing.assert_allclose(tle(got).detach().numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    assert tle.dropout == jle.dropout


def test_pallas_route_refuses_the_block_causal_bias(monkeypatch):
    """attn_impl="pallas" with T > 1: the JAX model cannot even be set up
    (its flash kernel takes 4-D biases only), and the port raises the same
    ValueError at the video encoder's first attention, before any kernel or
    its plain version runs."""
    with pytest.raises(ValueError, match="bias must be 4D"):
        init_transformer(JNOVA(**T2V, attn_impl="pallas",
                               noise_scheduler=jfm.FlowMatchEulerScheduler()), seed=0)
    calls = []
    plain = tfa.flash_attention_plain
    monkeypatch.setattr(tfa, "flash_attention_plain", lambda *a: calls.append(1) or plain(*a))
    tm = TNOVA(**T2V, attn_impl="pallas", noise_scheduler=FlowMatchEulerScheduler(),
               device="cpu")
    tm.load_state_dict(convert_params(_t2v_reference()["params"]), strict=True)
    pipe = ttrain.NOVATrainT2VPipeline(tm, ema_decay=None)
    with pytest.raises(ValueError, match="bias must be 4D"):
        pipe.loss_fn(_batch_t(_t2v_batch()), torch.Generator().manual_seed(0))
    assert not calls and not any(LAUNCHES.values())


@pytest.mark.parametrize("k", [2, 3])
def test_accumulation_matches_optax_multisteps(k):
    """build_optimizer(accum_steps=k) + the t2v freeze on the tiny t2v model
    over 6 calls (clip 1.0, a cosine schedule with warm-up) against the JAX
    build_optimizer's optax.MultiSteps + apply_freeze on the same gradients:
    the parameters after every call within 1e-6 of their scale, unmoved on
    the calls between updates; the schedule counts the updates. Every rule
    of the chain is per element but the global norm, so the JAX tree holds
    the port's parameters concatenated by rule: decayed (a rank-2 leaf),
    not decayed (rank 1, "norm" in the path) and frozen (the text embed's
    norm); the clip's norm runs over the same elements."""
    tm = TNOVA(**T2V, device="cpu")
    tm.load_state_dict(convert_params(_t2v_reference()["params"]), strict=True)
    named = dict(tm.named_parameters())
    trainable = ttrain.freeze_mask(tm, ttrain.T2V_FROZEN)
    decay = toptim.decay_mask(tm)
    group = {n: ("frozen" if not trainable[n] else "decay" if decay[n] else "plain")
             for n in named}
    layout = {"decay": ("decay", (-1, 1)), "plain": ("norm", (-1,)),
              "frozen": ("text_embed/norm", (-1,))}

    def tree(values):
        out = {}
        for g, (path, shape) in layout.items():
            leaf = np.concatenate([values[n].reshape(-1) for n in named if group[n] == g])
            node = out
            for part in path.split("/")[:-1]:
                node = node.setdefault(part, {})
            node[path.split("/")[-1]] = leaf.reshape(shape)
        return out

    def leaf(t, g):
        node = t
        for part in layout[g][0].split("/"):
            node = node[part]
        return np.asarray(node).reshape(-1)

    params = tree({n: p.detach().numpy() for n, p in named.items()})
    kw = dict(weight_decay=0.02, betas=(0.9, 0.95), grad_clip=1.0, accum_steps=k)
    tx = jtrain.apply_freeze(joptim.build_optimizer(
        params, jlr.cosine_lr(1e-3, 4, lr_min=1e-5, warmup_steps=1), **kw), params,
        jtrain.T2V_FROZEN)
    jdecay = joptim.decay_mask(params)
    assert jdecay["decay"] and not jdecay["norm"] and not jdecay["text_embed"]["norm"]
    opt = ttrain.apply_freeze(toptim.build_optimizer(
        tm, tlr.cosine_lr(1e-3, 4, lr_min=1e-5, warmup_steps=1), **kw), tm, ttrain.T2V_FROZEN)
    update = jax.jit(tx.update)
    state, jp = tx.init(params), params
    rng = np.random.default_rng(8)
    for call in range(6):
        grads = {n: rng.standard_normal(p.shape).astype(np.float32) for n, p in named.items()}
        updates, state = update(tree(grads), state, jp)
        jp = optax.apply_updates(jp, updates)
        before = {n: p.detach().clone() for n, p in named.items()}
        for name, p in named.items():
            p.grad = torch.from_numpy(grads[name])
        opt.step()
        emits = (call + 1) % k == 0
        assert opt.count == (call + 1) // k and opt.mini_step == (call + 1) % k
        got = tree({n: p.detach().numpy() for n, p in named.items()})
        for g in layout:
            r = leaf(jp, g)
            np.testing.assert_allclose(leaf(got, g), r, rtol=0,
                                       atol=1e-6 * max(np.abs(r).max(), 1e-3),
                                       err_msg=f"{g} call {call}")
        for name, p in named.items():
            assert emits and trainable[name] or torch.equal(p.detach(), before[name]), name


def test_resume_mid_accumulation_continues_bitwise(tmp_path):
    """A Trainer over AdamW with accum_steps 2 (a small linear model, each
    call's data drawn from the trainer's generator) saved after call 1
    (mini-step 1 of 2) and resumed in a fresh one continues bitwise: the
    parameters, the optimizer's count, mini-step and running mean and the
    EMA after call 2 (the update) equal the uninterrupted run's; the
    parameters do not move on call 1, the trainer's step counts calls and
    the EMA updates on each."""
    w0 = torch.from_numpy(np.random.default_rng(9).standard_normal((4, 8)).astype(np.float32))
    batch = {"target": torch.ones((16, 4))}

    def make(out=None):
        model = torch.nn.Linear(8, 4)
        with torch.no_grad():
            model.weight.copy_(w0)
            model.bias.zero_()
        opt = toptim.AdamW(model.named_parameters(), tlr.constant_lr(LR), weight_decay=0.02,
                           betas=(0.9, 0.95), grad_clip=1.0, accum_steps=2,
                           decay={n: True for n, _ in model.named_parameters()})

        def loss_fn(b, generator):
            x = torch.randn((16, 8), generator=generator)
            return torch.mean((model(x) - b["target"]) ** 2), {}

        return model, Trainer(loss_fn, model, opt, output_dir=out, save_every=1, log_every=1,
                              ema_decay=0.9, ema_every=1)

    ma, a = make()
    before = {n: p.detach().clone() for n, p in ma.named_parameters()}
    a.train(iter([batch]), 1)
    assert all(torch.equal(p, before[n]) for n, p in ma.named_parameters())
    ema1 = {n: e.clone() for n, e in a.ema.params.items()}
    a.train(iter([batch]), 2)
    out = str(tmp_path / "ckpt")
    _, b = make(out)
    b.train(iter([batch]), 1)
    assert b.optimizer.mini_step == 1 and b.optimizer.count == 0
    assert any(bool(torch.any(x != 0)) for x in b.optimizer.acc)
    mc, c = make(out)
    assert c.step == 1 and c.optimizer.mini_step == 1
    c.train(iter([batch]), 2)
    oa, oc = a.optimizer, c.optimizer
    assert (oa.count, oa.mini_step, a.step) == (oc.count, oc.mini_step, c.step) == (1, 0, 2)
    assert all(torch.equal(x, y) for x, y in zip(oa.acc, oc.acc))
    assert not torch.equal(a.ema.params["weight"], ema1["weight"])  # the update reached it
    for (n, x), (_, y) in zip(ma.named_parameters(), mc.named_parameters()):
        assert not torch.equal(x, before[n]) and torch.equal(x, y), n
    for n, e in a.ema.params.items():
        assert torch.equal(e, c.ema.params[n]), n
    buf = io.BytesIO()
    torch.save(oc.state_dict(), buf)
    assert buf.tell() > 0


@pytest.mark.parametrize("case", ["vae_scale", "latents_key"])
def test_prepare_latents_matches_jax(case):
    """prepare_latents with a VAE's scale (shift and scaling factor) on
    sampled moments, and with a ``latents`` key (used as given), against
    the JAX pipeline's, to f32 rounding."""
    batch = _t2v_batch()
    key = jax.random.PRNGKey(11)
    if case == "latents_key":
        batch = dict(batch, latents=np.random.default_rng(4).standard_normal(
            (B_T2V, FRAMES, 8, 8, 4)).astype(np.float32))
    jvae = JVAE(block_out_channels=(32, 64), latent_channels=4, layers_per_block=1,
                scaling_factor=0.13025, shift_factor=0.1)
    jpipe = _jax_pipe(jtrain.NOVATrainT2VPipeline, None, jvae)
    want = np.asarray(jax.jit(jpipe.prepare_latents)(
        {k: jnp.asarray(v) for k, v in batch.items()}, key))
    tvae = TVAE(block_out_channels=(32, 64), latent_channels=4, layers_per_block=1,
                scaling_factor=0.13025, shift_factor=0.1, device="cpu")
    tm = TNOVA(**T2V, noise_scheduler=FlowMatchEulerScheduler(), device="cpu")
    tpipe = ttrain.NOVATrainT2VPipeline(tm, vae=tvae, ema_decay=None)
    eps = torch.from_numpy(np.asarray(jax.random.normal(key, want.shape, jnp.float32)))
    got = tpipe.prepare_latents(_batch_t(batch), None, eps).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if case == "latents_key":
        assert np.array_equal(got, batch["latents"])


def test_t2v_freeze_mask_picks_the_jax_leaves():
    """NOVATrainT2VPipeline's rule (the text embed's norm) selects exactly
    the JAX mask's leaves on the t2v tree, mixer and motion embed included;
    every port parameter maps to one JAX leaf."""
    params = _t2v_reference()["params"]
    assert ttrain.T2V_FROZEN == jtrain.T2V_FROZEN
    assert ttrain.NOVATrainT2VPipeline.frozen == jtrain.NOVATrainT2VPipeline.frozen
    assert ttrain.NOVATrainC2IPipeline.frozen == jtrain.NOVATrainC2IPipeline.frozen == ()
    tm = TNOVA(**T2V, device="cpu")
    flat = {"/".join(getattr(k, "key", str(k)) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(jtrain.freeze_mask(params, jtrain.T2V_FROZEN))[0]}
    paths = jax_param_paths(tm)
    assert sorted(p for p, _ in paths.values()) == sorted(flat)
    got = ttrain.freeze_mask(tm, ttrain.T2V_FROZEN)
    for name, (path, _) in paths.items():
        assert got[name] == bool(flat[path]), (name, path)
    assert any(p.startswith("mixer/") for p in flat) and any("motion_embed" in p for p in flat)
