"""The t2pc training slice vs the JAX package on the CPU, at pc_d2w64 with
64 points: the training forward and its gradients, the composite loss for
each parameterization on the JAX side's draws, the optimizer chain
(per-layer clip -> adaptive lr -> AdamW) against optax, the attention
dropout's shared mask, remat with dropout, the gradient tools, the
checkpoint round trip, the evaluator, and the training / evaluation
scripts.

Random draws never match between threefry and Philox, so the JAX side's
draws are handed to the port: timesteps, noise and the partition are
recomputed from the loss's key, and the ClusterBlock's dropout mask (rate
0.1 even at ``dropout=0.0``) is read out of the JAX forward with
``flax.linen.intercept_methods``. Parity runs at ``dropout=0.0``, where
that mask is the only random one.

Tolerances, relative to each tensor's largest entry: the forward 1e-5, the
gradients 1e-4 (float32 through two blocks and the Sinkhorn loop, summed in
another order; a tensor whose gradient is 0 up to rounding against a
thousandth of the whole gradient's largest entry), the losses 1e-5, the optimizer's parameters 1e-5 after each
of three steps, the gradient tools 1e-6; remat and no remat, and a resumed
trainer's next step, bitwise.
"""

import functools
import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nova_pointcloud_tpu.engine import grad_tools as jgt
from nova_pointcloud_tpu.engine import lr_schedules as jlr
from nova_pointcloud_tpu.evaluation import pointcloud_eval as jeval
from nova_pointcloud_tpu.models.pointcloud import NOVAPointCloudTransformer as JModel
from nova_pointcloud_tpu.models.text_encoders.dummy import DummyTextEncoder as JEnc
from nova_pointcloud_tpu.ops import pointops as jpo
from nova_pointcloud_tpu.pipelines import pointcloud_train as jtrain
from nova_pointcloud_tpu.schedulers.ddpm import DDPMScheduler as JDDPM
from nova_pointcloud_tpu_torch.data.shapenet import GlobalNormalizer, make_synthetic_clouds
from nova_pointcloud_tpu_torch.engine import grad_tools as tgt
from nova_pointcloud_tpu_torch.engine import lr_schedules as tlr
from nova_pointcloud_tpu_torch.evaluation import pointcloud_eval as teval
from nova_pointcloud_tpu_torch.models.convert import convert_params, jax_param_paths
from nova_pointcloud_tpu_torch.models.pointcloud import (MultiHeadAttention, PreLNBlock,
                                                         attention_dropout_multiplier)
from nova_pointcloud_tpu_torch.models.pointcloud import NOVAPointCloudTransformer as TModel
from nova_pointcloud_tpu_torch.models.text_encoders.dummy import DummyTextEncoder as TEnc
from nova_pointcloud_tpu_torch.ops.attention import dot_product_attention
from nova_pointcloud_tpu_torch.ops.kernels import LAUNCHES
from nova_pointcloud_tpu_torch.pipelines import pointcloud_train as ttrain
from nova_pointcloud_tpu_torch.pipelines.pointcloud_gen import NOVAPointCloudGenerationPipeline
from nova_pointcloud_tpu_torch.schedulers.ddpm import DDPMScheduler as TDDPM
from nova_pointcloud_tpu_torch.scripts import eval_pc_quality, train_pointcloud

ARCH, POINTS, TOK_DIM, N_TOK, DEPTH = "pc_d2w64", 64, 32, 8, 2
PROMPTS = ["a chair", "a tall lamp"]
SCALES = {"output_proj": 0.5, "time_": 0.3}


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, ref, rtol, label=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30)
    assert err <= rtol, f"{label}: relative error {err:.3e} > {rtol:.0e}"


def _model_kw():
    return dict(arch=ARCH, point_cloud_size=POINTS, patch_size=1, text_token_dim=TOK_DIM)


@functools.lru_cache(maxsize=None)
def _jax_params(seed=0):
    """JAX params (numpy, not to be written) with seeded N(0, 0.05) noise on
    every leaf."""
    model = JModel(**_model_kw(), dropout=0.0)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((2, POINTS, 3)),
                        jnp.zeros((2,), jnp.int32), jnp.zeros((2, N_TOK, TOK_DIM)))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: (np.asarray(p) + rng.normal(0, 0.05, p.shape)).astype(np.float32), params)


def _port(params, dropout=0.0, remat=False):
    tm = TModel(**_model_kw(), dropout=dropout, remat=remat, device="cpu")
    tm.load_state_dict(convert_params(params))
    return tm


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = np.clip(rng.standard_normal((2, POINTS, 3)) * 0.5, -1, 1).astype(np.float32)
    text, _ = JEnc(TOK_DIM, N_TOK).encode(PROMPTS)
    return x, np.array([10, 700], np.int32), text


def _cluster_keep(fn):
    """Run ``fn()`` (a JAX forward, eagerly) and return the ClusterBlock
    dropout's keep mask: kept where the output is non-zero, and where the
    input is 0 (either choice gives 0 there, and relu's gradient is 0)."""
    rec = []

    def icpt(next_fun, args, kwargs, ctx):
        out = next_fun(*args, **kwargs)
        if isinstance(ctx.module, nn.Dropout) and ctx.module.rate > 0 \
                and not isinstance(out, jax.core.Tracer):
            rec.append((np.asarray(args[0]), np.asarray(out)))
        return out

    with nn.intercept_methods(icpt):
        result = fn()
    assert len(rec) == 1, len(rec)
    inp, out = rec[0]
    return result, _t((out != 0) | (inp == 0))


def _port_grads(tm):
    return {n: p.grad.detach().clone() for n, p in tm.named_parameters()}


def _check_grads(got, jgrads, rtol):
    """Each tensor relative to its largest entry, or to a thousandth of the
    whole gradient's largest entry where its own is smaller (the key
    projections' bias gradient is 0 up to rounding: softmax ignores a
    constant per query)."""
    ref = convert_params(jax.tree.map(np.asarray, jgrads))
    assert set(ref) == set(got)
    top = max(float(torch.max(torch.abs(r))) for r in ref.values())
    for n in ref:
        scale = max(float(torch.max(torch.abs(ref[n]))), 1e-3 * top)
        err = float(torch.max(torch.abs(got[n] - ref[n]))) / scale
        assert err <= rtol, f"{n}: relative error {err:.3e} > {rtol:.0e}"


# -- the training forward ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_training_forward():
    """The JAX side of the training-forward test, once a module (the port's
    remat does not change it): the dropout forward's output, its cluster
    dropout draw and the gradient of sum(out * w)."""
    params = _jax_params()
    x, t, text = _inputs()
    w = np.random.default_rng(2).standard_normal((2, POINTS, 3)).astype(np.float32)
    jm, key = JModel(**_model_kw(), dropout=0.0), jax.random.PRNGKey(3)

    def jloss(p):
        out = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(text),
                       deterministic=False, rngs={"dropout": key})
        return jnp.sum(out * w), out

    (_, jout), keep = _cluster_keep(lambda: jloss(params))
    jgrads = jax.jit(jax.grad(lambda p: jloss(p)[0]))(params)
    return jm, w, jout, keep, jgrads


@pytest.mark.parametrize("remat", [False, True])
def test_training_forward_and_gradients_match_jax(remat):
    params = _jax_params()
    x, t, text = _inputs()
    jm, w, jout, keep, jgrads = _jax_training_forward()
    tm = _port(params, remat=remat)
    masks = {"cluster": keep, "blocks": [{} for _ in range(DEPTH)]}
    out = tm(_t(x), _t(t), _t(text), deterministic=False, dropout_masks=masks)
    _rel(out, jout, 1e-5, "forward")
    torch.sum(out * _t(w)).backward()
    _check_grads(_port_grads(tm), jgrads, 1e-4)
    # serving is unchanged: no autograd, no dropout
    srv = tm(_t(x), _t(t), _t(text))
    assert not srv.requires_grad
    np.testing.assert_allclose(srv.numpy(), np.asarray(jm.apply({"params": params}, x, t, text)),
                               atol=1e-5, rtol=1e-5)


def _jax_loss_draws(key, jsched, cfg, b):
    """The JAX loss's timesteps, noise and partition, from its key."""
    k_t, k_n, k_p, _ = jax.random.split(key, 4)
    t = jsched.sample_timesteps(k_t, (b,))
    noise = jax.random.normal(k_n, (b, POINTS, 3))
    _, ids = jpo.dynamic_partition(k_p, POINTS, cfg.num_subsets)
    return dict(t=_t(t), noise=_t(noise), subset_ids=_t(ids))


@pytest.mark.parametrize("prediction_type", ["epsilon", "sample", "v_prediction"])
def test_composite_loss_matches_jax_on_its_draws(prediction_type):
    params = _jax_params()
    x, _, text = _inputs()
    batch = {"points": jnp.asarray(x), "text": jnp.asarray(text)}
    cfg = jtrain.PointCloudLossConfig(num_subsets=16)
    jsched = JDDPM(beta_schedule="squaredcos_cap_v2", prediction_type=prediction_type)
    jm, key = JModel(**_model_kw(), dropout=0.0), jax.random.PRNGKey(4)
    jfn = jtrain.make_pc_loss_fn(jm, jsched, cfg)
    (jl, jmetrics), keep = _cluster_keep(lambda: jfn(params, batch, key))
    draws = _jax_loss_draws(key, jsched, cfg, 2)

    tm = _port(params)
    tcfg = ttrain.PointCloudLossConfig(num_subsets=16)
    tfn = ttrain.make_pc_loss_fn(
        tm, TDDPM(beta_schedule="squaredcos_cap_v2", prediction_type=prediction_type), tcfg)
    masks = {"cluster": keep, "blocks": [{} for _ in range(DEPTH)]}
    loss, metrics = tfn({"points": _t(x), "text": _t(text)}, None, dropout_masks=masks, **draws)
    assert set(metrics) == set(jmetrics)
    _rel(loss, jl, 1e-5, "loss")
    for name in jmetrics:
        _rel(metrics[name], jmetrics[name], 1e-5, name)
    assert float(metrics["nonfinite_loss"]) == 0.0
    if prediction_type == "v_prediction":
        jgrads = jax.jit(jax.grad(lambda p: jfn(p, batch, key)[0]))(params)
        loss.backward()
        _check_grads(_port_grads(tm), jgrads, 1e-4)


def test_nonfinite_loss_is_guarded():
    tm = _port(_jax_params())
    tfn = ttrain.make_pc_loss_fn(tm, TDDPM(beta_schedule="squaredcos_cap_v2"))
    x, _, text = _inputs()
    x[0, 0, 0] = np.nan
    loss, metrics = tfn({"points": _t(x), "text": _t(text)}, torch.Generator().manual_seed(0))
    assert float(loss.detach()) == 0.0 and float(metrics["nonfinite_loss"]) == 1.0


# -- the optimizer chain ----------------------------------------------------------

def _grad_tree(params, step):
    """Gradients with set norms: each layer of a stacked block leaf at 0.8
    (its stack at 1.13: clipped at 1.0 only as one JAX leaf), the rest
    0.3-2.0; step 1 scaled x0.01 (under the spike threshold)."""
    rng = np.random.default_rng(10 + step)
    scale = 0.01 if step == 1 else 1.0

    def leaf(path, p):
        g = rng.standard_normal(p.shape).astype(np.float32)
        if "layers" in jax.tree_util.keystr(path):
            per = g.reshape(p.shape[0], -1)
            g = (per / np.linalg.norm(per, axis=1, keepdims=True) * 0.8).reshape(p.shape)
        else:
            g = g / np.linalg.norm(g) * rng.uniform(0.3, 2.0)
        return (g * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


@pytest.mark.parametrize("grouped", [True, False])
def test_clip_adaptive_adamw_chain_matches_optax(grouped):
    """Three steps of per_layer_clip(1.0, scales) -> adaptive_lr_on_spike(3.0)
    -> adamw(cosine, wd 0.01) against optax (the multiplier halves at steps
    0 and 2, creeps up at 1). Clipping over the port's per-layer tensors
    (no JAX paths) is not the JAX chain: it misses the stacked leaves."""
    params = _jax_params()
    jsched = jlr.cosine_lr(1e-2, 10, lr_min=1e-3, warmup_steps=2)
    jopt = optax.chain(jgt.per_layer_clip(1.0, SCALES), jgt.adaptive_lr_on_spike(3.0),
                       optax.adamw(jsched, weight_decay=0.01))
    jstate, jp = jopt.init(params), params
    jupdate = jax.jit(jopt.update)
    tm = _port(params)
    opt = ttrain.pc_adamw(tm, tlr.cosine_lr(1e-2, 10, lr_min=1e-3, warmup_steps=2), 0.01,
                          transforms=[tgt.per_layer_clip(1.0, SCALES), tgt.adaptive_lr_on_spike(3.0)])
    if not grouped:
        opt.paths = None
    mults = []
    for step in range(3):
        g = _grad_tree(params, step)
        upd, jstate = jupdate(g, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        mults.append(float(jstate[1].multiplier))
        for n, gv in convert_params(g).items():
            dict(tm.named_parameters())[n].grad = gv.clone()
        opt.step()
        assert float(opt.transforms[1].multiplier) == pytest.approx(mults[-1], rel=1e-7)
        ref = convert_params(jax.tree.map(np.asarray, jp))
        errs = {n: float(torch.max(torch.abs(p.detach() - ref[n])) / torch.max(torch.abs(ref[n])))
                for n, p in tm.named_parameters()}
        if grouped:
            assert max(errs.values()) <= 1e-5, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    assert mults == pytest.approx([0.5, 0.505, 0.2525], rel=1e-6)
    if not grouped:
        assert max(errs.values()) > 1e-3  # the blocks' per-layer tensors went unclipped


def test_pc_optimizer_decays_every_parameter():
    """optax's adamw has no mask: biases and LayerNorm parameters decay too
    (the T2I rules exempt them)."""
    tm = _port(_jax_params())
    opt = ttrain.pc_adamw(tm)
    assert all(g["weight_decay"] == 0.01 for g in opt.opt.param_groups)
    assert sum(len(g["params"]) for g in opt.opt.param_groups) == len(list(tm.parameters()))
    assert opt.betas == (0.9, 0.999) and opt.eps == 1e-8


def test_grad_stats_and_sanitize_match_jax():
    params = _jax_params()
    g = _grad_tree(params, 0)
    g["blocks"]["layers"]["block"]["fc1"]["kernel"][:, 3, 5] = np.nan  # both layers
    g["time_fc1"]["bias"][2] = np.inf
    g["output_proj"]["kernel"][0, 0] = -np.inf
    jfixed, jbad = jax.jit(jgt.sanitize_grads)(g)
    tm = _port(params)
    paths = {n: p for n, (p, _) in jax_param_paths(tm).items()}
    fixed, bad = tgt.sanitize_grads(convert_params(g), paths)
    assert int(bad) == int(jbad) == 3  # JAX leaves: the stacked fc1 kernel counts once
    _, bad_per_tensor = tgt.sanitize_grads(convert_params(g))
    assert int(bad_per_tensor) == 4
    ref = convert_params(jax.tree.map(np.asarray, jfixed))
    for n in ref:
        np.testing.assert_array_equal(fixed[n].numpy(), ref[n].numpy())
    groups = ("point_embed", "blocks", "output_proj", "time_", "cluster", "absent")
    jstats = jax.jit(functools.partial(jgt.grad_stats, groups=groups))(jfixed)
    stats = tgt.grad_stats(fixed, groups, paths)
    assert set(stats) == set(jstats) and "grad_norm/absent" not in stats
    for k in jstats:
        _rel(stats[k], jstats[k], 1e-6, k)


# -- dropout ---------------------------------------------------------------------------

def test_attention_dropout_mask_is_shared_over_batch_and_heads():
    """flax's broadcast_dropout: one (1, 1, Lq, Lk) keep mask for every batch
    element and head, the weights scaled by 1 / keep_prob; the port's core
    on JAX's mask within 1e-6 of flax's, and the mean kept (within 5
    standard errors)."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((2, 40, 4, 16)).astype(np.float32) for _ in range(3))
    key = jax.random.PRNGKey(5)
    ref = nn.dot_product_attention(q, k, v, dropout_rng=key, dropout_rate=0.1,
                                   deterministic=False, broadcast_dropout=True)
    keep = _t(jax.random.bernoulli(key, 0.9, (1, 1, 40, 40)))
    got = dot_product_attention(_t(q), _t(k), _t(v),
                                dropout_mult=attention_dropout_multiplier(keep, 0.1, torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)

    block = PreLNBlock(64, 4, device="cpu", dropout=0.1)
    drop = block.draw_dropout(torch.Generator().manual_seed(0), (3, 256, 64), "cpu")
    assert drop["attn"].shape == (1, 1, 256, 256) and drop["resid1"].shape == (3, 256, 64)
    assert drop["mlp"].shape == (3, 256, 256) and drop["resid2"].shape == (3, 256, 64)
    mult = attention_dropout_multiplier(drop["attn"], 0.1, torch.float32)
    vals = set(torch.unique(mult).tolist())
    assert vals == {0.0, float(torch.tensor(1.0) / torch.tensor(0.9))}
    n = mult.numel()
    assert abs(float(mult.mean()) - 1.0) < 5 * (0.1 / 0.9 / n) ** 0.5
    # identical batch elements and heads stay identical under the mask
    mha = MultiHeadAttention(64, 4, "cpu", "auto")
    x = torch.randn((1, 256, 64), generator=torch.Generator().manual_seed(1)).expand(3, -1, -1)
    with torch.no_grad():
        out = mha(x, dropout_mult=mult)
    assert torch.equal(out[0], out[1]) and torch.equal(out[0], out[2])
    assert not torch.allclose(out, mha(x))


def test_remat_equals_no_remat_with_dropout():
    """dropout 0.1 from one generator seed: remat=True recomputes each block
    with the same masks (a seed drawn before the block), so its gradients
    are bitwise those of remat=False; the dropout is live."""
    params = _jax_params()
    x, t, text = _inputs()
    w = _t(np.random.default_rng(2).standard_normal((2, POINTS, 3)).astype(np.float32))
    grads, outs = {}, {}
    for remat in (False, True):
        tm = _port(params, dropout=0.1, remat=remat)
        out = tm(_t(x), _t(t), _t(text), deterministic=False,
                 generator=torch.Generator().manual_seed(7))
        torch.sum(out * w).backward()
        grads[remat], outs[remat] = _port_grads(tm), out.detach()
    assert torch.equal(outs[False], outs[True])
    for n in grads[False]:
        assert torch.equal(grads[False][n], grads[True][n]), n
    with torch.no_grad():
        assert not torch.allclose(outs[False], tm(_t(x), _t(t), _t(text)))


# -- checkpoints, evaluation, scripts ----------------------------------------------

def _pc_pipe(tmp_path, init_seed, **kw):
    tm = TModel(**_model_kw(), dropout=0.1, remat=True, device="cpu")
    tm.init_weights(torch.Generator().manual_seed(init_seed))
    opt = ttrain.pc_adamw(tm, tlr.cosine_lr(1e-3, 20, lr_min=1e-4, warmup_steps=2), 0.01,
                          transforms=[tgt.per_layer_clip(1.0, SCALES), tgt.adaptive_lr_on_spike(1.0)])
    return ttrain.NOVATrainPointCloudPipeline(
        tm, text_encoder=TEnc(TOK_DIM, N_TOK), output_dir=str(tmp_path), optimizer=opt,
        loss_config=ttrain.PointCloudLossConfig(num_subsets=16), log_every=1, ema_every=2,
        seed=3, **kw)


def _pc_batch(seed=0):
    shapes = make_synthetic_clouds(2, POINTS, seed)
    return {"points": np.stack([s["points"] for s in shapes]),
            "prompts": [s["prompt"] for s in shapes]}


def test_checkpoint_save_prune_best_and_resume(tmp_path):
    batch = _pc_batch()
    a = _pc_pipe(tmp_path, 0, save_every=1)
    a.train(iter([batch] * 5), 5)
    root = tmp_path / "checkpoints"
    assert sorted(p.name for p in root.iterdir() if p.name.startswith("checkpoint-")) == \
        ["checkpoint-3", "checkpoint-4", "checkpoint-5"]
    a.trainer.save_best(0.25)
    best = a.trainer.ckpt.restore_best()
    assert (best["step"], best["metric"]) == (5, 0.25)
    assert json.loads((root / "best.json").read_text()) == {"step": 5, "metric": 0.25}
    a.trainer.save()  # re-save of the latest step: best stays, nothing else pruned
    assert (root / "checkpoint-best" / "state.pt").exists()

    b = _pc_pipe(tmp_path, 1, save_every=0)  # another init: everything comes from the checkpoint
    assert b.trainer.step == 5
    out_a = a.trainer.train_step(a.encode_batch(batch))
    out_b = b.trainer.train_step(b.encode_batch(batch))
    assert float(out_a["loss"]) == float(out_b["loss"])
    for (n, pa), (_, pb) in zip(a.model.named_parameters(), b.model.named_parameters()):
        assert torch.equal(pa, pb), n
    sa, sb = a.trainer.optimizer.state_dict(), b.trainer.optimizer.state_dict()
    assert sa["count"] == sb["count"] == 6
    for i, st in sa["adam"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st[k], sb["adam"]["state"][i][k])
    assert torch.equal(sa["transforms"][1]["multiplier"], sb["transforms"][1]["multiplier"])
    for n, e in a.trainer.ema.params.items():
        assert torch.equal(e, b.trainer.ema.params[n]), n
    assert torch.equal(a.trainer.generator.get_state(), b.trainer.generator.get_state())
    # the pipeline's load: a chosen step and the stats
    GlobalNormalizer(np.zeros(3), np.ones(3)).save(str(tmp_path / "stats.json"))
    assert b.load(4) == 4 and b.normalizer.fitted


def test_evaluate_batch_and_conditioning_report_match_jax():
    rng = np.random.default_rng(0)
    pred, ref = (rng.standard_normal((2, 600, 3)).astype(np.float32) * 0.5 for _ in range(2))
    got, want = teval.evaluate_batch(pred, ref, device="cpu"), jeval.evaluate_batch(pred, ref)
    _rel(got["chamfer"], want["chamfer"], 1e-6, "cd")
    _rel(got["chamfer_weighted"], want["chamfer_weighted"], 1e-6, "cdw")
    assert got["emd"] == want["emd"]

    refs = {c: rng.standard_normal((2, 32, 3)).astype(np.float32) for c in ("box", "sphere")}

    def gen(prompts, _):
        base = {"a box": refs["box"][0], "a sphere": refs["sphere"][0], "": refs["box"][1] * 2}
        return np.stack([base[p] + 0.01 for p in prompts])

    jr = jeval.conditioning_report(None, refs, samples_per_class=2, generate_fn=gen)
    tr = teval.conditioning_report(None, refs, samples_per_class=2, generate_fn=gen, device="cpu")
    assert tr["classes"] == jr["classes"] and tr["conditioned_ok"] == jr["conditioned_ok"]
    for k in ("cross_cd", "diag_cd", "null_cd", "class_separation", "null_degradation",
              "conditioning_accuracy"):
        _rel(tr[k], jr[k], 1e-6, k)


def test_evaluator_on_a_three_step_pipeline(tmp_path):
    tm = TModel(**_model_kw(), dropout=0.0, device="cpu")
    tm.init_weights(torch.Generator().manual_seed(0))
    torch.nn.init.normal_(tm.output_proj.weight, std=0.05)
    pipe = NOVAPointCloudGenerationPipeline(tm, text_encoder=TEnc(TOK_DIM, N_TOK))
    stats = tmp_path / "stats.json"
    GlobalNormalizer(np.full(3, 0.1), np.full(3, 2.0)).save(str(stats))
    ev = teval.PointCloudEvaluator(pipe, stats_path=str(stats))
    assert pipe.normalizer.fitted
    refs = np.stack([s["points"] for s in make_synthetic_clouds(2, POINTS, 1)])
    r = ev.run(PROMPTS, refs, guidance_scales=(1.0, 3.0, 1.0), num_points=POINTS,
               num_diffusion_steps=3, generator=torch.Generator().manual_seed(2),
               output_json=str(tmp_path / "r.json"))
    s = r["sweep"]
    assert [x["guidance_scale"] for x in s] == [1.0, 3.0, 1.0]
    assert (s[0]["chamfer"], s[0]["emd"]) == (s[2]["chamfer"], s[2]["emd"])  # same draws
    assert all(np.isfinite([x["chamfer"], x["chamfer_weighted"], x["emd"]]).all() for x in s)
    assert r["best_chamfer"] == min(x["chamfer"] for x in s)
    assert json.loads((tmp_path / "r.json").read_text())["num_points"] == POINTS
    # the train pipeline's sample: denormalized through the normalizer
    tp = ttrain.NOVATrainPointCloudPipeline(tm, text_encoder=TEnc(TOK_DIM, N_TOK),
                                            normalizer=GlobalNormalizer.load(str(stats)))
    out = tp.sample(PROMPTS, num_points=POINTS, num_diffusion_steps=3, postprocess="eval",
                    generator=torch.Generator().manual_seed(2), guidance_scale=1.0)
    raw = pipe(PROMPTS, num_points=POINTS, num_diffusion_steps=3, postprocess="eval",
               generator=torch.Generator().manual_seed(2), guidance_scale=1.0)
    np.testing.assert_allclose(out.point_clouds, raw.point_clouds * 2.0 + 0.1, rtol=1e-6)


def test_train_and_eval_scripts_on_the_cpu(tmp_path, capsys):
    """Two steps of the port's training script (tiny arch, synthetic data),
    its resume rule for train_config.json, then the evaluation script on
    its checkpoint."""
    d = str(tmp_path / "run")
    base = ["--output-dir", d, "--arch", ARCH, "--max-points", str(POINTS), "--batch-size", "2",
            "--val-every", "2", "--eval-shapes", "2", "--eval-steps", "2", "--num-subsets", "16"]
    out = train_pointcloud.main(base + ["--max-steps", "2", "--prediction-type", "v_prediction"],
                                device="cpu")
    assert out["step"] == 2 and np.isfinite(out["best_metric"])
    sidecar = json.loads((tmp_path / "run" / "train_config.json").read_text())
    assert sidecar == {"prediction_type": "v_prediction", "arch": ARCH, "patch_size": 1,
                       "max_points": POINTS}
    # resume: the sidecar's parameterization by default, a conflicting one refused
    assert train_pointcloud.main(base + ["--max-steps", "3"], device="cpu")["step"] == 3
    with pytest.raises(SystemExit, match="prediction_type='v_prediction'"):
        train_pointcloud.main(base + ["--max-steps", "4", "--prediction-type", "epsilon"],
                              device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_pointcloud.main(base + ["--offload-opt-state"], device="cpu")
    assert json.loads((tmp_path / "run" / "train_config.json").read_text()) == sidecar
    capsys.readouterr()
    res = eval_pc_quality.main(["--checkpoint-dir", d, "--arch", ARCH, "--num-points",
                                str(POINTS), "--num-shapes", "2", "--steps", "2", "--guidance",
                                "1.0", "3.0", "--out", str(tmp_path / "q.json"), "--use-ema"],
                               device="cpu")
    assert "# prediction_type=v_prediction" in capsys.readouterr().out
    assert res["checkpoint_step"] == 3 and res["backend"] == "cpu" and "int8" not in res
    assert np.isfinite(res["bf16"]["best_chamfer"]) and res["noise_baseline"]["emd"] > 0
    assert not any(LAUNCHES.values())
