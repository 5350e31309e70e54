"""The training side of the NOVA t2i slice vs the JAX package on the CPU:
flow-matching training draws, the training mask, the latent distribution,
the loss, prompt dropout, the optimizer and its masks, EMA and the lr
schedules, on the same numpy inputs (random draws: statistics, or the JAX
side's draws handed to the port; threefry and Philox streams never match).

Tolerances: float32 arithmetic in another order, 1e-6 relative (the
optimizer, EMA, schedules, loss); exact where both compute the same integer
or table (sigma tables, masks, decay and freeze selections); sample
statistics within a few standard errors of the JAX side's.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nova_pointcloud_tpu.engine import ema as jema
from nova_pointcloud_tpu.engine import lr_schedules as jlr
from nova_pointcloud_tpu.engine import optim as joptim
from nova_pointcloud_tpu.models import embeddings as jemb
from nova_pointcloud_tpu.models.autoencoders.modeling_utils import DiagonalGaussian as JGauss
from nova_pointcloud_tpu.models.nova import NOVATransformer as JNOVA
from nova_pointcloud_tpu.ops import losses as jloss
from nova_pointcloud_tpu.ops import masking as jmask
from nova_pointcloud_tpu.pipelines import train_nova as jtrain
from nova_pointcloud_tpu.pipelines.builder import init_transformer
from nova_pointcloud_tpu.schedulers import flow_match as jfm
from nova_pointcloud_tpu_torch.engine import ema as tema
from nova_pointcloud_tpu_torch.engine import lr_schedules as tlr
from nova_pointcloud_tpu_torch.engine import optim as toptim
from nova_pointcloud_tpu_torch.models import embeddings as temb
from nova_pointcloud_tpu_torch.models.autoencoders.modeling_utils import DiagonalGaussian as TGauss
from nova_pointcloud_tpu_torch.models.convert import convert_params, jax_param_paths
from nova_pointcloud_tpu_torch.models.nova import NOVATransformer as TNOVA
from nova_pointcloud_tpu_torch.ops import losses as tloss
from nova_pointcloud_tpu_torch.ops import masking as tmask
from nova_pointcloud_tpu_torch.pipelines import train_nova as ttrain
from nova_pointcloud_tpu_torch.schedulers import flow_match as tfm

TINY = dict(arch=("vit_d2w64", "vit_d2w64", "mlp_d2w64"), image_dim=4, image_base_size=(4, 4),
            video_base_size=(1, 2, 2), patch_size=2, text_token_dim=16, text_token_len=4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree):
    """{"a/b/kernel": leaf} of a JAX tree."""
    return {"/".join(getattr(k, "key", str(k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _tiny():
    """The tiny NOVA's JAX params (numpy), every zero-initialised leaf (the
    biases, the AdaLN projections) filled with seeded values."""
    jm = JNOVA(**TINY, noise_scheduler=jfm.FlowMatchEulerScheduler())
    rng = np.random.default_rng(1)
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.05).astype(np.float32)
                        if not np.any(a) else np.array(a, np.float32),
                        jax.tree.map(np.asarray, init_transformer(jm, seed=0)))


def _port_model(params):
    tm = TNOVA(**TINY, noise_scheduler=tfm.FlowMatchEulerScheduler(), device="cpu")
    tm.load_state_dict(convert_params(params), strict=True)
    return tm


# -- flow matching, masks, latents, loss -------------------------------------

@pytest.mark.parametrize("shift", [1.0, 3.0])
def test_flow_match_training_side_matches_jax(shift):
    js, ts = jfm.FlowMatchEulerScheduler(shift=shift), tfm.FlowMatchEulerScheduler(shift=shift)
    assert np.array_equal(js.train_sigmas(), ts.train_sigmas())
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((3, 5, 16)).astype(np.float32)
    noise = rng.standard_normal((3, 5, 16)).astype(np.float32)
    t = rng.integers(0, 1000, (3, 5)).astype(np.int32)
    jx, jt = js.add_noise(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
    tx, tt = ts.add_noise(_t(x0), _t(noise), _t(t))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ts.target(_t(x0), _t(noise)).numpy(),
                                  np.asarray(js.target(jnp.asarray(x0), jnp.asarray(noise))))


def test_sample_timesteps_statistics_match_jax():
    """Logit-normal timesteps: int32 in [0, 999], the same quantiles as the
    JAX draws (200k each; a quantile's standard error is ~1.5 steps)."""
    n = 200_000
    got = tfm.FlowMatchEulerScheduler().sample_timesteps(torch.Generator().manual_seed(0), (n,))
    ref = np.asarray(jfm.FlowMatchEulerScheduler().sample_timesteps(jax.random.PRNGKey(0), (n,)))
    assert got.dtype == torch.int32 and int(got.min()) >= 0 and int(got.max()) <= 999
    qs = np.linspace(0.05, 0.95, 19)
    np.testing.assert_allclose(np.quantile(got.numpy(), qs), np.quantile(ref, qs), atol=8)


def test_truncated_normal_statistics_match_jax():
    """The train mask ratio's law, truncnorm(0.7, 1; loc 1, scale 0.25):
    both packages' sample means at the analytic mean (se 5e-4 at 20k)."""
    a, b = -1.2, 0.0
    phi = lambda x: math.exp(-x * x / 2) / math.sqrt(2 * math.pi)  # noqa: E731
    cdf = lambda x: 0.5 * math.erfc(-x / math.sqrt(2))  # noqa: E731
    mean = 1.0 + 0.25 * (phi(a) - phi(b)) / (cdf(b) - cdf(a))
    got = tmask.truncated_normal(torch.Generator().manual_seed(1), 0.7, 1.0, 1.0, 0.25,
                                 (20_000,)).numpy()
    ref = np.asarray(jmask.truncated_normal(jax.random.PRNGKey(1), 0.7, 1.0, 1.0, 0.25,
                                            (20_000,)))
    assert got.min() >= 0.7 and got.max() <= 1.0
    assert abs(got.mean() - mean) < 3e-3 and abs(ref.mean() - mean) < 3e-3
    assert abs(got.std() - ref.std()) < 3e-3


def test_sample_train_mask_structure_and_statistics():
    """One ratio per call in [0.7, 1]; each sample's visible tokens are the
    first round((1 - ratio) N) of its own permutation; the mean visible count
    over seeded calls matches the JAX draws'."""
    n, batch = 64, 4
    g = torch.Generator().manual_seed(2)
    counts, jcounts = [], []
    for i in range(400):
        mask, rank = tmask.sample_train_mask(g, batch, n)
        assert mask.shape == (batch, n, 1) and mask.dtype == torch.float32
        assert torch.equal(torch.sort(rank, dim=1).values, torch.arange(n).expand(batch, n))
        nvis = (1 - mask[..., 0]).sum(1)
        assert bool((nvis == nvis[0]).all()) and 0 <= int(nvis[0]) <= round(0.3 * n)
        assert torch.equal(mask[..., 0], (rank >= nvis[:, None]).float())
        counts.append(int(nvis[0]))
        jm, _ = jmask.sample_train_mask(jax.random.PRNGKey(i), batch, n)
        jcounts.append(float((1 - np.asarray(jm)[0, :, 0]).sum()))
    assert not torch.equal(rank[0], rank[1])  # a permutation per sample
    assert abs(np.mean(counts) - np.mean(jcounts)) < 1.0  # se ~0.3 each


@pytest.mark.parametrize("c", [8, 5])
def test_diagonal_gaussian_matches_jax(c):
    rng = np.random.default_rng(3)
    z = np.concatenate([rng.standard_normal((2, 4, 4, c // 2 + c % 2)),
                        rng.uniform(-40, 30, (2, 4, 4, c // 2))], -1).astype(np.float16)
    jd, td = JGauss.from_params(jnp.asarray(z)), TGauss.from_params(_t(z))
    for a, b in ((td.mean, jd.mean), (td.logvar, jd.logvar), (td.std, jd.std),
                 (td.mode(), jd.mode())):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)
    key = jax.random.PRNGKey(4)
    eps = jax.random.normal(key, jd.mean.shape, jnp.float32)
    np.testing.assert_allclose(td.sample(eps=_t(eps)).numpy(), np.asarray(jd.sample(key)),
                               rtol=1e-6, atol=1e-6)
    assert td.sample(torch.Generator().manual_seed(0)).shape == td.mean.shape


def test_masked_diffusion_mse_matches_jax():
    rng = np.random.default_rng(5)
    pred = rng.standard_normal((8, 16, 16)).astype(np.float32)
    target = rng.standard_normal((8, 16, 16)).astype(np.float32)
    mask = (rng.random((8, 16, 1)) > 0.3).astype(np.float32)
    ref = jloss.masked_diffusion_mse(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask))
    got = tloss.masked_diffusion_mse(_t(pred).to(torch.bfloat16), _t(target), _t(mask))
    ref16 = jloss.masked_diffusion_mse(jnp.asarray(pred, jnp.bfloat16), jnp.asarray(target),
                                       jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(ref16), rtol=1e-6)
    got32 = tloss.masked_diffusion_mse(_t(pred), _t(target), _t(mask))
    np.testing.assert_allclose(float(got32), float(ref), rtol=1e-6)


def test_drop_prompts_matches_jax():
    """Whole prompts go to the null bank where the JAX draw says so."""
    jte = jemb.TextEmbed(16, 32, 4)
    embeds = np.random.default_rng(6).standard_normal((32, 4, 16)).astype(np.float32)
    v = jte.init(jax.random.PRNGKey(0), jnp.asarray(embeds))
    key = jax.random.PRNGKey(7)
    ref = jte.apply(v, jnp.asarray(embeds), key, method=jte.drop_prompts)
    drop = np.asarray(jax.random.uniform(key, (32, 1, 1)) < jte.dropout)[:, 0, 0]
    assert 0 < drop.sum() < 32
    tte = temb.TextEmbed(16, 32, 4, device="cpu")
    with torch.no_grad():
        tte.null_prompt.copy_(_t(v["params"]["null_prompt"]))
    got = tte.drop_prompts(_t(embeds), drop=_t(drop))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))
    assert tte.dropout == jte.dropout


# -- the optimizer and its masks -----------------------------------------------

def test_jax_param_paths_cover_the_jax_tree():
    """Every port parameter maps to one JAX leaf of the same path and rank,
    and every JAX leaf is mapped."""
    params = _tiny()
    flat = {k: np.ndim(v) for k, v in _flat(params).items()}
    paths = jax_param_paths(_port_model(params))
    assert sorted(paths.values()) == sorted(flat.items())


def test_decay_and_freeze_masks_pick_the_jax_leaves():
    params = _tiny()
    tm = _port_model(params)
    paths = jax_param_paths(tm)
    jdecay = _flat(joptim.decay_mask(params))
    jfreeze = _flat(jtrain.freeze_mask(params, jtrain.T2I_FROZEN))
    tdecay, tfreeze = toptim.decay_mask(tm), ttrain.freeze_mask(tm, ttrain.T2I_FROZEN)
    for name, (path, _) in paths.items():
        assert tdecay[name] == jdecay[path], (name, path)
        assert tfreeze[name] == jfreeze[path], (name, path)
    # the scanned stacks' biases carry a depth axis in JAX: decayed there
    assert tdecay["image_encoder.enc_layers.0.attn.qkv.bias"]
    assert not tdecay["image_encoder.enc_layers.0.norm1.weight"]
    assert not tdecay["image_decoder.blocks_0.proj.fc1.bias"]
    assert not tfreeze["video_patch_embed.proj.weight"] and tfreeze["image_patch_embed.proj.weight"]


@pytest.mark.parametrize("sched,clip", [("constant", 1.0), ("cosine", 1.0), ("cosine", 1e6)])
def test_optimizer_three_steps_match_optax(sched, clip):
    """build_optimizer + apply_freeze (T2I_FROZEN) for three steps on the same
    gradients; one matrix gets no gradient in the port (zero in JAX): its
    update is the decay alone. clip 1.0 clips every step, 1e6 none."""
    params = _tiny()
    jsched = (jlr.constant_lr(1e-3, warmup_steps=2) if sched == "constant"
              else jlr.cosine_lr(1e-3, 5, lr_min=1e-5, warmup_steps=1))
    tsched = (tlr.constant_lr(1e-3, warmup_steps=2) if sched == "constant"
              else tlr.cosine_lr(1e-3, 5, lr_min=1e-5, warmup_steps=1))
    kw = dict(weight_decay=0.02, betas=(0.9, 0.95), grad_clip=clip)
    tx = jtrain.apply_freeze(joptim.build_optimizer(params, jsched, **kw), params,
                             jtrain.T2I_FROZEN)
    tm = _port_model(params)
    opt = ttrain.apply_freeze(toptim.build_optimizer(tm, tsched, **kw), tm, jtrain.T2I_FROZEN)
    named = dict(tm.named_parameters())
    state, jp, update = tx.init(params), params, jax.jit(tx.update)  # compiled once
    rng = np.random.default_rng(8)
    nograd = "image_decoder/blocks_0/proj/fc1/kernel"
    for _ in range(3):
        grads = jax.tree_util.tree_map_with_path(
            lambda p, a: (np.zeros(a.shape, np.float32) if "/".join(k.key for k in p) == nograd
                          else rng.standard_normal(a.shape).astype(np.float32)), params)
        updates, state = update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        tgrads = convert_params(grads)
        for name, p in named.items():
            p.grad = tgrads[name].clone()
        named["image_decoder.blocks_0.proj.fc1.weight"].grad = None
        opt.step()
    ref = convert_params(jax.tree.map(np.asarray, jp))
    before = convert_params(params)
    for name, p in named.items():
        r = ref[name].numpy()
        np.testing.assert_allclose(p.detach().numpy(), r, rtol=0,
                                   atol=1e-6 * max(np.abs(r).max(), 1e-3), err_msg=name)
        frozen = not ttrain.freeze_mask(tm, jtrain.T2I_FROZEN)[name]
        assert frozen == bool(torch.equal(p.detach(), before[name])), name


def test_ema_matches_jax():
    rng = np.random.default_rng(9)
    p0 = {"a": rng.standard_normal((4, 3)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    js = jema.ema_init(jax.tree.map(jnp.asarray, p0), decay=0.9, update_every=2)
    ts = tema.ema_init({k: _t(v) for k, v in p0.items()}, decay=0.9, update_every=2)
    for step in range(1, 6):
        p = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
        js = jema.ema_update(js, jax.tree.map(jnp.asarray, p), jnp.int32(step))
        ts = tema.ema_update(ts, {k: _t(v) for k, v in p.items()}, step)
        for k in p0:
            np.testing.assert_allclose(ts.params[k].numpy(), np.asarray(js.params[k]),
                                       rtol=1e-6, atol=1e-7)
    assert ts.params["a"].dtype == torch.float32


@pytest.mark.parametrize("name", ["constant", "cosine", "multistep"])
def test_lr_schedules_match_jax(name):
    make = {"constant": lambda m: m.constant_lr(3e-4, warmup_steps=10, warmup_factor=0.01),
            "cosine": lambda m: m.cosine_lr(3e-4, 100, lr_min=1e-6, warmup_steps=10),
            "multistep": lambda m: m.multistep_lr(3e-4, [20, 50], gamma=0.5, warmup_steps=5)}
    js, ts = make[name](jlr), make[name](tlr)
    # 1e-6 of the peak lr: the JAX schedules compute in float32, whose
    # 1 + cos(pi t) loses digits near the end of the cosine
    for step in range(0, 130, 3):
        np.testing.assert_allclose(ts(step), float(js(jnp.int32(step))), rtol=0, atol=3e-10)
