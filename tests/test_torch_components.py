"""Port's small modules vs the JAX package on the same numpy inputs: DDPM
scheduler, dummy text encoder, timestep embedding, cdist, quantization."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nova_pointcloud_tpu.models.embeddings import timestep_freq_embed as j_tfe
from nova_pointcloud_tpu.models.text_encoders.dummy import DummyTextEncoder as JEnc
from nova_pointcloud_tpu.ops import quantization as jq
from nova_pointcloud_tpu.ops.pointops import cdist as j_cdist
from nova_pointcloud_tpu.schedulers.ddpm import DDPMScheduler as JDDPM
from nova_pointcloud_tpu_torch.models.embeddings import timestep_freq_embed as t_tfe
from nova_pointcloud_tpu_torch.models.text_encoders.dummy import DummyTextEncoder as TEnc
from nova_pointcloud_tpu_torch.ops import quantization as tq
from nova_pointcloud_tpu_torch.ops.pointops import cdist as t_cdist
from nova_pointcloud_tpu_torch.schedulers.ddpm import DDPMScheduler as TDDPM

# float32 elementwise math on both sides; the two libraries' sqrt/exp/log
# may differ in the last ulp
F32 = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("kw", [
    dict(beta_schedule="linear"),
    dict(beta_schedule="scaled_linear"),
    dict(beta_schedule="squaredcos_cap_v2"),
    dict(beta_schedule="sigmoid"),
    dict(trained_betas=list(np.linspace(1e-4, 2e-2, 1000))),
    dict(beta_schedule="linear", rescale_betas_zero_snr=True),
    dict(timestep_spacing="linspace"),
    dict(timestep_spacing="trailing"),
    dict(steps_offset=1),
])
def test_ddpm_tables_identical(kw):
    j, t = JDDPM(**kw), TDDPM(**kw)
    assert np.array_equal(j.betas, t.betas)
    assert np.array_equal(j.alphas_cumprod, t.alphas_cumprod)
    for s in (4, 25):
        assert np.array_equal(j.set_timesteps(s).timesteps, t.set_timesteps(s).timesteps)


@pytest.mark.parametrize("prediction_type", ["epsilon", "sample", "v_prediction"])
@pytest.mark.parametrize("variance_type", ["fixed_small", "fixed_small_log", "fixed_large",
                                           "fixed_large_log", "learned", "learned_range"])
def test_ddpm_step_matches_jax(prediction_type, variance_type):
    kw = dict(beta_schedule="squaredcos_cap_v2", prediction_type=prediction_type,
              variance_type=variance_type)
    j, t = JDDPM(**kw), TDDPM(**kw)
    rng = np.random.default_rng(0)
    sample = rng.standard_normal((2, 16, 3)).astype(np.float32)
    noise = rng.standard_normal((2, 16, 3)).astype(np.float32)
    out = rng.standard_normal((2, 16, 3)).astype(np.float32)
    if variance_type == "learned":
        out = np.concatenate([out, rng.uniform(1e-4, 0.1, (2, 16, 3))], -1).astype(np.float32)
    elif variance_type == "learned_range":
        out = np.concatenate([out, rng.uniform(-1, 1, (2, 16, 3))], -1).astype(np.float32)
    sj, st = j.set_timesteps(25), t.set_timesteps(25)
    for step in (960, 520, 40, 0):
        ref = np.asarray(j.step(jnp.asarray(out), step, jnp.asarray(sample),
                                schedule=sj, noise=jnp.asarray(noise)))
        got = t.step(_t(out), step, _t(sample), schedule=st, noise=_t(noise))
        np.testing.assert_allclose(got.numpy(), ref, **F32)
    # zero-variance step (no noise given, no generator): deterministic sampling
    ref = np.asarray(j.step(jnp.asarray(out), 520, jnp.asarray(sample), schedule=sj))
    got = t.step(_t(out), 520, _t(sample), schedule=st)
    np.testing.assert_allclose(got.numpy(), ref, **F32)


@pytest.mark.parametrize("prediction_type", ["epsilon", "sample", "v_prediction"])
def test_ddpm_train_side_matches_jax(prediction_type):
    j, t = JDDPM(prediction_type=prediction_type), TDDPM(prediction_type=prediction_type)
    rng = np.random.default_rng(1)
    x0, noise, out = (rng.standard_normal((4, 8, 3)).astype(np.float32) for _ in range(3))
    ts = np.array([0, 10, 500, 999])
    for name in ("add_noise", "get_velocity"):
        ref = np.asarray(getattr(j, name)(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(ts)))
        got = getattr(t, name)(_t(x0), _t(noise), torch.from_numpy(ts))
        np.testing.assert_allclose(got.numpy(), ref, **F32)
    ref = np.asarray(j.predict_x0(jnp.asarray(out), jnp.asarray(ts), jnp.asarray(x0)))
    got = t.predict_x0(_t(out), torch.from_numpy(ts), _t(x0))
    np.testing.assert_allclose(got.numpy(), ref, **F32)


def test_dummy_text_encoder_byte_identical():
    prompts = ["a chair", "", "A Wooden TABLE with four legs", "lamp " * 40]
    for args in ((256, 32), (32, 8)):
        ej, lj = JEnc(*args).encode(prompts)
        et, lt = TEnc(*args).encode(prompts)
        assert ej.tobytes() == et.tobytes() and lj.tobytes() == lt.tobytes()


def test_timestep_freq_embed_matches_jax():
    ts = np.array([0, 1, 40, 500, 999], np.float32)
    ref = np.asarray(j_tfe(jnp.asarray(ts), 256))
    got = t_tfe(torch.from_numpy(ts), 256)
    # sin/cos of arguments up to ~1e3: one f32 ulp of the argument is ~6e-5
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)


def test_cdist_matches_jax():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((2, 50, 3)).astype(np.float32)
    b = (rng.standard_normal((2, 8, 3)) * 0.1).astype(np.float32)
    ref = np.asarray(j_cdist(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(t_cdist(_t(a), _t(b)).numpy(), ref, atol=1e-5, rtol=1e-5)


def test_quantizers_match_jax_exactly():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((64, 96)).astype(np.float32)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    jw, tw = jq.quantize_weight(jnp.asarray(w)), tq.quantize_weight(_t(w))
    assert np.array_equal(np.asarray(jw.values), tw[0].numpy())
    assert np.array_equal(np.asarray(jw.scales), tw[1].numpy())
    w3 = rng.standard_normal((3, 64, 96)).astype(np.float32)
    jv, js = jq.quantize_weight_nd(jnp.asarray(w3))
    tv, ts = tq.quantize_weight_nd(_t(w3))
    assert np.array_equal(np.asarray(jv), tv.numpy()) and np.array_equal(np.asarray(js), ts.numpy())
    jx, jsx = jq.quantize_activations(jnp.asarray(x))
    tx, tsx = tq.quantize_activations(_t(x))
    assert np.array_equal(np.asarray(jx), tx.numpy()) and np.array_equal(np.asarray(jsx), tsx.numpy())
    ref = np.asarray(jq.int8_matmul(jnp.asarray(x), jw, jnp.float32))
    np.testing.assert_allclose(tq.int8_matmul(_t(x), tw, torch.float32).numpy(), ref, **F32)


def test_merge_act_scales_and_max_merge_match_jax():
    rng = np.random.default_rng(4)
    stats = {"blocks": {"layers": {"block": {
        k: rng.uniform(0.5, 4.0, 3).astype(np.float32)
        for k in ("a_ln1", "a_av", "a_ln2", "a_mid", "a_smax", "a_q")}}}}
    other = {"blocks": {"layers": {"block": {
        k: rng.uniform(0.5, 4.0, 3).astype(np.float32) for k in ("a_ln1", "a_smax")}}},
        "extra": {"a_x": np.float32(2.0)}}
    qp = {"blocks": {"layers": {"block": {"fc1_s": np.ones(3, np.float32)}}}}

    def to_t(tree):
        return {k: to_t(v) for k, v in tree.items()} if isinstance(tree, dict) else _t(tree)

    def flat(tree, pre=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(flat(v, f"{pre}/{k}"))
            return out
        return {pre: np.asarray(tree)}

    jm = flat(jq.merge_act_scales(qp, jq.max_merge_stats(stats, other), margin=1.05))
    tm = flat(tq.merge_act_scales(to_t(qp), tq.max_merge_stats(to_t(stats), to_t(other)),
                                  margin=1.05))
    assert jm.keys() == tm.keys()
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=0, atol=0, err_msg=k)
