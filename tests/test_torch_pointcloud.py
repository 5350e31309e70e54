"""The port's pc model and t2pc pipeline vs the JAX package, at pc_d2w64
with 64 points, on converted JAX weights.

Every JAX parameter gets seeded N(0, 0.05) noise added, so biases,
LayerNorms and the zero-initialised ``output_proj`` are non-zero and the
sampled cloud depends on every block. The int8 reference is the JAX
pipeline on its TPU serving path: the fused Pallas kernels in interpret
mode, with ``jax.default_backend`` patched to report "tpu" inside the test
only (the JAX package takes that path only on a TPU).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nova_pointcloud_tpu.models.pointcloud import NOVAPointCloudTransformer as JModel
from nova_pointcloud_tpu.models.text_encoders.dummy import DummyTextEncoder as JEnc
from nova_pointcloud_tpu.ops import quantization as jq
from nova_pointcloud_tpu.pipelines.pointcloud_gen import (
    NOVAPointCloudGenerationPipeline as JPipe)
from nova_pointcloud_tpu.schedulers.ddpm import DDPMScheduler as JDDPM
from nova_pointcloud_tpu_torch.models.convert import convert_params, convert_tree
from nova_pointcloud_tpu_torch.models.pointcloud import NOVAPointCloudTransformer as TModel
from nova_pointcloud_tpu_torch.models.text_encoders.dummy import DummyTextEncoder as TEnc
from nova_pointcloud_tpu_torch.ops.kernels import LAUNCHES
from nova_pointcloud_tpu_torch.pipelines.pointcloud_gen import (
    NOVAPointCloudGenerationPipeline as TPipe)
from nova_pointcloud_tpu_torch.schedulers.ddpm import DDPMScheduler as TDDPM

ARCH, POINTS, TOK_DIM, N_TOK = "pc_d2w64", 64, 32, 8
PROMPTS = ["a chair", "a tall lamp"]
# 5 leading-spaced steps are t = 800, 600, 400, 200, 0: guidance truncation
# at 800 (the flagship's) runs one CFG step at 2x batch, then four
# cond-only steps at 1x
STEPS, TRUNC = 5, 800.0


def _model_kw(quantize):
    return dict(arch=ARCH, point_cloud_size=POINTS, patch_size=1,
                text_token_dim=TOK_DIM, quantize=quantize)


def _jax_params(seed=0):
    model = JModel(**_model_kw(False), dropout=0.0)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((2, POINTS, 3)),
                        jnp.zeros((2,), jnp.int32), jnp.zeros((2, N_TOK, TOK_DIM)))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: (np.asarray(p) + rng.normal(0, 0.05, p.shape)).astype(np.float32), params)


def _pair(quantize, seed=0):
    params = _jax_params(seed)
    jm = JModel(**_model_kw(quantize), dropout=0.0)
    tm = TModel(**_model_kw(quantize), device="cpu")
    tm.load_state_dict(convert_params(params))
    return jm, params, tm


def _inputs(seed=1, batch=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, POINTS, 3)).astype(np.float32)
    t = np.array([10, 500] * (batch // 2), np.int32)
    text, _ = JEnc(TOK_DIM, N_TOK).encode(PROMPTS * (batch // 2))
    return x, t, text


def test_converted_float_forward_matches_jax():
    jm, params, tm = _pair(quantize=False)
    x, t, text = _inputs()
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                              jnp.asarray(text)))
    got = tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(text))
    assert np.abs(ref).max() > 0.1  # the non-zero head makes the check bite
    # f32 on both sides; flax's one-pass LayerNorm variance and other sum
    # orders differ at ~1e-6 relative
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_calibration_stats_match_jax():
    jm, params, tm = _pair(quantize=True)
    x, t, text = _inputs()
    ref, vs = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                       jnp.asarray(text), mutable=["act_stats"])
    got, stats = tm.calibration_forward(torch.from_numpy(x), torch.from_numpy(t),
                                        torch.from_numpy(text))
    js = vs["act_stats"]["blocks"]["layers"]["block"]
    ts = stats["blocks"]["layers"]["block"]
    assert set(js) == set(ts) == {"a_ln1", "a_av", "a_smax", "a_ln2", "a_mid"}
    for k in js:
        # per-site maxima of f32 activations; the int8 rounding of both
        # mirrors agrees, so only f32 sum order separates them
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def _pipes(quantize):
    jm, params, tm = _pair(quantize)
    jp = JPipe(jm, params, JDDPM(beta_schedule="squaredcos_cap_v2"),
               text_encoder=JEnc(TOK_DIM, N_TOK))
    tp = TPipe(tm, TDDPM(beta_schedule="squaredcos_cap_v2"), text_encoder=TEnc(TOK_DIM, N_TOK))
    return jp, tp


def _sample(jp, tp, postprocess, tpu_path=False):
    latents = np.random.default_rng(7).standard_normal((len(PROMPTS), POINTS, 3)).astype(np.float32)
    kw = dict(num_points=POINTS, num_diffusion_steps=STEPS, guidance_scale=7.5,
              guidance_trunc=TRUNC, postprocess=postprocess, deterministic=True)
    if tpu_path:
        with pltpu.force_tpu_interpret_mode(), mock.patch.object(jax, "default_backend",
                                                                 lambda: "tpu"):
            ref = jp(PROMPTS, latents=jnp.asarray(latents), **kw)
    else:
        ref = jp(PROMPTS, latents=jnp.asarray(latents), **kw)
    got = tp(PROMPTS, latents=latents, **kw)
    return ref, got


@pytest.mark.parametrize("postprocess", ["standard", "eval"])
def test_pipeline_float_matches_jax(postprocess):
    jp, tp = _pipes(quantize=False)
    ref, got = _sample(jp, tp, postprocess)
    # 5 f32 steps of the float model; outputs bounded by the postprocess
    np.testing.assert_allclose(got.point_clouds, ref.point_clouds, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.colors, ref.colors, atol=1e-4, rtol=0)


# The int8 path is discontinuous: an f32 value one ulp apart on the two
# sides (a LayerNorm or softmax sum taken in another order) can round to
# another int8 code, and one flipped code moves every later activation a
# little, so more codes flip downstream. Bitwise agreement is not on offer;
# the bounds below sit between that floor and what a real fault costs
# (measured at this size, eval postprocess):
#   JAX fused path vs itself with latents shifted by 1e-6: mean 2.8e-3
#   port vs JAX fused path: mean 1.1e-4 (calibrated), 3.9e-3 (per row);
#   87% and 64% of coordinates within 1e-4
#   JAX calibrated vs per-row scales (a fault such as dropped act scales):
#   mean 1.9e-2
INT8_MEAN_ATOL = 5e-3


def _int8_pair(calibrated):
    jp, tp = _pipes(quantize=True)
    if calibrated:
        scales = jp.calibrate(PROMPTS, num_points=POINTS, num_diffusion_steps=STEPS)
        tp.act_scales = convert_tree(scales)
    return jp, tp


@pytest.mark.parametrize("calibrated", [True, False])
def test_int8_forward_matches_fused_jax(calibrated):
    """One model forward per timestep of the schedule, the int8 serving
    path (fused kernels) on both sides, from the same inputs."""
    jp, tp = _int8_pair(calibrated)
    qp = jq.quantize_serving_params(jp.params)
    if calibrated:
        qp = jq.merge_act_scales(qp, jp.act_scales)
    tqp = convert_tree(qp)
    rng = np.random.default_rng(11)
    text = jp.encode_prompt(PROMPTS)
    for t in (800, 400, 0):
        x = rng.standard_normal((4, POINTS, 3)).astype(np.float32)
        ts = np.full((4,), t, np.int32)
        with pltpu.force_tpu_interpret_mode(), mock.patch.object(jax, "default_backend",
                                                                 lambda: "tpu"):
            ref = np.asarray(jp.model.apply({"params": jp.params, "qparams": qp},
                                            jnp.asarray(x), jnp.asarray(ts), jnp.asarray(text)))
        got = tp.model(torch.from_numpy(x), torch.from_numpy(ts), torch.from_numpy(text),
                       qparams=tqp).numpy()
        err = np.abs(got - ref)
        # one forward: a flipped code moves its sample's outputs by ~1e-3
        # (measured mean <= 4.1e-4, max <= 5.8e-3 over these inputs)
        assert err.mean() < 1e-3 and err.max() < 5e-2, (t, err.mean(), err.max())


@pytest.mark.parametrize("calibrated", [True, False])
def test_pipeline_int8_matches_fused_jax(calibrated):
    jp, tp = _int8_pair(calibrated)
    ref, got = _sample(jp, tp, "eval", tpu_path=True)
    for g, r in ((got.point_clouds, ref.point_clouds), (got.colors, ref.colors)):
        err = np.abs(g - np.asarray(r))
        assert err.mean() < INT8_MEAN_ATOL, err.mean()
        assert np.mean(err < 1e-4) > 0.5, np.mean(err < 1e-4)
    assert LAUNCHES == {"fused_attention_block": 0, "fused_ln_int8_mlp": 0}


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{pre}/{k}"))
        return out
    return {pre: tree}


def test_calibrated_qparams_tree_matches_jax():
    """Port calibrate + pre-quantization vs JAX quantize_serving_params +
    merge_act_scales: same keys, shapes (per depth) and dtypes; identical
    int8 weights and scales."""
    jp, tp = _pipes(quantize=True)
    jtree = jq.merge_act_scales(jq.quantize_serving_params(jp.params),
                                jp.calibrate(PROMPTS, num_points=POINTS,
                                             num_diffusion_steps=2))
    tp.calibrate(PROMPTS, num_points=POINTS, num_diffusion_steps=2,
                 generator=torch.Generator().manual_seed(0))
    ttree = tp.serving_qparams()
    jf, tf = _flat(jtree), _flat(ttree)
    assert jf.keys() == tf.keys()
    depth = 2
    for k in jf:
        j, t = np.asarray(jf[k]), tf[k].numpy()
        assert j.shape == t.shape and j.shape[0] == depth, k
        assert j.dtype == t.dtype, k
        if not k.split("/")[-1].startswith("a_"):
            assert np.array_equal(j, t), k
