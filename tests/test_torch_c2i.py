"""The c2i slice of the port (LabelEmbed, NOVATransformer.embed_label,
NOVAC2IPipeline, build_pipeline's c2i branch) vs the JAX package on the
CPU, on JAX-initialised weights (models/convert.convert_params); the
tolerances of test_torch_nova.py: f32 modules atol 2e-5 (1e-6 for the
label table's LayerNorm), the whole float sampler 5e-5 as a mean against a
replay of the JAX algorithm with the same order and noise, int8 modules
code for code (atol 1e-4; the JAX side's Pallas kernels in interpret mode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nova_pointcloud_tpu.models import embeddings as jemb
from nova_pointcloud_tpu.models import guidance as jguid
from nova_pointcloud_tpu.models.nova import NOVATransformer as JNOVA
from nova_pointcloud_tpu.ops import masking as jmask
from nova_pointcloud_tpu.ops import quantization as jquant
from nova_pointcloud_tpu_torch.models import embeddings as temb
from nova_pointcloud_tpu_torch.models import guidance as tguid
from nova_pointcloud_tpu_torch.models.convert import convert_params
from nova_pointcloud_tpu_torch.models.nova import NOVATransformer as TNOVA
from nova_pointcloud_tpu_torch.ops.kernels import LAUNCHES
from nova_pointcloud_tpu_torch.pipelines.builder import build_pipeline
from nova_pointcloud_tpu_torch.pipelines.nova_c2i import NOVAC2IPipeline
from nova_pointcloud_tpu_torch.pipelines.train_nova import NOVATrainC2IPipeline
from tests.test_torch_nova import (ARCH, SMALL, _encoder_inputs, _head_inputs, _models, _np,
                                   _t, _tpu_backend)
from tests.test_torch_nova_sampler import DIFF, STEPS, _jax_sample, _sampler_inputs

NUM_CLASSES = 10
# 4x4 patches: one phase (the masking path); test_torch_nova_sampler.py
# holds the bucket phases, which the conditioning does not reach
C2I = dict(SMALL, text_token_dim=None, num_classes=NUM_CLASSES)
LABELS = np.array([3, 7])


def _jax_label_cond(jm, params, labels):
    """The JAX pipeline's conditioning: [cond | null class]."""
    v = {"params": params}
    ids = jnp.asarray(labels, jnp.int32)
    return jnp.concatenate([jm.apply(v, ids, method=jm.embed_label),
                            jm.apply(v, jnp.full_like(ids, NUM_CLASSES),
                                     method=jm.embed_label)])


def test_label_embed_matches_jax():
    """The class table (num_classes + 1 rows, the last the null class) and
    its LayerNorm, 1-D ids as (B, 1) and 2-D ids."""
    jm, params, tm = _models(C2I)
    assert tm.label_embed.weight.shape == (NUM_CLASSES + 1, 64)
    for ids in (np.array([0, 3, 9, NUM_CLASSES]), np.array([[1, NUM_CLASSES], [4, 4]])):
        ref = jm.apply({"params": params}, jnp.asarray(ids, jnp.int32), method=jm.embed_label)
        got = tm.embed_label(torch.from_numpy(ids))
        assert got.shape == ref.shape == ids.reshape(len(ids), -1).shape + (64,)
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-6, rtol=0)


def test_text_embed_pad_embeds_matches_jax():
    """Positions at or past each prompt's length take the null bank's rows."""
    jte = jemb.TextEmbed(16, 64, 4)
    rng = np.random.default_rng(2)
    e = rng.standard_normal((3, 4, 16)).astype(np.float32)
    lengths = np.array([0, 2, 4], np.int32)
    params = jax.tree.map(np.asarray, jte.init(jax.random.PRNGKey(0), jnp.asarray(e))["params"])
    ref = jte.apply({"params": params}, jnp.asarray(e), jnp.asarray(lengths),
                    method=jte.pad_embeds)
    tte = temb.TextEmbed(16, 64, 4, device="cpu")
    tte.load_state_dict(convert_params(params), strict=True)
    np.testing.assert_array_equal(_np(tte.pad_embeds(_t(e), _t(lengths))), np.asarray(ref))
    np.testing.assert_array_equal(_np(tte.pad_embeds(_t(e))), e)


def test_float_c2i_sampler_matches_jax_replay():
    """NOVAC2IPipeline's whole float sampler (CFG 5 against the null
    class) against the JAX replay with the same order and noise."""
    jm, params, tm = _models(C2I)
    _, order, noise = _sampler_inputs(jm, 2, STEPS, DIFF, seed=21)
    c = _jax_label_cond(jm, params, LABELS)
    ref = _jax_sample(jm, {"params": params}, c, order, noise, STEPS, DIFF,
                      jguid.GuidanceConfig(guidance_scale=5.0), jit=True)
    out = NOVAC2IPipeline(tm)(list(LABELS), num_inference_steps=STEPS, num_diffusion_steps=DIFF,
                              guidance_scale=5.0, order=order, noise=noise)
    got = _np(out.latents)
    assert got.shape == ref.shape == (2, 8, 8, 4) and np.isfinite(got).all()
    assert np.abs(got - ref).mean() <= 5e-5
    assert not any(LAUNCHES.values())


def test_int8_c2i_step_matches_jax():
    """One int8 step of the c2i sampler, each stage on the JAX stage's
    inputs: the BOS frame with the class prefix through the video encoder,
    one image-encoder pass of the masking path on that condition, and one
    diffusion-head eval on the predicted slice, against the JAX model with
    its serving tree (interpret-mode Pallas), code for code; then the int8
    pipeline calibrates on class ids and serves."""
    _, params, tm_float = _models(C2I)  # the float weights, served int8
    jm = JNOVA(**C2I, quantize=True)
    tm = TNOVA(**C2I, quantize=True, device="cpu")
    tm.load_state_dict(tm_float.state_dict(), strict=True)
    jq = jquant.quantize_serving_params(params)
    qp = NOVAC2IPipeline(tm).serving_qparams()

    def japply(fn, *args, **kw):
        with _tpu_backend(), pltpu.force_tpu_interpret_mode():
            return jm.apply({"params": params, "qparams": jq}, *args, method=fn, **kw)

    c = _jax_label_cond(jm, params, LABELS)
    got_c = NOVAC2IPipeline(tm).encode_prompt(list(LABELS),
                                              guidance=tguid.GuidanceConfig(guidance_scale=5.0))
    np.testing.assert_allclose(_np(got_c), np.asarray(c), atol=1e-6, rtol=0)
    bos = jm.apply({"params": params}, 4, method=jm.bos_frame)
    cond = japply(jm.encode_video, bos, c, 1)
    got = tm.encode_video(tm.bos_frame(4), _t(c), 1, qparams=qp)
    np.testing.assert_allclose(_np(got), np.asarray(cond), atol=1e-4, rtol=0)
    tokens, mask, _ = _encoder_inputs(23, cfg=C2I, b=4)
    z = japply(jm.encode_image_step, jnp.asarray(tokens), jnp.asarray(mask), cond)
    got = tm.encode_image_step(_t(tokens), _t(mask), _t(cond), qparams=qp)
    np.testing.assert_allclose(_np(got), np.asarray(z), atol=1e-4, rtol=0)
    ids, _ = jmask.pred_slice(jnp.tile(jnp.arange(16, dtype=jnp.int32)[None], (4, 1)),
                              jnp.int32(0), jnp.int32(5), 5)
    z_sel = jnp.take_along_axis(z, ids[..., None], axis=1)
    x, t, _ = _head_inputs(24, b=4, p=5)
    pred = japply(jm.denoise_step, jnp.asarray(x), jnp.asarray(t), z_sel)
    got = tm.denoise_step(_t(x), _t(t), _t(z_sel), qparams=qp)
    np.testing.assert_allclose(_np(got), np.asarray(pred), atol=1e-4, rtol=0)
    # the int8 pipeline calibrates on class ids and serves (plain versions on the CPU)
    pipe = NOVAC2IPipeline(tm)
    pipe.calibrate(list(LABELS), num_inference_steps=2, num_diffusion_steps=DIFF)
    out = pipe(list(LABELS), num_inference_steps=3, num_diffusion_steps=DIFF,
               generator=torch.Generator().manual_seed(1)).latents
    assert out.shape == (2, 8, 8, 4) and torch.isfinite(out).all()
    assert not any(LAUNCHES.values())


def test_build_pipeline_c2i_branch():
    """build_pipeline's c2i branch from a reference-style config (patch
    size from image_stride, num_classes passed through) on the JAX weights:
    the same sampler as the pipeline built by hand, bitwise; its training
    branch builds NOVATrainC2IPipeline, whose loss on labels is finite."""
    jm, params, tm = _models(C2I)
    cfg = {"pipeline": {"name": "NOVAC2IPipeline"},
           "model": {"arch": list(ARCH), "image_dim": 4, "image_stride": 8,
                     "image_size": [64, 64], "image_base_size": [4, 4],
                     "video_base_size": [1, 2, 2], "num_classes": NUM_CLASSES},
           "scheduler": {"_sample_class_name": "FlowMatchEulerScheduler"}}
    sd = convert_params(jax.tree.map(np.asarray, params))
    pipe, state = build_pipeline(cfg, state_dict=sd, device="cpu")
    assert isinstance(pipe, NOVAC2IPipeline) and pipe.model.patch_size == 2
    assert pipe.model.num_classes == NUM_CLASSES and pipe.model.text_embed is None
    assert state.keys() == tm.state_dict().keys()
    _, order, noise = _sampler_inputs(jm, 2, 3, DIFF, seed=25)
    kw = dict(num_inference_steps=3, num_diffusion_steps=DIFF, order=order, noise=noise)
    a = pipe(list(LABELS), **kw).latents
    b = NOVAC2IPipeline(tm)(list(LABELS), **kw).latents
    assert torch.equal(a, b)
    assert not any(LAUNCHES.values())
    train, _ = build_pipeline({**cfg, "pipeline": {"name": "NOVATrainC2IPipeline"}},
                              state_dict=sd, device="cpu")
    assert isinstance(train, NOVATrainC2IPipeline) and train.model.num_classes == NUM_CLASSES
    losses = pipe.model.train_losses(torch.zeros((1, 8, 8, 4)), labels=torch.zeros(1).long(),
                                     generator=torch.Generator().manual_seed(0))
    assert set(losses) == {"loss"} and torch.isfinite(losses["loss"])
