"""The port's pc model and t2pc pipeline vs the JAX package, at pc_d2w64
with 64 points, on converted JAX weights.

Every JAX parameter gets seeded N(0, 0.05) noise added, so biases,
LayerNorms and the zero-initialised ``output_proj`` are non-zero and the
sampled cloud depends on every block. The int8 reference is the JAX
pipeline on its TPU serving path: the fused Pallas kernels in interpret
mode, with ``jax.default_backend`` patched to report "tpu" inside the test
only (the JAX package takes that path only on a TPU).
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nova_pointcloud_tpu.models.pointcloud import NOVAPointCloudTransformer as JModel
from nova_pointcloud_tpu.models.text_encoders.dummy import DummyTextEncoder as JEnc
from nova_pointcloud_tpu.models.pointcloud import PreLNBlock as JBlock
from nova_pointcloud_tpu.ops import quantization as jq
from nova_pointcloud_tpu.ops.pallas import fused_block as jfb
from nova_pointcloud_tpu.pipelines.builder import build_pipeline as jbuild_pipeline
from nova_pointcloud_tpu.pipelines.pointcloud_gen import (
    NOVAPointCloudGenerationPipeline as JPipe)
from nova_pointcloud_tpu.schedulers.ddpm import DDPMScheduler as JDDPM
from nova_pointcloud_tpu.utils import config as jconfig
from nova_pointcloud_tpu_torch.models import pointcloud as tpc
from nova_pointcloud_tpu_torch.models.convert import convert_params, convert_tree
from nova_pointcloud_tpu_torch.models.pointcloud import NOVAPointCloudTransformer as TModel
from nova_pointcloud_tpu_torch.models.text_encoders.dummy import DummyTextEncoder as TEnc
from nova_pointcloud_tpu_torch.ops.kernels import LAUNCHES
from nova_pointcloud_tpu_torch.ops.kernels import fused_block as tfb
from nova_pointcloud_tpu_torch.pipelines.builder import build_pipeline as tbuild_pipeline
from nova_pointcloud_tpu_torch.pipelines.pointcloud_gen import (
    NOVAPointCloudGenerationPipeline as TPipe)
from nova_pointcloud_tpu_torch.schedulers.ddpm import DDPMScheduler as TDDPM
from nova_pointcloud_tpu_torch.utils import config as tconfig

ARCH, POINTS, TOK_DIM, N_TOK = "pc_d2w64", 64, 32, 8
PROMPTS = ["a chair", "a tall lamp"]
# 5 leading-spaced steps are t = 800, 600, 400, 200, 0: guidance truncation
# at 800 (the flagship's) runs one CFG step at 2x batch, then four
# cond-only steps at 1x
STEPS, TRUNC = 5, 800.0


def _model_kw(quantize):
    return dict(arch=ARCH, point_cloud_size=POINTS, patch_size=1,
                text_token_dim=TOK_DIM, quantize=quantize)


@functools.lru_cache(maxsize=None)
def _jax_params(seed=0):
    """The JAX model's params (numpy, seeded noise on every leaf), built once
    a module per seed (the tests do not modify them)."""
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


@functools.lru_cache(maxsize=None)
def _jax_scales():
    """The JAX pipeline's calibration (its act-scale tree), computed once a
    module."""
    jp, _ = _pipes(quantize=True)
    return jp.calibrate(PROMPTS, num_points=POINTS, num_diffusion_steps=STEPS)


def _int8_pair(calibrated):
    """Fresh int8 pipelines (each test's own: the split-path tests patch the
    route the pipelines compile), both serving the JAX calibration when
    ``calibrated``."""
    jp, tp = _pipes(quantize=True)
    if calibrated:
        jp.act_scales = _jax_scales()
        tp.act_scales = convert_tree(jp.act_scales)
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
    assert not any(LAUNCHES.values())


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


# -- the per-point paths: split int8 serving and float serving through flash ----

def _boom(*a, **kw):
    raise AssertionError("the one-kernel attention sub-block must not run on the split path")


def _split_path():
    """Both packages take the split int8 path at this small size: the JAX
    rule (imported inside PreLNBlock._fused_attention) and the port's are
    patched to report a footprint past the 14 MiB limit, and the one-kernel
    attention block of either side fails the test if it is reached."""
    stack = mock.patch.multiple(jfb, attention_block_vmem_bytes=lambda t, d: 1 << 40,
                                fused_attention_block=_boom)
    tstack = mock.patch.multiple(tfb, attention_block_vmem_bytes=lambda t, d: 1 << 40)
    tblock = mock.patch.object(tpc, "fused_attention_block", _boom)
    tpu = mock.patch.object(jax, "default_backend", lambda: "tpu")

    class _All:
        def __enter__(self):
            self.cms = [stack, tstack, tblock, tpu, pltpu.force_tpu_interpret_mode()]
            for cm in self.cms:
                cm.__enter__()

        def __exit__(self, *exc):
            for cm in reversed(self.cms):
                cm.__exit__(*exc)

    return _All()


@pytest.mark.parametrize("calibrated", [True, False])
def test_split_path_block_matches_jax(calibrated):
    """One PreLNBlock on the split path: LN + QKV kernel, plain core in the
    activation dtype, out-projection + residual kernel, MLP kernel."""
    jp, tp = _int8_pair(calibrated)
    qp = jq.quantize_serving_params(jp.params)
    if calibrated:
        qp = jq.merge_act_scales(qp, jp.act_scales)
    layer = 1
    pick = lambda tree: jax.tree.map(lambda a: a[layer], tree)  # noqa: E731
    bparams = pick(jp.params["blocks"]["layers"]["block"])
    bq = pick(qp["blocks"]["layers"]["block"])
    x = np.random.default_rng(17).standard_normal((3, POINTS, 64)).astype(np.float32)
    with _split_path():
        ref = np.asarray(JBlock(64, 2, dropout=0.0, quantize=True).apply(
            {"params": bparams, "qparams": bq}, jnp.asarray(x)))
        got = tp.model.blocks.layers[layer].int8_forward(torch.from_numpy(x), convert_tree(bq))
    # every int8 code agrees on these inputs: f32 summation order only
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("calibrated", [True, False])
def test_split_path_forward_matches_jax(calibrated):
    jp, tp = _int8_pair(calibrated)
    qp = jq.quantize_serving_params(jp.params)
    if calibrated:
        qp = jq.merge_act_scales(qp, jp.act_scales)
    tqp = convert_tree(qp)
    rng = np.random.default_rng(12)
    text = jp.encode_prompt(PROMPTS)
    for t in (800, 0):
        x = rng.standard_normal((4, POINTS, 3)).astype(np.float32)
        ts = np.full((4,), t, np.int32)
        with _split_path():
            ref = np.asarray(jp.model.apply({"params": jp.params, "qparams": qp},
                                            jnp.asarray(x), jnp.asarray(ts), jnp.asarray(text)))
            got = tp.model(torch.from_numpy(x), torch.from_numpy(ts), torch.from_numpy(text),
                           qparams=tqp).numpy()
        err = np.abs(got - ref)
        # as test_int8_forward_matches_fused_jax: a flipped code costs ~1e-3
        assert err.mean() < 1e-3 and err.max() < 5e-2, (t, err.mean(), err.max())


@pytest.mark.parametrize("calibrated", [True, False])
def test_split_path_pipeline_matches_jax(calibrated):
    """The whole int8 per-point path, held to its own measured floor. At this
    size (eval postprocess) the JAX split path against itself with latents
    moved by 1e-6 differs by mean 2.6e-3 to 4.0e-3 (three shifts, calibrated
    and per-row MLP scales); the port against JAX by 6.1e-3 (calibrated) and
    3.9e-3 (per row), 61% and 63% of coordinates within 1e-4. The bound is
    2 x the largest floor + 1e-3; dropped act scales cost 1.9e-2 (above)."""
    jp, tp = _int8_pair(calibrated)
    with _split_path():
        ref, got = _sample(jp, tp, "eval", tpu_path=True)
    for g, r in ((got.point_clouds, ref.point_clouds), (got.colors, ref.colors)):
        err = np.abs(g - np.asarray(r))
        assert err.mean() < SPLIT_INT8_MEAN_ATOL, err.mean()
        assert np.mean(err < 1e-4) > 0.5, np.mean(err < 1e-4)
    assert not any(LAUNCHES.values())


SPLIT_INT8_MEAN_ATOL = 9e-3


def _pallas_pair(seed=0):
    """Float per-point models whose attention is forced onto the kernel
    route: the Pallas kernel (interpret mode) in JAX, the flash wrapper's
    plain version on CPU tensors in the port."""
    params = _jax_params(seed)
    jm = JModel(**_model_kw(False), dropout=0.0, attn_impl="pallas")
    tm = TModel(**_model_kw(False), attn_impl="pallas", device="cpu")
    tm.load_state_dict(convert_params(params))
    return jm, params, tm


def test_float_forward_through_flash_matches_jax():
    jm, params, tm = _pallas_pair()
    x, t, text = _inputs()
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                                  jnp.asarray(text)))
    with mock.patch.object(tpc, "dot_product_attention", _boom):  # blocks take the kernel route
        tm2 = TModel(**_model_kw(False), attn_impl="pallas", device="cpu")
    tm2.load_state_dict(tm.state_dict())
    tm2.cluster.cluster_attn.attention_fn = tm.cluster.cluster_attn.attention_fn
    got = tm2(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(text))
    assert np.abs(ref).max() > 0.1
    # f32 on both sides, online softmax vs one pass: as the float forward test
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("postprocess", ["standard", "eval"])
def test_float_pipeline_through_flash_matches_jax(postprocess):
    jm, params, tm = _pallas_pair()
    jp = JPipe(jm, params, JDDPM(beta_schedule="squaredcos_cap_v2"),
               text_encoder=JEnc(TOK_DIM, N_TOK))
    tp = TPipe(tm, TDDPM(beta_schedule="squaredcos_cap_v2"), text_encoder=TEnc(TOK_DIM, N_TOK))
    with pltpu.force_tpu_interpret_mode():
        ref, got = _sample(jp, tp, postprocess)
    np.testing.assert_allclose(got.point_clouds, ref.point_clouds, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.colors, ref.colors, atol=1e-4, rtol=0)
    assert not any(LAUNCHES.values())


@pytest.mark.parametrize("t,d,fused", [
    (128, 1024, True), (435, 1024, True), (436, 1024, False), (607, 768, True),
    (608, 768, False), (161, 1536, True), (162, 1536, False), (2048, 768, False),
    (2048, 1024, False), (64, 64, True)])
def test_fused_or_split_rule_is_jax(t, d, fused):
    """The 14 MiB rule of PreLNBlock._fused_attention, on both estimates."""
    assert (jfb.attention_block_vmem_bytes(t, d) <= 14 * 2**20) == fused
    assert (tfb.attention_block_vmem_bytes(t, d) <= tpc.FUSED_ATTENTION_MAX_BYTES) == fused


# -- build_pipeline and the config utilities --------------------------------------

PC_CONFIG = {"pipeline": {"name": "NOVAPointCloudGenerationPipeline"}, "model": {},
             "scheduler": {"class_name": "DDPMScheduler", "beta_schedule": "squaredcos_cap_v2",
                           "_sample_class_name": "DDPMScheduler"}}


def test_build_pipeline_defaults_are_the_per_point_model():
    """build_pipeline's defaults: pc_d8w768, 2048 points, every point a token,
    text dim 256; the module tree has the converted JAX tree's names and
    shapes (the JAX tree by eval_shape: nothing of that size is computed)."""
    jp, _ = jbuild_pipeline(PC_CONFIG, params={})
    tp, state = tbuild_pipeline(PC_CONFIG, device="cpu")
    jm, tm = jp.model, tp.model
    for attr in ("arch", "point_cloud_size", "patch_size", "text_token_dim", "text_pool",
                 "num_tokens", "quantize", "attn_impl", "attn_core"):
        assert getattr(jm, attr) == getattr(tm, attr), attr
    assert (tm.arch, tm.num_tokens, tm.patch_size) == ("pc_d8w768", 2048, 1)
    assert tp.text_encoder is None and jp.text_encoder is None
    assert _sched_fields(jp.scheduler) == _sched_fields(tp.scheduler)
    shapes = jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 2048, 3)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 16, 256)))["params"]
    want = convert_params(jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes))
    assert {k: tuple(v.shape) for k, v in want.items()} == \
        {k: tuple(v.shape) for k, v in state.items()}


def _sched_fields(sched):
    return {k: getattr(sched, k) for k in ("num_train_timesteps", "beta_schedule",
                                           "prediction_type", "variance_type",
                                           "timestep_spacing", "clip_sample")}


def test_built_pipelines_agree():
    """Both build_pipeline functions from one config dict and one set of weights, at
    pc_d2w64; the caller sets the text encoder, as both leave it."""
    cfg = dict(PC_CONFIG, model={"arch": ARCH, "point_cloud_size": POINTS,
                                 "text_token_dim": TOK_DIM})
    params = _jax_params(3)
    jp, _ = jbuild_pipeline(cfg, params=params)
    tp, state = tbuild_pipeline(cfg, state_dict=convert_params(params), device="cpu")
    assert set(state) == set(convert_params(params))
    jp.text_encoder, tp.text_encoder = JEnc(TOK_DIM, N_TOK), TEnc(TOK_DIM, N_TOK)
    ref, got = _sample(jp, tp, "eval")
    np.testing.assert_allclose(got.point_clouds, ref.point_clouds, atol=1e-4, rtol=0)
    seeded, _ = tbuild_pipeline(cfg, seed=5, device="cpu")
    again, _ = tbuild_pipeline(cfg, seed=5, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(seeded.model.state_dict().values(),
                                                 again.model.state_dict().values()))
    assert float(seeded.model.output_proj.weight.detach().abs().max()) == 0.0  # zero-init head


def test_config_utilities_match_jax():
    nested = {"model": {"arch": "pc_d8w768", "dims": [1, {"a": 2}]}, "training": {"lr": 1e-3}}
    for mod in (jconfig, tconfig):
        cfg = mod.Config.wrap(nested)
        assert cfg.model.arch == "pc_d8w768" and cfg.model.dims[1].a == 2
        assert cfg.to_dict() == nested  # round trip
        mod.set_by_path(cfg, "training.opt.name", "adamw")
        mod.merge(cfg, {"model": {"patch_size": 1}, "seed": 3})
        assert mod.get_by_path(cfg, "training.opt.name") == "adamw"
        assert mod.get_by_path(cfg, "model.nope.deeper", 7) == 7
        assert cfg.model.patch_size == 1 and cfg.model.arch == "pc_d8w768"
    j, t = (m.Config.wrap(nested) for m in (jconfig, tconfig))
    for m, c in ((jconfig, j), (tconfig, t)):
        m.set_by_path(c, "a.b.c", {"x": [1, 2]})
        m.merge(c, {"model": {"arch": "pc_d2w64"}})
    assert j.to_dict() == t.to_dict()
    assert jconfig.flatten_config(j) == tconfig.flatten_config(t)


def test_load_config_reads_yaml(tmp_path):
    path = tmp_path / "pc.yaml"
    path.write_text("pipeline:\n  name: NOVAPointCloudGenerationPipeline\nmodel:\n"
                    "  arch: pc_d2w64\n  point_cloud_size: 64\n"
                    "scheduler:\n  class_name: DDPMScheduler\n")
    assert tconfig.load_config(str(path)).to_dict() == jconfig.load_config(str(path)).to_dict()
    pipe, _ = tbuild_pipeline(tconfig.load_config(str(path)), device="cpu")
    assert pipe.model.arch == "pc_d2w64" and pipe.model.num_tokens == 64
