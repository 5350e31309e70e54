"""The point-cloud AR refinement mode of the port vs the JAX package on the
CPU: the point ops it and the masked-AR script use (Morton codes and sort,
farthest point sampling, the feature-aware interpolation, adaptive
resampling), the refinement modules (EdgeAligner, ARSubsetDiffusion,
ARRefiner(64, 4, depth=1), as the JAX package's e2e test builds it) and the
generation pipeline with ``use_autoregressive=True``, on converted JAX
weights with every leaf moved by seeded N(0, 0.05) noise (so the refiner's
zero-initialised head is live).

Tolerances: the integer ops (Morton codes, the sort, FPS's picks) exactly
equal; the float point ops to 1e-6; the modules to 1e-5 relative (f32 on
both sides, sums in another order); the whole refinement mode to 1e-4
(the DDPM trajectory's f32 differences, carried through 8 refinement
steps, as the pipeline tests of tests/test_torch_pointcloud.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nova_pointcloud_tpu.models import pointcloud as jpc
from nova_pointcloud_tpu.models.text_encoders.dummy import DummyTextEncoder as JEnc
from nova_pointcloud_tpu.ops import pointops as jops
from nova_pointcloud_tpu.pipelines.pointcloud_gen import (
    NOVAPointCloudGenerationPipeline as JPipe)
from nova_pointcloud_tpu.schedulers.ddpm import DDPMScheduler as JDDPM
from nova_pointcloud_tpu_torch.models import pointcloud as tpc
from nova_pointcloud_tpu_torch.models.convert import convert_params
from nova_pointcloud_tpu_torch.models.text_encoders.dummy import DummyTextEncoder as TEnc
from nova_pointcloud_tpu_torch.ops import pointops as tops
from nova_pointcloud_tpu_torch.ops.kernels import LAUNCHES
from nova_pointcloud_tpu_torch.pipelines.pointcloud_gen import (
    NOVAPointCloudGenerationPipeline as TPipe)
from nova_pointcloud_tpu_torch.schedulers.ddpm import DDPMScheduler as TDDPM
from tests.test_torch_pointcloud import _jax_params as _pc_jax_params
from tests.test_torch_pointcloud import _model_kw as _pc_model_kw

EMBED, HEADS, POINTS, SUBSETS = 64, 4, 128, 8
S0 = POINTS // SUBSETS


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, ref, rtol, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert np.isfinite(got).all() and err <= rtol, (what, err)


def _noisy(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (np.asarray(p) + rng.normal(0, 0.05, p.shape))
                        .astype(np.float32), params)


# -- point ops ---------------------------------------------------------------------

def _clouds(seed, b=3, n=256, lo=-1.2, hi=1.2):
    """Points in [lo, hi] (some outside [-1, 1], where the codes clip) with a
    run of duplicates, so equal codes must keep their order."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(lo, hi, (b, n, 3)).astype(np.float32)
    pts[:, 10:20] = pts[:, 5:6]
    return pts


@pytest.mark.parametrize("bits", [10, 4])
def test_morton_codes_and_sort_match_jax(bits):
    pts = _clouds(0)
    ref = np.asarray(jops.morton_codes(jnp.asarray(pts), bits)).astype(np.int64)
    got = tops.morton_codes(_t(pts), bits)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(tops.morton_sort(_t(pts), bits).numpy(),
                                  np.asarray(jops.morton_sort(jnp.asarray(pts), bits)))


def test_farthest_point_sampling_matches_jax():
    pts = _clouds(1, lo=-1.0, hi=1.0)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jops.farthest_point_sampling(jnp.asarray(pts), 32, key))
    start = np.asarray(jax.random.randint(key, (pts.shape[0],), 0, pts.shape[1]))
    got = tops.farthest_point_sampling(_t(pts), 32, start=_t(start))
    np.testing.assert_array_equal(got.numpy(), ref)  # the same points picked
    g = torch.Generator().manual_seed(0)
    drawn = tops.farthest_point_sampling(_t(pts), 32, g)
    assert drawn.shape == (3, 32, 3)


@pytest.mark.parametrize("n,target", [(256, 48), (40, 64), (64, 64)])
def test_interpolation_and_adaptive_sampling_match_jax(n, target):
    pts = _clouds(2, n=n)[:, :n]
    key = jax.random.PRNGKey(4)
    perm = np.asarray(jax.random.permutation(key, n))
    ref = np.asarray(jops.feature_aware_interpolation(jnp.asarray(pts), target, key))
    got = tops.feature_aware_interpolation(_t(pts), target, perm=_t(perm))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    ref = np.asarray(jops.adaptive_sampling(jnp.asarray(pts), target, key))
    got = tops.adaptive_sampling(_t(pts), target, perm=_t(perm))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    drawn = tops.adaptive_sampling(_t(pts), target, torch.Generator().manual_seed(0))
    assert drawn.shape == (3, target, 3)


# -- the refinement modules ----------------------------------------------------------

def _module_inputs(seed, valid):
    """Current subset (B, S0, 3), generated points (B, M, 3) with the not yet
    generated ones at the origin, gen_valid, progress."""
    rng = np.random.default_rng(seed)
    b = 2
    cur = rng.uniform(-1, 1, (b, S0, 3)).astype(np.float32)
    gen = rng.uniform(-1, 1, (b, POINTS, 3)).astype(np.float32)
    if valid == "none":
        gv = np.zeros((b, POINTS), np.float32)
    else:
        gv = (rng.random((b, POINTS)) < 0.4).astype(np.float32)
        gv[1, :] = 0.0  # one sample still empty while the other is part-way
    gen = gen * gv[..., None]
    progress = np.array([0.25, 0.0], np.float32)
    return cur, gen, gv, progress


def _jax_module(name):
    if name == "edge_aligner":
        return jpc.EdgeAligner(EMBED, 8)
    if name == "subset_diffusion":
        return jpc.ARSubsetDiffusion(EMBED, HEADS)
    return jpc.ARRefiner(EMBED, HEADS, depth=1)


def _port_module(name):
    if name == "edge_aligner":
        return tpc.EdgeAligner(EMBED, 8)
    if name == "subset_diffusion":
        return tpc.ARSubsetDiffusion(EMBED, HEADS)
    return tpc.ARRefiner(EMBED, HEADS, depth=1, device="cpu")


def _module_args(name, cur, gen, gv, progress, seed):
    """Features as the refiner makes them, a function of the points (a
    random lift and a tanh): points at the origin share one feature, so
    the kNN's choice among such ties (which JAX's top_k and torch.topk
    break differently) changes no edge feature."""
    rng = np.random.default_rng(seed + 100)
    w = rng.standard_normal((3, EMBED)).astype(np.float32)
    b = rng.standard_normal(EMBED).astype(np.float32) * 0.1
    cf, gf = (np.tanh(p @ w + b).astype(np.float32) for p in (cur, gen))
    if name == "edge_aligner":
        return (cur, cf, gen, gf, gv)
    if name == "subset_diffusion":
        return (cf, gf, progress, cur, gen, gv)
    return (cur, gen, gv, progress)


@pytest.mark.parametrize("valid", ["none", "part"])
@pytest.mark.parametrize("name", ["edge_aligner", "subset_diffusion", "refiner"])
def test_refinement_modules_match_jax(name, valid):
    """Each module on converted weights, with every generated slot invalid
    (the first subset step: a fully masked attention row must give flax's
    uniform softmax, not NaN) and part valid."""
    jmod = _jax_module(name)
    args = _module_args(name, *_module_inputs(5, valid), 5)
    params = _noisy(jmod.init(jax.random.PRNGKey(0), *map(jnp.asarray, args))["params"], 6)
    ref = np.asarray(jmod.apply({"params": params}, *map(jnp.asarray, args)))
    tmod = _port_module(name)
    tmod.load_state_dict(convert_params(params), strict=True)
    with torch.no_grad():
        got = tmod(*map(_t, args)).numpy()
    assert np.isfinite(ref).all() and got.shape == ref.shape
    _rel(got, ref, 1e-5, name)


def test_refiner_init_weights_has_a_zero_head():
    r = tpc.ARRefiner(EMBED, HEADS, depth=1, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    cur, gen, gv, progress = (_t(a) for a in _module_inputs(7, "part"))
    with torch.no_grad():
        assert torch.equal(r(cur, gen, gv, progress), cur)
    assert set(r.state_dict()) == set(convert_params(_noisy(_jax_module("refiner").init(
        jax.random.PRNGKey(0), *map(jnp.asarray, (cur.numpy(), gen.numpy(), gv.numpy(),
                                                   progress.numpy())))["params"], 0)))


# -- the generation pipeline's refinement mode ---------------------------------------

def _refine_pipes():
    pc_params = _pc_jax_params(0)
    jm = jpc.NOVAPointCloudTransformer(**_pc_model_kw(False), dropout=0.0)
    tm = tpc.NOVAPointCloudTransformer(**_pc_model_kw(False), device="cpu")
    tm.load_state_dict(convert_params(pc_params))
    n = tm.point_cloud_size
    jref = jpc.ARRefiner(EMBED, HEADS, depth=1)
    rp = _noisy(jref.init(jax.random.PRNGKey(1), jnp.zeros((1, n // SUBSETS, 3)),
                          jnp.zeros((1, n, 3)), jnp.zeros((1, n)), jnp.zeros((1,)))["params"], 2)
    tref = tpc.ARRefiner(EMBED, HEADS, depth=1, device="cpu")
    tref.load_state_dict(convert_params(rp), strict=True)
    enc_dim, enc_len = 32, 8
    jp = JPipe(jm, pc_params, JDDPM(beta_schedule="squaredcos_cap_v2"),
               text_encoder=JEnc(enc_dim, enc_len), ar_refiner=jref, ar_params=rp)
    tp = TPipe(tm, TDDPM(beta_schedule="squaredcos_cap_v2"), text_encoder=TEnc(enc_dim, enc_len),
               ar_refiner=tref)
    return jp, tp, n


def test_refinement_mode_matches_jax():
    """use_autoregressive=True, deterministic, given latents: the JAX
    pipeline's partition (drawn from its key) handed to the port."""
    jp, tp, n = _refine_pipes()
    prompts = ["a chair", "a tall lamp"]
    latents = np.random.default_rng(8).standard_normal((2, n, 3)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    kw = dict(num_points=n, num_diffusion_steps=3, guidance_scale=7.5,
              use_autoregressive=True, num_subsets=SUBSETS, deterministic=True)
    ref = jp(prompts, key=key, latents=jnp.asarray(latents), **kw)
    k_ar = jax.random.split(key, 5)[4]
    k_part, _ = jax.random.split(k_ar)
    order, ids = (np.array(a) for a in jops.dynamic_partition(k_part, n, SUBSETS))
    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
    got = tp(prompts, latents=latents, partition=(order, ids), **kw)
    assert not any(LAUNCHES.values())
    np.testing.assert_allclose(got.point_clouds, ref.point_clouds, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.colors, ref.colors, atol=1e-4, rtol=0)
    # the refiner moved the points: the mode is not a pass-through
    plain = tp(prompts, latents=latents, **dict(kw, use_autoregressive=False,
                                                postprocess="eval"))
    assert np.abs(got.point_clouds - plain.point_clouds).mean() > 1e-3


def test_refinement_mode_draws_its_partition():
    """Without a partition the mode draws one from the generator: the same
    seed gives the same cloud, another seed another."""
    _, tp, n = _refine_pipes()

    def run(seed):
        return tp(["a chair"], num_points=n, num_diffusion_steps=2, use_autoregressive=True,
                  num_subsets=SUBSETS, generator=torch.Generator().manual_seed(seed)
                  ).point_clouds

    a, b, c = run(1), run(1), run(2)
    assert np.array_equal(a, b) and not np.allclose(a, c)
