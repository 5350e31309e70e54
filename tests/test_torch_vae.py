"""The VAE layer of the port vs the JAX package on the CPU: the building
blocks (flax GroupNorm, the causal conv, every resize, the frame attention,
the mid block), AutoencoderKL's and OpenSora's encode moments and decode
(CogVideoX's and LTX's: tests/test_torch_vae_video.py, with these helpers), the
temporal tiling, the image processor's window-by-window decode and uint8
postprocess, the flow-matching ``scale_noise`` and the torch-checkpoint
loaders, on the same numpy inputs and weights.

Weights: seeded numpy values on the JAX ``init`` tree's shapes (taken with
``jax.eval_shape``), every leaf non-zero, converted by
``models/convert.convert_vae_params``. The JAX side runs jitted (eager
JAX compiles every op's program on its first use, which takes longer).

Tolerances. f32: the same math in another summation order, max |diff| <=
1e-4 x max |JAX| (measured: 1e-6 to 5e-6 relative at these sizes). bf16
(the bench's setting: bf16 weights, ``dtype=bf16``): held to the JAX bf16
run's own distance from the f32 run on the same bf16 weights, as
tests/test_torch_nova.py's module docstring sets out: the port's bf16 output
no farther from that f32 result than 1.25x that distance, and no farther
from the JAX bf16 output than 2x. uint8 postprocess: bitwise.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from nova_pointcloud_tpu.models.autoencoders import autoencoder_kl as jkl
from nova_pointcloud_tpu.models.autoencoders import autoencoder_kl_cogvideox as jcog
from nova_pointcloud_tpu.models.autoencoders import autoencoder_kl_ltx as jltx
from nova_pointcloud_tpu.models.autoencoders import autoencoder_kl_opensora as jos
from nova_pointcloud_tpu.models.autoencoders import modeling_utils as jmu
from nova_pointcloud_tpu.models.autoencoders import torch_loading as jload
from nova_pointcloud_tpu.schedulers import flow_match as jfm
from nova_pointcloud_tpu.utils.image_processor import VaeImageProcessor as JProcessor
from nova_pointcloud_tpu_torch.models.autoencoders import autoencoder_kl as tkl
from nova_pointcloud_tpu_torch.models.autoencoders import autoencoder_kl_cogvideox as tcog
from nova_pointcloud_tpu_torch.models.autoencoders import autoencoder_kl_ltx as tltx
from nova_pointcloud_tpu_torch.models.autoencoders import autoencoder_kl_opensora as tos
from nova_pointcloud_tpu_torch.models.autoencoders import modeling_utils as tmu
from nova_pointcloud_tpu_torch.models.autoencoders import torch_loading as tload
from nova_pointcloud_tpu_torch.models import layers as tlayers
from nova_pointcloud_tpu_torch.models.convert import convert_vae_params
from nova_pointcloud_tpu_torch.models.layers import group_norm
from nova_pointcloud_tpu_torch.ops.kernels import LAUNCHES
from nova_pointcloud_tpu_torch.schedulers import flow_match as tfm
from nova_pointcloud_tpu_torch.utils.image_processor import VaeImageProcessor

OS_TYPES = dict(down_block_types=("DownEncoderBlock2D", "DownEncoderBlock2D",
                                  "DownEncoderBlock3D", "DownEncoderBlock3D"),
                up_block_types=("UpDecoderBlock2D", "UpDecoderBlock2D",
                                "UpDecoderBlock3D", "UpDecoderBlock3D"))
# name: (JAX class, port class, config, input (B, T, H, W, 3) or image, latents)
VAES = {
    "kl": (jkl.AutoencoderKL, tkl.AutoencoderKL,
           dict(block_out_channels=(32, 64), latent_channels=4, layers_per_block=1),
           (2, 16, 16, 3), (2, 8, 8, 4)),
    # latent T 3 at min_t 2 and 9 frames at min_t 5: two windows each way
    "opensora": (jos.AutoencoderKLOpenSora, tos.AutoencoderKLOpenSora,
                 dict(OS_TYPES, block_out_channels=(32, 32, 64, 64), latent_channels=4,
                      layers_per_block=1, sample_min_t=5, latent_min_t=2),
                 (1, 9, 32, 32, 3), (1, 3, 4, 4, 4)),
    "cogvideox": (jcog.AutoencoderKLCogVideoX, tcog.AutoencoderKLCogVideoX,
                  dict(block_out_channels=(32, 32, 32, 64), layers_per_block=1,
                       latent_channels=4, sample_min_t=5, latent_min_t=2),
                  (1, 9, 32, 32, 3), (1, 3, 4, 4, 4)),
    "ltx": (jltx.AutoencoderKLLTXVideo, tltx.AutoencoderKLLTXVideo,
            dict(block_out_channels=(8, 16, 16, 32, 32), layers_per_block=(1, 1, 1, 1, 1),
                 decoder_block_out_channels=(4, 8, 16, 32),
                 decoder_layers_per_block=(1, 1, 1, 1), latent_channels=8, patch_size=4,
                 sample_min_t=9, latent_min_t=2, use_latent_stats=True),
            (1, 17, 64, 64, 3), (1, 3, 2, 2, 8)),
}


def _np(t):
    return t.detach().float().cpu().numpy()


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _params(module, *init_args, seed=0, method=None):
    """Seeded non-zero numpy values on the JAX init tree's shapes: kernels
    N(0, 1/fan_in), biases and tables 0.05 N(0, 1), norm scales and latent
    scales 1 + 0.1 N(0, 1), ``timestep_scale`` 1000."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *init_args,
                                                method=method))["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            v = rng.standard_normal(s.shape) * np.prod(s.shape[:-1]) ** -0.5
        elif name in ("scale", "scaling_factors"):
            v = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif name == "timestep_scale":
            v = np.full(s.shape, 1000.0)
        else:
            v = 0.05 * rng.standard_normal(s.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _japply(module, params, *args, method=None):
    """``module.apply`` of (jitted) ``method`` on numpy args."""
    fn = jax.jit(lambda p, *a: module.apply(
        {"params": p}, *a, method=None if method is None else getattr(module, method)))
    return fn(params, *(jnp.asarray(a) for a in args))


def _close(got, ref, rel=1e-4):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def _bf16_gate(got, ref, ref32, what):
    noise = np.abs(ref - ref32).mean()
    to_exact, to_jax = np.abs(got - ref32).mean(), np.abs(got - ref).mean()
    assert noise > 0 and to_exact <= 1.25 * noise and to_jax <= 2 * noise, \
        (what, to_exact, to_jax, noise)


def _port(cls, params, bf16=False, **kw):
    m = cls(**kw, dtype=torch.bfloat16 if bf16 else None, device="cpu")
    m.load_state_dict(convert_vae_params(params), strict=True)
    return m.to(torch.bfloat16) if bf16 else m


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# -- building blocks ----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 6, 5, 64), (2, 3, 4, 4, 64)])
@pytest.mark.parametrize("bf16", [False, True])
def test_group_norm_matches_flax(shape, bf16, monkeypatch):
    """flax GroupNorm(32, 1e-6) (fast variance, float32 statistics over
    every axis but batch and group: time too on a video) against
    ``layers.group_norm`` with a small ``_GN_CHUNK`` (several chunks a tensor);
    the output dtype follows the input and the parameters."""
    x = _rand(1, *shape) * 3.0 + 1.5
    gn = fnn.GroupNorm(32, epsilon=1e-6)
    p = _params(gn, jnp.zeros(shape), seed=2)
    dt = jnp.bfloat16 if bf16 else jnp.float32
    pj = jax.tree.map(lambda a: jnp.asarray(a, dt), p)
    ref = _japply(gn, pj, jnp.asarray(x, dt))
    norm = torch.nn.GroupNorm(32, shape[-1], eps=1e-6)
    norm.load_state_dict(convert_vae_params(p))
    tdt = torch.bfloat16 if bf16 else torch.float32
    monkeypatch.setattr(tlayers, "_GN_CHUNK", 256)
    got = group_norm(_t(x).to(tdt), norm.to(tdt))
    assert got.dtype == tdt and str(ref.dtype) == str(tdt).split(".")[-1]
    if bf16:  # one rounding of the same f32 value: at most one bf16 step apart
        diff = np.abs(_np(got) - np.asarray(ref, np.float32))
        assert (diff <= 2.0 ** -7 * np.abs(np.asarray(ref, np.float32)) + 1e-6).all()
    else:
        _close(_np(got), ref, 1e-5)


@pytest.mark.parametrize("kernel,strides,pad", [((3, 3, 3), (1, 1, 1), None),
                                                ((3, 3, 3), (2, 2, 2), 0),
                                                ((1, 3, 3), (1, 1, 1), None),
                                                ((1, 1, 1), (1, 1, 1), None)])
def test_causal_conv3d_matches_jax(kernel, strides, pad):
    x = _rand(3, 1, 5, 9, 8, 16)
    jc = jos.CausalConv3d(24, kernel, strides, spatial_pad=pad)
    p = _params(jc, jnp.asarray(x), seed=4)
    tc = tos.CausalConv3d(16, 24, kernel, strides, spatial_pad=pad)
    tc.load_state_dict(convert_vae_params(p))
    _close(_np(tc(_t(x))), _japply(jc, p, x))


@pytest.mark.parametrize("t", [1, 2, 4])
def test_linear_resize_matches_jax_at_the_edges(t):
    """``_resize_linear`` (F.interpolate, half-pixel, align_corners=False)
    against ``jax.image.resize(..., "trilinear" / "linear")`` x2 over every
    frame, row and column, the edges included (JAX renormalises the weights
    that fall inside; PyTorch clamps the source coordinate: the same
    values)."""
    x = _rand(5, 2, t, 5, 7, 3)
    ref = jax.image.resize(jnp.asarray(x), (2, 2 * t, 10, 14, 3), "trilinear")
    _close(_np(tos._resize_linear(_t(x), (2 * t, 10, 14))), ref, 1e-6)
    ref2 = jax.image.resize(jnp.asarray(x[:, 0]), (2, 10, 14, 3), "linear")
    _close(_np(tos._resize_linear(_t(x[:, 0]), (10, 14))), ref2, 1e-6)


@pytest.mark.parametrize("mode,t", [("2d", None), ("3d_spatial", 3), ("3d_trilinear", 1),
                                    ("3d_trilinear", 3)])
def test_upsample_matches_jax(mode, t):
    shape = (2, 5, 6, 32) if t is None else (1, t, 5, 6, 32)
    x = _rand(6, *shape)
    ju = jos.Upsample(32, mode)
    p = _params(ju, jnp.asarray(x), seed=7)
    tu = tos.Upsample(32, mode)
    tu.load_state_dict(convert_vae_params(p))
    _close(_np(tu(_t(x))), _japply(ju, p, x))


@pytest.mark.parametrize("kind", ["kl", "os_2d", "os_3d"])
def test_downsample_and_kl_upsample_match_jax(kind):
    if kind == "kl":
        mods = [(jkl.Downsample(32), tkl.Downsample(32)), (jkl.Upsample(32), tkl.Upsample(32))]
        shape = (2, 7, 6, 32)
    else:
        three_d = kind == "os_3d"
        mods = [(jos.Downsample(32, three_d), tos.Downsample(32, three_d))]
        shape = (1, 5, 7, 6, 32) if three_d else (2, 7, 6, 32)
    x = _rand(8, *shape)
    for jm, tm in mods:
        p = _params(jm, jnp.asarray(x), seed=9)
        tm.load_state_dict(convert_vae_params(p))
        _close(_np(tm(_t(x))), _japply(jm, p, x))


@pytest.mark.parametrize("heads,video", [(1, False), (1, True), (2, True)])
def test_frame_attention_matches_jax(heads, video):
    """One head: q kᵀ in the input dtype, scaled after the product, float32
    softmax; two heads: flax's dot_product_attention. On a video the
    GroupNorm pools over the frames before the fold."""
    shape = (1, 3, 4, 5, 64) if video else (2, 4, 5, 64)
    x = _rand(10, *shape)
    ja = jos.FrameAttention(64, num_heads=heads)
    p = _params(ja, jnp.asarray(x), seed=11)
    ta = tos.FrameAttention(64, num_heads=heads)
    ta.load_state_dict(convert_vae_params(p))
    _close(_np(ta(_t(x))), _japply(ja, p, x))


@pytest.mark.parametrize("kind", ["kl", "os_2d", "os_3d"])
def test_mid_block_matches_jax(kind):
    if kind == "kl":
        jm, tm, shape = jkl.MidBlock(64), tkl.MidBlock(64), (2, 4, 5, 64)
    else:
        three_d = kind == "os_3d"
        jm, tm = jos.MidBlock(64, three_d), tos.MidBlock(64, three_d)
        shape = (1, 3, 4, 5, 64) if three_d else (2, 4, 5, 64)
    x = _rand(12, *shape)
    p = _params(jm, jnp.asarray(x), seed=13)
    tm.load_state_dict(convert_vae_params(p))
    _close(_np(tm(_t(x))), _japply(jm, p, x))


# -- whole VAEs -----------------------------------------------------------------------

def _vae(name, bf16=False, seed=20):
    jcls, tcls, cfg, xs, zs = VAES[name]
    jv = jcls(**cfg)
    p = _params(jv, jnp.zeros(xs), seed=seed)
    return jv, p, _port(tcls, p, bf16, **cfg), xs, zs


def check_encode_decode(name):
    """f32: the posterior's mean and logvar, and the decode (its temporal
    tiling running two windows for the video VAEs); no kernel launched."""
    jv, p, tv, xs, zs = _vae(name)
    x, z = _rand(21, *xs), _rand(22, *zs)
    dist = _japply(jv, p, x, method="encode")
    ref = _japply(jv, p, z, method="decode")
    with torch.no_grad():
        tdist = tv.encode(_t(x))
        got = tv.decode(_t(z))
    _close(_np(tdist.mean), dist.mean)
    _close(_np(tdist.logvar), dist.logvar)
    _close(_np(got), ref)
    assert not any(LAUNCHES.values())


def check_bf16(name):
    """bf16 weights with dtype=bf16 (the bench's serving setting): decode
    and encode moments held to the JAX bf16 run's distance from f32."""
    jcls, _, cfg, xs, zs = VAES[name]
    jv, p, tv, _, _ = _vae(name, bf16=True, seed=23)
    jb = jcls(**cfg, dtype=jnp.bfloat16)
    pb = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    p32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), pb)
    x, z = _rand(24, *xs), _rand(25, *zs)
    with torch.no_grad():
        got_z, got_x = tv.decode(_t(z)), tv.encode(_t(x)).mean
    for what, got, method, arg in (("decode", got_z, "decode", z), ("encode", got_x, "encode", x)):
        def run(mod, params):
            out = _japply(mod, params, arg, method=method)
            return np.asarray(out if method == "decode" else out.mean, np.float32)

        _bf16_gate(_np(got), run(jb, pb), run(jv, p32), f"{name} {what}")


def test_tiled_temporal_apply_matches_jax():
    """Windows every min_t - ovr_t frames, the first out_ovr_t frames of
    each later output dropped, a trailing remainder dropped (11 frames,
    windows of 4 every 3: 0, 3, 6; 9 + 4 > 11 is left out)."""
    x = _rand(26, 1, 11, 2, 2, 3)

    def fn(a):
        return a[:, ::2] * 2.0 + a.sum() * 0.01

    ref = jmu.tiled_temporal_apply(lambda a: fn(a), jnp.asarray(x), 4, 1, 1)
    got = tmu.tiled_temporal_apply(lambda a: fn(a), _t(x), 4, 1, 1)
    _close(_np(got), ref, 1e-6)
    assert got.shape[1] == 2 + 1 + 1
    short = tmu.tiled_temporal_apply(lambda a: a * 3.0, _t(x[:, :4]), 4, 1, 1)
    assert torch.equal(short, _t(x[:, :4]) * 3.0)


def test_processor_decode_matches_jax():
    """VaeImageProcessor: videos longer than one window (latent T 5 at
    min_t 2: windows 0-1, 1-2, 2-3, 3-4) in micro-batches of 2 over 3
    videos, against JAX's processor (its window-by-window ``_decode_video``)
    on the same scaled latents and against the VAE's own decode of the
    unscaled ones; latents pass through without a VAE."""
    jv, p, tv, _, _ = _vae("opensora", seed=27)
    z = _rand(28, 3, 5, 4, 4, 4)
    pj = jax.tree.map(jnp.asarray, p)
    proc = VaeImageProcessor(tv)
    with torch.no_grad():
        scaled = tv.scale(_t(z))
        out = proc.decode_latents(scaled)
        whole = tv.decode(_t(z))
    ref = JProcessor(jv, pj).decode_latents(jnp.asarray(_np(scaled)))
    assert out.shape == (3, 5 + 3 * 4, 32, 32, 3)  # 5 frames a window, the first dropped after it
    _close(_np(out), ref)
    _close(_np(out), _np(whole))
    lat = _t(z)
    assert VaeImageProcessor().decode_latents(lat) is lat
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        proc.device_params()


def test_postprocess_uint8_matches_jax_bitwise():
    """The uint8 codes of the port's postprocess on a tensor and on a numpy
    array equal JAX's ``_to_u8`` on the same floats, exact half-way and
    out-of-range values included."""
    x = np.random.default_rng(29).uniform(-1.3, 1.3, (2, 7, 9, 3)).astype(np.float32)
    x[0, 0, :5, 0] = [-1.0, 1.0, 0.0, 1.0 / 255 - 1.0, 2.0 / 255 - 1.0]
    ref = np.asarray(JProcessor().postprocess(jnp.asarray(x)))
    proc = VaeImageProcessor()
    got = proc.postprocess(_t(x))
    assert got.dtype == np.uint8 and np.array_equal(got, ref)
    assert np.array_equal(proc.postprocess(x), JProcessor.to_uint8(x))
    pil = proc.postprocess(_t(x), "pil")
    assert len(pil) == 2 and np.array_equal(np.asarray(pil[1]), ref[1])


def test_scale_noise_matches_jax():
    s = _rand(30, 2, 4, 4)
    n = _rand(31, 2, 4, 4)
    for shift in (1.0, 3.0):
        js = jfm.FlowMatchEulerScheduler(shift=shift).set_timesteps(7)
        ts = tfm.FlowMatchEulerScheduler(shift=shift).set_timesteps(7)
        for i in (0, 3, 7):
            ref = jfm.FlowMatchEulerScheduler().scale_noise(jnp.asarray(s), i, jnp.asarray(n), js)
            got = tfm.FlowMatchEulerScheduler().scale_noise(_t(s), i, _t(n), ts)
            np.testing.assert_array_equal(_np(got), np.asarray(ref))


def test_diagonal_gaussian_matches_jax():
    """sample with given eps (JAX threefry and torch Philox never match),
    in a dtype; mode; kl; the odd-channel trick; the identity
    distribution."""
    z = _rand(32, 2, 3, 3, 5) * 2.0
    jd, td = jmu.DiagonalGaussian.from_params(jnp.asarray(z)), \
        tmu.DiagonalGaussian.from_params(_t(z))
    eps = jax.random.normal(jax.random.PRNGKey(3), jd.mean.shape, jnp.float32)
    ref = jd.mean + jd.std * eps
    _close(_np(td.sample(eps=_t(eps))), ref, 1e-6)
    assert td.sample(eps=_t(eps), dtype=torch.bfloat16).dtype == torch.bfloat16
    _close(_np(td.kl()), jd.kl(), 1e-6)
    assert torch.equal(td.mode(), td.mean)
    ident = tmu.IdentityDistribution(_t(z))
    assert ident.sample() is ident.parameters and ident.mode() is ident.parameters


# -- torch-checkpoint loaders ---------------------------------------------------------

_BLOCK = re.compile(r"(down|up)_(\d+)_(res|resize|time_embed)(?:_(\d+))?$")


def _reference_names(params):
    """Invert the JAX loaders' mapping: the flax tree -> a reference-named
    torch state_dict (diffusers / OpenSoraPlan / LTX / CogVideoX names)."""
    sd = {}
    for path, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [k.key for k in path]
        leaf, parts = keys[-1], []
        for i, k in enumerate(keys[:-1]):
            last = i == len(keys) - 2
            m = _BLOCK.match(k)
            if m and m[3] == "res":
                parts += [f"{m[1]}_blocks", m[2], "resnets", m[4]]
            elif m and m[3] == "resize":
                parts += [f"{m[1]}_blocks", m[2],
                          "downsamplers" if m[1] == "down" else "upsamplers", "0"]
            elif m:
                parts += ["up_blocks", m[2], "time_embed", "timestep_proj"]
            elif re.fullmatch(r"mid_res_\d+", k):
                parts += ["mid_block", "resnets", k.rsplit("_", 1)[1]]
            elif re.fullmatch(r"(resnets|attentions)_\d+", k):
                parts += k.rsplit("_", 1)
            elif k == "mid_time_embed":
                parts += ["mid_block", "time_embed", "timestep_proj"]
            elif k == "time_embed":
                parts += ["time_embed", "timestep_proj"]
            elif k == "to_out":
                parts += ["to_out", "0"]
            elif k == "resize":  # OpenSora's resize wrapper is the reference's conv
                parts.append("conv")
            elif last and (k == "norm" or (k == "conv" and not _BLOCK.match(keys[i - 1]))):
                pass  # a wrapper's flax child (CausalConv3d.conv, AdaGroupNorm.norm)
            else:
                parts.append(k)
        v = np.asarray(v)
        if leaf == "kernel":
            leaf, v = "weight", np.transpose(v, {2: (1, 0), 4: (3, 2, 0, 1),
                                                  5: (4, 3, 0, 1, 2)}[v.ndim])
        elif leaf == "scale":
            leaf = "weight"
        sd[".".join(parts + [leaf])] = torch.from_numpy(np.array(v))
    return sd


LOADERS = {"kl": ("load_torch_vae_weights", "decode"),
           "opensora": ("load_torch_opensora_weights", "decode"),
           "ltx": ("load_torch_ltx_weights", "decode"),
           "cogvideox": ("load_torch_cogvideox_weights", "decode")}


def check_loader(name):
    """A reference-named state_dict (the JAX loader's mapping inverted):
    the JAX loader gives the JAX params back bitwise; the port's loader
    gives exactly convert_vae_params of them, and the port model loaded
    from it decodes bitwise as the one loaded from those (which
    check_encode_decode holds to the JAX model)."""
    jcls, tcls, cfg, xs, zs = VAES[name]
    jv = jcls(**cfg)
    p = _params(jv, jnp.zeros(xs), seed=33)
    sd = _reference_names(p)
    loader = LOADERS[name][0]
    back = getattr(jload, loader)(jv, sd)
    flat_p = jax.tree_util.tree_flatten_with_path(p)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_p) == len(flat_b)
    for path, v in flat_p:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), v)
    tv = tcls(**cfg, device="cpu")
    port_sd = getattr(tload, loader)(tv, sd)
    want = convert_vae_params(p)
    assert port_sd.keys() == want.keys()
    assert all(torch.equal(port_sd[k], want[k]) for k in want)
    tv.load_state_dict(port_sd, strict=True)
    z = _t(_rand(34, *zs))
    with torch.no_grad():  # check_encode_decode holds _port's model to JAX's
        assert torch.equal(tv.decode(z), _port(tcls, p, **cfg).decode(z))


@pytest.mark.parametrize("name", ["kl", "opensora"])
def test_vae_encode_and_decode_match_jax(name):
    check_encode_decode(name)


@pytest.mark.parametrize("name", ["kl", "opensora"])
def test_vae_bf16_matches_jax(name):
    check_bf16(name)


@pytest.mark.parametrize("name", ["kl", "opensora"])
def test_torch_loaders_match_jax(name):
    check_loader(name)
