"""NOVA serving end to end on the CPU, prompt to uint8 pixels: the port's
``NOVAPipeline(vae=...)`` with ``output_type="np"`` against the JAX
algorithm, replayed through the JAX model's methods with the same
prediction orders and noise (tests/test_torch_nova_sampler.py) and decoded
by the JAX ``VaeImageProcessor``, for T = 1 here and T = 3 in
tests/test_torch_nova_e2e_video.py; and ``encode_image``, the i2v prompt
image's latents, against the JAX pipeline's with the same eps, feeding the
``latents=`` prefill.

Tolerances. The latents agree to about 5e-5 (mean) before the decode, so a
uint8 code may sit on the other side of a rounding step: codes differ by at
most 1, and the share of codes that differ is printed (measured: none of
1536 for T = 1, 0.009% of 221184 for T = 3). The encoded latents: max |diff| <= 1e-4 x max |JAX|, as
tests/test_torch_vae.py's f32 tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nova_pointcloud_tpu.models import guidance as jguid
from nova_pointcloud_tpu.pipelines.nova import NOVAPipeline as JPipeline
from nova_pointcloud_tpu.schedulers import flow_match as jfm
from nova_pointcloud_tpu.utils.image_processor import VaeImageProcessor as JProcessor
from nova_pointcloud_tpu_torch.ops.kernels import LAUNCHES
from nova_pointcloud_tpu_torch.pipelines.nova import NOVAPipeline
from tests.test_torch_nova import SMALL, _models, _np
from tests.test_torch_nova_sampler import _jax_sample, _sampler_inputs
from tests.test_torch_nova_video import VIDEO
from tests.test_torch_vae import VAES, _close, _params, _port

STEPS, DIFF = 3, 2


def _vae(name, seed):
    """(JAX VAE, its params as jnp arrays, the port's VAE) at
    tests/test_torch_vae.py's small configurations."""
    jcls, tcls, cfg, xs, _ = VAES[name]
    jv = jcls(**cfg)
    p = _params(jv, jnp.zeros(xs), seed=seed)
    return jv, jax.tree.map(jnp.asarray, p), _port(tcls, p, **cfg)


def _codes_close(got, ref, what):
    assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape, (got.shape, ref.shape)
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    print(f"{what}: {100.0 * np.mean(diff > 0):.3f}% of {diff.size} codes differ, by at most "
          f"{diff.max()}")
    assert diff.max() <= 1
    assert ref.std() > 0  # not a constant image


def test_t2i_np_output_matches_jax_replay():
    """T = 1: the sampler's latents through AutoencoderKL's decode (two
    images in one micro-batch of 2) to (B, H, W, 3) uint8 ``images``."""
    jm, params, tm = _models(SMALL)
    jv, jp, tv = _vae("kl", seed=40)
    text, order, noise = _sampler_inputs(jm, 2, STEPS, DIFF, seed=41)
    guidance = jguid.GuidanceConfig(guidance_scale=5.0)
    c = jnp.concatenate([jm.apply({"params": params}, jnp.asarray(text), method=jm.embed_text),
                         jm.apply({"params": params}, 2, 4, method=jm.null_text)])
    lat = _jax_sample(jm, {"params": params}, c, order, noise, STEPS, DIFF, guidance, jit=True)
    proc = JProcessor(jv, jp)
    ref = proc.postprocess(proc.decode_latents(jnp.asarray(lat)), "np")
    out = NOVAPipeline(tm, vae=tv)(prompt_embeds=text, num_inference_steps=STEPS,
                                   num_diffusion_steps=DIFF, guidance_scale=5.0, order=order,
                                   noise=noise, output_type="np")
    assert out.latents is None and out.frames is None
    _codes_close(out.images, np.asarray(ref), "t2i images")
    assert out.images.shape == (2, 16, 16, 3)
    assert not any(LAUNCHES.values())


@pytest.mark.parametrize("name,size", [("kl", 16), ("opensora", 64)])
def test_encode_image_matches_jax_and_feeds_the_prefill(name, size):
    """``encode_image`` of a uint8 image with the JAX pipeline's eps (its
    default key's normal draw): the scaled posterior sample, repeated per
    image; an i2v call prefilled with it (OpenSora's latents are the
    video model's 8 x 8 frame) returns it bitwise as frame 0."""
    jv, jp, tv = _vae(name, seed=44)
    image = np.random.default_rng(45).integers(0, 256, (size, size, 3), dtype=np.uint8)
    jm, params, tm = _models(VIDEO)
    ref = JPipeline(jm, params, jfm.FlowMatchEulerScheduler(), vae=jv,
                    vae_params=jp).encode_image(image, num_images_per_prompt=2)
    eps = jax.random.normal(jax.random.PRNGKey(0), (1,) + ref.shape[1:], jnp.float32)
    pipe = NOVAPipeline(tm, vae=tv)
    got = pipe.encode_image(image, num_images_per_prompt=2, eps=torch.from_numpy(np.array(eps)))
    _close(_np(got), ref)
    assert torch.equal(got[0], got[1])
    # no eps: a seeded draw, the same on every call
    assert torch.equal(pipe.encode_image(image), pipe.encode_image(image))
    if name == "opensora":
        text = np.random.default_rng(46).standard_normal((2, 4, 16)).astype(np.float32)
        out = pipe(prompt_embeds=text, num_inference_steps=2, num_diffusion_steps=1,
                   max_latent_length=2, guidance_scale=5.0, latents=got)
        assert torch.equal(out.latents[:, 0], got)
    assert not any(LAUNCHES.values())
