"""NOVA text-to-video serving end to end on the CPU: the port's
``NOVAPipeline(vae=AutoencoderKLOpenSora(...))`` with ``output_type="np"``
against the JAX video sampler's replay (tests/test_torch_nova_video_sampler.py)
decoded by the JAX ``VaeImageProcessor``, window by window; tolerances as
tests/test_torch_nova_e2e.py states them."""

import jax.numpy as jnp
import numpy as np

from nova_pointcloud_tpu.models import guidance as jguid
from nova_pointcloud_tpu.schedulers import flow_match as jfm
from nova_pointcloud_tpu.utils.image_processor import VaeImageProcessor as JProcessor
from nova_pointcloud_tpu_torch.ops.kernels import LAUNCHES
from nova_pointcloud_tpu_torch.pipelines.nova import NOVAPipeline
from tests.test_torch_nova import _models
from tests.test_torch_nova_e2e import _codes_close, _vae
from tests.test_torch_nova_video import VIDEO
from tests.test_torch_nova_video_sampler import _draws, _jax_video


def test_t2v_np_output_matches_jax_replay():
    """T = 3: the video sampler's latent frames through OpenSora's
    window-by-window decode (latent_min_t 2: two windows, 5 + 4 frames) to
    (B, T', H, W, 3) uint8 ``frames``."""
    jm, params, tm = _models(VIDEO)
    jv, jp, tv = _vae("opensora", seed=42)
    text, order, noise, step_noise = _draws(jm, seed=43)
    guidance = jguid.GuidanceConfig(guidance_scale=5.0)
    lat = _jax_video(jm, {"params": params}, text, order, noise, step_noise, guidance,
                     jfm.FlowMatchEulerScheduler(), jit=True)
    proc = JProcessor(jv, jp)
    ref = proc.postprocess(proc.decode_latents(jnp.asarray(lat)), "np")
    out = NOVAPipeline(tm, vae=tv)(prompt_embeds=text, num_inference_steps=4,
                                   num_diffusion_steps=2, max_latent_length=3,
                                   guidance_scale=5.0, order=order, noise=noise,
                                   output_type="np")
    assert out.latents is None and out.images is None
    _codes_close(out.frames, np.asarray(ref), "t2v frames")
    assert out.frames.shape == (2, 9, 64, 64, 3)
    assert not any(LAUNCHES.values())
