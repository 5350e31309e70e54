"""Guards of the port package: it imports without CUDA and without JAX,
its entry points never run quietly on the CPU, and the CPU runs no kernel."""

import ast
import importlib
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import nova_pointcloud_tpu_torch
from nova_pointcloud_tpu_torch.models import pointcloud
from nova_pointcloud_tpu_torch.models.autoencoders import AutoencoderKL, AutoencoderKLOpenSora
from nova_pointcloud_tpu_torch.models.nova import NOVATransformer
from nova_pointcloud_tpu_torch.models.pointcloud import NOVAPointCloudTransformer, PreLNBlock
from nova_pointcloud_tpu_torch.models.text_encoders.dummy import DummyTextEncoder
from nova_pointcloud_tpu_torch.models.text_encoders.phi import (PhiConfig, PhiEncoderModel,
                                                                PhiTextEncoder)
from nova_pointcloud_tpu_torch.ops.attention import attention
from nova_pointcloud_tpu_torch.ops.kernels import LAUNCHES, flash_attention, fused_block
from nova_pointcloud_tpu_torch.pipelines.builder import build_pipeline
from nova_pointcloud_tpu_torch.pipelines.nova import NOVAPipeline
from nova_pointcloud_tpu_torch.pipelines.nova_c2i import NOVAC2IPipeline
from nova_pointcloud_tpu_torch.pipelines.pretrained import from_pretrained
from nova_pointcloud_tpu_torch.pipelines.pointcloud_gen import NOVAPointCloudGenerationPipeline
from nova_pointcloud_tpu_torch.pipelines.train_nova import (NOVATrainC2IPipeline,
                                                            NOVATrainT2IPipeline,
                                                            NOVATrainT2VPipeline)
from nova_pointcloud_tpu_torch.schedulers.builder import build_scheduler
from nova_pointcloud_tpu_torch.schedulers.flow_match import FlowMatchEulerScheduler
from nova_pointcloud_tpu_torch.utils.device import resolve_device

REPO = Path(__file__).resolve().parents[1]
NOVA_TINY = dict(arch=("vit_d2w64", "vit_d2w64", "mlp_d2w64"), image_base_size=(8, 8),
                 video_base_size=(1, 2, 2), text_token_dim=16, text_token_len=4)
C2I_TINY = {**NOVA_TINY, "image_base_size": (4, 4), "text_token_dim": None, "num_classes": 10}
C2I_CFG = {**C2I_TINY, "image_stride": 8}
PKG = REPO / "nova_pointcloud_tpu_torch"
BANNED_ROOTS = {"jax", "jaxlib", "flax", "optax", "nova_pointcloud_tpu"}
KERNEL_NAMES = ("fused_attention_block", "fused_ln_int8_mlp", "fused_ln_int8_matmul",
                "int8_matmul_residual", "flash_attention", "fused_int8_mlp_postln",
                "fused_int8_diffusion_block", "flash_attention_static", "int8_linear",
                "flash_attention_bwd_f32", "flash_attention_bwd_prep",
                "flash_attention_bwd_dkvq", "flash_attention_bwd_dq_cast",
                "flash_attention_bwd_dkvq96", "flash_attention_bwd_f32_96")


def _port_sources():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "chip_ab.py",
                                        REPO / "chip_bwd_probe.py"]


def test_port_imports_nothing_of_jax():
    offenders = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(REPO)}:{node.lineno} {n}"
                          for n in names if n.split(".")[0] in BANNED_ROOTS]
    assert not offenders, offenders


def test_every_module_imports_without_cuda_or_jax():
    """In a fresh interpreter where ``import yaml`` fails: import every
    module of the port and chip_smoke.py; none of them may pull in JAX."""
    mods = [m.name for m in pkgutil.walk_packages(nova_pointcloud_tpu_torch.__path__,
                                                  "nova_pointcloud_tpu_torch.")]
    assert {"nova_pointcloud_tpu_torch.ops.attention",
            "nova_pointcloud_tpu_torch.ops.kernels.flash_attention",
            "nova_pointcloud_tpu_torch.pipelines.builder",
            "nova_pointcloud_tpu_torch.schedulers.builder",
            "nova_pointcloud_tpu_torch.utils.config",
            "nova_pointcloud_tpu_torch.models.nova",
            "nova_pointcloud_tpu_torch.models.vit",
            "nova_pointcloud_tpu_torch.models.diffusion_mlp",
            "nova_pointcloud_tpu_torch.pipelines.nova",
            "nova_pointcloud_tpu_torch.schedulers.flow_match",
            "nova_pointcloud_tpu_torch.ops.masking",
            "nova_pointcloud_tpu_torch.ops.losses",
            "nova_pointcloud_tpu_torch.models.autoencoders.modeling_utils",
            "nova_pointcloud_tpu_torch.engine.lr_schedules",
            "nova_pointcloud_tpu_torch.engine.optim",
            "nova_pointcloud_tpu_torch.engine.ema",
            "nova_pointcloud_tpu_torch.engine.trainer",
            "nova_pointcloud_tpu_torch.utils.logging",
            "nova_pointcloud_tpu_torch.pipelines.train_nova",
            "nova_pointcloud_tpu_torch.pipelines.pointcloud_train",
            "nova_pointcloud_tpu_torch.engine.grad_tools",
            "nova_pointcloud_tpu_torch.engine.checkpoint",
            "nova_pointcloud_tpu_torch.data.shapenet",
            "nova_pointcloud_tpu_torch.evaluation.pointcloud_eval",
            "nova_pointcloud_tpu_torch.scripts.train_pointcloud",
            "nova_pointcloud_tpu_torch.scripts.eval_pc_quality",
            "nova_pointcloud_tpu_torch.models.pointcloud_ar",
            "nova_pointcloud_tpu_torch.pipelines.pointcloud_ar",
            "nova_pointcloud_tpu_torch.scripts.train_eval_pc_ar",
            "nova_pointcloud_tpu_torch.models.autoencoders.autoencoder_kl",
            "nova_pointcloud_tpu_torch.models.autoencoders.autoencoder_kl_opensora",
            "nova_pointcloud_tpu_torch.models.autoencoders.autoencoder_kl_cogvideox",
            "nova_pointcloud_tpu_torch.models.autoencoders.autoencoder_kl_ltx",
            "nova_pointcloud_tpu_torch.models.autoencoders.torch_loading",
            "nova_pointcloud_tpu_torch.utils.image_processor",
            "nova_pointcloud_tpu_torch.models.text_encoders.phi",
            "nova_pointcloud_tpu_torch.models.torch_loading",
            "nova_pointcloud_tpu_torch.pipelines.nova_c2i",
            "nova_pointcloud_tpu_torch.pipelines.pretrained",
            "nova_pointcloud_tpu_torch.evaluation.samplers",
            "nova_pointcloud_tpu_torch.utils.export",
            "nova_pointcloud_tpu_torch.utils.safetensors_io",
            "nova_pointcloud_tpu_torch.scripts.precompute_prompts",
            "nova_pointcloud_tpu_torch.scripts.generate"} <= set(mods)
    code = ("import importlib, sys\n"
            "sys.modules['yaml'] = None\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import chip_smoke, chip_ab\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(BANNED_ROOTS)!r})\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    for m in mods:
        importlib.import_module(m)


def test_every_module_imports_without_the_host_side_packages():
    """The card's installation has no transformers, safetensors, PIL or
    imageio: with each blocked in a fresh interpreter, every module of the
    port and chip_smoke.py import, and a safetensors file still reads."""
    mods = [m.name for m in pkgutil.walk_packages(nova_pointcloud_tpu_torch.__path__,
                                                  "nova_pointcloud_tpu_torch.")]
    code = ("import importlib, os, sys, tempfile, torch\n"
            "for m in ('transformers', 'safetensors', 'PIL', 'imageio', 'tokenizers'):\n"
            "    sys.modules[m] = None\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "from nova_pointcloud_tpu_torch.pipelines.pretrained import _read_state_dict\n"
            "from nova_pointcloud_tpu_torch.utils.safetensors_io import save_file\n"
            "d = tempfile.mkdtemp()\n"
            "w = torch.ones(2, dtype=torch.bfloat16)\n"
            "save_file({'w': w}, os.path.join(d, 'a.safetensors'))\n"
            "sd = _read_state_dict(d)\n"
            "assert sd['w'].dtype == torch.float32 and sd['w'].tolist() == [1.0, 1.0]\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NOVAPointCloudTransformer(arch="pc_d2w64", point_cloud_size=64)
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")
    model = NOVAPointCloudTransformer(arch="pc_d2w64", point_cloud_size=64, device="cpu")
    assert model.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NOVATransformer(**NOVA_TINY)
    assert NOVATransformer(**NOVA_TINY, device="cpu").device == torch.device("cpu")


def test_kernel_wrappers_refuse_other_devices():
    x = torch.empty((2, 8, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_block.fused_ln_int8_mlp(x, *([None] * 8))


def test_cpu_serving_runs_no_kernel():
    fused_block.reset_launch_counts()
    model = NOVAPointCloudTransformer(arch="pc_d2w64", point_cloud_size=32, text_token_dim=16,
                                      quantize=True, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    torch.nn.init.normal_(model.output_proj.weight, std=0.05)
    pipe = NOVAPointCloudGenerationPipeline(model, text_encoder=DummyTextEncoder(16, 4))
    pipe.calibrate(["a chair"], num_points=32, num_diffusion_steps=2)
    out = pipe(["a chair"], num_points=32, num_diffusion_steps=2, guidance_trunc=800.0,
               generator=torch.Generator().manual_seed(1))
    assert out.point_clouds.shape == (1, 32, 3) and np.isfinite(out.point_clouds).all()
    assert np.all(np.abs(out.point_clouds) <= 1.0) and out.colors.min() >= 0.0
    assert LAUNCHES == dict.fromkeys(KERNEL_NAMES, 0)


@pytest.mark.parametrize("path", ["split_int8", "float_pallas"])
def test_cpu_per_point_serving_runs_no_kernel(path, monkeypatch):
    """The slice-2 routes on CPU tensors: the split int8 path (forced at this
    size) and the float path through the flash wrapper run plain versions."""
    fused_block.reset_launch_counts()
    quantize = path == "split_int8"
    if quantize:
        monkeypatch.setattr(fused_block, "attention_block_vmem_bytes", lambda t, d: 1 << 40)
        monkeypatch.setattr(pointcloud, "fused_attention_block", None)  # must not be called
    model = NOVAPointCloudTransformer(arch="pc_d2w64", point_cloud_size=32, text_token_dim=16,
                                      quantize=quantize, attn_impl="pallas", device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    torch.nn.init.normal_(model.output_proj.weight, std=0.05)
    pipe = NOVAPointCloudGenerationPipeline(model, text_encoder=DummyTextEncoder(16, 4))
    if quantize:
        pipe.calibrate(["a chair"], num_points=32, num_diffusion_steps=2)
    out = pipe(["a chair"], num_points=32, num_diffusion_steps=2, guidance_trunc=800.0,
               generator=torch.Generator().manual_seed(1))
    assert out.point_clouds.shape == (1, 32, 3) and np.isfinite(out.point_clouds).all()
    assert LAUNCHES == dict.fromkeys(KERNEL_NAMES, 0)


def test_unported_paths_raise():
    model = NOVAPointCloudTransformer(arch="pc_d2w64", point_cloud_size=32, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        NOVAPointCloudGenerationPipeline(model, mesh=object())
    pipe = NOVAPointCloudGenerationPipeline(model, text_encoder=DummyTextEncoder(16, 4))
    with pytest.raises(ValueError, match="ar_refiner"):  # as the JAX pipeline without one
        pipe(["a chair"], num_points=32, use_autoregressive=True)
    # sequence-parallel attention, c2i training and mesh construction wait
    # for their slices
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PreLNBlock(64, 2, device="cpu", attn_impl="ring")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        attention(*(torch.zeros((1, 2, 8, 32)),) * 3, impl="ring:sequence")
    cfg = {"pipeline": {"name": "NOVATrainC2IPipeline"}, "model": C2I_CFG,
           "scheduler": {"class_name": "DDPMScheduler"}}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_pipeline(cfg, device="cpu")
    cfg["pipeline"]["name"] = "NOVAPointCloudGenerationPipeline"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_pipeline(cfg, device="cpu", mesh=object())
    # the default class is the flow-matching scheduler, as in the JAX builder
    assert isinstance(build_scheduler({}), FlowMatchEulerScheduler)
    assert isinstance(build_scheduler({"class_name": "FlowMatchEulerDiscreteScheduler"}),
                      FlowMatchEulerScheduler)
    with pytest.raises(KeyError, match="Unknown scheduler"):
        build_scheduler({"class_name": "NoSuchScheduler"})


def test_flash_backward_on_the_card_is_refused(monkeypatch):
    """A backward on the card that its kernels do not take (head dim 32)
    raises before any launch and never runs the plain backward instead; the
    autograd node needs no card to be asked."""
    import types

    monkeypatch.setattr(flash_attention, "flash_attention_bwd_plain", None)  # must not run
    x = torch.zeros((1, 2, 8, 32))
    ctx = types.SimpleNamespace(plain=False, needs_input_grad=(True,) * 3 + (False,) * 2,
                                saved_tensors=(x, x, x, None, None, x, torch.zeros((1, 2, 8))))
    with pytest.raises(NotImplementedError, match="head dim 64"):
        flash_attention._FlashAttention.backward(ctx, x, None)
    assert not any(LAUNCHES.values())


def test_chip_smoke_refuses_without_cuda_or_repo(tmp_path):
    """Without a card (this CPU run), and alone in a directory without the
    package, chip_smoke.py exits non-zero and prints no result line."""
    for cwd in (REPO, tmp_path):
        script = REPO / "chip_smoke.py"
        if cwd == tmp_path:
            script = tmp_path / "chip_smoke.py"
            script.write_text((REPO / "chip_smoke.py").read_text())
        r = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                           text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("quantize", [True, False])
def test_cpu_nova_serving_runs_no_kernel(quantize):
    """NOVA t2i on CPU tensors (int8 calibrated, and float): the wrappers run
    their plain versions and count nothing."""
    fused_block.reset_launch_counts()
    model = NOVATransformer(**NOVA_TINY, quantize=quantize, device="cpu")
    g = torch.Generator().manual_seed(0)
    model.init_weights(g).fill_zero_init(g)
    pipe = NOVAPipeline(model, text_encoder=DummyTextEncoder(16, 4))
    if quantize:
        pipe.calibrate(["a scene"], num_inference_steps=3, num_diffusion_steps=2)
    out = pipe(["a scene", "a cat"], num_inference_steps=4, num_diffusion_steps=2,
               generator=torch.Generator().manual_seed(1))
    assert out.latents.shape == (2, 16, 16, 4) and torch.isfinite(out.latents).all()
    assert LAUNCHES == dict.fromkeys(KERNEL_NAMES, 0)


def test_nova_unported_paths_raise(monkeypatch):
    """Mesh serving and host offload (of the pipeline and of the VAE's
    weights) raise; the VAE decode is ported: NOVAPipeline(vae=) builds, and
    "pil" output without PIL installed raises a clear ImportError."""
    model = NOVATransformer(**NOVA_TINY, device="cpu")
    pipe = NOVAPipeline(model, text_encoder=DummyTextEncoder(16, 4))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        NOVAPipeline(model, mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pipe.enable_host_offload()
    vae_pipe = NOVAPipeline(model, vae=AutoencoderKL(block_out_channels=(32, 64),
                                                     latent_channels=4, layers_per_block=1,
                                                     device="cpu"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        vae_pipe.image_processor.device_params()
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="output_type='np'"):
        vae_pipe.image_processor.postprocess(np.zeros((1, 4, 4, 3), np.float32), "pil")
    for kw in (dict(num_experts=4), dict(attn_impl="ring")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            NOVATransformer(**{**NOVA_TINY, **kw}, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PhiTextEncoder(None, None).host_offload = True
    cfg = {"model": {**NOVA_TINY, "image_stride": 8}}
    for name in ("NOVATrainC2IPipeline", "NOVATrainT2VPipeline"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_pipeline({**cfg, "pipeline": {"name": name}}, device="cpu")
    assert isinstance(build_scheduler({}), FlowMatchEulerScheduler)  # as the JAX builder


@pytest.mark.parametrize("quantize", [True, False])
def test_cpu_nova_video_serving_runs_no_kernel(quantize):
    """NOVA t2v on CPU tensors (a RoPE model with the mixer, 3 frames
    through the KV caches, int8 calibrated over 2 frames, and float; an
    i2v call with latents=): the wrappers run their plain versions and count
    nothing; the prefilled frame 0 is the given latents."""
    fused_block.reset_launch_counts()
    model = NOVATransformer(**{**NOVA_TINY, "video_base_size": (3, 4, 4),
                               "rotary_pos_embed": True, "video_mixer_rank": 4},
                            quantize=quantize, device="cpu")
    g = torch.Generator().manual_seed(0)
    model.init_weights(g).fill_zero_init(g)
    pipe = NOVAPipeline(model, text_encoder=DummyTextEncoder(16, 4))
    if quantize:
        pipe.calibrate(["a scene"], num_inference_steps=3, num_diffusion_steps=2,
                       max_latent_length=2)
    out = pipe(["a scene"], num_inference_steps=4, num_diffusion_steps=2, max_latent_length=3,
               generator=torch.Generator().manual_seed(1))
    assert out.latents.shape == (1, 3, 16, 16, 4) and torch.isfinite(out.latents).all()
    lat = torch.randn((1, 16, 16, 4), generator=g)
    out = pipe(["a scene"], num_inference_steps=4, num_diffusion_steps=2, max_latent_length=2,
               latents=lat)
    assert torch.equal(out.latents[:, 0], lat)
    assert LAUNCHES == dict.fromkeys(KERNEL_NAMES, 0)


@pytest.mark.parametrize("quantize", [True, False])
def test_cpu_vae_decode_and_e2e_serving_run_no_kernel(quantize):
    """The VAE layer runs no kernel of the repo: a CPU decode and encode of
    each VAE class, and e2e NOVA calls on CPU tensors (t2i to uint8 images
    through AutoencoderKL, t2v to uint8 frames through OpenSora's
    window-by-window decode, int8 calibrated and float), count nothing."""
    from nova_pointcloud_tpu_torch.models.autoencoders.autoencoder_kl_cogvideox import (
        AutoencoderKLCogVideoX)
    from nova_pointcloud_tpu_torch.models.autoencoders.autoencoder_kl_ltx import (
        AutoencoderKLLTXVideo)

    fused_block.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    kl = AutoencoderKL(block_out_channels=(32, 64), latent_channels=4, layers_per_block=1,
                       device="cpu").init_weights(g)
    os_vae = AutoencoderKLOpenSora(
        down_block_types=("DownEncoderBlock2D", "DownEncoderBlock3D"),
        up_block_types=("UpDecoderBlock2D", "UpDecoderBlock3D"), block_out_channels=(32, 32),
        latent_channels=4, layers_per_block=1, sample_min_t=3, latent_min_t=2,
        device="cpu").init_weights(g)
    with torch.no_grad():
        for vae, x in ((kl, torch.randn(1, 8, 8, 3)), (os_vae, torch.randn(1, 5, 8, 8, 3)),
                       (AutoencoderKLCogVideoX(block_out_channels=(32, 32, 32, 32),
                                               layers_per_block=1, latent_channels=4,
                                               device="cpu").init_weights(g),
                        torch.randn(1, 5, 16, 16, 3)),
                       (AutoencoderKLLTXVideo(block_out_channels=(8, 16, 16, 32, 32),
                                              layers_per_block=(1,) * 5,
                                              decoder_block_out_channels=(4, 8, 16, 32),
                                              decoder_layers_per_block=(1,) * 4,
                                              latent_channels=8, device="cpu").init_weights(g),
                        torch.randn(1, 9, 32, 32, 3))):
            z = vae.encode(x).mode()
            assert torch.isfinite(vae.decode(z)).all()
    model = NOVATransformer(**{**NOVA_TINY, "image_base_size": (4, 4),
                               "video_base_size": (3, 2, 2), "rotary_pos_embed": True,
                               "video_mixer_rank": 4}, quantize=quantize, device="cpu")
    model.init_weights(g).fill_zero_init(g)
    pipe = NOVAPipeline(model, text_encoder=DummyTextEncoder(16, 4), vae=kl)
    if quantize:
        pipe.calibrate(["a scene"], num_inference_steps=2, num_diffusion_steps=1)
    out = pipe(["a scene", "a cat"], num_inference_steps=2, num_diffusion_steps=1,
               output_type="np", generator=torch.Generator().manual_seed(1))
    assert out.images.shape == (2, 16, 16, 3) and out.images.dtype == np.uint8
    pipe = NOVAPipeline(model, text_encoder=DummyTextEncoder(16, 4), vae=os_vae)
    out = pipe(["a scene"], num_inference_steps=2, num_diffusion_steps=1, max_latent_length=3,
               output_type="np", generator=torch.Generator().manual_seed(1))
    assert out.frames.shape == (1, 3, 16, 16, 3) and out.frames.dtype == np.uint8  # 2 + 1 frames
    assert LAUNCHES == dict.fromkeys(KERNEL_NAMES, 0)


def test_nova_kernel_wrappers_refuse_shapes_on_the_card(monkeypatch):
    """On the card a shape the kernels do not take raises before any launch
    and never runs the plain version (the route is forced to the card's
    here; the checks come before anything touches CUDA)."""
    monkeypatch.setattr(fused_block, "_plain_route", lambda x: False)
    monkeypatch.setattr(flash_attention, "plain_route", lambda x: False)
    for name in ("fused_int8_mlp_postln_plain", "fused_int8_diffusion_block_plain",
                 "int8_linear_plain"):
        monkeypatch.setattr(fused_block, name, None)  # must not be called
    monkeypatch.setattr(flash_attention, "flash_attention_static_plain", None)
    i8 = torch.int8
    with pytest.raises(NotImplementedError, match="multiples of 128"):
        fused_block.fused_int8_mlp_postln(torch.zeros(4, 96), torch.zeros(96, 384, dtype=i8),
                                          *([None] * 7))
    with pytest.raises(NotImplementedError, match="multiples of 128"):
        fused_block.fused_int8_diffusion_block(torch.zeros(4, 96), torch.zeros(4, 96),
                                               *([None] * 11))
    with pytest.raises(NotImplementedError, match="multiples of 128"):
        fused_block.int8_linear(torch.zeros(4, 100), torch.zeros(100, 128, dtype=i8), None)
    q = torch.zeros(1, 2, 8, 32)
    with pytest.raises(NotImplementedError, match="head dim 64"):
        flash_attention.flash_attention_static(q, q, q, torch.tensor(1.0))


def _train_batch(b=2):
    g = torch.Generator().manual_seed(0)
    return {"moments": torch.cat([torch.randn((b, 16, 16, 4), generator=g),
                                  torch.full((b, 16, 16, 4), -6.0)], -1).half(),
            "text_embeds": torch.randn((b, 4, 16), generator=g)}


def test_training_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    """The training model defaults to the card and raises without it; on a
    CPU model the pipeline, the trainer's generator and the step stay on the
    CPU, and the flash route runs its plain forward and backward."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NOVATransformer(**NOVA_TINY, noise_scheduler=FlowMatchEulerScheduler(), remat=True)
    fused_block.reset_launch_counts()
    model = NOVATransformer(**NOVA_TINY, noise_scheduler=FlowMatchEulerScheduler(), remat=True,
                            attn_impl="pallas", dtype=torch.bfloat16, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    pipe = NOVATrainT2IPipeline(model, log_every=1)
    assert pipe.trainer.generator.device == torch.device("cpu")
    out = pipe.train(iter([_train_batch()] * 2), 2)
    assert np.isfinite(out["loss"]) and pipe.trainer.step == 2
    assert LAUNCHES == dict.fromkeys(KERNEL_NAMES, 0)


def test_unported_training_paths_raise():
    model = NOVATransformer(**NOVA_TINY, noise_scheduler=FlowMatchEulerScheduler(), device="cpu")
    for cls in (NOVATrainT2VPipeline, NOVATrainC2IPipeline):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            cls(model)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        NOVATrainT2IPipeline(model, vae=object())
    x = torch.zeros((1, 16, 16, 4))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.train_losses(torch.zeros((1, 2, 16, 16, 4)), torch.zeros((1, 4, 16)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.train_losses(x, labels=torch.zeros((1,), dtype=torch.long))
    ddpm = NOVATransformer(**NOVA_TINY, noise_scheduler=build_scheduler(
        {"class_name": "DDPMScheduler"}), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ddpm.train_losses(x, torch.zeros((1, 4, 16)))
    from nova_pointcloud_tpu_torch.engine.optim import build_optimizer

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_optimizer(model, 1e-4, accum_steps=4)


@pytest.mark.parametrize("dropout,attn_impl", [(0.1, "auto"), (0.0, "pallas")])
def test_cpu_pc_training_step_runs_no_kernel(dropout, attn_impl, monkeypatch):
    """The t2pc training step on CPU tensors: live dropout (the plain core)
    and, at dropout 0, the flash route's plain forward and backward through
    its autograd node count nothing; without CUDA the model and the
    evaluator's device default raise."""
    from nova_pointcloud_tpu_torch.evaluation.pointcloud_eval import evaluate_batch
    from nova_pointcloud_tpu_torch.pipelines.pointcloud_train import (
        NOVATrainPointCloudPipeline, PointCloudLossConfig)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NOVAPointCloudTransformer(arch="pc_d2w64", point_cloud_size=32, remat=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate_batch(np.zeros((1, 8, 3), np.float32), np.zeros((1, 8, 3), np.float32))
    fused_block.reset_launch_counts()
    model = NOVAPointCloudTransformer(arch="pc_d2w64", point_cloud_size=32, text_token_dim=16,
                                      dropout=dropout, remat=True, attn_impl=attn_impl,
                                      device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    pipe = NOVATrainPointCloudPipeline(model, text_encoder=DummyTextEncoder(16, 4), log_every=1,
                                       loss_config=PointCloudLossConfig(num_subsets=4))
    assert pipe.trainer.generator.device == torch.device("cpu")
    batch = {"points": np.random.default_rng(0).uniform(-1, 1, (2, 32, 3)).astype(np.float32),
             "prompts": ["a chair", "a box"]}
    out = pipe.train(iter([batch] * 2), 2)
    assert np.isfinite(out["loss"]) and out["nonfinite_loss"] == 0.0 and pipe.trainer.step == 2
    assert LAUNCHES == dict.fromkeys(KERNEL_NAMES, 0)


@pytest.mark.parametrize("path", ["masked_ar_int8", "masked_ar_float", "masked_ar_train",
                                  "refinement"])
def test_cpu_ar_paths_run_no_kernel(path, monkeypatch):
    """The point-cloud AR modes on CPU tensors: masked-AR serving (int8:
    the ViT's int8_linear and post-LN MLP and the head's diffusion blocks
    on their plain versions), its training step, and the refinement mode
    over int8 flagship-style serving count nothing; without CUDA the AR
    model and the refiner raise."""
    from nova_pointcloud_tpu_torch.models.pointcloud import ARRefiner
    from nova_pointcloud_tpu_torch.models.pointcloud_ar import NOVAPointCloudARTransformer
    from nova_pointcloud_tpu_torch.pipelines.pointcloud_ar import NOVAPointCloudARPipeline
    from nova_pointcloud_tpu_torch.schedulers.ddpm import DDPMScheduler

    fused_block.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    if path == "refinement":
        model = NOVAPointCloudTransformer(arch="pc_d2w64", point_cloud_size=64, patch_size=4,
                                          text_token_dim=16, quantize=True, device="cpu")
        model.init_weights(g)
        refiner = ARRefiner(64, 4, depth=1, device="cpu").init_weights(g)
        torch.nn.init.normal_(refiner.head.weight, std=0.05)
        pipe = NOVAPointCloudGenerationPipeline(model, text_encoder=DummyTextEncoder(16, 4),
                                                ar_refiner=refiner)
        out = pipe(["a chair"], num_points=64, num_diffusion_steps=2, use_autoregressive=True,
                   num_subsets=4, generator=torch.Generator().manual_seed(1))
        pts = out.point_clouds
    else:
        model = NOVAPointCloudARTransformer(
            arch="pc_d2w64", point_cloud_size=128, patch_size=8, text_token_dim=16,
            text_token_len=4, quantize=path == "masked_ar_int8",
            noise_scheduler=DDPMScheduler(), remat=True, device="cpu")
        model.init_weights(g).fill_zero_init(g)
        if path == "masked_ar_train":
            loss = model(torch.rand((2, 128, 3)) * 2 - 1, torch.randn((2, 4, 16)), generator=g)
            loss["loss"].backward()
            pts = loss["loss"].detach().numpy()[None]
        else:
            pipe = NOVAPointCloudARPipeline(model, DDPMScheduler(beta_schedule="squaredcos_cap_v2"),
                                            text_encoder=DummyTextEncoder(16, 4))
            pts = pipe(["a chair", "a box"], num_inference_steps=4, num_diffusion_steps=2,
                       generator=torch.Generator().manual_seed(1)).point_clouds
            assert pts.shape == (2, 128, 3)
    assert np.isfinite(pts).all()
    assert LAUNCHES == dict.fromkeys(KERNEL_NAMES, 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NOVAPointCloudARTransformer(arch="pc_d2w64", point_cloud_size=128, patch_size=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ARRefiner(64, 4, depth=1)


def test_c2i_and_text_encoder_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    """The c2i model and pipeline, the Phi encoder, from_pretrained and the
    two new scripts default to the card and raise without it; on CPU
    tensors the c2i pipeline (int8 calibrated, and float) and the Phi
    encoder run no kernel."""
    from nova_pointcloud_tpu_torch.scripts import generate, precompute_prompts

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    phi = PhiConfig(vocab_size=32, hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                    num_attention_heads=4, partial_rotary_factor=0.5)
    (tmp_path / "p.txt").write_text("a chair\n")
    for fn in (lambda: NOVATransformer(**C2I_TINY), lambda: PhiEncoderModel(phi),
               lambda: from_pretrained(str(tmp_path / "missing")),
               lambda: build_pipeline({"pipeline": {"name": "NOVAC2IPipeline"},
                                       "model": C2I_CFG}),
               lambda: precompute_prompts.main(["--prompts", str(tmp_path / "p.txt"),
                                                "--out", str(tmp_path / "e.npz")]),
               lambda: generate.main(["--config", str(tmp_path / "missing.json"),
                                      "--prompt", "1"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()
    fused_block.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    for quantize in (True, False):
        model = NOVATransformer(**C2I_TINY, quantize=quantize, device="cpu")
        model.init_weights(g).fill_zero_init(g)
        pipe = NOVAC2IPipeline(model)
        assert pipe.device == torch.device("cpu") and pipe.text_encoder is None
        if quantize:
            pipe.calibrate([3], num_inference_steps=2, num_diffusion_steps=1)
        out = pipe([3, 10], num_inference_steps=3, num_diffusion_steps=1,
                   generator=torch.Generator().manual_seed(1))
        assert out.latents.shape == (2, 8, 8, 4) and torch.isfinite(out.latents).all()
    enc = PhiEncoderModel(phi, device="cpu").init_weights(g)
    with torch.no_grad():
        y = enc(torch.zeros((2, 5), dtype=torch.long), torch.tensor([[1] * 5, [0] * 5]))
    assert torch.isfinite(y).all()
    assert LAUNCHES == dict.fromkeys(KERNEL_NAMES, 0)
