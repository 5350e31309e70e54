"""Reference-checkpoint loading in the port (utils/safetensors_io,
models/torch_loading, pipelines/pretrained) vs the JAX package on the CPU.

- The safetensors reader against ``safetensors.numpy`` (the files written
  by the safetensors package and by the port's writer), and
  ``_read_state_dict`` against the JAX one over two shards: bitwise.
- ``load_torch_nova_weights`` against the JAX loader followed by
  ``models/convert.convert_params``: bitwise, on the reference-named state
  dict of tests/test_nova_torch_loading.py and, for the parts it lacks
  (labels, RoPE with the motion tokens and the mixer), on
  ``reference_state_dict`` of a port model.
- ``from_pretrained`` against the JAX function on one written directory
  (a tiny transformer in two f32 shards, FlowMatch, a tiny AutoencoderKL,
  a tiny HF PhiModel and an offline tokenizer): the transformer's and the
  VAE's weights bitwise, the text encoder's embeddings to 1e-5 of their
  size; latent-only; the text encoder skipped without ``tokenizer/``; the
  c2i index; ``dtype`` on the transformer and the VAE only.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes  # noqa: F401  (registers bfloat16 with numpy for safetensors.numpy)
import numpy as np
import pytest
import torch

from nova_pointcloud_tpu.models.autoencoders import autoencoder_kl as jkl
from nova_pointcloud_tpu.models.nova import NOVATransformer as JNOVA
from nova_pointcloud_tpu.models.torch_loading import \
    load_torch_nova_weights as jax_load_nova
from nova_pointcloud_tpu.pipelines import pretrained as jpre
from nova_pointcloud_tpu.schedulers import flow_match as jfm
from nova_pointcloud_tpu_torch.models.convert import convert_params, convert_vae_params
from nova_pointcloud_tpu_torch.models.nova import NOVATransformer as TNOVA
from nova_pointcloud_tpu_torch.models.torch_loading import (load_torch_nova_weights,
                                                            reference_state_dict)
from nova_pointcloud_tpu_torch.pipelines import pretrained as tpre
from nova_pointcloud_tpu_torch.pipelines.nova_c2i import NOVAC2IPipeline
from nova_pointcloud_tpu_torch.utils import safetensors_io

safetensors_numpy = pytest.importorskip("safetensors.numpy")
safetensors_torch = pytest.importorskip("safetensors.torch")
transformers = pytest.importorskip("transformers")

L, TEXT_DIM = 8, 32
ARCH = ("vit_d2w64", "vit_d2w64", "mlp_d2w64")
TCFG = {"image_dim": 4, "image_size": 64, "image_stride": 8, "text_token_dim": TEXT_DIM,
        "text_token_len": L, "image_base_size": [4, 4], "video_base_size": [1, 2, 2],
        "rotary_pos_embed": False, "arch": list(ARCH)}
VAE_CFG = dict(block_out_channels=(32, 64), latent_channels=4, layers_per_block=1)
WORDS = ["[PAD]", "[UNK]", "a", "cat", "chair", "photo", "of", "the"]


def _sd_equal(a, b):
    assert a.keys() == b.keys()
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    assert not bad, bad[:5]


# -- the safetensors reader -------------------------------------------------------------

def test_safetensors_reader_matches_the_package(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {"f32": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)),
               "f16": torch.from_numpy(rng.standard_normal((7,)).astype(np.float16)),
               "bf16": torch.randn((2, 3, 4), generator=torch.Generator().manual_seed(1)
                                   ).bfloat16(),
               "i64": torch.arange(-5, 6), "scalar": torch.tensor(2.5)}
    a, b = str(tmp_path / "a.safetensors"), str(tmp_path / "b.safetensors")
    safetensors_torch.save_file(tensors, a)
    safetensors_io.save_file(tensors, b)
    for path in (a, b):
        want = safetensors_numpy.load_file(path)
        got = safetensors_io.load_file(path)
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert got[k].dtype == tensors[k].dtype and tuple(got[k].shape) == v.shape
            np.testing.assert_array_equal(got[k].float().numpy(), v.astype(np.float32))
    # two shards merged, floating tensors as float32: the JAX reader's result
    d = tmp_path / "component"
    d.mkdir()
    safetensors_torch.save_file({k: tensors[k] for k in ("f32", "bf16")},
                                str(d / "model-00001-of-00002.safetensors"))
    safetensors_torch.save_file({k: tensors[k] for k in ("f16", "i64", "scalar")},
                                str(d / "model-00002-of-00002.safetensors"))
    got, want = tpre._read_state_dict(str(d)), jpre._read_state_dict(str(d))
    assert got.keys() == want.keys() == tensors.keys()
    for k, v in want.items():
        assert got[k].numpy().dtype == v.dtype and np.array_equal(got[k].numpy(), v)


# -- load_torch_nova_weights --------------------------------------------------------------

def test_nova_loader_matches_jax_on_the_reference_names():
    from tests.test_nova_torch_loading import _fake_state_dict

    cfg = dict(arch=ARCH, image_dim=4, image_base_size=(4, 4), video_base_size=(1, 2, 2),
               patch_size=2, text_token_dim=32, text_token_len=8)
    jm = JNOVA(**cfg, noise_scheduler=jfm.FlowMatchEulerScheduler())
    sd = _fake_state_dict(jm)
    want = convert_params(jax.tree.map(np.asarray, jax_load_nova(jm, sd)))
    tm = TNOVA(**cfg, device="cpu")
    got = load_torch_nova_weights(tm, {k: torch.from_numpy(v) for k, v in sd.items()})
    _sd_equal(got, want)
    tm.load_state_dict(got, strict=True)
    back = reference_state_dict(tm)
    assert back.keys() <= sd.keys()
    assert all(np.array_equal(back[k].numpy(), sd[k]) for k in back)


@pytest.mark.parametrize("kind", ["c2i", "rope_motion_mixer"])
def test_nova_loader_matches_jax_on_every_part(kind):
    """The parts _fake_state_dict lacks: a port model's weights written
    under the reference names (reference_state_dict), read back by both
    loaders."""
    cfg = dict(arch=ARCH, image_dim=4, image_base_size=(4, 4), patch_size=2)
    if kind == "c2i":
        cfg.update(video_base_size=(1, 2, 2), num_classes=10)
    else:
        cfg.update(video_base_size=(3, 2, 2), text_token_dim=16, text_token_len=4,
                   rotary_pos_embed=True, video_mixer_rank=4)
    g = torch.Generator().manual_seed(3)
    tm = TNOVA(**cfg, device="cpu").init_weights(g).fill_zero_init(g)
    sd = reference_state_dict(tm)
    want = convert_params(jax.tree.map(np.asarray, jax_load_nova(
        JNOVA(**cfg), {k: v.numpy() for k, v in sd.items()})))
    _sd_equal(load_torch_nova_weights(tm, sd), want)
    _sd_equal(want, {k: v.float() for k, v in tm.state_dict().items()})


# -- from_pretrained ----------------------------------------------------------------------

def _write_tokenizer(tok_dir):
    """An offline fast tokenizer (word level) in the transformers layout."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    os.makedirs(tok_dir)
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(WORDS)}, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    transformers.PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="[PAD]",
                                         unk_token="[UNK]",
                                         model_max_length=L).save_pretrained(tok_dir)


def _write_checkpoint(root, c2i=False):
    """A reference-layout directory; the transformer's weights split over
    two f32 safetensors shards."""
    from tests.test_torch_vae import _params, _reference_names

    tcfg = dict(TCFG)
    if c2i:
        tcfg.pop("text_token_dim")
        tcfg["num_classes"] = 10
    g = torch.Generator().manual_seed(0)
    port = TNOVA(arch=ARCH, image_base_size=(4, 4), video_base_size=(1, 2, 2),
                 text_token_dim=tcfg.get("text_token_dim"), text_token_len=L,
                 num_classes=tcfg.get("num_classes"), device="cpu")
    sd = reference_state_dict(port.init_weights(g).fill_zero_init(g))
    names = sorted(sd)
    os.makedirs(os.path.join(root, "transformer"))
    for i, part in enumerate((names[::2], names[1::2])):
        safetensors_torch.save_file({k: sd[k] for k in part}, os.path.join(
            root, "transformer", f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
    with open(os.path.join(root, "transformer", "config.json"), "w") as f:
        json.dump({"_class_name": "NOVATransformer3DModel", **tcfg}, f)
    os.makedirs(os.path.join(root, "scheduler"))
    with open(os.path.join(root, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump({"_class_name": "FlowMatchEulerDiscreteScheduler",
                   "num_train_timesteps": 1000, "shift": 1.0}, f)
    vp = _params(jkl.AutoencoderKL(**VAE_CFG), jnp.zeros((1, 16, 16, 3)), seed=1)
    os.makedirs(os.path.join(root, "vae"))
    safetensors_torch.save_file({k: v.contiguous() for k, v in _reference_names(vp).items()},
                                os.path.join(
        root, "vae", "diffusion_pytorch_model.safetensors"))
    with open(os.path.join(root, "vae", "config.json"), "w") as f:
        json.dump({"_class_name": "AutoencoderKL", "scaling_factor": 0.13025,
                   **{k: list(v) if isinstance(v, tuple) else v
                      for k, v in VAE_CFG.items()}}, f)
    index = {"_class_name": "NOVAC2IPipeline" if c2i else "NOVAPipeline"}
    if not c2i:
        torch.manual_seed(0)
        transformers.PhiModel(transformers.PhiConfig(
            vocab_size=16, hidden_size=TEXT_DIM, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, partial_rotary_factor=0.5, max_position_embeddings=64)
        ).save_pretrained(os.path.join(root, "text_encoder"))
        _write_tokenizer(os.path.join(root, "tokenizer"))
    with open(os.path.join(root, "model_index.json"), "w") as f:
        json.dump(index, f)
    return vp


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nova") / "nova-tiny")
    _write_checkpoint(root)
    return root


def test_from_pretrained_matches_jax(checkpoint):
    """t2i with the VAE and the text encoder: the same weights as the JAX
    pipeline's, the same embeddings, and the port pipeline serves pixels."""
    jp = jpre.from_pretrained(checkpoint)
    tp = tpre.from_pretrained(checkpoint, device="cpu")
    assert type(tp).__name__ == type(jp).__name__ == "NOVAPipeline"
    assert (tp.scheduler.num_train_timesteps, tp.scheduler.shift) == (1000, 1.0)
    _sd_equal(tp.model.state_dict(), convert_params(jax.tree.map(np.asarray, jp.params)))
    _sd_equal(tp.vae.state_dict(), convert_vae_params(
        jax.tree.map(np.asarray, jp.image_processor.vae_params)))
    assert tp.vae.scaling_factor == 0.13025
    prompts = ["a photo of a cat", "", "the chair"]
    je, jl = jp.text_encoder.encode(prompts)
    te, tl = tp.text_encoder.encode(prompts)
    assert te.shape == (3, L, TEXT_DIM) and np.array_equal(tl, jl) and tl.tolist() == [5, 0, 2]
    assert np.abs(te - je).max() <= 1e-5 * np.abs(je).max()
    out = tp(["a photo of a cat"], num_inference_steps=2, num_diffusion_steps=1,
             output_type="np", generator=torch.Generator().manual_seed(1))
    assert out.images.shape == (1, 16, 16, 3) and out.images.dtype == np.uint8


def test_from_pretrained_skips_components(checkpoint, tmp_path):
    """Latent-only by the flags; without tokenizer/ no text encoder (as the
    JAX function); dtype casts the transformer and the VAE, not the text
    encoder."""
    tp = tpre.from_pretrained(checkpoint, device="cpu", load_vae=False, load_text_encoder=False)
    assert tp.vae is None and tp.text_encoder is None
    emb = np.random.default_rng(0).standard_normal((2, L, TEXT_DIM)).astype(np.float32)
    lat = tp(prompt_embeds=emb, num_inference_steps=2, num_diffusion_steps=1,
             guidance_scale=1.0, generator=torch.Generator().manual_seed(1)).latents
    assert lat.shape == (2, 8, 8, 4) and torch.isfinite(lat).all()
    root = str(tmp_path / "no-tokenizer")
    shutil.copytree(checkpoint, root, ignore=shutil.ignore_patterns("tokenizer"))
    assert jpre.from_pretrained(root, load_vae=False).text_encoder is None
    assert tpre.from_pretrained(root, device="cpu", load_vae=False).text_encoder is None
    bf = tpre.from_pretrained(checkpoint, dtype=torch.bfloat16, device="cpu")
    assert {p.dtype for p in bf.model.parameters()} == {torch.bfloat16}
    assert {p.dtype for p in bf.vae.parameters()} == {torch.bfloat16}
    assert {p.dtype for p in bf.text_encoder.model.parameters()} == {torch.float32}
    assert bf.model.dtype == bf.vae.dtype == torch.bfloat16
    _sd_equal(bf.model.state_dict(), {k: v.bfloat16() for k, v in
                                      tp.model.state_dict().items()})


def test_from_pretrained_c2i_index(tmp_path):
    root = str(tmp_path / "nova-c2i")
    _write_checkpoint(root, c2i=True)
    jp = jpre.from_pretrained(root, load_vae=False)
    tp = tpre.from_pretrained(root, device="cpu", load_vae=False)
    assert type(jp).__name__ == "NOVAC2IPipeline" and isinstance(tp, NOVAC2IPipeline)
    assert tp.model.num_classes == 10 and tp.text_encoder is None
    _sd_equal(tp.model.state_dict(), convert_params(jax.tree.map(np.asarray, jp.params)))
    lat = tp([1, 9], num_inference_steps=2, num_diffusion_steps=1,
             generator=torch.Generator().manual_seed(1)).latents
    assert lat.shape == (2, 8, 8, 4) and torch.isfinite(lat).all()
