"""The port's host-side evaluation tools on the CPU (evaluation/samplers,
utils/export, scripts/precompute_prompts, scripts/generate): the GenEval
and VBench layouts; prompts precomputed (the DummyTextEncoder's file
bitwise the JAX encoder's; a tiny Phi checkpoint with a tokenizer that has
no pad token) into an ``.npz`` that ``sample_geneval`` serves; ``generate``
on a tiny config and on a trainer checkpoint; the PLY text byte for byte
the JAX writer's.
"""

import json

import numpy as np
import pytest
import torch
import yaml

from nova_pointcloud_tpu.models.text_encoders.dummy import DummyTextEncoder as JDummy
from nova_pointcloud_tpu.utils import export as jexport
from nova_pointcloud_tpu_torch.engine.checkpoint import CheckpointManager
from nova_pointcloud_tpu_torch.evaluation.samplers import sample_geneval, sample_vbench
from nova_pointcloud_tpu_torch.models.nova import NOVATransformer
from nova_pointcloud_tpu_torch.models.text_encoders.dummy import DummyTextEncoder
from nova_pointcloud_tpu_torch.pipelines.nova import NOVAPipeline
from nova_pointcloud_tpu_torch.scripts import generate, precompute_prompts
from nova_pointcloud_tpu_torch.utils import export

ARCH = ("vit_d2w64", "vit_d2w64", "mlp_d2w64")
MODEL = dict(image_dim=4, image_base_size=(4, 4), text_token_dim=16, text_token_len=8)


def _pipe(video_frames=1):
    model = NOVATransformer(ARCH, video_base_size=(video_frames, 2, 2), device="cpu", **MODEL)
    g = torch.Generator().manual_seed(0)
    model.init_weights(g).fill_zero_init(g)
    return NOVAPipeline(model, text_encoder=DummyTextEncoder(16, 8))


def test_precompute_then_geneval_layout(tmp_path):
    metadata = [{"prompt": "a red chair", "tag": "color"},
                {"prompt": "two dogs", "tag": "counting"}]
    prompts_file = tmp_path / "prompts.jsonl"
    prompts_file.write_text("\n".join(json.dumps(m) for m in metadata))
    out = precompute_prompts.main(["--prompts", str(prompts_file), "--out",
                                   str(tmp_path / "embeds.npz"), "--max-tokens", "8"],
                                  device="cpu")
    blob = np.load(out, allow_pickle=True)
    want, want_len = JDummy(256, 8).encode([m["prompt"] for m in metadata])
    assert np.array_equal(blob["embeds"], want.astype(np.float16))
    assert np.array_equal(blob["lengths"], want_len)
    assert list(blob["prompts"]) == [m["prompt"] for m in metadata]

    pipe = _pipe()
    emb = blob["embeds"][..., :16].astype(np.float32)  # the tiny model's text width
    paths = sample_geneval(pipe, metadata, str(tmp_path / "geneval"), samples_per_prompt=2,
                           prompt_embeds=emb, num_inference_steps=2, num_diffusion_steps=1,
                           guidance_scale=1.0)
    assert len(paths) == 4
    for idx in range(2):
        d = tmp_path / "geneval" / f"{idx:05d}"
        assert json.loads((d / "metadata.jsonl").read_text()) == metadata[idx]
        assert sorted(p.name for p in (d / "samples").iterdir()) == ["0000.png", "0001.png"]
    # the prompt's generator: seed + idx, the same call again gives the same samples
    again = pipe(["two dogs"], num_images_per_prompt=2, prompt_embeds=emb[1:2],
                 num_inference_steps=2, num_diffusion_steps=1, guidance_scale=1.0,
                 generator=torch.Generator().manual_seed(1), output_type="np").images
    from PIL import Image

    assert np.array_equal(np.asarray(Image.open(paths[2])), again[0])


def test_precompute_with_a_phi_checkpoint(tmp_path):
    """A tiny HF Phi checkpoint (config.json + safetensors) and a tokenizer
    without a pad token: the script pads with EOS, and writes the
    encoder's own embeddings (float16) and lengths."""
    transformers = pytest.importorskip("transformers")
    from tokenizers import Tokenizer, models, pre_tokenizers

    from nova_pointcloud_tpu_torch.models.text_encoders.phi import (
        PhiConfig, PhiEncoderModel, PhiTextEncoder, load_torch_phi_weights)

    words = ["<eos>", "[UNK]", "a", "red", "chair", "two", "dogs"]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    transformers.PreTrainedTokenizerFast(tokenizer_object=tok, eos_token="<eos>",
                                         unk_token="[UNK]").save_pretrained(tmp_path / "tok")
    torch.manual_seed(0)
    hf_cfg = dict(vocab_size=8, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                  num_attention_heads=4, partial_rotary_factor=0.5)
    hf = transformers.PhiModel(transformers.PhiConfig(**hf_cfg)).eval()
    hf.save_pretrained(tmp_path / "phi")
    (tmp_path / "p.txt").write_text("a red chair\ntwo dogs\n\n")
    out = precompute_prompts.main(["--prompts", str(tmp_path / "p.txt"), "--out",
                                   str(tmp_path / "e.npz"), "--phi-checkpoint",
                                   str(tmp_path / "phi"), "--tokenizer", str(tmp_path / "tok"),
                                   "--max-tokens", "6", "--batch-size", "1"], device="cpu")
    blob = np.load(out, allow_pickle=True)
    model = PhiEncoderModel(PhiConfig(**hf_cfg), device="cpu")
    model.load_state_dict(load_torch_phi_weights(model, hf.state_dict()))
    tokenizer = transformers.AutoTokenizer.from_pretrained(tmp_path / "tok")
    tokenizer.pad_token = tokenizer.eos_token
    want, lengths = PhiTextEncoder(model, tokenizer, 6).encode(["a red chair", "two dogs"])
    assert blob["embeds"].shape == (2, 6, 32) and blob["lengths"].tolist() == [3, 2]
    assert np.array_equal(blob["lengths"], lengths)
    assert np.array_equal(blob["embeds"], want.astype(np.float16))


def test_vbench_layout(tmp_path):
    paths = sample_vbench(_pipe(video_frames=2), ["a cat / running"], str(tmp_path / "vbench"),
                          samples_per_prompt=2, max_latent_length=2, num_inference_steps=2,
                          num_diffusion_steps=1, guidance_scale=1.0)
    assert len(paths) == 2
    for k, p in enumerate(paths):  # an mp4, or a GIF beside it where no mp4 writer works
        assert p.rsplit(".", 1)[0].endswith(f"a cat   running-{k}")
        assert (tmp_path / "vbench" / p.rsplit("/", 1)[1]).stat().st_size > 0


def _config(tmp_path, name="NOVAPipeline"):
    cfg = {"pipeline": {"name": name},
           "model": {"arch": list(ARCH), "image_dim": 4, "image_stride": 8,
                     "image_base_size": [4, 4], "video_base_size": [1, 2, 2],
                     "text_token_dim": 16, "text_token_len": 8},
           "scheduler": {"_noise_class_name": "FlowMatchEulerScheduler",
                         "_sample_class_name": "FlowMatchEulerScheduler"}}
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_generate_writes_images_from_a_config_and_a_checkpoint(tmp_path):
    """A training config is served by its inference pipeline; the trainer's
    checkpoint (its EMA weights where it has them) replaces the seeded
    init."""
    cfg = _config(tmp_path, "NOVATrainT2IPipeline")
    args = ["--config", cfg, "--prompt", "a red chair", "two dogs", "--num-inference-steps",
            "2", "--num-diffusion-steps", "1", "--seed", "3"]
    paths = generate.main(args + ["--output-dir", str(tmp_path / "a")], device="cpu")
    assert [p.rsplit("/", 1)[1] for p in paths] == ["image_0.png", "image_1.png"]
    from PIL import Image

    first = np.asarray(Image.open(paths[0]))
    assert first.shape == (8, 8, 4) and first.dtype == np.uint8  # latents: no VAE
    model = NOVATransformer(ARCH, video_base_size=(1, 2, 2), device="cpu", **MODEL)
    g = torch.Generator().manual_seed(7)
    model.init_weights(g).fill_zero_init(g)
    state = {n: p.detach() for n, p in model.named_parameters()}
    CheckpointManager(str(tmp_path / "run")).save(5, {"params": {}, "ema": state})
    paths = generate.main(args + ["--output-dir", str(tmp_path / "b"), "--checkpoint",
                                  str(tmp_path / "run")], device="cpu")
    pipe = NOVAPipeline(model, text_encoder=DummyTextEncoder(16, 32))
    want = pipe(["a red chair", "two dogs"], num_inference_steps=2, num_diffusion_steps=1,
                generator=torch.Generator().manual_seed(3), output_type="np").images
    assert np.array_equal(np.asarray(Image.open(paths[1])), want[1])
    assert not np.array_equal(np.asarray(Image.open(paths[0])), first)


@pytest.mark.parametrize("colors", [False, True])
def test_ply_bytes_equal_jax(tmp_path, colors):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (37, 3)).astype(np.float32)
    col = rng.uniform(-0.1, 1.1, (37, 3)) if colors else None
    a = export.export_to_ply(pts, str(tmp_path / "port.ply"), colors=col)
    b = jexport.export_to_ply(pts, str(tmp_path / "jax.ply"), colors=col)
    assert open(a, "rb").read() == open(b, "rb").read()
