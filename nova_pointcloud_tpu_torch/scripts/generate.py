"""Generation CLI: text-to-image / video / point cloud from a config (the
port of ``scripts/generate.py``, with its arguments and defaults):

    python -m nova_pointcloud_tpu_torch.scripts.generate \\
        --config <model config> --prompt "a red chair" --output-dir output/samples

The pipeline comes from the config's ``pipeline`` / ``model`` /
``scheduler`` sections (``pipelines/builder.build_pipeline``; a training
pipeline's name is served by its inference pipeline), on seeded random
weights or, with ``--checkpoint``, the port trainer's weights (the EMA
weights where the checkpoint holds them). The NOVA pipelines take
``DummyTextEncoder`` prompts and, having no VAE, write their latents as
images / videos; the point-cloud pipeline writes PLY files. A c2i model's
prompts are class ids.
"""

import argparse
import os
from typing import List, Optional, Sequence

import torch

from nova_pointcloud_tpu_torch.engine.checkpoint import CheckpointManager
from nova_pointcloud_tpu_torch.models.text_encoders.dummy import DummyTextEncoder
from nova_pointcloud_tpu_torch.pipelines.builder import build_pipeline
from nova_pointcloud_tpu_torch.utils.config import Config, load_config
from nova_pointcloud_tpu_torch.utils.device import resolve_device
from nova_pointcloud_tpu_torch.utils.export import export_to_image, export_to_ply, export_to_video


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--prompt", nargs="+", required=True)
    ap.add_argument("--negative-prompt", default=None)
    ap.add_argument("--output-dir", default="output/samples")
    ap.add_argument("--num-inference-steps", type=int, default=64)
    ap.add_argument("--num-diffusion-steps", type=int, default=25)
    ap.add_argument("--guidance-scale", type=float, default=5.0)
    ap.add_argument("--max-latent-length", type=int, default=1)
    ap.add_argument("--num-points", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None,
                    help="the output directory of the port's trainer "
                         "(engine/checkpoint.CheckpointManager: checkpoints/checkpoint-<step>/"
                         "state.pt, the latest step read), in place of the JAX script's "
                         "orbax directory")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, device=None) -> List[str]:
    """Generate and write the outputs; returns their paths. ``device``: the
    card unless "cpu" is asked for."""
    args = parse_args(argv)
    dev = resolve_device(device)
    cfg = load_config(args.config)
    # force an inference pipeline even from a training config
    name = cfg.get("pipeline", {}).get("name", "NOVAPipeline")
    if name.startswith("NOVATrain"):
        name = "NOVAC2IPipeline" if "C2I" in name else "NOVAPipeline"
        cfg.setdefault("pipeline", Config())["name"] = name
    state_dict = None
    if args.checkpoint:
        restored = CheckpointManager(args.checkpoint).restore(map_location=dev)
        if restored is None:
            raise FileNotFoundError(f"no checkpoint under {args.checkpoint}")
        state = restored["state"]
        state_dict = state.get("ema", state.get("params", state))
    pipe, _ = build_pipeline(cfg, state_dict=state_dict, seed=args.seed, device=dev)
    kind = type(pipe).__name__
    if "PointCloud" in kind:
        pipe.text_encoder = DummyTextEncoder(256, 32)
    elif kind != "NOVAC2IPipeline":
        pipe.text_encoder = DummyTextEncoder(cfg["model"].get("text_token_dim", 256), 32)

    os.makedirs(args.output_dir, exist_ok=True)
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    paths = []
    if "PointCloud" in kind:
        out = pipe(args.prompt, num_points=args.num_points,
                   num_diffusion_steps=args.num_diffusion_steps,
                   guidance_scale=args.guidance_scale, generator=generator)
        for i, (pts, col) in enumerate(zip(out.point_clouds, out.colors)):
            paths.append(export_to_ply(pts, os.path.join(args.output_dir, f"pc_{i}.ply"),
                                       colors=col))
    else:
        prompt = [int(p) for p in args.prompt] if kind == "NOVAC2IPipeline" else args.prompt
        out = pipe(prompt, num_inference_steps=args.num_inference_steps,
                   num_diffusion_steps=args.num_diffusion_steps,
                   guidance_scale=args.guidance_scale,
                   max_latent_length=args.max_latent_length,
                   negative_prompt=([args.negative_prompt] * len(prompt)
                                    if args.negative_prompt else None),
                   generator=generator, output_type="np")
        if out.images is not None:
            for i, img in enumerate(out.images):
                paths.append(export_to_image(img, os.path.join(args.output_dir,
                                                               f"image_{i}.png")))
        else:
            for i, frames in enumerate(out.frames):
                paths.append(export_to_video(frames, os.path.join(args.output_dir,
                                                                  f"video_{i}.mp4")))
    for p in paths:
        print("wrote", p)
    return paths


if __name__ == "__main__":
    main()
