"""Benchmark-harness samplers: GenEval images and VBench videos (port of
``nova_pointcloud_tpu/evaluation/samplers.py``).

Prompts are sampled in the layouts the external scorers read, optionally
from precomputed prompt embeddings (``scripts/precompute_prompts``):

- GenEval: ``<out>/<idx:05d>/samples/<k:04d>.png`` and
  ``<out>/<idx:05d>/metadata.jsonl``, one prompt's N samples from one call;
- VBench: ``<out>/<prompt[:180]>-<k>.mp4`` (``/`` in a prompt becomes a
  space).

Each call draws from ``torch.Generator(pipeline.device).manual_seed(seed +
i)``, i the prompt's index (GenEval) or the sample's (VBench), as the JAX
samplers key theirs.
"""

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from nova_pointcloud_tpu_torch.utils.export import export_to_image, export_to_video


def _generator(pipeline, seed: int) -> torch.Generator:
    return torch.Generator(device=pipeline.device).manual_seed(seed)


def sample_geneval(pipeline, metadata: Sequence[Dict], output_dir: str,
                   samples_per_prompt: int = 4, prompt_embeds: Optional[np.ndarray] = None,
                   seed: int = 0, **call_kwargs) -> List[str]:
    """GenEval layout; ``metadata`` entries carry a "prompt"; returns the
    image paths."""
    paths = []
    for idx, entry in enumerate(metadata):
        sample_dir = os.path.join(output_dir, f"{idx:05d}", "samples")
        os.makedirs(sample_dir, exist_ok=True)
        with open(os.path.join(output_dir, f"{idx:05d}", "metadata.jsonl"), "w") as f:
            f.write(json.dumps(entry) + "\n")
        pe = None if prompt_embeds is None else prompt_embeds[idx: idx + 1]
        out = pipeline([entry["prompt"]], num_images_per_prompt=samples_per_prompt,
                       prompt_embeds=pe, generator=_generator(pipeline, seed + idx),
                       output_type="np", **call_kwargs)
        for k, img in enumerate(out.images):
            paths.append(export_to_image(img, os.path.join(sample_dir, f"{k:04d}.png")))
    return paths


def sample_vbench(pipeline, prompts: Sequence[str], output_dir: str,
                  samples_per_prompt: int = 5, max_latent_length: int = 9, fps: int = 12,
                  seed: int = 0, **call_kwargs) -> List[str]:
    """VBench layout; returns the video paths (a GIF's where no mp4 writer
    works)."""
    os.makedirs(output_dir, exist_ok=True)
    paths = []
    for prompt in prompts:
        for k in range(samples_per_prompt):
            out = pipeline([prompt], max_latent_length=max_latent_length,
                           generator=_generator(pipeline, seed + k), output_type="np",
                           **call_kwargs)
            name = f"{prompt.replace('/', ' ')[:180]}-{k}.mp4"
            paths.append(export_to_video(out.frames[0], os.path.join(output_dir, name),
                                         fps=fps))
    return paths
