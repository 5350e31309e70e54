"""Train the masked-AR point-cloud model on synthetic clouds and score it by
CD / EMD over a guidance sweep, on the card (the port of
``scripts/train_eval_pc_ar.py``, with its arguments and defaults):

    python -m nova_pointcloud_tpu_torch.scripts.train_eval_pc_ar \\
        --stats output/pc_r2/stats.json --out results/pc_ar_quality_r2.json

``NOVAPointCloudARTransformer`` (``--arch``, 1024 points at patch 16, f32,
remat) trained on 64 ``make_synthetic_clouds`` shapes normalized by the
``GlobalNormalizer`` saved at ``--stats`` (the flat trainer's
``stats.json``; this script reads it and never fits one), clipped to
[-1, 1] and sorted by Morton code, so each 16-point patch is a spatially
compact group. The optimizer is optax's ``chain(clip_by_global_norm(5.0),
adamw(cosine lr, weight_decay=0.01))``: betas (0.9, 0.999), decay on every
parameter, a cosine schedule from ``--lr`` to 0 with 200 warm-up steps.
Then ``NOVAPointCloudARPipeline`` samples 24 held-out prompts at 16 AR x
25 diffusion steps for guidance 1, 2, 3 and 5, and the CD / EMD of each
scale and the best are written to ``--out`` as JSON.
"""

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from nova_pointcloud_tpu_torch.data.shapenet import (GlobalNormalizer, make_batches,
                                                     make_synthetic_clouds)
from nova_pointcloud_tpu_torch.engine.lr_schedules import cosine_lr
from nova_pointcloud_tpu_torch.engine.optim import build_optimizer
from nova_pointcloud_tpu_torch.engine.trainer import Trainer
from nova_pointcloud_tpu_torch.evaluation.pointcloud_eval import evaluate_batch
from nova_pointcloud_tpu_torch.models.pointcloud_ar import NOVAPointCloudARTransformer
from nova_pointcloud_tpu_torch.models.text_encoders.dummy import DummyTextEncoder
from nova_pointcloud_tpu_torch.ops.pointops import morton_sort
from nova_pointcloud_tpu_torch.pipelines.pointcloud_ar import NOVAPointCloudARPipeline
from nova_pointcloud_tpu_torch.schedulers.ddpm import DDPMScheduler
from nova_pointcloud_tpu_torch.utils.device import resolve_device

GUIDANCE_SWEEP = (1.0, 2.0, 3.0, 5.0)
EVAL_SHAPES, EVAL_AR_STEPS, EVAL_DIFF_STEPS = 24, 16, 25


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="pc_d8w768")
    ap.add_argument("--max-points", type=int, default=1024)
    ap.add_argument("--patch-size", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--max-steps", type=int, default=4000)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--stats", default="output/pc_r2/stats.json")
    ap.add_argument("--out", default="results/pc_ar_quality_r2.json")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def build_model(args: argparse.Namespace, scheduler, device) -> NOVAPointCloudARTransformer:
    """The script's model: text tokens (16 of width 256), remat, seeded
    init on ``device``."""
    model = NOVAPointCloudARTransformer(
        arch=args.arch, point_cloud_size=args.max_points, patch_size=args.patch_size,
        text_token_dim=256, text_token_len=16, noise_scheduler=scheduler, remat=True,
        device=device)
    return model.init_weights(torch.Generator(device=model.device).manual_seed(args.seed))


def build_optimizer_and_schedule(model, lr: float, max_steps: int):
    """optax ``chain(clip_by_global_norm(5.0), adamw(cosine_lr(lr, max_steps,
    warmup_steps=200), weight_decay=0.01))`` over ``model``."""
    schedule = cosine_lr(lr, max_steps, warmup_steps=200)
    optimizer = build_optimizer(model, schedule, weight_decay=0.01, betas=(0.9, 0.999),
                                grad_clip=5.0,
                                decay={n: True for n, _ in model.named_parameters()})
    return optimizer, schedule


def train_batches(shapes, normalizer: GlobalNormalizer, text_encoder, batch_size: int,
                  num_points: int, seed: int, device):
    """The training stream: batches of the shapes, normalized, clipped to
    [-1, 1], Morton-sorted, with their prompts' text embeddings, forever."""
    for batch in make_batches(shapes, batch_size, num_points, seed):
        pts = np.clip(normalizer.normalize(batch["points"]), -1.0, 1.0).astype(np.float32)
        emb, _ = text_encoder.encode(batch["prompts"])
        yield {"points": morton_sort(torch.as_tensor(pts, device=device)),
               "text_embeds": torch.as_tensor(emb, device=device)}


def main(argv: Optional[Sequence[str]] = None, device=None) -> dict:
    """Train, evaluate, write ``--out``; returns the results. ``device``:
    the card unless "cpu" is asked for."""
    args = parse_args(argv)
    dev = resolve_device(device)
    normalizer = GlobalNormalizer.load(args.stats)
    text_encoder = DummyTextEncoder(256, 16)
    scheduler = DDPMScheduler(beta_schedule="squaredcos_cap_v2")
    model = build_model(args, scheduler, dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"masked-AR {args.arch}: {n_params / 1e6:.1f}M params")

    def loss_fn(batch, generator):
        losses = model(batch["points"], batch["text_embeds"], generator=generator)
        return losses["loss"], losses

    optimizer, schedule = build_optimizer_and_schedule(model, args.lr, args.max_steps)
    trainer = Trainer(loss_fn, model, optimizer, output_dir=None, lr_schedule=schedule,
                      max_steps=args.max_steps, log_every=100, save_every=0, ema_decay=None,
                      seed=args.seed)
    shapes = make_synthetic_clouds(64, args.max_points, args.seed)
    trainer.train(train_batches(shapes, normalizer, text_encoder, args.batch_size,
                                args.max_points, args.seed, dev), args.max_steps)

    pipe = NOVAPointCloudARPipeline(model, scheduler, text_encoder=text_encoder,
                                    normalizer=normalizer)
    ref_shapes = make_synthetic_clouds(EVAL_SHAPES, args.max_points, args.seed + 7)
    prompts = [s["prompt"] for s in ref_shapes]
    refs = np.clip(normalizer.normalize(np.stack([s["points"] for s in ref_shapes])),
                   -1.0, 1.0).astype(np.float32)
    results = {"arch": args.arch, "params_m": round(n_params / 1e6, 1),
               "steps": args.max_steps, "mode": "masked_ar", "sweep": []}
    for gs in GUIDANCE_SWEEP:
        out = pipe(prompts, num_inference_steps=EVAL_AR_STEPS,
                   num_diffusion_steps=EVAL_DIFF_STEPS, guidance_scale=gs,
                   generator=torch.Generator(device=dev).manual_seed(11))
        m = evaluate_batch(out.point_clouds, refs, device=dev)
        m["guidance_scale"] = gs
        results["sweep"].append(m)
        print("gs", gs, m)
    best = min(results["sweep"], key=lambda r: r["chamfer"])
    results["best_chamfer"] = best["chamfer"]
    results["best_emd"] = best["emd"]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print("wrote", args.out)
    return results


if __name__ == "__main__":
    main()
