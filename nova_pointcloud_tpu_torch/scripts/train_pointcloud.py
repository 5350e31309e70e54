"""Standalone text-to-point-cloud trainer on the card (the port of
``scripts/train_pointcloud.py``, with its arguments and defaults):

    python -m nova_pointcloud_tpu_torch.scripts.train_pointcloud \\
        --output-dir output/pc --max-steps 10000

``NOVAPointCloudTransformer`` (``--arch``, f32, remat unless
``--no-remat``) trained by ``NOVATrainPointCloudPipeline`` on the composite
loss, through per-layer clipping (``output_proj`` x0.5, ``time_`` x0.3),
the adaptive lr multiplier and AdamW (cosine lr with 200 warmup steps,
weight decay 0.01 on every parameter), EMA every ``--ema-every`` steps;
checkpoints every ``--val-every`` steps, resumed from the latest in
``--output-dir``; at each validation the EMA weights are sampled and the
best sampled Chamfer (or validation loss) is kept as ``checkpoint-best``,
with early stopping after ``--patience`` rounds without a gain.

Without ``--data-root`` it trains on procedural clouds (spheres, boxes,
cylinders), fresh each batch. The ``train_config.json`` sidecar records
the parameterization the checkpoints are trained for; on resume it is read,
not overwritten: ``--prediction-type`` defaults to its value, and a
conflicting one (or a conflicting arch, patch size or point count) is
refused. ``--offload-opt-state`` is not ported and raises.
"""

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from nova_pointcloud_tpu_torch.data.shapenet import (
    GlobalNormalizer, ShapeNet15kPointClouds, make_batches, make_synthetic_clouds)
from nova_pointcloud_tpu_torch.engine.grad_tools import adaptive_lr_on_spike, per_layer_clip
from nova_pointcloud_tpu_torch.engine.lr_schedules import cosine_lr
from nova_pointcloud_tpu_torch.evaluation.pointcloud_eval import PointCloudEvaluator
from nova_pointcloud_tpu_torch.models.pointcloud import NOVAPointCloudTransformer
from nova_pointcloud_tpu_torch.models.text_encoders.dummy import DummyTextEncoder
from nova_pointcloud_tpu_torch.pipelines.pointcloud_gen import NOVAPointCloudGenerationPipeline
from nova_pointcloud_tpu_torch.pipelines.pointcloud_train import (
    NOVATrainPointCloudPipeline, PointCloudLossConfig, pc_adamw)
from nova_pointcloud_tpu_torch.schedulers.ddpm import DDPMScheduler
from nova_pointcloud_tpu_torch.utils.device import resolve_device

SIDECAR_KEYS = ("prediction_type", "arch", "patch_size", "max_points")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-root", default=None, help="ShapeNet 15k npy root")
    ap.add_argument("--categories", nargs="+", default=["all"])
    ap.add_argument("--output-dir", default="output/pc")
    ap.add_argument("--arch", default="pc_d8w768")
    ap.add_argument("--max-points", type=int, default=1024)
    ap.add_argument("--patch-size", type=int, default=1)
    ap.add_argument("--num-subsets", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--max-steps", type=int, default=10000)
    ap.add_argument("--val-every", type=int, default=500)
    ap.add_argument("--patience", type=int, default=8)
    ap.add_argument("--grad-clip", type=float, default=50.0)
    ap.add_argument("--ema-decay", type=float, default=0.99)
    ap.add_argument("--ema-every", type=int, default=10,
                    help="EMA update cadence in steps")
    ap.add_argument("--lr-min-ratio", type=float, default=0.1,
                    help="cosine floor as a fraction of peak lr")
    ap.add_argument("--cond-dropout", type=float, default=0.1,
                    help="per-sample probability of replacing the prompt "
                         "with '' so the CFG uncond branch is trained")
    ap.add_argument("--prediction-type", default=None,
                    choices=("epsilon", "sample", "v_prediction"),
                    help="diffusion parameterization (default: the output "
                         "dir's train_config.json, else epsilon)")
    ap.add_argument("--fresh-data", dest="fresh_data", action="store_true",
                    default=None,
                    help="stream freshly-sampled procedural clouds every "
                         "batch (default ON without --data-root)")
    ap.add_argument("--no-fresh-data", dest="fresh_data", action="store_false")
    ap.add_argument("--select-on", choices=("cd", "val_loss"), default="cd",
                    help="best-checkpoint / early-stop criterion: sampled "
                         "chamfer on the EMA weights, or the validation loss")
    ap.add_argument("--eval-shapes", type=int, default=24)
    ap.add_argument("--eval-steps", type=int, default=25)
    ap.add_argument("--eval-guidance", type=float, nargs="+", default=[1.0, 3.0])
    ap.add_argument("--no-remat", action="store_true",
                    help="disable per-block gradient checkpointing")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--offload-opt-state", action="store_true",
                    help="park the Adam moments in host memory (not ported)")
    args = ap.parse_args(argv)
    if args.fresh_data is None:
        args.fresh_data = args.data_root is None
    return args


def resolve_train_config(output_dir: str, args: argparse.Namespace) -> dict:
    """The sidecar's settings: those of an existing ``train_config.json``
    (a conflicting argument raises ``SystemExit``), else the arguments'
    (``prediction_type`` epsilon by default), written to it."""
    path = os.path.join(output_dir, "train_config.json")
    want = {"prediction_type": args.prediction_type, "arch": args.arch,
            "patch_size": args.patch_size, "max_points": args.max_points}
    if os.path.exists(path):
        with open(path) as f:
            saved = json.load(f)
        if want["prediction_type"] is None:
            want["prediction_type"] = saved.get("prediction_type", "epsilon")
        clash = {k: (saved[k], want[k]) for k in SIDECAR_KEYS
                 if k in saved and saved[k] != want[k]}
        if clash:
            raise SystemExit(f"{path} records {', '.join(f'{k}={v[0]!r}' for k, v in clash.items())}"
                             f"; the arguments ask for "
                             f"{', '.join(f'{k}={v[1]!r}' for k, v in clash.items())}: "
                             f"refusing to resume with another configuration")
        return want
    if want["prediction_type"] is None:
        want["prediction_type"] = "epsilon"
    with open(path, "w") as f:
        json.dump(want, f)
    return want


def build_optimizer(model, lr: float = 1e-4, max_steps: int = 10000,
                    lr_min_ratio: float = 0.1, grad_clip: float = 50.0):
    """The script's optimizer and its schedule: per_layer_clip(grad_clip,
    output_proj x0.5, time_ x0.3) -> adaptive_lr_on_spike(grad_clip) ->
    AdamW (cosine from ``lr`` to ``lr * lr_min_ratio``, 200 warmup steps,
    weight decay 0.01 on every parameter)."""
    schedule = cosine_lr(lr, max_steps, lr_min=lr * lr_min_ratio, warmup_steps=200)
    optimizer = pc_adamw(model, schedule, weight_decay=0.01, transforms=[
        per_layer_clip(grad_clip, {"output_proj": 0.5, "time_": 0.3}),
        adaptive_lr_on_spike(explode_norm=grad_clip)])
    return optimizer, schedule


def fresh_batches(normalizer: GlobalNormalizer, batch_size: int, num_points: int, seed: int,
                  cond_dropout: float = 0.0, drop_rng: Optional[np.random.RandomState] = None):
    """Freshly-sampled procedural clouds every batch, forever: normalized
    and clipped to [-1, 1] (the sampler's postprocess assumes the data lives
    there); each prompt replaced by "" with probability ``cond_dropout``
    (``drop_rng``'s draws), so the CFG uncond branch trains on the encoder's
    "" embedding."""
    batch_seed = seed
    while True:
        batch_seed += 1
        shapes = make_synthetic_clouds(batch_size, num_points, batch_seed)
        pts = np.clip(normalizer.normalize(np.stack([s["points"] for s in shapes])), -1.0, 1.0)
        prompts = [s["prompt"] for s in shapes]
        if cond_dropout > 0:
            prompts = ["" if drop_rng.rand() < cond_dropout else p for p in prompts]
        yield {"points": pts.astype(np.float32), "prompts": prompts}


def main(argv: Optional[Sequence[str]] = None, device=None) -> dict:
    """Train; returns ``{"step", "best_metric"}``. ``device``: the card
    unless "cpu" is asked for."""
    args = parse_args(argv)
    if args.offload_opt_state:
        raise NotImplementedError("optimizer-state offload (--offload-opt-state) is not ported "
                                  "yet: ROADMAP.md, module queue, parallelism")
    dev = resolve_device(device)
    os.makedirs(args.output_dir, exist_ok=True)
    train_cfg = resolve_train_config(args.output_dir, args)
    prediction_type = train_cfg["prediction_type"]

    if args.data_root:
        train_ds = ShapeNet15kPointClouds(args.data_root, args.categories, split="train")
        val_ds = ShapeNet15kPointClouds(args.data_root, args.categories, split="val")
        sample_clouds = [train_ds[i]["points"] for i in range(min(64, len(train_ds)))]
    else:
        print("no --data-root: training on synthetic bootstrap clouds")
        shapes = make_synthetic_clouds(64, args.max_points, args.seed)
        sample_clouds = [s["points"] for s in shapes]
        train_ds = shapes
        val_ds = make_synthetic_clouds(16, args.max_points, args.seed + 1)

    normalizer = GlobalNormalizer().fit(sample_clouds)
    normalizer.save(os.path.join(args.output_dir, "stats.json"))

    text_encoder = DummyTextEncoder(256, 16)
    model = NOVAPointCloudTransformer(arch=args.arch, point_cloud_size=args.max_points,
                                      patch_size=args.patch_size, text_token_dim=256,
                                      remat=not args.no_remat, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(args.seed))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model {args.arch}: {n_params / 1e6:.1f}M params")

    optimizer, schedule = build_optimizer(model, args.lr, args.max_steps, args.lr_min_ratio,
                                          args.grad_clip)
    sched = DDPMScheduler(beta_schedule="squaredcos_cap_v2", prediction_type=prediction_type)
    pipe = NOVATrainPointCloudPipeline(
        model, scheduler=sched, text_encoder=text_encoder, normalizer=normalizer,
        output_dir=args.output_dir, optimizer=optimizer,
        loss_config=PointCloudLossConfig(num_subsets=args.num_subsets),
        max_steps=args.max_steps, log_every=20, save_every=args.val_every,
        ema_decay=args.ema_decay or None, ema_every=args.ema_every,
        lr_schedule=schedule, seed=args.seed)

    drop_rng = np.random.RandomState(args.seed + 1234)

    def norm_batches(ds, seed, cond_dropout=0.0):
        for batch in make_batches(ds, args.batch_size, args.max_points, seed):
            # clamp to [-1, 1] after normalization: the sampler's
            # postprocess assumes the data lives there
            batch["points"] = np.clip(normalizer.normalize(batch["points"]), -1.0, 1.0)
            if cond_dropout > 0:
                # train the CFG uncond branch on the encoder's "" embedding
                batch["prompts"] = ["" if drop_rng.rand() < cond_dropout else p
                                    for p in batch["prompts"]]
            yield batch

    # in-training sampled-quality eval: the EMA weights through the
    # generation pipeline at eval postprocess, CD against a fixed held-out
    # set (seed + 7; the eval script's default seed is 123)
    eval_shapes = make_synthetic_clouds(args.eval_shapes, args.max_points, args.seed + 7)
    eval_prompts = [s["prompt"] for s in eval_shapes]
    eval_refs = np.clip(normalizer.normalize(np.stack([s["points"] for s in eval_shapes])),
                        -1.0, 1.0)
    bf16 = dev.type == "cuda"
    eval_model = NOVAPointCloudTransformer(
        arch=args.arch, point_cloud_size=args.max_points, patch_size=args.patch_size,
        text_token_dim=256, dropout=0.0, dtype=torch.bfloat16 if bf16 else None, device=dev)
    if bf16:
        eval_model = eval_model.to(torch.bfloat16)
    eval_pipe = NOVAPointCloudGenerationPipeline(
        eval_model, DDPMScheduler(beta_schedule="squaredcos_cap_v2",
                                  prediction_type=prediction_type),
        text_encoder=text_encoder)
    evaluator = PointCloudEvaluator(eval_pipe)

    def sampled_cd(step):
        w = pipe.trainer.ema.params if pipe.trainer.ema is not None else pipe.params
        eval_model.load_state_dict(w)
        r = evaluator.run(eval_prompts, eval_refs, guidance_scales=tuple(args.eval_guidance),
                          num_points=args.max_points, num_diffusion_steps=args.eval_steps,
                          generator=torch.Generator(device=dev).manual_seed(args.seed + step))
        return r["best_chamfer"], r["best_guidance_scale"], r["best_emd"]

    train_stream = (fresh_batches(normalizer, args.batch_size, args.max_points, args.seed,
                                  args.cond_dropout, drop_rng) if args.fresh_data
                    else norm_batches(train_ds, args.seed, args.cond_dropout))

    # early stopping and the best checkpoint on sampled CD over the EMA
    # weights (or the validation loss)
    best_metric, bad_rounds = float("inf"), 0
    step = pipe.trainer.step  # resume-aware
    while step < args.max_steps and bad_rounds < args.patience:
        target = min(step + args.val_every, args.max_steps)
        pipe.train(train_stream, max_steps=target)
        step = pipe.trainer.step
        vb = norm_batches(val_ds, args.seed + 99)
        val = pipe.validate([next(vb) for _ in range(4)])
        line = ", ".join(f"{k}={v:.4f}" for k, v in val.items())
        if args.select_on == "cd":
            cd, gs, emd = sampled_cd(step)
            line += f", sampled_cd={cd:.4f} (gs={gs}, emd={emd:.4f})"
            metric = cd
        else:
            metric = val["loss"]
        print(f"[val @ {step}] {line}", flush=True)
        if metric < best_metric - 1e-5:
            best_metric, bad_rounds = metric, 0
            pipe.trainer.save_best(metric)
        else:
            bad_rounds += 1
    print(f"done at step {step}; best {args.select_on} {best_metric:.4f}")
    return {"step": step, "best_metric": best_metric}


if __name__ == "__main__":
    main()
