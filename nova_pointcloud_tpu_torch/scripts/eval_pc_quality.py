"""Quality evaluation of a trained point-cloud checkpoint on the card (the
port of ``scripts/eval_pc_quality.py``, with its arguments and defaults):
a guidance sweep of CD / density-weighted CD / EMD for the float (bf16 on
the card) and int8 serving paths, a noise baseline, optionally calibrated
static int8 scales and the conditioning report; a results JSON.

    python -m nova_pointcloud_tpu_torch.scripts.eval_pc_quality \\
        --checkpoint-dir output/pc --out results/pc_quality.json

The checkpoint directory is the trainer's (``checkpoints/checkpoint-best``
unless ``--latest``, ``stats.json``, ``train_config.json``); references
are procedural clouds from ``--seed`` in the checkpoint's coordinates.
"""

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from nova_pointcloud_tpu_torch.data.shapenet import GlobalNormalizer, make_synthetic_clouds
from nova_pointcloud_tpu_torch.engine.checkpoint import CheckpointManager
from nova_pointcloud_tpu_torch.evaluation.pointcloud_eval import (
    PointCloudEvaluator, conditioning_report, evaluate_batch)
from nova_pointcloud_tpu_torch.models.pointcloud import NOVAPointCloudTransformer
from nova_pointcloud_tpu_torch.models.text_encoders.dummy import DummyTextEncoder
from nova_pointcloud_tpu_torch.pipelines.pointcloud_gen import NOVAPointCloudGenerationPipeline
from nova_pointcloud_tpu_torch.schedulers.ddpm import DDPMScheduler
from nova_pointcloud_tpu_torch.utils.device import resolve_device


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint-dir", default="output/pc_r2")
    ap.add_argument("--arch", default="pc_d8w768")
    ap.add_argument("--num-points", type=int, default=1024)
    ap.add_argument("--patch-size", type=int, default=1)
    ap.add_argument("--num-shapes", type=int, default=24)
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--out", default="results/pc_quality_r2.json")
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--latest", action="store_true",
                    help="evaluate the latest periodic checkpoint even when "
                         "a best-on-CD slot exists")
    ap.add_argument("--use-ema", action="store_true",
                    help="evaluate the EMA weights saved alongside params")
    ap.add_argument("--guidance", type=float, nargs="+", default=(1.0, 2.0, 3.0, 5.0),
                    help="guidance scales to sweep")
    ap.add_argument("--guidance-trunc", type=float, default=0.0,
                    help="disable CFG below this timestep")
    ap.add_argument("--static-acts", dest="static_acts", action="store_true",
                    help="also score the int8 path with calibrated static "
                         "activation scales as a third 'int8_static' row")
    ap.add_argument("--conditioning", action="store_true",
                    help="also run the conditioning report: cross-class CD "
                         "matrix + null-text ablation control")
    ap.add_argument("--deterministic", action="store_true",
                    help="zero-variance reverse DDPM")
    ap.add_argument("--attn-core", choices=("f32", "bf16", "int8"), default="bf16",
                    help="fused-kernel attention-core precision for the int8 rows")
    ap.add_argument("--prediction-type", default=None,
                    choices=("epsilon", "sample", "v_prediction"),
                    help="override the checkpoint's train_config.json "
                         "parameterization (default: read the sidecar, else epsilon)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, device=None) -> dict:
    """Evaluate; writes ``--out`` and returns the results. ``device``: the
    card unless "cpu" is asked for (the int8 rows run on the card only)."""
    args = parse_args(argv)
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    normalizer = GlobalNormalizer.load(os.path.join(args.checkpoint_dir, "stats.json"))
    # sample with the parameterization the checkpoint was trained for
    prediction_type = args.prediction_type
    tc_path = os.path.join(args.checkpoint_dir, "train_config.json")
    if prediction_type is None:
        prediction_type = "epsilon"
        if os.path.exists(tc_path):
            with open(tc_path) as f:
                prediction_type = json.load(f).get("prediction_type", "epsilon")
    print(f"# prediction_type={prediction_type}")
    shapes = make_synthetic_clouds(args.num_shapes, args.num_points, args.seed)
    prompts = [s["prompt"] for s in shapes]
    refs = np.clip(normalizer.normalize(np.stack([s["points"] for s in shapes])),
                   -1.0, 1.0).astype(np.float32)

    def build(quantize):
        model = NOVAPointCloudTransformer(
            arch=args.arch, point_cloud_size=args.num_points, patch_size=args.patch_size,
            text_token_dim=256, dropout=0.0, quantize=quantize, attn_core=args.attn_core,
            dtype=torch.bfloat16 if on_card else None, device=dev)
        ckpt = CheckpointManager(args.checkpoint_dir)
        # the quality-selected slot before the latest periodic save
        out = None if args.latest else ckpt.restore_best(map_location=dev)
        if out is None:
            out = ckpt.restore(map_location=dev)
        if out is None:
            raise SystemExit(f"no checkpoint under {args.checkpoint_dir}")
        model.load_state_dict(out["state"]["ema" if args.use_ema else "params"])
        if on_card:
            model = model.to(torch.bfloat16)
        pipe = NOVAPointCloudGenerationPipeline(
            model, DDPMScheduler(beta_schedule="squaredcos_cap_v2",
                                 prediction_type=prediction_type),
            text_encoder=DummyTextEncoder(256, 16))
        return pipe, out["step"]

    results = {"arch": args.arch, "num_points": args.num_points,
               "diffusion_steps": args.steps, "attn_core": args.attn_core,
               "backend": dev.type}
    # noise baseline: what CD / EMD does pure noise score?
    noise = np.clip(np.random.RandomState(0).randn(*refs.shape), -2, 2).astype(np.float32)
    results["noise_baseline"] = evaluate_batch(noise, refs, device=dev)

    variants = [("bf16", False, False), ("int8", True, False)]
    if args.static_acts:
        variants.append(("int8_static", True, True))
    for tag, quantize, static in variants:
        if quantize and not on_card:
            continue
        pipe, step = build(quantize)
        if static:
            pipe.calibrate(prompt_embeds=pipe.encode_prompt(prompts),
                           num_points=args.num_points, num_diffusion_steps=args.steps)
        results["checkpoint_step"] = step
        r = PointCloudEvaluator(pipe).run(
            prompts, refs, guidance_scales=tuple(args.guidance), num_points=args.num_points,
            num_diffusion_steps=args.steps,
            generator=torch.Generator(device=dev).manual_seed(args.seed),
            deterministic=args.deterministic, guidance_trunc=args.guidance_trunc)
        results[tag] = r
        print(tag, "best_cd=%.4f best_emd=%.4f @gs=%s" % (
            r["best_chamfer"], r["best_emd"], r["best_guidance_scale"]))
        if args.conditioning:
            refs_by_class = {}
            for s, ref in zip(shapes, refs):
                refs_by_class.setdefault(s["synset"], []).append(ref)
            refs_by_class = {k: np.stack(v) for k, v in refs_by_class.items()}
            rep = conditioning_report(
                pipe, refs_by_class, num_points=args.num_points,
                num_diffusion_steps=args.steps, guidance_scale=r["best_guidance_scale"],
                generator=torch.Generator(device=dev).manual_seed(args.seed + 1))
            results[tag + "_conditioning"] = rep
            print(tag, "conditioning acc=%.2f sep=%.4f null_deg=%.4f ok=%s"
                  % (rep["conditioning_accuracy"], rep["class_separation"],
                     rep["null_degradation"], rep["conditioned_ok"]))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2, default=str)
    print("wrote", args.out)
    return results


if __name__ == "__main__":
    main()
