"""Point-cloud quantitative evaluation (port of
``nova_pointcloud_tpu/evaluation/pointcloud_eval.py``):

- ``evaluate_batch``: Chamfer and density-weighted Chamfer on the device,
  the exact Hungarian EMD on the host (at most 512 points a cloud);
- ``PointCloudEvaluator``: a guidance-scale sweep over a generation
  pipeline, the best Chamfer picked, an optional JSON dump;
- ``conditioning_report``: the cross-class Chamfer matrix and the
  null-prompt control that tell live text conditioning from a dead one.

Randomness comes from a ``torch.Generator`` in place of the JAX ``key``:
every guidance scale of a sweep starts from the same generator state, as
the JAX sweep reuses one key.
"""

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from nova_pointcloud_tpu_torch.data.shapenet import GlobalNormalizer
from nova_pointcloud_tpu_torch.ops import losses as L
from nova_pointcloud_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class EvalResult:
    guidance_scale: float
    chamfer: float
    chamfer_weighted: float
    emd: float
    seconds: float


def evaluate_batch(pred: np.ndarray, target: np.ndarray, max_emd_points: int = 512,
                   device=None) -> Dict[str, float]:
    """CD and density-weighted CD (on ``device``, the card unless "cpu") and
    the Hungarian EMD (host), each cloud subsampled to ``max_emd_points``
    for the EMD with the JAX evaluator's seeds."""
    dev = resolve_device(device)
    pred_t = torch.as_tensor(np.asarray(pred), dtype=torch.float32, device=dev)
    tgt_t = torch.as_tensor(np.asarray(target), dtype=torch.float32, device=dev)
    with torch.no_grad():
        cd = float(torch.mean(L.chamfer_distance(pred_t, tgt_t)))
        cdw = float(torch.mean(L.density_weighted_chamfer(pred_t, tgt_t)))
    emds = []
    for p, t in zip(pred, target):
        if len(p) > max_emd_points:
            idx = np.random.RandomState(0).choice(len(p), max_emd_points, False)
            p, t = p[idx], t[np.random.RandomState(1).choice(len(t), max_emd_points, False)]
        emds.append(L.hungarian_emd_host(p, t))
    return {"chamfer": cd, "chamfer_weighted": cdw, "emd": float(np.mean(emds))}


def _fresh(generator: Optional[torch.Generator], device) -> torch.Generator:
    return generator if generator is not None else \
        torch.Generator(device=device).manual_seed(0)


class PointCloudEvaluator:
    """Guidance-sweep evaluator over a generation pipeline."""

    def __init__(self, pipeline, stats_path: Optional[str] = None):
        self.pipeline = pipeline
        if stats_path and os.path.exists(stats_path):
            self.pipeline.normalizer = GlobalNormalizer.load(stats_path)

    def run(
        self,
        prompts: Sequence[str],
        references: np.ndarray,  # (B, N, 3), same coordinate system
        guidance_scales: Sequence[float] = (1.0, 2.0, 3.0, 5.0),
        num_points: int = 2048,
        num_diffusion_steps: int = 25,
        generator: Optional[torch.Generator] = None,
        output_json: Optional[str] = None,
        postprocess: str = "eval",  # clamp to [-2, 2], no tanh
        deterministic: bool = False,  # zero-variance reverse DDPM
        guidance_trunc: float = 0.0,  # half-batch CFG truncation threshold
    ) -> Dict:
        dev = self.pipeline.device
        g = _fresh(generator, dev)
        start = g.get_state()
        sweep: List[EvalResult] = []
        for gs in guidance_scales:
            t0 = time.time()
            g.set_state(start)  # every scale from the same draws
            out = self.pipeline(list(prompts), num_points=num_points,
                                num_diffusion_steps=num_diffusion_steps,
                                guidance_scale=gs, generator=g, postprocess=postprocess,
                                deterministic=deterministic, guidance_trunc=guidance_trunc)
            metrics = evaluate_batch(np.asarray(out.point_clouds), np.asarray(references),
                                     device=dev)
            sweep.append(EvalResult(gs, metrics["chamfer"], metrics["chamfer_weighted"],
                                    metrics["emd"], time.time() - t0))
        best = min(sweep, key=lambda r: r.chamfer)
        results = {
            "sweep": [dataclasses.asdict(r) for r in sweep],
            "best_guidance_scale": best.guidance_scale,
            "best_chamfer": best.chamfer,
            "best_emd": best.emd,
            "num_prompts": len(prompts),
            "num_points": num_points,
            "guidance_trunc": guidance_trunc,
        }
        if output_json:
            with open(output_json, "w") as f:
                json.dump(results, f, indent=2)
        return results


def conditioning_report(
    pipeline,
    refs_by_class: Dict[str, np.ndarray],  # class -> (B, N, 3) references
    prompt_for: Optional[Dict[str, str]] = None,  # class -> prompt
    num_points: int = 2048,
    num_diffusion_steps: int = 25,
    guidance_scale: float = 3.0,
    samples_per_class: int = 8,
    generator: Optional[torch.Generator] = None,
    generate_fn=None,  # override: (prompts, generator) -> (B, N, 3), for tests
    device=None,  # where the CDs run without a pipeline (the card unless "cpu")
) -> Dict:
    """Discriminative text-conditioning eval: the cross-class CD matrix and
    a null-conditioning control.

    ``cross_cd[i][j]`` is the mean CD of clouds generated for class i's
    prompt against class j's references (over all pairs);
    ``conditioning_accuracy`` the share of rows whose diagonal is the row
    minimum. The null control generates with "" (the CFG uncond embedding,
    guidance 1.0); ``null_degradation`` is the mean of (null CD - the
    conditioned diagonal CD). ``conditioned_ok``: accuracy 1, a positive
    class separation (mean off-diagonal - mean diagonal), and a null
    degradation above a quarter of it. Each class and the null control
    draw from their own generator, seeded from ``generator`` (seed 0 by
    default)."""
    dev = pipeline.device if pipeline is not None else resolve_device(device)
    g = _fresh(generator, dev)
    classes = sorted(refs_by_class)
    prompt_for = prompt_for or {c: f"a {c}" for c in classes}
    seeds = torch.randint(0, 2 ** 62, (len(classes) + 1,), generator=g,
                          device=g.device).tolist()

    def gen(prompts, seed):
        gi = torch.Generator(device=g.device).manual_seed(seed)
        if generate_fn is not None:
            return np.asarray(generate_fn(prompts, gi))
        out = pipeline(list(prompts), num_points=num_points,
                       num_diffusion_steps=num_diffusion_steps,
                       guidance_scale=(1.0 if all(p == "" for p in prompts)
                                       else guidance_scale),
                       generator=gi, postprocess="eval")
        return np.asarray(out.point_clouds)

    def mean_cd(a, b):
        # over all (generated, reference) pairs: conditioning is a
        # distribution-level property
        na, nb = len(a), len(b)
        aa = torch.as_tensor(np.repeat(a, nb, axis=0), dtype=torch.float32, device=dev)
        bb = torch.as_tensor(np.tile(b, (na, 1, 1)), dtype=torch.float32, device=dev)
        with torch.no_grad():
            return float(torch.mean(L.chamfer_distance(aa, bb)))

    cross = np.zeros((len(classes), len(classes)))
    for i, c in enumerate(classes):
        gen_i = gen([prompt_for[c]] * samples_per_class, seeds[i])
        for j, cj in enumerate(classes):
            cross[i, j] = mean_cd(gen_i, refs_by_class[cj][:samples_per_class])
    null_gen = gen([""] * samples_per_class, seeds[-1])
    null_cd = np.array([mean_cd(null_gen, refs_by_class[c][:samples_per_class])
                        for c in classes])

    diag = np.diag(cross)
    offdiag = cross[~np.eye(len(classes), dtype=bool)]
    accuracy = float(np.mean(np.argmin(cross, axis=1) == np.arange(len(classes))))
    separation = float(offdiag.mean() - diag.mean())
    null_degradation = float(np.mean(null_cd - diag))
    ok = bool(accuracy == 1.0 and separation > 0 and null_degradation > 0.25 * separation)
    return {
        "classes": classes,
        "cross_cd": cross.tolist(),
        "conditioning_accuracy": accuracy,
        "diag_cd": diag.tolist(),
        "null_cd": null_cd.tolist(),
        "class_separation": separation,
        "null_degradation": null_degradation,
        "conditioned_ok": ok,
    }
