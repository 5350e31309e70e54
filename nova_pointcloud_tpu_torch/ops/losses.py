"""Training losses (port of ``nova_pointcloud_tpu/ops/losses.py``): the
token-wise masked diffusion MSE of NOVA training, and the point-cloud terms
of the composite t2pc loss: Chamfer (exact, direct differences), the
entropy-regularised EMD (Sinkhorn, on the device, with the envelope
gradient), the density-weighted Chamfer, the AR subset-consistency term,
and the exact Hungarian EMD (host numpy + scipy, evaluation only)."""

import math
from typing import Dict, Optional

import numpy as np
import torch

from nova_pointcloud_tpu_torch.ops.pointops import (exact_min_sqdist, local_density,
                                                    pairwise_sqdist)


def masked_diffusion_mse(model_pred: torch.Tensor, target: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Per-token MSE over the channels, weighted by ``mask`` (1 = a predicted
    token) and normalised by its sum (+1e-5); float32."""
    loss = torch.square(model_pred.float() - target.float())
    loss = torch.mean(loss, dim=-1, keepdim=True)
    weight = mask.to(loss.dtype)
    return torch.sum(loss * weight) / (torch.sum(weight) + 1e-5)


def chamfer_distance(pred: torch.Tensor, target: torch.Tensor,
                     squared: bool = True) -> torch.Tensor:
    """Symmetric Chamfer distance per batch element (B,): the mean of the
    minimum squared distances in both directions (their square roots, +1e-12
    inside, with ``squared=False``)."""
    fwd = exact_min_sqdist(pred, target)
    bwd = exact_min_sqdist(target, pred)
    if not squared:
        fwd, bwd = torch.sqrt(fwd + 1e-12), torch.sqrt(bwd + 1e-12)
    return torch.mean(fwd, dim=1) + torch.mean(bwd, dim=1)


def sinkhorn_emd(pred: torch.Tensor, target: torch.Tensor, epsilon: float = 0.02,
                 num_iters: int = 50) -> torch.Tensor:
    """Entropy-regularised EMD per batch element (B,), log-domain Sinkhorn
    over uniform marginals.

    The gradient follows the envelope theorem, as the JAX op's: the
    potentials and the plan are computed without autograd from a detached
    cost, and the loss is ``sum(plan * cost)`` with the plan held fixed, so
    autograd sees one (B, N, M) product instead of ``num_iters`` unrolled
    logsumexp passes."""
    b, n, _ = pred.shape
    m = target.shape[1]
    cost = pairwise_sqdist(pred, target)  # (B, N, M)
    with torch.no_grad():
        c = cost.detach()
        log_mu = torch.full((b, n), -math.log(n), device=c.device)
        log_nu = torch.full((b, m), -math.log(m), device=c.device)
        f = torch.zeros((b, n), device=c.device)
        g = torch.zeros((b, m), device=c.device)
        for _ in range(num_iters):
            f = epsilon * (log_mu - torch.logsumexp((g[:, None, :] - c) / epsilon, dim=2))
            g = epsilon * (log_nu - torch.logsumexp((f[:, :, None] - c) / epsilon, dim=1))
        plan = torch.exp((f[:, :, None] + g[:, None, :] - c) / epsilon)
    return torch.sum(plan * cost, dim=(1, 2))


def hungarian_emd_host(pred: np.ndarray, target: np.ndarray) -> float:
    """Exact EMD by scipy's Hungarian solve: the mean matched euclidean
    distance. Host numpy, for evaluation only."""
    from scipy.optimize import linear_sum_assignment

    d = np.linalg.norm(pred[:, None, :] - target[None, :, :], axis=-1)
    row, col = linear_sum_assignment(d)
    return float(d[row, col].mean())


def density_weighted_chamfer(pred: torch.Tensor, target: torch.Tensor,
                             k: int = 8) -> torch.Tensor:
    """Chamfer with the target's sparse regions weighted up (B,): the
    target->pred term weighted by each target point's mean kNN distance over
    its cloud's mean."""
    density = local_density(target, k)  # (B, M); larger = sparser
    w = density / (torch.mean(density, dim=1, keepdim=True) + 1e-8)
    fwd = torch.mean(exact_min_sqdist(pred, target), dim=1)
    bwd = torch.mean(exact_min_sqdist(target, pred) * w, dim=1)
    return fwd + bwd


def ar_consistency_loss(points: torch.Tensor, subset_ids: torch.Tensor) -> torch.Tensor:
    """Subset boundary smoothness (scalar): for each consecutive pair of
    subsets (in index order, as the JAX op), the mean over the batch and the
    first subset's points of the squared distance to the nearest point of
    the next; averaged over the k - 1 pairs, all pairs in one batched
    product. points (B, N, 3), subset_ids (k, N // k)."""
    b, k, n = points.shape[0], subset_ids.shape[0], subset_ids.shape[1]
    subsets = points[:, subset_ids.long()]  # (B, k, N // k, 3)
    d2 = pairwise_sqdist(subsets[:, :-1].reshape(b * (k - 1), n, -1),
                         subsets[:, 1:].reshape(b * (k - 1), n, -1))
    per_pair = torch.mean(torch.amin(d2, dim=2).reshape(b, k - 1, n), dim=(0, 2))
    return torch.sum(per_pair) / (k - 1)


def composite_pointcloud_loss(
    model_pred: torch.Tensor,
    noise_target: torch.Tensor,
    pred_points: torch.Tensor,
    target_points: torch.Tensor,
    subset_ids: Optional[torch.Tensor] = None,
    weights: Optional[Dict[str, float]] = None,
) -> Dict[str, torch.Tensor]:
    """0.85 diffusion MSE + 0.12 Chamfer + 0.08 EMD (Sinkhorn at its
    defaults) (+ 0.2 AR consistency when ``subset_ids`` is given): the
    scalar components and ``"loss"``, their weighted sum."""
    w = {"diffusion": 0.85, "chamfer": 0.12, "emd": 0.08, "ar": 0.2}
    w.update(weights or {})
    out = {
        "loss_diffusion": torch.mean(torch.square(model_pred.float() - noise_target.float())),
        "loss_chamfer": torch.mean(chamfer_distance(pred_points, target_points)),
        "loss_emd": torch.mean(sinkhorn_emd(pred_points, target_points)),
    }
    loss = (w["diffusion"] * out["loss_diffusion"]
            + w["chamfer"] * out["loss_chamfer"] + w["emd"] * out["loss_emd"])
    if subset_ids is not None:
        out["loss_ar"] = ar_consistency_loss(pred_points, subset_ids)
        loss = loss + w["ar"] * out["loss_ar"]
    out["loss"] = loss
    return out
