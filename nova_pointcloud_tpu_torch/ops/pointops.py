"""Point-cloud geometry ops (port of ``pairwise_sqdist``, ``cdist``,
``exact_min_sqdist``, ``knn``, ``local_density`` and ``dynamic_partition``
from ``nova_pointcloud_tpu/ops/pointops.py``; farthest point sampling, the
feature-aware interpolation and the Morton order come with the point-cloud
AR modes, see ROADMAP.md)."""

from typing import Optional, Tuple

import torch


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances (B, N, M) via one matmul.

    ||a-b||^2 = |a|^2 + |b|^2 - 2ab ; clamped at 0 for fp error.
    """
    a2 = torch.sum(a * a, dim=-1, keepdim=True)  # (B, N, 1)
    b2 = torch.sum(b * b, dim=-1, keepdim=True)  # (B, M, 1)
    cross = torch.einsum("bnd,bmd->bnm", a, b)
    return torch.clamp(a2 + b2.transpose(-1, -2) - 2.0 * cross, min=0.0)


def cdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclidean distance matrix, sqrt(sqdist + 1e-12) as the JAX op."""
    return torch.sqrt(pairwise_sqdist(a, b) + 1e-12)


def exact_min_sqdist(a: torch.Tensor, b: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """min_j ||a_i - b_j||^2 from direct differences (exact in float32, unlike
    the matmul form), ``chunk`` rows of ``a`` at a time so that memory stays
    at chunk * M * D. a: (B, N, D), b: (B, M, D) -> (B, N)."""
    mins = []
    for i in range(0, a.shape[1], chunk):
        ac = a[:, i:i + chunk]
        d2 = torch.sum(torch.square(ac[:, :, None, :] - b[:, None, :, :]), dim=-1)
        mins.append(torch.amin(d2, dim=-1))
    return torch.cat(mins, dim=1)


def knn(points: torch.Tensor, queries: torch.Tensor, k: int
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbours of ``queries`` among ``points``: (distances
    (B, Q, k), indices (B, Q, k)), ascending."""
    neg, idx = torch.topk(-cdist(queries, points), k, dim=-1)
    return -neg, idx


def local_density(points: torch.Tensor, k_neighbors: int = 8) -> torch.Tensor:
    """Mean distance to the k nearest other points, per point (B, N)."""
    d, _ = knn(points, points, k_neighbors + 1)
    return torch.mean(d[..., 1:], dim=-1)


def dynamic_partition(generator: Optional[torch.Generator], num_points: int, k: int = 20,
                      perm: Optional[torch.Tensor] = None,
                      order: Optional[torch.Tensor] = None, device=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A random split into ``k`` equal subsets and a random generation order:
    ``(order (k,), subset_ids (k, num_points // k))``, int32, with
    ``subset_ids = perm.reshape(k, -1)`` as the JAX op lays them out.
    ``perm`` / ``order`` given (the tests give JAX's draws) are used as
    they are; otherwise both are drawn from ``generator``."""
    if num_points % k:
        raise ValueError(f"num_points={num_points} must divide into k={k} subsets")
    dev = device if device is not None else (
        generator.device if generator is not None else None)
    if perm is None:
        perm = torch.randperm(num_points, generator=generator, device=dev)
    if order is None:
        order = torch.randperm(k, generator=generator, device=dev)
    perm = torch.as_tensor(perm, device=dev).to(torch.int32)
    order = torch.as_tensor(order, device=dev).to(torch.int32)
    return order, perm.reshape(k, num_points // k)
