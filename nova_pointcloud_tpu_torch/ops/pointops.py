"""Point-cloud geometry ops (port of ``pairwise_sqdist`` and ``cdist`` from
``nova_pointcloud_tpu/ops/pointops.py``; the kNN / FPS / partition ops are
still to port, see ROADMAP.md)."""

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
