"""Point-cloud geometry ops (port of ``nova_pointcloud_tpu/ops/pointops.py``):
distances, kNN, local density, the dynamic partition, farthest point
sampling, the feature-aware interpolation and adaptive resampling, and the
Morton (z-order) codes and sort.

The random draws (a start index, a permutation) come from a
``torch.Generator`` or are given, as the tests give JAX's."""

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


def _draw_device(generator: Optional[torch.Generator], points: torch.Tensor):
    return generator.device if generator is not None else points.device


def farthest_point_sampling(points: torch.Tensor, num_samples: int,
                            generator: Optional[torch.Generator] = None,
                            start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Iterative farthest point sampling: (B, N, D) -> (B, S, D). One running
    min-distance vector; each step takes the first point of largest
    distance. ``start`` (B,) gives the first index of each cloud, else it is
    drawn uniformly from ``generator``."""
    batch, n, _ = points.shape
    if start is None:
        start = torch.randint(0, n, (batch,), generator=generator,
                              device=_draw_device(generator, points))
    rows = torch.arange(batch, device=points.device)
    start = torch.as_tensor(start, device=points.device).long()

    def dist_to(idx):
        d = points - points[rows, idx][:, None, :]
        return torch.sqrt(torch.sum(d * d, dim=-1))

    sel = [start]
    min_d = dist_to(start)
    for _ in range(1, num_samples):
        far = torch.argmax(min_d, dim=1)  # the first maximum, as jnp.argmax
        sel.append(far)
        min_d = torch.minimum(min_d, dist_to(far))
    idx = torch.stack(sel, dim=1)
    return torch.gather(points, 1, idx[..., None].expand(-1, -1, points.shape[-1]))


def _tile_to(points: torch.Tensor, target_size: int) -> torch.Tensor:
    reps = target_size // points.shape[1] + 1
    return points.repeat(1, reps, 1)[:, :target_size]


def feature_aware_interpolation(points: torch.Tensor, target_size: int,
                                generator: Optional[torch.Generator] = None,
                                perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Downsample (B, N, D) to ``target_size`` points: the first
    ``target_size`` of a random permutation of the N points (``perm``, else
    drawn from ``generator``) are anchors, each replaced by the
    softmax(-distance) blend of all N points. A cloud of at most
    ``target_size`` points is tiled instead."""
    n = points.shape[1]
    if n <= target_size:
        return _tile_to(points, target_size)
    if perm is None:
        perm = torch.randperm(n, generator=generator, device=_draw_device(generator, points))
    idx = torch.as_tensor(perm, device=points.device).long()[:target_size]
    anchors = points[:, idx]
    w = torch.softmax(-cdist(anchors, points), dim=-1)  # (B, T, N)
    return torch.einsum("btn,bnd->btd", w, points)


def adaptive_sampling(subset: torch.Tensor, target_size: int,
                      generator: Optional[torch.Generator] = None,
                      perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Resize a subset (B, N, D) to ``target_size`` points: a sparse one is
    tiled, a dense one goes through :func:`feature_aware_interpolation`."""
    if subset.shape[1] < target_size:
        return _tile_to(subset, target_size)
    return feature_aware_interpolation(subset, target_size, generator, perm)


def morton_codes(points: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """Z-order codes (int64) of (..., N, 3) points in [-1, 1]: each axis
    quantized to ``bits`` bits (truncated, as the JAX op's uint32 cast), the
    bits interleaved x, y, z from the lowest."""
    q = torch.clamp((points + 1.0) * 0.5, 0.0, 1.0)
    q = (q * float((1 << bits) - 1)).to(torch.int64)

    def spread(v: torch.Tensor) -> torch.Tensor:
        out = torch.zeros_like(v)
        for i in range(bits):
            out = out | (((v >> i) & 1) << (3 * i))
        return out

    return spread(q[..., 0]) | (spread(q[..., 1]) << 1) | (spread(q[..., 2]) << 2)


def morton_sort(points: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """(..., N, 3) points reordered along N by Morton code, ties kept in
    their order (a stable sort, as ``jnp.argsort``): each run of consecutive
    points is then a spatially compact group."""
    order = torch.argsort(morton_codes(points, bits), dim=-1, stable=True)
    return torch.gather(points, -2, order[..., None].expand(order.shape + (points.shape[-1],)))
