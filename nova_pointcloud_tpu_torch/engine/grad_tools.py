"""Gradient hygiene (port of ``nova_pointcloud_tpu/engine/grad_tools.py``):
non-finite repair, per-group norms, per-layer clipping and an adaptive lr
multiplier after gradient spikes.

The JAX tools act on the leaves of the JAX parameter tree. Its block stacks
are ``nn.scan``s, so each block parameter is ONE leaf stacked over depth,
where the port holds one tensor a layer. Every tool here therefore groups
the port's gradients by their JAX path (``paths``: port name -> JAX path,
``models/convert.jax_param_paths``): a group is one JAX leaf, its norm the
norm of all its tensors together, and the path is what the name rules
match. Without ``paths`` each tensor is its own group.

``per_layer_clip`` and ``adaptive_lr_on_spike`` are gradient transforms
for ``engine/optim.AdamW(transforms=...)``: each ``update(grads, paths)``
scales the step's gradients in place, in the chain's order, before Adam.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import torch


def jax_leaf_groups(grads: Dict[str, torch.Tensor], paths: Optional[Dict[str, str]] = None
                    ) -> Dict[str, List[torch.Tensor]]:
    """JAX path -> the gradients of its port tensors (in the port's order)."""
    groups: Dict[str, List[torch.Tensor]] = {}
    for name, g in grads.items():
        groups.setdefault(paths.get(name, name) if paths else name, []).append(g)
    return groups


def _sq(gs: Sequence[torch.Tensor]) -> torch.Tensor:
    return sum(torch.sum(torch.square(g.float())) for g in gs)


def sanitize_grads(grads: Dict[str, torch.Tensor], paths: Optional[Dict[str, str]] = None
                   ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Non-finite entries set to 0; returns (grads, the number of JAX leaves
    that held one, int32)."""
    bad = sum(torch.stack([~torch.isfinite(g).all() for g in gs]).any().to(torch.int32)
              for gs in jax_leaf_groups(grads, paths).values())
    fixed = {n: torch.where(torch.isfinite(g), g, torch.zeros_like(g)) for n, g in grads.items()}
    return fixed, bad


def grad_stats(grads: Dict[str, torch.Tensor], groups: Optional[Sequence[str]] = None,
               paths: Optional[Dict[str, str]] = None) -> Dict[str, torch.Tensor]:
    """``grad_norm`` (the global norm) and ``grad_norm/{name}`` for each
    name of ``groups`` that occurs in some JAX path (the norm of those
    leaves)."""
    by_path = jax_leaf_groups(grads, paths)
    out = {"grad_norm": torch.sqrt(_sq(list(grads.values())))}
    for g_name in groups or ():
        sq = [_sq(gs) for p, gs in by_path.items() if g_name in p]
        if sq:
            out[f"grad_norm/{g_name}"] = torch.sqrt(sum(sq))
    return out


class PerLayerClip:
    """Clip each JAX leaf's norm to ``max_norm * scale``, the scale of the
    last ``group_scales`` key found in its path (1 if none)."""

    def __init__(self, max_norm: float, group_scales: Optional[Dict[str, float]] = None):
        self.max_norm, self.group_scales = max_norm, dict(group_scales or {})

    def limit(self, path: str) -> float:
        limit = self.max_norm
        for prefix, s in self.group_scales.items():
            if prefix in path:
                limit = self.max_norm * s
        return limit

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], paths: Optional[Dict[str, str]] = None
               ) -> None:
        for path, gs in jax_leaf_groups(grads, paths).items():
            n = torch.sqrt(_sq(gs))
            scale = torch.clamp(self.limit(path) / (n + 1e-6), max=1.0)
            for g in gs:
                g.mul_(scale.to(g.dtype))

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state: dict) -> None:
        pass


def per_layer_clip(max_norm: float, group_scales: Optional[Dict[str, float]] = None
                   ) -> PerLayerClip:
    return PerLayerClip(max_norm, group_scales)


class AdaptiveLR:
    """After a step whose global gradient norm exceeds ``explode_norm`` the
    multiplier is multiplied by ``decay``, else by ``recover`` up to 1; it
    stays at least ``floor`` and scales the gradients (float32, on the
    gradients' device; the checkpointed state)."""

    def __init__(self, explode_norm: float = 50.0, decay: float = 0.5, recover: float = 1.01,
                 floor: float = 0.01):
        self.explode_norm, self.decay, self.recover, self.floor = (
            explode_norm, decay, recover, floor)
        self.multiplier: Optional[torch.Tensor] = None

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], paths: Optional[Dict[str, str]] = None
               ) -> None:
        gs = list(grads.values())
        if self.multiplier is None:
            self.multiplier = torch.ones((), dtype=torch.float32, device=gs[0].device)
        total = torch.sqrt(_sq(gs))
        m = self.multiplier
        m = torch.where(total > self.explode_norm, m * self.decay,
                        torch.clamp(m * self.recover, max=1.0))
        self.multiplier = torch.clamp(m, min=self.floor)
        for g in gs:
            g.mul_(self.multiplier.to(g.dtype))

    def state_dict(self) -> dict:
        return {"multiplier": self.multiplier}

    def load_state_dict(self, state: dict) -> None:
        m = state["multiplier"]
        self.multiplier = None if m is None else m.clone()


def adaptive_lr_on_spike(explode_norm: float = 50.0, decay: float = 0.5,
                         recover: float = 1.01, floor: float = 0.01) -> AdaptiveLR:
    return AdaptiveLR(explode_norm, decay, recover, floor)
