"""Classifier-free guidance as batch-dim algebra (port of
``nova_pointcloud_tpu/models/guidance.py``).

2-pass CFG with an optional 3rd pass (image or spatiotemporal guidance), a
linear guidance decay over AR progress, truncation below a timestep, and
renorm clamping. Batch layout: ``[cond | uncond | extra]``.
"""

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class GuidanceConfig:
    guidance_scale: float = 1.0
    guidance_trunc: float = 0.0
    guidance_renorm: float = 1.0
    image_guidance_scale: float = 0.0
    spatiotemporal_guidance_scale: float = 0.0
    min_guidance_scale: Optional[float] = None

    @property
    def enabled(self) -> bool:
        return self.guidance_scale > 1.0

    @property
    def extra_pass(self) -> bool:
        return (self.image_guidance_scale + self.spatiotemporal_guidance_scale) > 0

    @property
    def num_passes(self) -> int:
        return 1 if not self.enabled else (3 if self.extra_pass else 2)

    def decayed_scale(self, decay: float) -> float:
        """Linear decay over AR progress; a falsy ``min_guidance_scale``
        (None or 0) means no decay."""
        lo = self.min_guidance_scale or self.guidance_scale
        return (self.guidance_scale - lo) * decay + lo

    # -- batch expansion ----------------------------------------------------
    def expand(self, x: torch.Tensor, padding: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Tile inputs across the guidance passes along the batch;
        ``padding`` replaces the middle pass for image guidance."""
        if not self.enabled:
            return x
        parts = [x] * self.num_passes
        if self.image_guidance_scale and padding is not None:
            parts[1] = torch.broadcast_to(padding.to(x.dtype), x.shape)
        return torch.cat(parts, dim=0)

    def expand_text(self, c_cond: torch.Tensor, c_null: torch.Tensor) -> torch.Tensor:
        """Per-pass text embeddings."""
        if not self.enabled:
            return c_cond
        parts = [c_cond, c_null]
        if self.image_guidance_scale:
            parts.append(c_null)  # Null, Null
        elif self.spatiotemporal_guidance_scale:
            parts.append(c_cond)  # Null, Text
        return torch.cat(parts, dim=0)

    # -- combination ---------------------------------------------------------
    def _renorm(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        if self.guidance_renorm >= 1.0:
            return x
        nx = torch.linalg.norm(x.reshape(x.shape[0], -1), dim=-1)
        nc = torch.linalg.norm(cond.reshape(cond.shape[0], -1), dim=-1)
        clamp = torch.clamp(nc / (nx + 1e-12), self.guidance_renorm, 1.0)
        return x * clamp.reshape((-1,) + (1,) * (x.ndim - 1))

    def combine(self, x: torch.Tensor, scale: Optional[float] = None,
                timestep: Optional[float] = None) -> torch.Tensor:
        """Collapse the guidance passes back to the cond batch; below
        ``guidance_trunc`` the output is the pure conditional prediction."""
        if not self.enabled:
            return x
        scale = torch.tensor(self.guidance_scale if scale is None else scale,
                             dtype=torch.float32, device=x.device).to(x.dtype)
        chunks = torch.chunk(x, self.num_passes, dim=0)
        if self.image_guidance_scale:
            cond, uncond, imgcond = chunks
            out = self._renorm(uncond + (cond - imgcond) * scale, cond)
            out = out + (imgcond - uncond) * self.image_guidance_scale
        elif self.spatiotemporal_guidance_scale:
            cond, uncond, perturb = chunks
            out = self._renorm(uncond + (cond - uncond) * scale, cond)
            out = out + (cond - perturb) * self.spatiotemporal_guidance_scale
        else:
            cond, uncond = chunks
            out = self._renorm(uncond + (cond - uncond) * scale, cond)
        if self.guidance_trunc and timestep is not None and timestep < self.guidance_trunc:
            out = chunks[0]
        return out
