"""Embedding helpers (port of the parts of
``nova_pointcloud_tpu/models/embeddings.py`` that the pc model uses)."""

import math

import torch


def timestep_freq_embed(timestep: torch.Tensor, freq_dim: int = 256) -> torch.Tensor:
    """Sinusoidal diffusion-timestep features: ``[cos(t·f), sin(t·f)]``."""
    half = freq_dim // 2
    log_theta = math.log(10000.0)
    freq = torch.exp(torch.arange(half, dtype=torch.float32,
                                  device=timestep.device) * (-log_theta / half))
    emb = timestep[..., None].float() * freq
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)
