"""Training losses (port of ``nova_pointcloud_tpu/ops/losses.py``): the
token-wise masked diffusion MSE of NOVA training. The point-cloud losses
(chamfer, Sinkhorn EMD, ...) come with t2pc training (ROADMAP.md)."""

import torch


def masked_diffusion_mse(model_pred: torch.Tensor, target: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Per-token MSE over the channels, weighted by ``mask`` (1 = a predicted
    token) and normalised by its sum (+1e-5); float32."""
    loss = torch.square(model_pred.float() - target.float())
    loss = torch.mean(loss, dim=-1, keepdim=True)
    weight = mask.to(loss.dtype)
    return torch.sum(loss * weight) / (torch.sum(weight) + 1e-5)
