"""Exponential moving average of the parameters (port of
``nova_pointcloud_tpu/engine/ema.py``): a float32 shadow copy, blended in
every ``update_every`` steps with ``decay``."""

from typing import Dict, NamedTuple

import torch


class EMAState(NamedTuple):
    params: Dict[str, torch.Tensor]
    decay: float
    update_every: int


@torch.no_grad()
def ema_init(params: Dict[str, torch.Tensor], decay: float = 0.99,
             update_every: int = 100) -> EMAState:
    """A float32 copy of ``params`` (name -> tensor)."""
    shadow = {k: p.detach().to(torch.float32, copy=True) for k, p in params.items()}
    return EMAState(shadow, decay, update_every)


@torch.no_grad()
def ema_update(state: EMAState, params: Dict[str, torch.Tensor], step: int) -> EMAState:
    """``e = e * decay + p * (1 - decay)`` in place when ``step`` is a
    multiple of ``update_every``."""
    if step % state.update_every == 0:
        dec = torch.tensor(state.decay, dtype=torch.float32)
        one_minus = float(1.0 - dec)  # as the JAX update: 1 - decay in float32
        for k, e in state.params.items():
            e.mul_(float(dec)).add_(params[k].detach().float() * one_minus)
    return state
