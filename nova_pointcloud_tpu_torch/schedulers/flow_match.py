"""Flow-matching (rectified flow) Euler scheduler (port of
``nova_pointcloud_tpu/schedulers/flow_match.py``, inference side).

Shifted sigmas ``shift*s/(1+(shift-1)*s)``, a linspace over the shifted train
table's timesteps re-shifted, a trailing 0, and the Euler step
``x += pred * (sigma[i+1] - sigma[i])``. The schedule is host numpy, as in the
JAX package; the step runs on the sample's device. The training side
(timestep sampling, ``add_noise``) and ``scale_noise`` (i2v) wait for their
slices (ROADMAP.md).
"""

import dataclasses
import math
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FlowMatchSchedule:
    """Immutable Euler schedule. ``sigmas`` has S+1 entries ending in 0."""

    timesteps: np.ndarray  # (S,) float32
    sigmas: np.ndarray  # (S+1,) float32
    num_inference_steps: int


def _apply_shift(sigmas, shift: float):
    return shift * sigmas / (1 + (shift - 1) * sigmas)


@dataclasses.dataclass(frozen=True)
class FlowMatchEulerScheduler:
    """Rectified-flow Euler scheduler."""

    num_train_timesteps: int = 1000
    shift: float = 1.0
    use_dynamic_shifting: bool = False
    prediction_type: str = "flow"  # model target = noise - x0

    def set_timesteps(self, num_inference_steps: int, shift: Optional[float] = None,
                      mu: Optional[float] = None) -> FlowMatchSchedule:
        """linspace over t between the shifted train table's ends, then re-shift."""
        shift = self.shift if shift is None else shift
        if self.use_dynamic_shifting:
            sigma_max = 1.0
            sigma_min = 1.0 / self.num_train_timesteps
        else:
            sigma_max = float(_apply_shift(np.float32(1.0), shift))
            sigma_min = float(_apply_shift(np.float32(1.0 / self.num_train_timesteps), shift))
        t_max = sigma_max * self.num_train_timesteps
        t_min = sigma_min * self.num_train_timesteps
        ts = np.linspace(t_max, t_min, num_inference_steps, dtype=np.float32)
        sigmas = ts / self.num_train_timesteps
        if self.use_dynamic_shifting:
            if mu is None:
                raise ValueError("use_dynamic_shifting=True requires mu.")
            sigmas = math.exp(mu) / (math.exp(mu) + (1 / sigmas - 1) ** 1.0)
        else:
            sigmas = _apply_shift(sigmas, shift)
        sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
        timesteps = (sigmas[:-1] * self.num_train_timesteps).astype(np.float32)
        return FlowMatchSchedule(timesteps=timesteps, sigmas=sigmas,
                                 num_inference_steps=num_inference_steps)

    def step(self, model_output: torch.Tensor, step_index: int, sample: torch.Tensor,
             schedule: FlowMatchSchedule) -> torch.Tensor:
        """Euler step: x += pred * (sigma_{i+1} - sigma_i)."""
        s = schedule.sigmas
        dt = torch.tensor(s[step_index + 1] - s[step_index], device=sample.device)
        return sample + model_output * dt.to(sample.dtype)
