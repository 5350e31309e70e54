"""Flow-matching (rectified flow) Euler scheduler (port of
``nova_pointcloud_tpu/schedulers/flow_match.py``).

Shifted sigmas ``shift*s/(1+(shift-1)*s)``. Inference: a linspace over the
shifted train table's timesteps re-shifted, a trailing 0, and the Euler step
``x += pred * (sigma[i+1] - sigma[i])``; the schedule is host numpy, as in the
JAX package, and the step runs on the sample's device. Training:
logit-normal timesteps ``int(sigmoid(N(0, 1)) * T)`` drawn from an explicit
``torch.Generator`` (the JAX package draws them from a key; the two streams
never match), the per-timestep sigma table, ``add_noise`` returning
``(x_t, model_t)`` and the regression ``target``; ``scale_noise``, the
inference-side forward noising of a sample.
"""

import dataclasses
import math
from typing import Optional, Sequence, Tuple

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

    # -- training ---------------------------------------------------------
    def sample_timesteps(self, generator: Optional[torch.Generator], shape: Sequence[int],
                         device=None) -> torch.Tensor:
        """Logit-normal timesteps: ``int32(sigmoid(N(0, 1)) * T)``."""
        dist = torch.sigmoid(torch.randn(tuple(shape), generator=generator, device=device))
        return (dist * self.num_train_timesteps).to(torch.int32)

    def train_sigmas(self) -> np.ndarray:
        """Per-train-timestep sigma table, descending in t."""
        s = np.arange(1, self.num_train_timesteps + 1, dtype=np.float32)[::-1]
        s = s / self.num_train_timesteps
        if not self.use_dynamic_shifting:
            s = _apply_shift(s, self.shift)
        return s.astype(np.float32)

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Forward process: ``(sigma * noise + (1 - sigma) * x0, sigma * T)``
        with ``sigma = train_sigmas()[t]``; the model is conditioned on the
        second value."""
        table = torch.from_numpy(self.train_sigmas()).to(x0.device)
        sigma = table[t.long()]
        model_t = sigma * self.num_train_timesteps
        sigma = sigma.reshape(tuple(sigma.shape) + (1,) * (x0.ndim - sigma.ndim)).to(x0.dtype)
        return sigma * noise + (1.0 - sigma) * x0, model_t

    def target(self, x0: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """The flow-matching regression target."""
        return noise - x0

    # -- inference --------------------------------------------------------
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

    def scale_noise(self, sample: torch.Tensor, step_index: int, noise: torch.Tensor,
                    schedule: FlowMatchSchedule) -> torch.Tensor:
        """Inference-side forward noising: ``sigma * noise + (1 - sigma) *
        sample`` with the schedule's ``sigma`` at ``step_index`` in the
        sample's dtype."""
        sigma = torch.tensor(schedule.sigmas[step_index], device=sample.device).to(sample.dtype)
        return sigma * noise + (1.0 - sigma) * sample
