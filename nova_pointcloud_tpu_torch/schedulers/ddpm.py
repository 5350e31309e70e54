"""DDPM scheduler on torch tensors over precomputed host tables.

Port of ``nova_pointcloud_tpu/schedulers/ddpm.py``: five beta schedules,
zero-terminal-SNR rescale, all six variance types (the learned pair splits a
2C-channel model output on the last axis), epsilon/sample/v prediction,
leading/linspace/trailing spacing, and the training side: ``sample_timesteps``,
``add_noise``, ``get_velocity`` and ``predict_x0``. NOVA's training loss reads
``add_noise``'s x_t alone (a flow-matching scheduler gives a pair): its
target is the noise and the model's timestep the integer one drawn.

The tables are built in host numpy exactly as the JAX scheduler builds them;
every tensor op below runs in float32 as the JAX one does. ``set_timesteps``
returns an immutable :class:`DDPMSchedule`; ``step`` takes the timestep
explicitly. Random noise comes from a ``torch.Generator`` or is given as
``noise`` (the tests feed the same noise to both frameworks).
"""

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch


def betas_for_alpha_bar(num_steps: int, max_beta: float = 0.999,
                        transform: str = "cosine") -> np.ndarray:
    """Discretize a continuous alpha-bar function into betas (Glide cosine)."""
    if transform == "cosine":
        alpha_bar = lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2  # noqa: E731
    elif transform == "exp":
        alpha_bar = lambda t: math.exp(t * -12.0)  # noqa: E731
    else:
        raise ValueError(f"Unsupported alpha transform: {transform}")
    t = np.arange(num_steps, dtype=np.float64)
    betas = 1.0 - np.array([alpha_bar((i + 1) / num_steps) / alpha_bar(i / num_steps)
                            for i in t])
    return np.minimum(betas, max_beta).astype(np.float32)


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Rescale betas so the terminal SNR is exactly zero (arXiv 2305.08891)."""
    alphas_bar_sqrt = np.sqrt(np.cumprod(1.0 - betas))
    a0, aT = alphas_bar_sqrt[0], alphas_bar_sqrt[-1]
    alphas_bar_sqrt = (alphas_bar_sqrt - aT) * (a0 / (a0 - aT))
    alphas_bar = alphas_bar_sqrt**2
    alphas = np.concatenate([alphas_bar[:1], alphas_bar[1:] / alphas_bar[:-1]])
    return (1.0 - alphas).astype(np.float32)


def make_betas(schedule: str, num_steps: int, beta_start: float, beta_end: float,
               trained_betas=None) -> np.ndarray:
    if trained_betas is not None:
        return np.asarray(trained_betas, dtype=np.float32)
    if schedule == "linear":
        return np.linspace(beta_start, beta_end, num_steps, dtype=np.float32)
    if schedule == "scaled_linear":
        return np.linspace(beta_start**0.5, beta_end**0.5, num_steps,
                           dtype=np.float32) ** 2
    if schedule == "squaredcos_cap_v2":
        return betas_for_alpha_bar(num_steps)
    if schedule == "sigmoid":
        x = np.linspace(-6, 6, num_steps)
        return (1 / (1 + np.exp(-x)) * (beta_end - beta_start) + beta_start).astype(np.float32)
    raise NotImplementedError(f"beta schedule {schedule!r}")


@dataclasses.dataclass(frozen=True)
class DDPMSchedule:
    """Immutable inference schedule."""

    timesteps: np.ndarray  # (S,) int64, descending
    num_inference_steps: int


def _as_index(t, device) -> torch.Tensor:
    return torch.as_tensor(t, device=device).long()


@dataclasses.dataclass(frozen=True)
class DDPMScheduler:
    """Denoising diffusion probabilistic models, functional style."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.0001
    beta_end: float = 0.02
    beta_schedule: str = "linear"
    variance_type: str = "fixed_small"
    clip_sample: bool = True
    clip_sample_range: float = 1.0
    prediction_type: str = "epsilon"
    timestep_spacing: str = "leading"
    steps_offset: int = 0
    rescale_betas_zero_snr: bool = False
    trained_betas: Optional[Sequence[float]] = None

    init_noise_sigma: float = dataclasses.field(default=1.0, init=False)

    def __post_init__(self):
        betas = make_betas(self.beta_schedule, self.num_train_timesteps,
                           self.beta_start, self.beta_end, self.trained_betas)
        if self.rescale_betas_zero_snr:
            betas = rescale_zero_terminal_snr(betas)
        object.__setattr__(self, "betas", betas)
        object.__setattr__(self, "alphas_cumprod",
                           np.cumprod(1.0 - betas).astype(np.float32))

    def _gather(self, t, ndim: int, device) -> torch.Tensor:
        table = torch.as_tensor(self.alphas_cumprod, device=device)
        v = table[_as_index(t, device)]
        return v.reshape(v.shape + (1,) * (ndim - v.ndim))

    # -- training ---------------------------------------------------------
    def sample_timesteps(self, generator: Optional[torch.Generator], shape,
                         device=None) -> torch.Tensor:
        """Uniform integer timesteps in [0, num_train_timesteps) (int64),
        drawn from ``generator`` on its device unless ``device`` is given."""
        dev = device if device is not None else (
            generator.device if generator is not None else None)
        return torch.randint(0, self.num_train_timesteps, tuple(shape),
                             generator=generator, device=dev)

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t) -> torch.Tensor:
        """q(x_t | x_0): sqrt(a_bar)·x0 + sqrt(1-a_bar)·noise."""
        a = self._gather(t, x0.ndim, x0.device)
        return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise

    def get_velocity(self, x0: torch.Tensor, noise: torch.Tensor, t) -> torch.Tensor:
        a = self._gather(t, x0.ndim, x0.device)
        return torch.sqrt(a) * noise - torch.sqrt(1.0 - a) * x0

    # -- inference --------------------------------------------------------
    def set_timesteps(self, num_inference_steps: int) -> DDPMSchedule:
        """Discrete reverse-process timesteps (Table 2, arXiv 2305.08891)."""
        T, S = self.num_train_timesteps, num_inference_steps
        if self.timestep_spacing == "linspace":
            ts = np.linspace(0, T - 1, S).round()[::-1].astype(np.int64)
        elif self.timestep_spacing == "leading":
            ts = (np.arange(S) * (T // S)).round()[::-1].astype(np.int64) + self.steps_offset
        elif self.timestep_spacing == "trailing":
            ts = np.arange(T, 0, -(T / S)).round().astype(np.int64) - 1
        else:
            raise ValueError(f"{self.timestep_spacing} is not supported.")
        return DDPMSchedule(timesteps=ts, num_inference_steps=S)

    def predict_x0(self, model_output: torch.Tensor, t,
                   sample: torch.Tensor) -> torch.Tensor:
        a_t = self._gather(t, sample.ndim, sample.device)
        b_t = 1.0 - a_t
        if self.prediction_type == "epsilon":
            x0 = (sample - torch.sqrt(b_t) * model_output) / torch.sqrt(a_t)
        elif self.prediction_type == "sample":
            x0 = model_output
        elif self.prediction_type == "v_prediction":
            x0 = torch.sqrt(a_t) * sample - torch.sqrt(b_t) * model_output
        else:
            raise ValueError(f"Unsupported prediction type {self.prediction_type}.")
        if self.clip_sample:
            x0 = torch.clamp(x0, -self.clip_sample_range, self.clip_sample_range)
        return x0

    def step(
        self,
        model_output: torch.Tensor,
        t,
        sample: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        schedule: Optional[DDPMSchedule] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """One reverse step x_t -> x_{t-1} (formula 7, arXiv 2006.11239).

        The stochastic term uses ``noise`` when given, else a draw from
        ``generator``; with neither the step has zero variance.

        For ``variance_type`` in ("learned", "learned_range") the model
        output carries 2C channels on the LAST axis: the first half is the
        prediction, the second the variance head.
        """
        predicted_variance = None
        if self.variance_type in ("learned", "learned_range"):
            if model_output.shape[-1] == sample.shape[-1] * 2:
                model_output, predicted_variance = torch.chunk(
                    model_output, 2, dim=-1)

        dev = sample.device
        S = schedule.num_inference_steps if schedule else self.num_train_timesteps
        stride = self.num_train_timesteps // S
        t_idx = _as_index(t, dev)
        prev_t = t_idx - stride

        table = torch.as_tensor(self.alphas_cumprod, device=dev)
        a_t = self._gather(t_idx, sample.ndim, dev)
        a_prev = torch.where(prev_t >= 0, table[torch.clamp(prev_t, min=0)],
                             torch.ones((), device=dev))
        a_prev = a_prev.reshape(a_t.shape)
        b_t, b_prev = 1.0 - a_t, 1.0 - a_prev
        cur_alpha = a_t / a_prev
        cur_beta = 1.0 - cur_alpha

        x0 = self.predict_x0(model_output, t_idx, sample)
        x0_coeff = torch.sqrt(a_prev) * cur_beta / b_t
        xt_coeff = torch.sqrt(cur_alpha) * b_prev / b_t
        prev_sample = x0_coeff * x0 + xt_coeff * sample

        # formula (6)/(7) posterior variance, log-clamped like the reference
        variance = torch.clamp(b_prev / b_t * cur_beta, min=1e-20)
        if self.variance_type == "fixed_small":
            std = torch.sqrt(variance)
        elif self.variance_type == "fixed_small_log":
            std = torch.exp(0.5 * torch.log(variance))
        elif self.variance_type == "fixed_large":
            std = torch.sqrt(cur_beta)
        elif self.variance_type == "fixed_large_log":
            # Glide max_log: std = exp(0.5 * log beta_t) == sqrt(beta_t)
            std = torch.exp(0.5 * torch.log(torch.clamp(cur_beta, min=1e-20)))
        elif self.variance_type == "learned":
            if predicted_variance is None:
                raise ValueError("variance_type 'learned' needs a 2C-channel "
                                 "model output (prediction | variance).")
            std = torch.sqrt(torch.clamp(predicted_variance, min=1e-20))
        elif self.variance_type == "learned_range":
            # improved-DDPM (arXiv 2102.09672 eq. 15): interpolate between
            # the posterior (min) and beta_t (max) LOG variances
            if predicted_variance is None:
                raise ValueError("variance_type 'learned_range' needs a "
                                 "2C-channel model output.")
            frac = (predicted_variance + 1.0) / 2.0
            min_log = torch.log(variance)
            max_log = torch.log(torch.clamp(cur_beta, min=1e-20))
            std = torch.exp(0.5 * (frac * max_log + (1.0 - frac) * min_log))
        else:
            raise NotImplementedError(f"variance_type {self.variance_type!r}")
        if noise is None:
            noise = (torch.randn(sample.shape, generator=generator,
                                 device=dev, dtype=sample.dtype)
                     if generator is not None else torch.zeros_like(sample))
        add = torch.where(t_idx.reshape(t_idx.shape + (1,) * (std.ndim - t_idx.ndim)) > 0,
                          std, torch.zeros((), device=dev))
        return prev_sample + add * noise
