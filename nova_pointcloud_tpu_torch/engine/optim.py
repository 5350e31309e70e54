"""Optimizer construction (port of ``nova_pointcloud_tpu/engine/optim.py``):
AdamW with the JAX optax chain's semantics.

The chain, per step, over the trainable parameters: clip the gradients by
their global norm (optional), Adam's moments with bias correction and ``eps``
outside the square root (``scale_by_adam``), decoupled weight decay
``+ wd * p`` on the parameters ``decay`` selects, per-parameter lr scales,
and ``- lr(step)`` from the schedule (the first update reads step 0). The
port runs it as ``torch.optim.AdamW`` with param groups. A parameter without
a gradient is updated as one with a zero gradient, as the JAX tree always
has one. Frozen parameters (``trainable`` False) get no update, no decay and
no moments, and do not count in the global norm (optax ``multi_transform``
with ``set_to_zero``).

Gradient accumulation (``accum_steps`` k > 1) is ``optax.MultiSteps``
around that chain: each call adds its gradients into a running mean, ``acc
+ (g - acc) / (n + 1)`` at mini-step n, and only every k-th call runs the
chain (clip, transforms, Adam, decay, the schedule) on that mean and
resets it; the parameters do not move on the other calls, and the
schedule counts the chain's steps.

Gradient transforms (``engine/grad_tools``: the per-layer clip, the
adaptive lr multiplier) run after the global-norm clip and before Adam, in
the order given, as an optax chain placed in front of ``adamw``; they group
the gradients by JAX path (``paths``).

The masks follow each parameter's JAX path and JAX rank
(``models/convert.jax_param_paths``), not the port's module names: the JAX
package decays every leaf of rank >= 2 whose path has no "norm", which takes
in the biases of its scanned block stacks (a leading depth axis) and skips
every LayerNorm.
"""

from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from nova_pointcloud_tpu_torch.models.convert import jax_param_paths


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """Port parameter name -> whether it receives weight decay: JAX rank
    >= 2 and no "norm" in its JAX path."""
    return {name: ndim >= 2 and "norm" not in path.lower()
            for name, (path, ndim) in jax_param_paths(model).items()}


def lr_scale_mask(model: nn.Module, lr_scales: Dict[str, float]) -> Dict[str, float]:
    """Port parameter name -> lr scale from JAX path-prefix rules (the last
    matching rule wins)."""
    out = {}
    for name, (path, _) in jax_param_paths(model).items():
        s = 1.0
        for prefix, v in lr_scales.items():
            if path.startswith(prefix) or f"/{prefix}" in path:
                s = v
        out[name] = s
    return out


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


class AdamW:
    """The optax chain of :func:`build_optimizer` over a model's named
    parameters (float32 master weights, updated in place): the global-norm
    clip in front of ``torch.optim.AdamW`` (fused), one param group per
    (decay, lr scale) with its lr set from the schedule before each step.
    Its decay ``p * (1 - lr * wd)`` before the Adam update equals optax's
    ``- lr * (adam + wd * p)``, and a group's lr ``lr * scale`` scales both
    terms as optax's lr scale does. ``transforms`` scale the gradients
    after the clip (each ``update(grads, paths)``, in place); ``paths``
    maps a port name to its JAX path for them. ``accum_steps`` > 1 wraps
    the chain as ``optax.MultiSteps`` (module docstring)."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 learning_rate: Union[float, Callable], weight_decay: float = 0.0,
                 betas=(0.9, 0.99), eps: float = 1e-8, grad_clip: Optional[float] = None,
                 decay: Optional[Dict[str, bool]] = None,
                 lr_scale: Optional[Dict[str, float]] = None,
                 transforms: Sequence = (), paths: Optional[Dict[str, str]] = None,
                 accum_steps: int = 1):
        self.named = list(named_params)
        self.transforms, self.paths = list(transforms), paths
        self.learning_rate = learning_rate
        self.weight_decay, self.betas, self.eps, self.grad_clip = (
            weight_decay, tuple(betas), eps, grad_clip)
        self.decay = decay or {}
        self.lr_scale = lr_scale or {}
        self.count = 0  # Adam's step count (the schedule reads it before the increment)
        self.accum_steps, self.mini_step = accum_steps, 0
        self.set_trainable({})

    def set_trainable(self, trainable: Dict[str, bool]) -> None:
        """Freeze the parameters mapped to False; before the first step."""
        if self.count:
            raise RuntimeError("set_trainable after the first step")
        self.live_named = [(n, p) for n, p in self.named if trainable.get(n, True)]
        self.live = [p for _, p in self.live_named]
        groups: Dict[Tuple[float, float], list] = {}
        for n, p in self.named:
            if trainable.get(n, True):
                wd = self.weight_decay if self.decay.get(n, False) else 0.0
                groups.setdefault((wd, self.lr_scale.get(n, 1.0)), []).append(p)
        self.opt = torch.optim.AdamW(
            [dict(params=ps, weight_decay=wd, lr_scale=s) for (wd, s), ps in groups.items()],
            lr=0.0, betas=self.betas, eps=self.eps, fused=True)
        # the running mean of the mini-steps' gradients (accum_steps > 1)
        self.acc = ([torch.zeros_like(p) for p in self.live] if self.accum_steps > 1
                    else None)

    def zero_grad(self) -> None:
        for _, p in self.named:
            p.grad = None

    def lr(self, step: int) -> float:
        lr = self.learning_rate
        return float(lr(step)) if callable(lr) else float(lr)

    @torch.no_grad()
    def step(self) -> None:
        """One call: the chain's step, or with ``accum_steps`` k > 1 one
        mini-step (the chain's step on every k-th)."""
        for p in self.live:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.acc is not None:
            grads = [p.grad for p in self.live]
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, delta)
            if self.mini_step < self.accum_steps - 1:
                self.mini_step += 1
                return
            for p, a in zip(self.live, self.acc):
                p.grad.copy_(a)
            torch._foreach_zero_(self.acc)
            self.mini_step = 0
        if self.grad_clip:
            grads = [p.grad for p in self.live]
            norm = torch.nn.utils.get_total_norm(grads, foreach=True)
            torch._foreach_mul_(grads, torch.where(norm < self.grad_clip,
                                                   torch.ones_like(norm), self.grad_clip / norm))
        if self.transforms:
            grads = {n: p.grad for n, p in self.live_named}
            for t in self.transforms:
                t.update(grads, self.paths)
        lr = self.lr(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr * group["lr_scale"]
        self.opt.step()
        self.count += 1

    def state_dict(self) -> dict:
        """Adam's moments and step, the schedule's count, the transforms'
        states and, when accumulating, the mini-step and the running mean (a
        checkpoint's optimizer entry)."""
        state = {"count": self.count, "adam": self.opt.state_dict(),
                 "transforms": [t.state_dict() for t in self.transforms]}
        if self.acc is not None:
            state.update(mini_step=self.mini_step, acc=[a.clone() for a in self.acc])
        return state

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.opt.load_state_dict(state["adam"])
        for t, ts in zip(self.transforms, state["transforms"]):
            t.load_state_dict(ts)
        if self.acc is not None:
            self.mini_step = int(state["mini_step"])
            for a, v in zip(self.acc, state["acc"]):
                a.copy_(v)


def build_optimizer(model: nn.Module, learning_rate: Union[float, Callable],
                    weight_decay: float = 0.0, betas=(0.9, 0.99), eps: float = 1e-8,
                    grad_clip: Optional[float] = None,
                    lr_scales: Optional[Dict[str, float]] = None, accum_steps: int = 1,
                    decay: Optional[Dict[str, bool]] = None, transforms: Sequence = ()) -> AdamW:
    """AdamW with norm-exempt decay (``decay_mask`` unless ``decay`` is
    given), lr scaling, clipping, gradient ``transforms`` (grouped by
    ``model``'s JAX paths) and accumulation over ``accum_steps`` calls, over
    ``model``'s parameters."""
    paths = {n: p for n, (p, _) in jax_param_paths(model).items()}
    return AdamW(model.named_parameters(), learning_rate, weight_decay, betas, eps, grad_clip,
                 decay if decay is not None else decay_mask(model),
                 lr_scale_mask(model, lr_scales) if lr_scales else None, transforms, paths,
                 accum_steps)
