"""Training engine (port of ``nova_pointcloud_tpu/engine/trainer.py``), on
one device: the step (forward, backward, optimizer, metrics), the loop with
the EMA cadence, and the smoothed-metric / progress logging.

The JAX trainer's mesh (DP / TP / ZeRO shardings), optimizer-state offload,
ZeRO-3 and checkpoint save / resume are not ported yet and raise
(``engine/checkpoint.py`` and ``parallel/`` are queued in ROADMAP.md).
"""

from typing import Any, Callable, Dict, Iterator, Optional

import torch
from torch import nn

from nova_pointcloud_tpu_torch.engine.ema import ema_init, ema_update
from nova_pointcloud_tpu_torch.utils.logging import SmoothedValue, Timer, get_logger, get_progress


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md, module queue, "
                               f"NOVA training")


class Trainer:
    """Single-device trainer over ``(loss_fn, model, optimizer, data)``.

    ``loss_fn(batch, generator, **kw) -> (loss, metrics)`` computes on
    ``model``'s parameters; ``optimizer`` is ``engine/optim.AdamW`` over
    them. ``seed`` seeds the trainer's ``torch.Generator`` on the model's
    device, which every random draw of a step comes from."""

    def __init__(self, loss_fn: Callable, model: nn.Module, optimizer, mesh=None,
                 output_dir: Optional[str] = None, max_steps: int = 10000, log_every: int = 20,
                 ema_decay: Optional[float] = 0.99, ema_every: int = 100, seed: int = 0,
                 offload_opt_state: bool = False, zero3: bool = False):
        if mesh is not None:
            raise _unported("a sharded train step (mesh=)")
        if offload_opt_state:
            raise _unported("optimizer-state offload (offload_opt_state=True)")
        if zero3:
            raise _unported("ZeRO-3 parameter sharding (zero3=True)")
        if output_dir is not None:
            raise _unported("checkpoint save / resume (output_dir=, engine/checkpoint.py)")
        self.loss_fn, self.model, self.optimizer = loss_fn, model, optimizer
        self.max_steps, self.log_every = max_steps, log_every
        self.logger = get_logger("trainer")
        dev = next(model.parameters()).device
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self.step = 0
        self.ema = (ema_init(dict(model.named_parameters()), ema_decay, ema_every)
                    if ema_decay else None)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def train_step(self, batch: Dict[str, Any], **loss_kw) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch``; ``loss_kw`` go to the loss (the
        tests give it the JAX side's random draws). Returns the step's
        metrics (detached, on the device)."""
        self.optimizer.zero_grad()
        loss, metrics = self.loss_fn(batch, self.generator, **loss_kw)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        if self.ema is not None:
            self.ema = ema_update(self.ema, self.params, self.step)
        return {k: v.detach() for k, v in dict(metrics, loss=loss).items()}

    def train(self, data: Iterator[Dict[str, Any]],
              max_steps: Optional[int] = None) -> Dict[str, float]:
        """Steps until ``max_steps``; every ``log_every`` steps the metrics
        are read, smoothed and logged, and the last read is returned."""
        max_steps = max_steps or self.max_steps
        meters: Dict[str, SmoothedValue] = {}
        timer = Timer()
        last: Dict[str, float] = {}
        while self.step < max_steps:
            batch = next(data)
            # host-only fields (caption strings) never reach the step
            batch = {k: v for k, v in batch.items() if not isinstance(v, (str, list))}
            with timer.tic_and_toc():
                metrics = self.train_step(batch)
            if self.step % self.log_every == 0:
                last = {k: float(v) for k, v in metrics.items()}
                for k, v in last.items():
                    meters.setdefault(k, SmoothedValue()).update(v)
                msg = ", ".join(f"{k}: {m.median:.4f} ({m.global_average:.4f})"
                                for k, m in meters.items())
                self.logger.info("Iteration %d, time: %.3fs, lr: %.2e, %s", self.step,
                                 timer.average_time, self.optimizer.lr(self.step), msg)
            if self.step % (10 * self.log_every) == 0:
                self.logger.info(get_progress(timer, self.step, max_steps))
        return last
