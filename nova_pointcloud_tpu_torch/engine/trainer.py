"""Training engine (port of ``nova_pointcloud_tpu/engine/trainer.py``), on
one device: the step (forward, backward, optimizer, metrics), the loop with
the EMA cadence, the smoothed-metric / progress logging, and checkpoint
save / resume-latest (``engine/checkpoint.py``).

A checkpoint holds the parameters, the optimizer's state (Adam's moments
and step, the schedule's count, the gradient transforms' state such as the
adaptive lr multiplier, the accumulated gradients and mini-step), the EMA,
the step and the generator's state, so a resumed trainer's next step is
bitwise the uninterrupted one's. With gradient accumulation the step counts
calls, as in the JAX trainer (the EMA updates on each), and the optimizer's
schedule counts its own steps. The JAX
trainer's mesh (DP / TP / ZeRO shardings), optimizer-state offload and
ZeRO-3 are not ported yet and raise (``parallel/`` is queued in ROADMAP.md).
"""

from typing import Any, Callable, Dict, Iterator, Optional

import torch
from torch import nn

from nova_pointcloud_tpu_torch.engine.checkpoint import CheckpointManager
from nova_pointcloud_tpu_torch.engine.ema import ema_init, ema_update
from nova_pointcloud_tpu_torch.utils.logging import SmoothedValue, Timer, get_logger, get_progress


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md, module queue, "
                               f"parallelism")


class Trainer:
    """Single-device trainer over ``(loss_fn, model, optimizer, data)``.

    ``loss_fn(batch, generator, **kw) -> (loss, metrics)`` computes on
    ``model``'s parameters; ``optimizer`` is ``engine/optim.AdamW`` over
    them. ``seed`` seeds the trainer's ``torch.Generator`` on the model's
    device, which every random draw of a step comes from. With
    ``output_dir`` it saves a checkpoint every ``save_every`` steps and
    starts from the latest one there. ``lr_schedule`` is what
    the log shows (the optimizer's own schedule when None)."""

    def __init__(self, loss_fn: Callable, model: nn.Module, optimizer, mesh=None,
                 output_dir: Optional[str] = None, lr_schedule: Optional[Callable] = None,
                 max_steps: int = 10000, log_every: int = 20, save_every: int = 1000,
                 ema_decay: Optional[float] = 0.99, ema_every: int = 100, seed: int = 0,
                 offload_opt_state: bool = False, zero3: bool = False):
        if mesh is not None:
            raise _unported("a sharded train step (mesh=)")
        if offload_opt_state:
            raise _unported("optimizer-state offload (offload_opt_state=True)")
        if zero3:
            raise _unported("ZeRO-3 parameter sharding (zero3=True)")
        self.loss_fn, self.model, self.optimizer = loss_fn, model, optimizer
        self.max_steps, self.log_every, self.save_every = max_steps, log_every, save_every
        self.lr_schedule = lr_schedule
        self.logger = get_logger("trainer")
        dev = next(model.parameters()).device
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self.step = 0
        self.ema = (ema_init(dict(model.named_parameters()), ema_decay, ema_every)
                    if ema_decay else None)
        self.ckpt = CheckpointManager(output_dir) if output_dir else None
        if self.ckpt is not None and self._try_resume():
            self.logger.info("Resumed from checkpoint-%d", self.step)

    def state_dict(self) -> Dict[str, Any]:
        """What a checkpoint holds (tensors on the model's device)."""
        state = {"params": {n: p.detach() for n, p in self.model.named_parameters()},
                 "optimizer": self.optimizer.state_dict(), "step": self.step,
                 "generator": self.generator.get_state()}
        if self.ema is not None:
            state["ema"] = self.ema.params
        return state

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        params = dict(self.model.named_parameters())
        for n, v in state["params"].items():
            params[n].copy_(v)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        self.generator.set_state(state["generator"].cpu())
        if self.ema is not None and "ema" in state:
            for n, e in self.ema.params.items():
                e.copy_(state["ema"][n])

    def _try_resume(self) -> bool:
        out = self.ckpt.restore(map_location=self.generator.device)
        if out is None:
            return False
        self.load_state_dict(out["state"])
        return True

    def save(self) -> None:
        if self.ckpt is None:
            return
        self.ckpt.save(self.step, self.state_dict())
        self.logger.info("Saved checkpoint-%d", self.step)

    def save_best(self, metric: Optional[float] = None) -> None:
        """The quality-selected slot (parameters and EMA only, not for
        resume), exempt from pruning; the metric is the caller's."""
        if self.ckpt is None:
            return
        state = {"params": {n: p.detach() for n, p in self.model.named_parameters()}}
        if self.ema is not None:
            state["ema"] = self.ema.params
        self.ckpt.save_best(self.step, state, metric)
        self.logger.info("Saved checkpoint-best @ step %d (metric=%s)", self.step, metric)

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
                lr = (float(self.lr_schedule(self.step)) if self.lr_schedule
                      else self.optimizer.lr(self.optimizer.count))
                self.logger.info("Iteration %d, time: %.3fs, lr: %.2e, %s", self.step,
                                 timer.average_time, lr, msg)
            if self.step % (10 * self.log_every) == 0:
                self.logger.info(get_progress(timer, self.step, max_steps))
            if self.save_every and self.step % self.save_every == 0:
                self.save()
        return last
