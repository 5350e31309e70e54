"""Scheduler construction from declarative configs (port of
``nova_pointcloud_tpu/schedulers/builder.py``).

A scheduler config may carry ``_noise_class_name`` / ``_sample_class_name``
selecting different scheduler classes for training noise and inference
sampling. Only ``DDPMScheduler`` is ported; the flow-matching scheduler (the
default when a config names none) raises until its slice (ROADMAP.md).
"""

import inspect
from typing import Dict

from nova_pointcloud_tpu_torch.schedulers.ddpm import DDPMScheduler

_CLASSES = {"DDPMScheduler": DDPMScheduler}
_UNPORTED = ("FlowMatchEulerScheduler", "FlowMatchEulerDiscreteScheduler")


def build_scheduler(config: Dict, phase: str = "sample"):
    """Build a scheduler. ``phase`` is "noise" (training) or "sample"."""
    config = dict(config or {})
    name = config.pop(f"_{phase}_class_name", None) or config.pop("class_name", None) \
        or config.pop("_class_name", "FlowMatchEulerScheduler")
    config = {k: v for k, v in config.items() if not k.startswith("_")}
    if name in _UNPORTED:
        raise NotImplementedError(
            f"scheduler {name!r} is not ported yet: ROADMAP.md, module queue, "
            f"NOVA t2i serving (schedulers/flow_match.py)")
    cls = _CLASSES.get(name)
    if cls is None:
        raise KeyError(f"Unknown scheduler class {name!r}. Known: "
                       f"{sorted(_CLASSES) + sorted(_UNPORTED)}")
    accepted = set(inspect.signature(cls).parameters)
    return cls(**{k: v for k, v in config.items() if k in accepted})
