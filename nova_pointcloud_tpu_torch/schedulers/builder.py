"""Scheduler construction from declarative configs (port of
``nova_pointcloud_tpu/schedulers/builder.py``).

A scheduler config may carry ``_noise_class_name`` / ``_sample_class_name``
selecting different scheduler classes for training noise and inference
sampling; a config that names none gets the flow-matching scheduler.
"""

import inspect
from typing import Dict

from nova_pointcloud_tpu_torch.schedulers.ddpm import DDPMScheduler
from nova_pointcloud_tpu_torch.schedulers.flow_match import FlowMatchEulerScheduler

_CLASSES = {
    "DDPMScheduler": DDPMScheduler,
    "FlowMatchEulerScheduler": FlowMatchEulerScheduler,
    "FlowMatchEulerDiscreteScheduler": FlowMatchEulerScheduler,  # the reference's alias
}


def build_scheduler(config: Dict, phase: str = "sample"):
    """Build a scheduler. ``phase`` is "noise" (training) or "sample"."""
    config = dict(config or {})
    name = config.pop(f"_{phase}_class_name", None) or config.pop("class_name", None) \
        or config.pop("_class_name", "FlowMatchEulerScheduler")
    config = {k: v for k, v in config.items() if not k.startswith("_")}
    cls = _CLASSES.get(name)
    if cls is None:
        raise KeyError(f"Unknown scheduler class {name!r}. Known: {sorted(_CLASSES)}")
    accepted = set(inspect.signature(cls).parameters)
    return cls(**{k: v for k, v in config.items() if k in accepted})
