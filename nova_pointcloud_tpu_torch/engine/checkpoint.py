"""Checkpoint save / resume-latest (port of
``nova_pointcloud_tpu/engine/checkpoint.py``), with ``torch.save`` state
dicts in place of Orbax trees and the same directory layout:

- ``{output_dir}/checkpoints/checkpoint-{step}/state.pt``, the periodic
  saves, the oldest pruned beyond ``max_to_keep``;
- ``checkpoints/checkpoint-best/state.pt`` and ``checkpoints/best.json``
  (``{"step", "metric"}``), the quality-selected slot, exempt from pruning.
"""

import json
import os
import re
import shutil
from typing import Any, Dict, Optional

import torch

STATE_FILE = "state.pt"


class CheckpointManager:
    """Directory naming and pruning of the JAX manager over ``torch.save``."""

    def __init__(self, output_dir: str, max_to_keep: int = 3):
        self.root = os.path.join(os.path.abspath(output_dir), "checkpoints")
        os.makedirs(self.root, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> str:
        return os.path.join(self.root, f"checkpoint-{step}")

    def _steps(self):
        names = os.listdir(self.root) if os.path.isdir(self.root) else []
        return sorted(int(m.group(1)) for m in (re.fullmatch(r"checkpoint-(\d+)", n)
                                                for n in names) if m)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    @staticmethod
    def _write(path: str, state: Dict[str, Any]) -> None:
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, STATE_FILE + ".tmp")
        torch.save(state, tmp)
        os.replace(tmp, os.path.join(path, STATE_FILE))

    @staticmethod
    def _read(path: str, map_location=None) -> Dict[str, Any]:
        return torch.load(os.path.join(path, STATE_FILE), map_location=map_location,
                          weights_only=False)

    def save(self, step: int, state: Dict[str, Any]) -> None:
        self._write(self._path(step), state)
        self._cleanup()

    def save_best(self, step: int, state: Dict[str, Any],
                  metric: Optional[float] = None) -> None:
        """The quality-selected slot, exempt from pruning; ``best.json``
        records which step and score won."""
        self._write(os.path.join(self.root, "checkpoint-best"), state)
        with open(os.path.join(self.root, "best.json"), "w") as f:
            json.dump({"step": step, "metric": metric}, f)

    def restore_best(self, map_location=None) -> Optional[Dict]:
        """``{"step", "metric", "state"}`` of the best slot, or None."""
        path = os.path.join(self.root, "checkpoint-best")
        if not os.path.isfile(os.path.join(path, STATE_FILE)):
            return None
        meta = {"step": -1, "metric": None}
        meta_path = os.path.join(self.root, "best.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        return {"step": meta["step"], "metric": meta.get("metric"),
                "state": self._read(path, map_location)}

    def restore(self, step: Optional[int] = None, map_location=None) -> Optional[Dict]:
        """``{"step", "state"}`` of ``step`` (the latest when None), or None."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return {"step": step, "state": self._read(self._path(step), map_location)}

    def _cleanup(self) -> None:
        for s in self._steps()[: -self.max_to_keep]:
            shutil.rmtree(self._path(s), ignore_errors=True)
