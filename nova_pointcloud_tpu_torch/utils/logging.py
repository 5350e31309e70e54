"""Logging, smoothed metrics and wall-clock timers (the port's copy of
``nova_pointcloud_tpu/utils/logging.py``: ``SmoothedValue``, ``Timer``,
``get_progress``, ``get_logger``). Host-side only."""

import collections
import contextlib
import datetime
import logging
import sys
import time


class SmoothedValue:
    """A series of values with a sliding window and a global mean."""

    def __init__(self, window_size: int = 20):
        self.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float):
        self.deque.append(float(value))
        self.count += 1
        self.total += float(value)

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def average(self) -> float:
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_average(self) -> float:
        return self.total / max(self.count, 1)


class Timer:
    """Accumulating tic / toc timer with a context-manager helper."""

    def __init__(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0
        self.average_time = 0.0

    def tic(self):
        self.start_time = time.monotonic()
        return self

    def toc(self, average: bool = True):
        self.diff = time.monotonic() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        self.average_time = self.total_time / self.calls
        return self.average_time if average else self.diff

    @contextlib.contextmanager
    def tic_and_toc(self):
        try:
            yield self.tic()
        finally:
            self.toc()


def get_progress(timer: Timer, step: int, max_steps: int) -> str:
    """A PROGRESS / SPEED / ETA status string."""
    eta_seconds = timer.average_time * (max_steps - step)
    eta = str(datetime.timedelta(seconds=int(eta_seconds)))
    progress = (step + 1.0) / max_steps
    return "< PROGRESS: {:.2%} | SPEED: {:.3f}s / iter | ETA: {} >".format(
        progress, timer.average_time, eta)


def get_logger(name: str = "nova_torch") -> logging.Logger:
    """A logger writing to standard output (one process; no log file)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        logger.setLevel(logging.INFO)
        logger.propagate = False
        stream = logging.StreamHandler(sys.stdout)
        stream.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(name)s] %(message)s",
                                              "%H:%M:%S"))
        logger.addHandler(stream)
    return logger
