"""Uniform logging set-up and the training meter (``ppyolo_tpu/utils/logger.py``;
reference format string, train.py:30-33)."""
from __future__ import annotations

import logging
from collections import deque

FORMAT = "%(asctime)s-%(levelname)s: %(message)s"
DATEFMT = "%Y-%m-%d %H:%M:%S"


def setup_logger(name: str = "ppyolo_tpu_torch", level=logging.INFO) -> logging.Logger:
    logging.basicConfig(level=level, format=FORMAT, datefmt=DATEFMT)
    return logging.getLogger(name)


class TrainMeter:
    """Rolling per-iteration time and ETA (reference train.py:359-361,407-413)."""

    def __init__(self, window: int = 20):
        self.times = deque(maxlen=window)

    def update(self, dt: float) -> None:
        self.times.append(dt)

    @property
    def avg(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    def imgs_per_sec(self, batch_size: int) -> float:
        return batch_size / max(self.avg, 1e-9)

    def eta_hours(self, iters_left: int) -> float:
        return iters_left * self.avg / 3600.0
