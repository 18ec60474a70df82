"""Logging, progress, TensorBoard, meters.

The PyTorch port's own copy of the JAX package's ``logging_utils.py`` (same
names and behaviour). ``TBWriter`` writes nothing where tensorboardX is
not installed.

Parity with the reference's observability stack (SURVEY §2.7):
rich+file logger (reference train.py:64-75), TensorBoard scalars
(train.py:145,226-229), timm AverageMeters (train.py:96-97), and the
predict-side metrics.csv with a mean row (predict.py:186-201).
"""

from __future__ import annotations

import logging
import os
from typing import Optional


def get_logger(config) -> logging.Logger:
    """Rich console + per-run file logger (reference train.py:64-75)."""
    log = logging.getLogger(f"gmist.{config.job_name}.{id(config)}")
    log.setLevel(logging.DEBUG)
    log.handlers.clear()
    try:
        from rich.logging import RichHandler

        log.addHandler(RichHandler())
    except ImportError:  # headless minimal env
        log.addHandler(logging.StreamHandler())
    file_handler = logging.FileHandler(
        os.path.join(config.hydra_path, f"{config.job_name}.log")
    )
    log.addHandler(file_handler)
    log.propagate = False
    log.info("Successfully create rich logger")
    return log


class AverageMeter:
    """timm-style running meter (reference train.py:96-97 usage)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class TBWriter:
    """TensorBoard scalar writer rooted at the run dir (train.py:145)."""

    def __init__(self, logdir: str):
        try:
            from tensorboardX import SummaryWriter

            self._w = SummaryWriter(logdir)
        except ImportError:
            self._w = None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._w is not None:
            self._w.add_scalar(tag, float(value), step)

    def close(self) -> None:
        if self._w is not None:
            self._w.close()


def log_config(logger: logging.Logger, config) -> None:
    """Echo all resolved config keys at startup (train.py:378-381)."""
    for key, value in config.items():
        logger.info(f"{key}: {value}")


class ProgressBars:
    """rich.progress epoch+batch bars (reference train.py:100-106,164-165;
    predict.py:67-73). No-op on non-TTY stdout so batch logs stay clean."""

    def __init__(self, enabled: Optional[bool] = None):
        import sys

        if enabled is None:
            enabled = sys.stdout.isatty()
        self._progress = None
        if not enabled:
            return
        try:
            from rich.progress import Progress

            self._progress = Progress()
            self._progress.start()
        except ImportError:
            self._progress = None

    def add_task(self, description: str, total: int):
        if self._progress is None:
            return None
        return self._progress.add_task(description, total=total)

    def update(self, task, completed: int) -> None:
        if self._progress is not None and task is not None:
            self._progress.update(task, completed=completed)

    def reset(self, task, total: int) -> None:
        if self._progress is not None and task is not None:
            self._progress.reset(task, total=total)

    def stop(self) -> None:
        if self._progress is not None:
            self._progress.stop()

