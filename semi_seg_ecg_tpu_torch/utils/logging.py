"""Observability sinks: smoothed meters, epoch JSONL log, optional TensorBoard.

Capability parity with the reference's three sinks (src/utils/misc.py:14-177,
src/algorithms/base.py:160-172,408-432):

1. stdout — the trainer's progress line (iter/ETA/meters/step-time/
   data-wait) every ``PRINT_FREQ`` steps; timestamps on every line (the
   reference monkey-patches ``builtins.print``; we just format here).
2. TensorBoard — per-iter scalars on the ``epoch_1000x`` x-axis and per-epoch
   ``perf/*`` scalars. Optional: enabled when ``tensorboard`` is importable
   and an output dir exists.
3. ``log.txt`` — append-only, one JSON dict per epoch.

The parts of ``semi_seg_ecg_tpu/utils/logging.py`` the trainer uses, copied:
host-side Python only. The
trainer hands the meters plain floats, drained from the device at the print
cadence, so logging never waits on the card between drains.
"""

from __future__ import annotations

import datetime
import json
import os
from collections import defaultdict, deque
from typing import Dict, Optional


class SmoothedValue:
    """Track a series of values with a windowed median/avg and global stats.

    Mirrors misc.SmoothedValue (misc.py:14-73) minus the torch.distributed
    sync: the trainer all-reduces each step's metrics before they get
    here, so every rank's meters hold the global means.
    """

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        if not d:
            return 0.0
        m = len(d) // 2
        return d[m] if len(d) % 2 else 0.5 * (d[m - 1] + d[m])

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / self.count if self.count else 0.0

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(
            median=self.median,
            avg=self.avg,
            global_avg=self.global_avg,
            max=self.max,
            value=self.value,
        )


class MetricLogger:
    """Meter dict behind the progress line (misc.py:76-159 parity)."""

    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            if v is None:
                continue
            self.meters[k].update(float(v))

    def __str__(self) -> str:
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items()
        )

    def stats(self) -> Dict[str, float]:
        return {k: m.global_avg for k, m in self.meters.items()}


_ENABLED = True


def set_logging_enabled(enabled: bool) -> None:
    """Rank-0-only printing: the process group turns the other ranks'
    :func:`log` off (the reference's ``setup_for_distributed``)."""
    global _ENABLED
    _ENABLED = enabled


def log(*args, force: bool = False) -> None:
    if not (_ENABLED or force):
        return
    now = datetime.datetime.now().strftime("[%Y-%m-%d %H:%M:%S]")
    print(now, *args, flush=True)


class TensorBoardWriter:
    """Thin optional wrapper: a no-op where tensorboard is not installed."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter  # type: ignore

            self._writer = SummaryWriter(log_dir=log_dir)
        except Exception:
            self._writer = None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, value, step)

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()


class JsonlLogger:
    """Append-only per-epoch JSON log (base.py:417-432 parity)."""

    def __init__(self, output_dir: Optional[str], filename: str = "log.txt"):
        self.path = os.path.join(output_dir, filename) if output_dir else None

    def write(self, stats: Dict) -> None:
        if self.path is None:
            return
        with open(self.path, mode="a", encoding="utf-8") as f:
            f.write(json.dumps(stats) + "\n")
