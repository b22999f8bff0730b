"""The training trace schedule and the device-memory reading (counterpart
of ``semi_seg_ecg_tpu/utils/profiling.py``).

- :class:`ProfileSchedule` drives ``torch.profiler`` over a configured
  window of global steps, ``config['profile'] = {'trace_dir': ...,
  'start_step': 10, 'num_steps': 5}``: host activity, and the card's
  kernels and copies when the run is on one. The training loop builds one
  schedule per epoch and closes it at the epoch's end, as the JAX package
  does, so a window that reaches past the end stops there. Each step in
  the window is a host range ``ProfilerStep#{global step}``; the trace is
  written, in the Chrome trace format that TensorBoard's profiler and
  Perfetto read, to ``trace_dir/rank{rank}_steps{first}-{last}.pt.trace.json``.
  Without ``trace_dir`` the schedule does nothing;
- :func:`device_memory_mb`: the card's peak allocated memory (the
  reference's ``torch.cuda.max_memory_allocated`` meter), None on the CPU.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch


class ProfileSchedule:
    """Start and stop a ``torch.profiler`` trace around a configured
    window of global steps; :meth:`step` is called before each step."""

    def __init__(self, profile_cfg: Optional[Dict[str, Any]],
                 device: torch.device, rank: int = 0):
        cfg = profile_cfg or {}
        self.trace_dir = cfg.get("trace_dir")
        self.start_step = int(cfg.get("start_step", 10))
        self.num_steps = int(cfg.get("num_steps", 5))
        self.device = device
        self.rank = rank
        self.path = None  # the trace file, once written
        self._profiler = None
        self._range = None
        self._last = None
        self._done = False

    def step(self, global_step: int) -> None:
        if self.trace_dir is None or self._done:
            return
        if self._profiler is None and global_step == self.start_step:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()
        elif self._profiler is not None and \
                global_step >= self.start_step + self.num_steps:
            self.close()
            return
        if self._profiler is not None:
            self._end_range()
            self._range = torch.profiler.record_function(
                f"ProfilerStep#{global_step}")
            self._range.__enter__()
            self._last = global_step

    def _end_range(self) -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None

    def close(self) -> None:
        """Stop the trace, if one runs, and write it."""
        if self._profiler is None:
            return
        self._end_range()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        os.makedirs(self.trace_dir, exist_ok=True)
        self.path = os.path.join(
            self.trace_dir, f"rank{self.rank}_steps{self.start_step}-"
                            f"{self._last}.pt.trace.json")
        self._profiler.export_chrome_trace(self.path)
        self._profiler = None
        self._done = True


def device_memory_mb(device: torch.device) -> Optional[float]:
    """Peak bytes allocated on ``device``, in MiB; None off the card."""
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 20
