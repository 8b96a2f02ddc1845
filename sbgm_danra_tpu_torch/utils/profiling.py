"""Tracing and throughput instrumentation (counterpart of
``sbgm_danra_tpu/utils/profiling.py``):

- ``trace(log_dir, device)``: ``torch.profiler`` over the block,
  CPU activity and, on a CUDA device, the card's kernels and copies (CUPTI),
  written as one Chrome trace (``trace_<pid>_<ns>.json``, readable in
  Perfetto or ``chrome://tracing``) under ``log_dir``; a no-op when
  ``log_dir`` is falsy. JAX's ``jax.profiler`` writes a TensorBoard profile
  directory instead;
- ``StepTimer``: rolling per-step wall time, steps/s and items/s (a copy);
- ``loader_probe``: seconds per batch over a loader's first batches (a copy).

A CUDA graph replayed inside the block shows as its kernels on the device
timeline under one ``cudaGraphLaunch`` on the host.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import deque
from typing import Optional

import torch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(log_dir: Optional[str], device=None):
    """``torch.profiler`` over the block, its Chrome trace written under
    ``log_dir``; no-op when ``log_dir`` is falsy. Yields the trace's path
    (None when off)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


class StepTimer:
    """Rolling window of step durations -> steps/sec and items/sec."""

    def __init__(self, window: int = 50):
        self.durations: deque = deque(maxlen=window)
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        """Call once per step; returns the last step's duration (or None)."""
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self.durations.append(dt)
        self._last = now
        return dt

    def reset(self) -> None:
        self._last = None

    @property
    def steps_per_sec(self) -> float:
        if not self.durations:
            return 0.0
        return len(self.durations) / sum(self.durations)

    def items_per_sec(self, items_per_step: int) -> float:
        return self.steps_per_sec * items_per_step


def loader_probe(loader, n_batches: int = 100) -> float:
    """Average seconds/batch over the first n batches (reference :58-63)."""
    t0 = time.perf_counter()
    n = 0
    for _, _batch in zip(range(n_batches), iter(loader)):
        n += 1
    if n == 0:
        return float("nan")
    dt = (time.perf_counter() - t0) / n
    logger.info("loader probe: %.4f s/batch over %d batches", dt, n)
    return dt
