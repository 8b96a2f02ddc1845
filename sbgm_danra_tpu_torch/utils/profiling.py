"""Tracing and throughput instrumentation (counterpart of
``sbgm_danra_tpu/utils/profiling.py``):

- ``trace(log_dir, device)``: ``torch.profiler`` over the block, on every
  thread of the process, CPU activity and, on a CUDA device, the card's
  kernels and copies (CUPTI), written as one Chrome trace
  (``trace_<pid>_<ns>.json``, readable in Perfetto or ``chrome://tracing``)
  under ``log_dir``; a no-op when ``log_dir`` is falsy. JAX's
  ``jax.profiler`` writes a TensorBoard profile directory instead;
- ``span(name)``: a host range ``sbgm:<name>`` (``record_function``) in
  whatever ``torch.profiler`` is recording, on the clock of the card's
  kernel and copy events, so that each idle gap of the card can be put down
  to the span that was open; with no profiler on, one flag check;
- ``StepTimer``: rolling per-step wall time, steps/s and items/s (a copy).

A CUDA graph replayed inside the block shows as its kernels on the device
timeline under one ``cudaGraphLaunch`` on the host; no span is recorded
inside a captured graph.

How an operator sees the port's spans: training with
``training.profile_dir`` traces epoch 0 (``train.chunk`` and its ``draw``,
``replay`` and ``sync`` on the fused route); a serving engine, a
``sample_full_domain`` loop or any other caller is wrapped in
``with trace(dir, device):`` (``serve.*``, ``domain.*``, ``sample.*``).
``torch.profiler`` records only the thread that started it unless asked
for every thread, as ``trace`` asks: under a profiler of another's, the
spans of threads other than its own are not recorded (a serving engine's
``serve.queued`` lives on each caller's thread).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import deque
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

logger = logging.getLogger(__name__)

SPAN_PREFIX = "sbgm:"
_OFF = contextlib.nullcontext()


def recording() -> bool:
    """Whether a ``torch.profiler`` is on (in any thread of the process)."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """The host range ``sbgm:<name>`` while a profiler records; otherwise a
    shared no-op context (one flag check, no ``RecordFunction``)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return record_function(SPAN_PREFIX + name)


@contextlib.contextmanager
def trace(log_dir: Optional[str], device=None):
    """``torch.profiler`` over the block, its Chrome trace written under
    ``log_dir``; no-op when ``log_dir`` is falsy. Yields the trace's path
    (None when off)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    every_thread = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=activities, experimental_config=every_thread) as prof:
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
