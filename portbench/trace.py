"""The traced window of a ``--trace 1`` run: ``torch.profiler`` (CPU and CUDA)
over whole calls at the start of the measured window, and the reduction of
its raw events to what the per-layer readers take.

``Tracer.begin_call`` starts the profiler at the first call of the window;
``end_call`` counts the call and, once ``seconds`` have passed, waits for the
device and stops it. The window is the host's time from the first call's
start to that stop. Device busy time is the union of the device's kernel,
copy and set intervals inside it (the busy arithmetic of the port's
``profile_port.py``, frozen here).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

SPAN_PREFIX = "portbench:"  # the benchmark's own host spans


class Trace:
    """Raw device and host events of a finished profile, in seconds from the
    start of the traced window."""

    def __init__(self, device: List[Tuple[str, float, float]],
                 host: List[Tuple[str, float, float]], window_s: float, calls: int):
        self.device, self.host, self.window_s, self.calls = device, host, window_s, calls

    def kernels(self, *patterns: str) -> List[Tuple[str, float, float]]:
        return [e for e in self.device if any(p in e[0] for p in patterns)]

    def busy_s(self) -> float:
        return union_s((max(s, 0.0), min(e, self.window_s)) for _, s, e in self.device
                       if e > 0.0 and s < self.window_s)

    def gaps(self) -> List[Tuple[float, float]]:
        """Intervals of the window in which the device ran nothing."""
        out, end = [], 0.0
        for s, e in sorted((s, e) for _, s, e in self.device):
            if s > end:
                out.append((end, min(s, self.window_s)))
            end = max(end, e)
        if end < self.window_s:
            out.append((end, self.window_s))
        return [(s, e) for s, e in out if e > s]

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the longest idle
        gaps named by the innermost host event spanning each gap's middle."""
        by_name: Dict[str, float] = {}
        for name, s, e in self.device:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        named = []
        for s, e in gaps:
            mid = 0.5 * (s + e)
            inside = [h for h in self.host if h[1] <= mid <= h[2]]
            label = min(inside, key=lambda h: h[2] - h[1])[0] if inside else "no host event"
            named.append([label[:120], e - s])
        return {"device_ops": [[n[:120], v] for n, v in ops], "idle_gaps": named}


def union_s(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


class Tracer:
    """Profiles whole calls from the window's first for ``seconds`` (off when
    ``seconds`` is None). ``trace`` holds the result once stopped."""

    def __init__(self, seconds: Optional[float], device):
        self.seconds, self.dev = seconds, torch.device(device)
        self.prof = None
        self.t0 = self.t1 = None
        self.calls = 0
        self.trace: Optional[Trace] = None

    @property
    def active(self) -> bool:
        return self.prof is not None and self.t1 is None

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm_up(self) -> None:
        """One empty profile: the first start sets up the device's tracing."""
        if self.seconds is None:
            return
        with self._profile():
            torch.zeros(1, device=self.dev).add_(1)
            if self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)

    def begin_call(self) -> None:
        if self.seconds is None or self.prof is not None:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.prof = self._profile()
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def end_call(self) -> None:
        if not self.active:
            return
        self.calls += 1
        if time.perf_counter() - self.t0 >= self.seconds:
            self.stop()

    def stop(self) -> None:
        if not self.active:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.trace = self._reduce()

    def _reduce(self) -> Trace:
        events = self.prof.profiler.kineto_results.events()
        window = self.t1 - self.t0
        base = None
        for e in events:  # the window starts with the first call's host span
            if e.device_type() == torch.autograd.DeviceType.CPU and \
                    e.name().startswith(SPAN_PREFIX + "call"):
                base = e.start_ns() if base is None else min(base, e.start_ns())
        if base is None:
            base = min(e.start_ns() for e in events)
        dev, host = [], []
        for e in events:
            s = (e.start_ns() - base) * 1e-9
            rec = (e.name(), s, s + e.duration_ns() * 1e-9)
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not e.is_user_annotation() and not e.name().startswith(SPAN_PREFIX):
                    dev.append(rec)
            else:
                host.append(rec)
        return Trace(dev, host, window, self.calls)


def span(name: str):
    """A host span of the benchmark's own, seen in the trace."""
    return torch.profiler.record_function(SPAN_PREFIX + name)
