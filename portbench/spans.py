"""The arithmetic of the readers of the port's own spans: the host ranges
``sbgm:<name>`` that ``sbgm_danra_tpu_torch/utils/profiling.span`` records
in the traced stretch (``run.trace.host``, on the clock of the device's
events).

A span counts when it lies wholly inside the traced window [0, window_s].
Host events carry no thread here, so a child is a span of its name inside
its parent's interval: the parents and children read below each run on one
thread (the dispatcher's, the caller's), one after another.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

PREFIX = "sbgm:"


def spans(run, name: str) -> List[Tuple[float, float]]:
    """(start, end) in seconds of every ``sbgm:<name>`` inside the window."""
    t = run.trace
    if t is None:
        return []
    full = PREFIX + name
    return sorted((s, e) for n, s, e in t.host if n == full and s >= 0.0 and e <= t.window_s)


def host_ms(run, call: str, replay: str, sync: str) -> Optional[float]:
    """Mean over the ``call`` spans that end in a ``sync`` child of the call's
    length less its ``replay`` and ``sync`` children, in ms: the host's own
    work in the call, outside the graph's launch (which blocks while the
    device runs what it has queued) and the wait for the device. None where
    none was recorded."""
    replays, syncs = spans(run, replay), spans(run, sync)
    per_call = []
    for s, e in spans(run, call):
        waits = [b - a for a, b in syncs if s <= a and b <= e]
        if waits:
            waits += [b - a for a, b in replays if s <= a and b <= e]
            per_call.append(e - s - sum(waits))
    return 1e3 * sum(per_call) / len(per_call) if per_call else None
