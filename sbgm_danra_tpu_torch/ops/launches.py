"""Launch counts of the port's hand-written kernels, in this process.

Every kernel wrapper calls ``count(name, ...)`` once per launch, under the
kernel's report name: ``conv3x3_stats`` (and ``conv3x3_stats_sample_bias``
for those launches that take a per-sample bias), ``gn_apply``,
``group_norm_stats``, ``group_norm`` (the standalone GroupNorm's normalise),
``flash_attention_fwd_<variant>`` and ``flash_attention_bwd_<variant>``
(``<variant>`` ``tc_bf16`` or ``fp32``; a backward call is its three kernels)
and ``upsample2x``.

A call made while its stream is being captured into a CUDA graph launches
nothing: it adds to ``recorded`` instead. ``capture.Graph`` keeps what its
capture recorded, and each replay adds that to ``counts`` (``add_replay``),
so ``counts`` stays the number of kernel launches on the card.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict

import torch

counts = collections.Counter()  # launches on the card, by report name
recorded = collections.Counter()  # launches recorded into CUDA graphs, by report name
_lock = threading.Lock()  # a serving engine launches from its own thread


def count(*names: str) -> None:
    """One launch of each kernel in ``names`` on the current stream, or its
    record while the stream is being captured."""
    target = recorded if torch.cuda.is_current_stream_capturing() else counts
    with _lock:
        target.update(names)


def add_replay(per_replay: Dict[str, int]) -> None:
    """One replay of a graph that holds ``per_replay`` launches of each kernel."""
    with _lock:
        counts.update(per_replay)


def reset() -> None:
    """Zero every launch count (``recorded`` is left to the captures)."""
    with _lock:
        counts.clear()


def snapshot() -> collections.Counter:
    """A copy of the launch counts; a name not in it has 0."""
    with _lock:
        return collections.Counter(counts)


def since(before: collections.Counter) -> collections.Counter:
    """The launches made since ``before`` (a ``snapshot()``), by name."""
    with _lock:
        return counts - before
