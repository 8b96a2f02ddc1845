"""Torch port: the launch counts of the hand-written kernels (``ops/launches.py``).

A CUDA graph's capture records its kernels' launches under their report
names and each replay adds them to the counts; the capture is played here on
the CPU by making ``torch.cuda.is_current_stream_capturing`` say so. Each
wrapper's ``launches.count(...)`` calls are read from its source, so that the
names below are the ones the kernels are counted under.
"""

import ast
import collections
import inspect
import os
import sys
import threading

import pytest
import torch

from sbgm_danra_tpu_torch.ops import cuda_attention, launches
from sbgm_danra_tpu_torch.ops import fused_conv_gn as k1
from sbgm_danra_tpu_torch.ops import upsample as up

VARIANTS = tuple(cuda_attention.VARIANTS.values())
# kernel family: (its wrapper module, the names each of its launch calls counts,
# launches of each call in one graph)
FAMILIES = {
    "conv3x3_stats": (k1, [("conv3x3_stats",)], 8),
    "conv3x3_stats_sample_bias": (k1, [("conv3x3_stats", "conv3x3_stats_sample_bias")], 55),
    "gn_apply": (k1, [("gn_apply",)], 8),
    "group_norm": (k1, [("group_norm_stats",), ("group_norm",)], 62),
    **{f"flash_attention_{kind}_{v}": (cuda_attention, [(f"flash_attention_{kind}_{v}",)], 2)
       for kind in ("fwd", "bwd") for v in VARIANTS},
    "upsample2x": (up, [("upsample2x",)], 5),
}
REPORT_NAMES = {"conv3x3_stats", "conv3x3_stats_sample_bias", "gn_apply", "group_norm",
                "group_norm_stats", "upsample2x",
                *(f"flash_attention_{kind}_{v}" for kind in ("fwd", "bwd") for v in VARIANTS)}


def _counted_names(module) -> set:
    """Every name that a ``launches.count(...)`` call in ``module`` can count."""

    def names(node) -> set:
        if isinstance(node, ast.Constant):
            return {node.value}
        if isinstance(node, ast.JoinedStr):  # f"<prefix>{layout.variant}"
            return {node.values[0].value + v for v in VARIANTS}
        if isinstance(node, ast.IfExp):
            return names(node.body) | names(node.orelse)
        if isinstance(node, ast.Starred):
            return names(node.value)
        if isinstance(node, ast.Tuple):
            return set().union(*map(names, node.elts))
        raise AssertionError(f"unread launch name {ast.unparse(node)}")

    calls = [n for n in ast.walk(ast.parse(inspect.getsource(module)))
             if isinstance(n, ast.Call) and ast.unparse(n.func) == "launches.count"]
    assert calls, f"{module.__name__} counts no launch"
    return set().union(*(names(a) for c in calls for a in c.args))


@pytest.fixture
def capturing(monkeypatch):
    """Set ``capturing[0]`` to play a capture in progress on the current stream."""
    state = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: state[0])
    return state


@pytest.mark.parametrize("family", FAMILIES)
def test_a_replay_adds_its_launches_to_exactly_their_names(family, capturing):
    """The family's launches, made during a capture, are recorded and not
    counted; the graph's ``per_replay`` (what its capture recorded) is added
    by each replay to exactly those names."""
    module, calls, n = FAMILIES[family]
    assert {name for call in calls for name in call} <= _counted_names(module)
    counts, recorded = launches.snapshot(), launches.recorded.copy()
    capturing[0] = True
    for _ in range(n):
        for call in calls:
            launches.count(*call)
    capturing[0] = False
    per_replay = dict(launches.recorded - recorded)
    assert per_replay == {name: n for call in calls for name in call}
    assert not launches.since(counts)
    for _ in range(2):
        launches.add_replay(per_replay)
    assert launches.since(counts) == {name: 2 * k for name, k in per_replay.items()}


def test_every_report_name_is_counted_by_a_wrapper():
    assert set().union(*map(_counted_names, (k1, cuda_attention, up))) == REPORT_NAMES


def test_a_launch_outside_a_capture_counts_and_records_nothing(capturing):
    counts, recorded = launches.snapshot(), launches.recorded.copy()
    launches.count("conv3x3_stats", "conv3x3_stats_sample_bias")
    launches.count("upsample2x")
    assert launches.since(counts) == {"conv3x3_stats": 1, "conv3x3_stats_sample_bias": 1,
                                        "upsample2x": 1}
    assert launches.recorded == recorded


def test_reset_zeroes_every_name():
    launches.add_replay(collections.Counter(REPORT_NAMES))
    launches.reset()
    assert all(launches.counts[name] == 0 for name in REPORT_NAMES)
    assert launches.snapshot() == {}


def test_launches_from_many_threads_are_all_counted(capturing):
    """A serving engine's batcher thread launches and replays beside the
    caller's: no count is lost to two threads adding at once."""
    threads = 2 * (os.cpu_count() or 1)  # more threads than cores
    per_thread = 160000 // threads  # the same work whatever the core count

    def work():
        for _ in range(per_thread):
            launches.count("gn_apply")
            launches.add_replay({"conv3x3_stats": 8})

    before = launches.snapshot()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=work) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert launches.since(before) == {"gn_apply": threads * per_thread,
                                        "conv3x3_stats": 8 * threads * per_thread}
