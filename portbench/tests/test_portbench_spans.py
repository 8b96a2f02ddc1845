"""The readers of the port's spans (``portbench/spans.py`` and the metrics
that use it) on synthetic traces, and on tiny traced runs of their cells on
the CPU, where the port records its spans as on the card."""

from types import SimpleNamespace

import pytest

from portbench import harness, spans
from portbench.tests.tiny import run_tiny
from portbench.trace import Trace

READERS = {  # metric -> (cell, call span, replay span, sync span)
    "dispatch_host_ms.serve": ("serve-128-poisson", "serve.dispatch", "sample.replay",
                               "serve.sync"),
    "field_host_ms.domain": ("domain-edm18", "domain.field", "sample.replay", "domain.sync"),
    "chunk_host_ms.train": ("train-128-fused", "train.chunk", "train.replay", "train.sync"),
}


def traced(host, window_s=1.0):
    return SimpleNamespace(trace=Trace([], host, window_s, calls=1))


def calls(call, replay, sync):
    """Two calls of 40 and 60 ms with replays of 5 and 15 ms and syncs of 30
    and 20 ms, a call with no sync (a loop's end), and calls cut by the
    window's ends."""
    return [
        ("portbench:call", 0.0, 0.5),
        (f"sbgm:{call}", 0.10, 0.14), (f"sbgm:{replay}", 0.105, 0.11),
        (f"sbgm:{sync}", 0.11, 0.14),
        (f"sbgm:{call}", 0.20, 0.26), (f"sbgm:{replay}", 0.22, 0.235),
        (f"sbgm:{sync}", 0.24, 0.26),
        (f"sbgm:{call}", 0.30, 0.3001),
        (f"sbgm:{call}", -0.05, 0.02), (f"sbgm:{sync}", 0.0, 0.02),
        (f"sbgm:{call}", 0.95, 1.05), (f"sbgm:{sync}", 0.96, 1.0),
        ("aten::copy_", 0.12, 0.13), (f"sbgm:{sync}x", 0.21, 0.23),
    ]


@pytest.mark.parametrize("metric", sorted(READERS))
def test_host_ms_is_each_call_less_its_replay_and_sync(metric):
    got = harness.reader(metric)(traced(calls(*READERS[metric][1:])))
    assert got == pytest.approx(1e3 * ((0.04 - 0.005 - 0.03) + (0.06 - 0.015 - 0.02)) / 2)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_nothing_to_read_reads_none(metric):
    """A program without the spans (the parent's), or no trace: no value."""
    read = harness.reader(metric)
    assert read(SimpleNamespace(trace=None)) is None
    assert read(traced([("portbench:call", 0.0, 0.5), ("aten::mm", 0.1, 0.2)])) is None


def test_spans_inside_the_window():
    run = traced(calls("serve.dispatch", "sample.replay", "serve.sync"))
    assert spans.spans(run, "serve.dispatch") == [(0.10, 0.14), (0.20, 0.26), (0.30, 0.3001)]
    assert spans.spans(run, "serve.sync") == [(0.0, 0.02), (0.11, 0.14), (0.24, 0.26),
                                              (0.96, 1.0)]
    assert spans.spans(run, "serve.queued") == []


def test_entries_list_their_one_cell():
    bench = harness.benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for metric, (cell, *_) in READERS.items():
        m = entries[metric]
        assert (m["source"], m["unit"], m["better"], m["workloads"]) == \
            ("program_span", "ms", "lower", [cell])
        assert metric in {x["name"] for x in harness.cell_metrics(cell, bench)[1]}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_traced_tiny_run_reads_the_ports_spans(metric):
    cell = READERS[metric][0]
    out = run_tiny(cell, trace=True)
    assert out["correct"]
    assert out["metrics"][metric]["value"] > 0
    assert out["metrics"][metric]["unit"] == "ms"
