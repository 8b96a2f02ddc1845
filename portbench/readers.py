"""The arithmetic the per-layer readers share (each metric's own file under
``portbench/metrics/`` names which of these it reads, and for what)."""

from __future__ import annotations

from typing import Optional

from portbench import work


def idle_share(run) -> Optional[float]:
    """Per cent of the traced window in which the device ran nothing."""
    t = run.trace
    if t is None or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)


def mfu(run, flops: float, seconds: float) -> Optional[float]:
    """Per cent of the bf16 peak that ``flops`` of model work in ``seconds`` is."""
    if seconds <= 0 or flops <= 0:
        return None
    return 100.0 * flops / seconds / work.PEAK_FLOPS[run.cfg["model"]["compute_dtype"]]


def traced_mfu(run) -> Optional[float]:
    """Model operations of the traced stretch's UNet evaluations over its length
    (the profiler's stop, which gathers its events, lies outside it)."""
    c = run.counts
    if run.trace is None:
        return None
    flops = c["traced_evals"] * c["rows_per_eval"] * work.unet_flops(run.cfg, *c["hw"])
    return mfu(run, flops, run.trace.window_s)


def roofline(run, patterns, least_per_eval: float) -> Optional[float]:
    """Per cent: the least time of the traced evaluations' calls of a kernel
    over the device time of the trace's kernels whose names hold ``patterns``."""
    t = run.trace
    if t is None:
        return None
    kernels = t.kernels(*patterns)
    measured = sum(e - s for _, s, e in kernels)
    if not kernels or measured <= 0 or run.counts["traced_evals"] <= 0:
        return None
    return 100.0 * run.counts["traced_evals"] * least_per_eval / measured


def k1_roofline(run) -> Optional[float]:
    c = run.counts
    return roofline(run, ("conv3x3_stats", "gn_apply"),
                    work.k1_least_s(run.cfg, *c["hw"], c["rows_per_eval"]))


def k2_roofline(run) -> Optional[float]:
    c = run.counts
    return roofline(run, ("flash_attention_fwd",),
                    work.k2_least_s(run.cfg, *c["hw"], c["rows_per_eval"]))
