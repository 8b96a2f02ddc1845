"""Model operations of the traced CorrDiff calls (the regression once a
date, 34 residual evaluations a member; ``portbench/work_corrdiff.py``) over
the traced stretch, per cent of the bf16 peak."""

from portbench import readers, work_corrdiff


def read(run):
    c = run.counts
    if run.trace is None:
        return None
    flops = c["traced_calls"] * work_corrdiff.call_flops(run.cfg, *c["hw"], c["dates"],
                                                         c["members"])
    return readers.mfu(run, flops, run.trace.window_s)
