"""Model operations of the traced stretch's train steps over its length, per
cent of the bf16 peak: three forwards a step (the forward and a backward of
twice its work), recomputation not counted."""

from portbench import work
from portbench.readers import mfu


def read(run):
    c = run.counts
    if run.trace is None:
        return None
    flops = 3 * c["traced_steps"] * c["rows_per_eval"] * work.unet_flops(run.cfg, *c["hw"])
    return mfu(run, flops, run.trace.window_s)
