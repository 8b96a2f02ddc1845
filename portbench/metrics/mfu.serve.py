"""Model operations of the traced dispatches' rows that belong to requests
(filler rows left out; both CFG branches counted) over the summed wall time
of those dispatches, per cent of the bf16 peak."""

from portbench import work
from portbench.readers import mfu


def read(run):
    c = run.counts
    rows = c["traced_rows"] * work.cfg_rows(run.cfg["sampler"], 1)
    return mfu(run, rows * c["evals_per_dispatch"] * work.unet_flops(run.cfg, *c["hw"]),
               c["traced_dispatch_s"])
