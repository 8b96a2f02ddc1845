"""K1 against its roofline in CorrDiff: the least time of the traced calls'
``conv0 -> + emb -> GroupNorm -> SiLU`` chains (every block of both nets;
``portbench/work_corrdiff.k1_least_s_per_call``) over the device time of
K1's kernels, ``conv3x3_stats*`` and ``gn_apply*``."""

from portbench import work_corrdiff


def read(run):
    c, t = run.counts, run.trace
    if t is None:
        return None
    measured = sum(e - s for _, s, e in t.kernels("conv3x3_stats", "gn_apply"))
    if measured <= 0 or c["traced_calls"] <= 0:
        return None
    least = work_corrdiff.k1_least_s_per_call(run.cfg, *c["hw"], c["dates"], c["members"])
    return 100.0 * c["traced_calls"] * least / measured
