"""Host time of a CorrDiff call: the mean over the traced calls of the port's
``sbgm:corrdiff.call`` less its ``sbgm:sample.replay`` and
``sbgm:corrdiff.sync`` (what is left: the regression's eager launches, the
conditioning's repeat, the noise draw and copies in, the sum and the copy
out), in ms."""

from portbench.spans import host_ms


def read(run):
    return host_ms(run, "corrdiff.call", "sample.replay", "corrdiff.sync")
