"""Host time of a fused training chunk: the mean over the traced chunks of
the port's ``sbgm:train.chunk`` less its ``sbgm:train.replay`` and
``sbgm:train.sync`` (what is left: the loader's and the DSM draws), in ms."""

from portbench.spans import host_ms


def read(run):
    return host_ms(run, "train.chunk", "train.replay", "train.sync")
