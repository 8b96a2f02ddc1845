"""Host time of a full-domain field: the mean over the traced calls of the
port's ``sbgm:domain.field`` less its ``sbgm:sample.replay`` and
``sbgm:domain.sync`` (what is left: padding, the noise draw, the crop and
the copy out), in ms."""

from portbench.spans import host_ms


def read(run):
    return host_ms(run, "domain.field", "sample.replay", "domain.sync")
