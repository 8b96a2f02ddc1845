"""Host time of a serving dispatch: the mean over the traced dispatches of
the port's ``sbgm:serve.dispatch`` less its ``sbgm:sample.replay`` and
``sbgm:serve.sync`` (what is left: packing, generators, the conditioning's
copies, the sampler's inputs, the copy out and the split), in ms."""

from portbench.spans import host_ms


def read(run):
    return host_ms(run, "serve.dispatch", "sample.replay", "serve.sync")
