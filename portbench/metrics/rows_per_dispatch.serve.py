"""Rows that belong to requests per dispatch over the traced dispatches, from
the engine's own counters (``n_rows``, ``n_dispatches``)."""


def read(run):
    c = run.counts
    return c["traced_rows"] / c["traced_dispatches"] if c["traced_dispatches"] else None
