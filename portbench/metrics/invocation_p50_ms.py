"""Median (nearest rank) of every attempted invocation's latency, due time
to last token (closed loop: sent to last token)."""

from portbench import readers


def read(ctx):
    return readers.percentile(readers.latencies_ms(ctx), 50)
