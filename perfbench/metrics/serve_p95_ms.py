"""95th percentile of all the window's request latencies, from ``submit`` to the future's result, host clock."""

from perfbench import readers


def read(ctx):
    return readers.percentile(ctx, "serve.latency", 95.0)
