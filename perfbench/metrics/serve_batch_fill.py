"""Requests a served batch carries: the window's completed requests over the batches the micro-batcher ran (its ``batches_run`` counter)."""

from perfbench import readers


def read(ctx):
    return readers.ratio(ctx, "requests", "work")
