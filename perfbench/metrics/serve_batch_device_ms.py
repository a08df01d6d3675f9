"""Device milliseconds of a served batch (``serving/export.py``'s packed-IO program), CUDA events around the call the micro-batcher makes, mean over the window."""

from perfbench import readers


def read(ctx):
    return readers.mean(ctx, "serve.batch_device")
