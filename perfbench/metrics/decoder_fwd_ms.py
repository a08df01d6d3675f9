"""Device milliseconds of the decoder's forward in a train step, CUDA events at its forward hooks, mean over the window."""

from perfbench import readers


def read(ctx):
    return readers.mean(ctx, "train.decoder_fwd")
