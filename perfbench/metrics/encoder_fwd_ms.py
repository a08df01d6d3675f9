"""Device milliseconds of the encoder's forward in a train step (the voxel encoder, or the image backbone and head), CUDA events at its forward hooks, mean over the window."""

from perfbench import readers


def read(ctx):
    return readers.mean(ctx, "train.encoder_fwd")
