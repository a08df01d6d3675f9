"""Device milliseconds of a train step (``train/step.py``: forward, backward, finite check, Adam), CUDA events around the step the trainer calls, mean over the window's steps."""

from perfbench import readers


def read(ctx):
    return readers.mean(ctx, "train.step_device")
