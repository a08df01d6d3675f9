"""Milliseconds of host clock a train batch takes to make (``cli.train.build_batch_fn``: the loader's rows, the native packer), on the prefetch thread, mean over the window's batches."""

from perfbench import readers


def read(ctx):
    return readers.mean(ctx, "train.batch_host")
