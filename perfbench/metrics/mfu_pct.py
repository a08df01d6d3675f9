"""The window's matmul and convolution operations, counted on the plain reference at the cell's shapes, over the window's seconds and the chip's peak at the compute dtype."""

from perfbench import readers


def read(ctx):
    return readers.mfu_pct(ctx)
