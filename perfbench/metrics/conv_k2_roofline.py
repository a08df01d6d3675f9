"""Share of its roofline that ``conv_k2``'s forward, dx and dw reach in the traced window (``flops.py``: bound time over the device time of everything the ops launched)."""

from perfbench import readers


def read(ctx):
    return readers.conv_k2_roofline(ctx)
