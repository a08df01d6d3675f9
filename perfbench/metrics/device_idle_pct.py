"""Share of the measured window in which no kernel, copy or memset ran on the device: the traced stretch's busy time a step or batch (the union of their intervals), scaled to the window's work (``readers.idle_pct``)."""

from perfbench import readers


def read(ctx):
    return readers.idle_pct(ctx)
