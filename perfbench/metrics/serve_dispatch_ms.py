"""Host milliseconds the micro-batcher's dispatcher spends a batch between a group and its hand-off: ``batcher.assemble`` (pad and row copies), ``batcher.h2d`` (pin and copy) and ``batcher.launch`` (the serving program's enqueue), in the traced stretch (``spans.py``)."""

from perfbench import spans


def read(ctx):
    return spans.host_ms(ctx, ["batcher.assemble", "batcher.h2d", "batcher.launch"])
