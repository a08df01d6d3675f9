"""Device milliseconds a step or a served batch of the host-to-device copies launched inside ``prefetch.h2d`` (the prefetcher's worker) or ``batcher.h2d`` (the micro-batcher's dispatcher), in the traced stretch (``spans.py``)."""

from perfbench import spans


def read(ctx):
    return spans.device_ms(ctx, ["prefetch.h2d", "batcher.h2d"], ["gpu_memcpy"])
