"""Host milliseconds a served batch waits to be handed to the completion thread: the ``batcher.backpressure`` span, which blocks while ``max_in_flight`` batches are unfetched, in the traced stretch (``spans.py``)."""

from perfbench import spans


def read(ctx):
    return spans.host_ms(ctx, ["batcher.backpressure"])
