"""Host milliseconds a served batch takes to resolve its requests' futures and run their done callbacks (the ``batcher.resolve`` span on the completion thread), in the traced stretch (``spans.py``)."""

from perfbench import spans


def read(ctx):
    return spans.host_ms(ctx, ["batcher.resolve"])
