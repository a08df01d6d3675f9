"""Device milliseconds a served batch of the work launched inside ``serve.unpack`` (the packed bits to the model's input grid), in the traced stretch (``spans.py``)."""

from perfbench import spans


def read(ctx):
    return spans.device_ms(ctx, ["serve.unpack"])
