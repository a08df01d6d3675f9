"""Device milliseconds a step or a served batch of the work launched inside ``model.encode`` (the encoder's forward and the posterior split), in the traced stretch (``spans.py``); the program's counterpart of ``encoder_fwd_ms``."""

from perfbench import spans


def read(ctx):
    return spans.device_ms(ctx, ["model.encode"])
