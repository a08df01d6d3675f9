"""Device milliseconds a step or a served batch of the work launched inside ``model.decode`` (the decoder's forward), in the traced stretch (``spans.py``); the program's counterpart of ``decoder_fwd_ms``."""

from perfbench import spans


def read(ctx):
    return spans.device_ms(ctx, ["model.decode"])
