"""Host milliseconds a train step waits for its batch: the ``trainer.batch_wait`` span (``DevicePrefetcher.get``, or at depth 0 the batch made and copied in line) on the train loop's thread, a step of the traced stretch (``spans.py``)."""

from perfbench import spans


def read(ctx):
    return spans.host_ms(ctx, ["trainer.batch_wait"])
