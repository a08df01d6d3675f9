"""Kernels launched a unit of work inside its span: ``trainer.step`` (the train loop's thread and the autograd engine's) or ``batcher.launch`` (the serving program on the dispatcher), in the traced stretch (``spans.py``)."""

from perfbench import spans


def read(ctx):
    return spans.launches(ctx)
