"""Named spans of the program's stages, on the profiler's clock.

``span(name)`` marks a stage of the work. While a profiler runs
(``torch.profiler.profile``; or ``torch.autograd.profiler.emit_nvtx``
under Nsight Systems, which makes every such range an NVTX range) the span
is a ``torch.profiler.record_function`` range, so it lies in the same trace
as the kernels and copies launched inside it, on the same clock. With no
profiler on, ``span`` returns one shared no-op context and records nothing;
while ``torch.compile`` or ``torch.export`` traces, it records nothing
either, so an exported program holds no profiler op. A span closes only
what it opened: a profiler that starts or stops inside an open span leaves
the trace well formed.

Names are fixed ``<layer>.<stage>`` strings, with no step number, so that a
trace's spans group by name:

- input path: ``prefetch.make``, ``prefetch.stage``, ``prefetch.h2d``,
  ``prefetch.queue_full`` (``data/prefetch.py``, the worker thread);
  ``batch.load``, ``batch.pack`` (``cli/train.py::build_batch_fn``, on the
  thread that makes the batch);
- train loop: ``trainer.batch_wait``, ``trainer.step``, ``trainer.fetch``,
  ``trainer.log``, ``trainer.save``, ``trainer.eval``
  (``train/trainer.py``);
- train step: ``step.forward``, ``step.backward``, ``step.update``
  (``train/step.py``);
- model: ``model.encode``, ``model.decode`` (``models/mmvae.py``);
- micro-batcher: ``batcher.collect``, ``batcher.assemble``,
  ``batcher.h2d``, ``batcher.launch``, ``batcher.backpressure`` (the
  dispatcher thread); ``batcher.fetch``, ``batcher.resolve`` (the
  completion thread) (``serving/batcher.py``);
- serving program: ``serve.unpack``, ``serve.classify``, ``serve.pack``
  (``serving/export.py``).

The JAX package's ``step_annotation``, ``trace`` and
``enable_compilation_cache`` have no counterpart: ``span`` is the one
mechanism, a trace is taken with ``torch.profiler.profile``, and the port
compiles its kernels once into ``kernels/_build/``.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

_OFF = contextlib.nullcontext()  # the one no-op context of every span with no profiler on


def span(name: str):
    """A context that marks the work inside as the stage ``name`` in a
    running profiler's trace (a ``record_function`` range, which closes at
    exit only what it opened at entry); the shared no-op context where no
    profiler runs or where ``torch.compile`` or ``torch.export`` traces."""
    if not _autograd_profiler._is_profiler_enabled or torch.compiler.is_compiling():
        return _OFF
    return record_function(name)
