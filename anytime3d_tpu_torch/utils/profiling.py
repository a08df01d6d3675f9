"""Profiling annotations and a trace of a span of work.

Counterpart of ``anytime3d_tpu/utils/profiling.py``'s ``step_annotation`` and
``trace`` on ``torch.profiler``: a step's span carries its name and number in
the trace (and, where CUDA is present, in an NVTX range, which a CUDA
profiler reads); ``trace`` records the host and, where present, the CUDA
device and writes a Chrome trace into ``log_dir``. The JAX package's
``enable_compilation_cache`` has no counterpart: the port compiles its
kernels once into ``kernels/_build/``.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def step_annotation(name: str, step: int):
    """Mark the work inside as step ``step`` of ``name``: a
    ``torch.profiler.record_function`` span named ``"{name} step {step}"``
    and, where CUDA is present, an NVTX range of that name."""
    label = f"{name} step {step}"
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(label)
    try:
        with torch.profiler.record_function(label):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the work inside (the host, and the CUDA device where there is
    one) and write its Chrome trace into ``log_dir`` as
    ``trace-<pid>-<ns>.json`` on the way out. Yields the profiler, whose
    ``key_averages()`` can be read after."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
