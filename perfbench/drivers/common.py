"""What the window drivers share: the port's model built from a
configuration file with the seeded weights, device spans by CUDA events, the
profiler over a part of the window, and what the per-layer readers get."""

from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

from perfbench import generators, harness
from perfbench.tracereader import WINDOW, Trace


@dataclasses.dataclass
class Readings:
    """What a per-layer metric's ``read(ctx)`` gets: ``spans`` (name -> list
    of milliseconds), ``counts`` (the measured window's ``work``, its steps or
    batches, its seconds, operations, compute dtype...), the parsed ``trace``
    of the traced stretch after the window, or None, and the ``traced_work``
    done in that stretch."""

    spans: Dict[str, List[float]]
    counts: Dict[str, object]
    trace: Optional[Trace]
    traced_work: int = 0


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def build_model(cfg: dict, seed: int, device, dtype: Optional[torch.dtype]):
    """(the port's MultiModalVAE of ``cfg`` on ``device``, uninitialised;
    its LossConfig; the seeded float32 weights by ``state_dict`` name)."""
    from anytime3d_tpu_torch.models.mmvae import MultiModalVAE

    from perfbench.reference import model as ref

    mcfg, lcfg = harness.port_configs(cfg)
    with torch.device("meta"):
        model = MultiModalVAE(mcfg, dtype=dtype)
    model = model.to_empty(device=device)
    weights = generators.weights(ref.param_spec(cfg["model"]), seed, device)
    return model, lcfg, weights


def load_weights(model, weights: Dict[str, torch.Tensor]) -> None:
    with torch.no_grad():
        model.load_state_dict(weights, strict=True)


class EventSpans:
    """Device milliseconds of named spans, by CUDA events on the current
    stream (the host clock on the CPU); read once the work has ended."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._pairs: Dict[str, list] = defaultdict(list)
        self._open: Dict[str, object] = {}
        self._hooks: list = []

    def _mark(self):
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        start = self._mark()
        try:
            yield
        finally:
            self._pairs[name].append((start, self._mark()))

    def hook_forward(self, name: str, first, last) -> None:
        """A span from the forward of module ``first`` entering to that of ``last`` returning."""

        def pre(_module, _args):
            if self.enabled:
                self._open[name] = self._mark()

        def post(_module, _args, _out):
            if self.enabled and name in self._open:
                self._pairs[name].append((self._open.pop(name), self._mark()))

        self._hooks += [first.register_forward_pre_hook(pre), last.register_forward_hook(post)]

    def clear(self) -> None:
        self._pairs.clear()

    def remove_hooks(self) -> None:
        for h in self._hooks:
            h.remove()
        self._hooks = []

    def read(self) -> Dict[str, List[float]]:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        out = {}
        for name, pairs in self._pairs.items():
            out[name] = [(b - a) * 1e3 if isinstance(a, float) else a.elapsed_time(b) for a, b in pairs]
        return out


def _all_threads():
    """The profiler's option to record the operators of every thread (the
    micro-batcher's, the prefetcher's), and to keep only the trace, where
    this torch has them."""
    from torch._C._profiler import _ExperimentalConfig

    for kw in ({"profile_all_threads": True, "trace_only": True}, {"profile_all_threads": True}, {}):
        try:
            return _ExperimentalConfig(**kw)
        except TypeError:
            continue
    return None


class Tracer:
    """``torch.profiler`` over ``seconds``, right after the measured window
    (which it would slow): :meth:`arm` at the window's end, then :meth:`tick`
    from the thread that drives the work, after each step or batch, until
    :attr:`done`. ``counter()`` counts the work done (steps or batches), so
    that :attr:`work` is what the traced part did. The trace is written
    under ``trace_dir``, read into :attr:`trace` and deleted."""

    def __init__(self, trace_dir: str, seconds: float, counter):
        self.dir, self.seconds, self.counter = trace_dir, seconds, counter
        self.prof = None
        self.trace: Optional[Trace] = None
        self.done = False
        self.work = 0
        self._rf = None
        self._first = 0
        self.stop_at = float("inf")

    def arm(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True,
                            experimental_config=_all_threads())
        self.prof.start()
        self._rf = record_function(WINDOW)
        self._rf.__enter__()
        self._first = self.counter()
        self.stop_at = time.perf_counter() + self.seconds

    def tick(self) -> None:
        if self.prof is not None and not self.done and time.perf_counter() >= self.stop_at:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._rf.__exit__(None, None, None)
            self.work = self.counter() - self._first
            self.prof.stop()
            self.done = True

    def finish(self) -> None:
        if self.prof is None:
            return
        tmp = tempfile.mkdtemp(prefix="perfbench-trace-", dir=self.dir)
        try:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            self.trace = Trace.load(path)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        self.prof = None
