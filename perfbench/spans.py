"""Arithmetic shared by the readers of the program's own spans
(``anytime3d_tpu_torch/utils/profiling.py``: ``record_function`` ranges,
``user_annotation`` events of the traced stretch, on the trace's clock).

- The unit of work: a ``trainer.step`` span in a train cell, a
  ``batcher.launch`` span in a serve cell. The spans of a name are read over
  the cycles between the first and the last start of a unit inside the
  ``perfbench.window`` annotation: the spans that start in that stretch,
  over the number of cycles in it. A span that the profiler's start or stop
  cut is thus left out, and each stage of a cycle counts once.
- A span's device work: the device events (kernels, copies, memsets) whose
  runtime call was made on the span's thread inside the span, matched by
  correlation id as ``Trace.launched_by`` matches an operator's. A
  ``trainer.step`` also owns the launches made while it is open on the
  autograd engine's threads, which run the backward.

Each function returns None where the trace, the unit or the span is absent,
so that the metric is left out of the line (a program without the spans
writes none).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

from perfbench.tracereader import Trace

UNITS = ("trainer.step", "batcher.launch")
SPAN_CAT = "user_annotation"
AUTOGRAD = "autograd::engine::evaluate_function"
KERNEL = "kernel"


class _Index:
    """The spans of a trace by name, its runtime calls by thread, its device
    events by correlation id and the cycles of its unit of work."""

    def __init__(self, trace: Trace):
        self.by_name: Dict[str, List[dict]] = defaultdict(list)
        for e in trace.host:
            if e.get("cat") == SPAN_CAT and trace.t0 <= float(e["ts"]) <= trace.t1:
                self.by_name[e.get("name")].append(e)
        for spans in self.by_name.values():
            spans.sort(key=lambda e: float(e["ts"]))
        self.runtime: Dict[object, List[dict]] = defaultdict(list)
        for r in trace.runtime:
            self.runtime[r.get("tid")].append(r)
        for rs in self.runtime.values():
            rs.sort(key=lambda r: float(r["ts"]))
        self.starts = {tid: [float(r["ts"]) for r in rs] for tid, rs in self.runtime.items()}
        self.device: Dict[int, List[dict]] = defaultdict(list)
        for e in trace.device:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                self.device[int(corr)].append(e)
        self.autograd = {e.get("tid") for e in trace.host if str(e.get("name", "")).startswith(AUTOGRAD)}
        self.unit: Optional[str] = None  # the unit of work's span, and its cycles [a, b): their number n
        self.a = self.b = 0.0
        self.n = 0
        for unit in UNITS:
            starts = [float(e["ts"]) for e in self.by_name.get(unit, [])]
            if len(starts) >= 2:
                self.unit, self.a, self.b, self.n = unit, starts[0], starts[-1], len(starts) - 1
                break

    def spans(self, name: str) -> List[dict]:
        """The spans named ``name`` that start in the cycles."""
        return [e for e in self.by_name.get(name, []) if self.a <= float(e["ts"]) < self.b]

    def launched(self, span: dict) -> List[dict]:
        """The device events of the runtime calls made inside ``span`` on its
        thread, and for a ``trainer.step`` on the autograd engine's threads."""
        a = float(span["ts"])
        b = a + float(span.get("dur", 0))
        tids = {span.get("tid")}
        if span.get("name") == UNITS[0]:
            tids |= self.autograd
        out = []
        for tid in tids:
            starts, rs = self.starts.get(tid, []), self.runtime.get(tid, [])
            for r in rs[bisect.bisect_left(starts, a):bisect.bisect_right(starts, b)]:
                corr = r.get("args", {}).get("correlation")
                if corr is not None:
                    out += self.device.get(int(corr), [])
        return out


def index(ctx) -> Optional[_Index]:
    """The trace's index; None without a trace or a unit of work."""
    if ctx.trace is None:
        return None
    idx = _Index(ctx.trace)
    return idx if idx.unit is not None else None


def host_ms(ctx, names: Sequence[str]) -> Optional[float]:
    """Host milliseconds a unit of work spent in the spans ``names``."""
    idx = index(ctx)
    spans = [e for name in names for e in idx.spans(name)] if idx else []
    if not spans:
        return None
    return sum(float(e.get("dur", 0)) for e in spans) / 1e3 / idx.n


def device_ms(ctx, names: Sequence[str], cats: Optional[Sequence[str]] = None) -> Optional[float]:
    """Device milliseconds a unit of work of the events (of ``cats``, or all)
    launched inside the spans ``names``."""
    idx = index(ctx)
    spans = [e for name in names for e in idx.spans(name)] if idx else []
    if not spans:
        return None
    us = sum(float(k.get("dur", 0)) for e in spans for k in idx.launched(e) if cats is None or k.get("cat") in cats)
    return us / 1e3 / idx.n


def launches(ctx) -> Optional[float]:
    """Kernels launched a unit of work inside the unit's spans."""
    idx = index(ctx)
    if idx is None:
        return None
    return sum(1 for e in idx.spans(idx.unit) for k in idx.launched(e) if k.get("cat") == KERNEL) / idx.n
