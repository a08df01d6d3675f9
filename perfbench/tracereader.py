"""Reduction of a profiler trace (``torch.profiler``'s Chrome trace JSON) to
what the per-layer metrics read.

- Device activity: the ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events.
  Busy time is the union of their intervals inside the traced window, so
  that overlapping streams count once; the gaps are the rest of the window.
- What an operator launched: the runtime calls (``cuda_runtime``,
  ``cuda_driver``) made on the operator's thread inside its interval, and
  the device events of the same correlation id, whatever their names.
- The window: the span of the ``perfbench.window`` annotation the harness
  records around the traced steps, or else that of all events.
- A gap's host activity: the innermost annotation or operator, on any
  thread, that was running at the gap's middle.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
WINDOW = "perfbench.window"
NAME = 160  # characters of a kernel's name kept in a breakdown


def _union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    """A parsed trace; times in microseconds as the trace gives them."""

    def __init__(self, events: Sequence[dict]):
        self.device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        self.runtime = [e for e in events if e.get("ph") == "X" and e.get("cat") in RUNTIME_CATS]
        self.host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
        marks = [e for e in self.host if e.get("name") == WINDOW]
        timed = [e for e in events if e.get("ph") == "X" and "ts" in e]
        if marks:
            self.t0 = min(float(e["ts"]) for e in marks)
            self.t1 = max(float(e["ts"]) + float(e.get("dur", 0)) for e in marks)
        elif timed:
            self.t0 = min(float(e["ts"]) for e in timed)
            self.t1 = max(float(e["ts"]) + float(e.get("dur", 0)) for e in timed)
        else:
            self.t0 = self.t1 = 0.0
        self._host_sorted = sorted((e for e in self.host if e.get("name") != WINDOW), key=lambda e: float(e["ts"]))
        self._host_starts = [float(e["ts"]) for e in self._host_sorted]
        self._by_corr: Dict[int, List[dict]] = defaultdict(list)
        for e in self.device:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                self._by_corr[int(corr)].append(e)

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as fh:
            data = json.load(fh)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    def busy(self) -> List[Tuple[float, float]]:
        """The union of device intervals, clipped to the window."""
        clipped = ((max(float(e["ts"]), self.t0), min(float(e["ts"]) + float(e.get("dur", 0)), self.t1))
                   for e in self.device)
        return _union((a, b) for a, b in clipped if b > a)

    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy())

    def gaps(self) -> List[Tuple[float, float]]:
        out, t = [], self.t0
        for a, b in self.busy():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            out.append((t, self.t1))
        return out

    def device_ops(self, n: int = 10) -> List[list]:
        """[name, seconds] of the device events that took most time in the window."""
        sums: Dict[str, float] = defaultdict(float)
        for e in self.device:
            a, b = max(float(e["ts"]), self.t0), min(float(e["ts"]) + float(e.get("dur", 0)), self.t1)
            if b > a:
                sums[e.get("name", "?")[:NAME]] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:n]]

    def host_at(self, t: float, lookback: int = 4096) -> str:
        """The innermost host annotation or operator running at ``t``: the
        latest-starting one whose interval holds ``t``."""
        i = bisect.bisect_right(self._host_starts, t)
        for e in reversed(self._host_sorted[max(0, i - lookback):i]):
            if float(e["ts"]) + float(e.get("dur", 0)) >= t:
                return e.get("name", "?")
        return "host idle"

    def idle_gaps(self, n: int = 10) -> List[list]:
        """[host activity, seconds]: the device's idle time in the window,
        summed by what the host was doing at each gap's middle, the largest first."""
        sums: Dict[str, float] = defaultdict(float)
        for a, b in self.gaps():
            sums[self.host_at((a + b) / 2)] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:n]]

    def launched_by(self, names: Sequence[str]) -> List[Tuple[dict, float]]:
        """(operator event, device microseconds of everything it launched)
        for each outermost call of an operator named in ``names`` inside the window."""
        calls = [e for e in self.host if e.get("cat") == "cpu_op" and e.get("name") in names
                 and self.t0 <= float(e["ts"]) <= self.t1]
        by_tid: Dict[object, List[dict]] = defaultdict(list)
        for e in calls:
            by_tid[e.get("tid")].append(e)
        runtime_by_tid: Dict[object, List[dict]] = defaultdict(list)
        for r in self.runtime:
            runtime_by_tid[r.get("tid")].append(r)
        for rs in runtime_by_tid.values():
            rs.sort(key=lambda r: float(r["ts"]))
        out = []
        for tid, evs in by_tid.items():
            evs.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0))))
            rs = runtime_by_tid.get(tid, [])
            starts = [float(r["ts"]) for r in rs]
            end_outer = -1.0
            for e in evs:
                a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
                if a < end_outer:  # nested inside an outer call of the same family
                    continue
                end_outer = b
                us = 0.0
                for r in rs[bisect.bisect_left(starts, a):bisect.bisect_right(starts, b)]:
                    corr = r.get("args", {}).get("correlation")
                    for k in self._by_corr.get(int(corr), []) if corr is not None else []:
                        us += float(k.get("dur", 0))
                out.append((e, us))
        return out
