"""Metric logging: running means, a live stdout line and a JSONL file sink.

Counterpart of ``anytime3d_tpu/utils/logging.py``. ``print_every`` 0 prints
nothing (the ranks after the first of a data-parallel run).
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, jsonl_path: Optional[str] = None, print_every: int = 1):
        self._sums: Dict[str, float] = {}
        self._count = 0
        self._t0 = time.time()
        self._print_every = print_every
        self._fh = open(jsonl_path, "a") if jsonl_path else None

    def update(self, metrics: Dict[str, float], step: int, epoch: int = 0) -> None:
        self._count += 1
        for k, v in metrics.items():
            self._sums[k] = self._sums.get(k, 0.0) + float(v)
        if self._fh is not None:
            rec = {"step": step, "epoch": epoch, "t": round(time.time() - self._t0, 3)}
            rec.update({k: float(v) for k, v in metrics.items()})
            self._fh.write(json.dumps(rec) + "\n")
        if self._print_every and step % self._print_every == 0:
            self._print_line(step, epoch)

    def means(self) -> Dict[str, float]:
        return {k: v / max(self._count, 1) for k, v in self._sums.items()}

    def _print_line(self, step: int, epoch: int) -> None:
        rt = (time.time() - self._t0) / max(self._count, 1)
        parts = [f"it:{step:05d} ep:{epoch:03d} rt:{rt:.2f}s"]
        parts += [f"{k}:{v:.4f}" for k, v in self.means().items()]
        sys.stdout.write(" ".join(parts) + "  \r")
        sys.stdout.flush()

    def reset_epoch(self) -> None:
        self._sums = {}
        self._count = 0
        self._t0 = time.time()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.flush()
            self._fh.close()
            self._fh = None
