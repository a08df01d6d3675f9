"""Background batch prefetcher: host batch making and the host-to-device copy
overlap the device's work on the steps before.

Counterpart of ``anytime3d_tpu/data/prefetch.py``. A worker thread calls
``next_batch_fn`` in order. On CUDA it copies each array into a pinned host
buffer and from there to the device on a side stream, and records an event;
``get`` makes the current stream wait on that event, so the step reads the
batch only after its copy, and hands each tensor to the caching allocator
with ``record_stream``, so its memory is not reused while the step may still
read it. A pinned buffer is refilled only after the copy out of it has
completed. On the CPU the arrays pass through as tensors that share their
memory.

Batch making overlaps the device only where it releases the interpreter
lock: NumPy's copies and casts, and ctypes calls such as the native packer
(``data/packing.py``), do; Python loops do not.

Spans (``utils/profiling.py``), on the worker thread: ``prefetch.make``
(``next_batch_fn``), ``prefetch.stage`` (the wait on the slot's last copy,
then the pinned copies; on the CPU, the arrays made tensors),
``prefetch.h2d`` (enqueuing the copies and their event),
``prefetch.queue_full`` (the wait for room in the queue).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from anytime3d_tpu_torch.utils.profiling import span

HostBatch = Mapping[str, np.ndarray]


def to_device(batch: Mapping, device: torch.device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) as tensors on ``device``; to CUDA
    from pinned memory without blocking the host."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


class _Slot:
    """Pinned host buffers for one batch and the event of their last copy.
    A buffer is kept for each (key, shape, dtype) the slot has staged, so a
    batch whose shape changes from batch to batch (a multi-scale schedule's
    images) allocates no pinned memory after each shape's first batch: a
    reallocation cost 0.69 ms a batch of 32 96x128 images beside an NVIDIA
    H100 80GB HBM3, 700 W (``chip_smoke.py``'s image phase)."""

    def __init__(self):
        self.buffers: Dict[tuple, torch.Tensor] = {}
        self.event: Optional[torch.cuda.Event] = None

    def stage(self, key: str, array: np.ndarray) -> torch.Tensor:
        src = torch.as_tensor(array)
        spec = (key, tuple(src.shape), src.dtype)
        buf = self.buffers.get(spec)
        if buf is None:
            buf = self.buffers[spec] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        buf.copy_(src)
        return buf


class DevicePrefetcher:
    """Makes batches ``depth`` ahead on a worker thread and serves them, on
    ``device``, with :meth:`get`. ``next_batch_fn`` returns a batch of numpy
    arrays; an exception it raises (``StopIteration`` at the end of a finite
    stream) is raised by the ``get`` that would have returned that batch.
    Call :meth:`close` when done."""

    def __init__(self, next_batch_fn: Callable[[], HostBatch], device: torch.device, depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth {depth} < 1")
        self._fn = next_batch_fn
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if cuda else None
        # the queue's batches, the one the consumer holds and the one being filled
        self._slots: List[_Slot] = [_Slot() for _ in range(depth + 2)] if cuda else []
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, name="DevicePrefetcher", daemon=True)
        self._thread.start()

    def _copy(self, batch: HostBatch, slot: _Slot):
        with span("prefetch.stage"):
            if slot.event is not None:
                slot.event.synchronize()  # the last copy out of these buffers is done
            staged = {k: slot.stage(k, v) for k, v in batch.items()}
        with span("prefetch.h2d"), torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = {k: v.to(self.device, non_blocking=True) for k, v in staged.items()}
            slot.event = torch.cuda.Event()
            slot.event.record(self.stream)
        return out, slot.event

    def _worker(self):
        try:
            n = 0
            while not self._stop.is_set():
                with span("prefetch.make"):
                    batch = self._fn()
                if self.stream is not None:
                    item = self._copy(batch, self._slots[n % len(self._slots)])
                else:
                    with span("prefetch.stage"):
                        item = ({k: torch.as_tensor(v) for k, v in batch.items()}, None)
                n += 1
                with span("prefetch.queue_full"):
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
        except Exception as e:  # noqa: BLE001 — raised by get(), after the batches made before it
            self._error = e

    def get(self) -> Dict[str, torch.Tensor]:
        """The next batch, ready for work on the current stream."""
        while True:
            try:
                batch, event = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if self._error is None:
                    continue
                try:  # the worker queues a batch before it records an error
                    batch, event = self._q.get_nowait()
                    break
                except queue.Empty:
                    raise self._error from None
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in batch.values():
                t.record_stream(current)
        return batch

    def close(self) -> None:
        """Stop the worker and wait until it has ended. It checks for the stop
        between batches and while its queue is full, so it ends within one
        batch's making; the wait is unbounded so that no worker outlives the
        prefetcher and races a successor on a shared loader."""
        self._stop.set()
        waited = 0.0
        while True:
            self._thread.join(timeout=60.0)
            if not self._thread.is_alive():
                return
            waited += 60.0
            print(f"prefetch worker still running after {waited:.0f} s: next_batch_fn appears blocked")
