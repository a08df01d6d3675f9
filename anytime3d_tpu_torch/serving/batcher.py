"""Fixed-shape micro-batching in front of the serving program.

Counterpart of ``anytime3d_tpu/serving/batcher.py``, with the same contract
and threads:

- requests are coalesced by a dispatcher thread into groups of at most
  ``batch_size`` within ``max_wait_s`` of the first; short groups are padded
  to the full batch, so the program always sees one shape;
- ``submit`` returns a ``concurrent.futures.Future`` at once;
- the dispatcher copies each batch to the device (from pinned host memory,
  without blocking, on a CUDA device) and enqueues the call; a completion
  thread fetches the outputs with ``.cpu()`` and resolves the futures in
  FIFO order, so up to ``max_in_flight`` batches overlap.

Spans (``utils/profiling.py``): on the dispatcher ``batcher.collect``,
``batcher.assemble`` (pad and row copies), ``batcher.h2d`` (pin and copy),
``batcher.launch`` (the ``infer_fn`` call) and ``batcher.backpressure``
(the hand-off that blocks at ``max_in_flight``); on the completion thread
``batcher.fetch`` (the outputs' ``.cpu()``) and ``batcher.resolve`` (the
futures and their done callbacks).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Callable, Dict, Optional

import numpy as np
import torch

from anytime3d_tpu_torch.utils.profiling import span


class MicroBatcher:
    """Coalesce single-item requests into fixed-size device batches."""

    def __init__(
        self,
        infer_fn: Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]],
        batch_size: int,
        input_shape,
        mask_dim: int,
        max_wait_s: float = 0.005,
        input_dtype=np.float32,
        max_in_flight: int = 2,
        device="cuda",
    ):
        """``input_shape`` is the per-item shape (no batch dim); ``mask_dim``
        the latent-mask width; ``device`` where ``infer_fn`` takes its inputs
        (the card unless the caller names another)."""
        self._fn = infer_fn
        self._b = int(batch_size)
        self._item_shape = tuple(input_shape)
        self._mask_dim = int(mask_dim)
        self._wait = float(max_wait_s)
        self._dtype = input_dtype
        self._device = torch.device(device)
        self._q: "queue.Queue" = queue.Queue()
        # dispatched-but-unfetched batches; bounded => backpressure on the dispatcher
        self._pending: "queue.Queue" = queue.Queue(maxsize=max(1, int(max_in_flight)))
        self._closed = threading.Event()
        self._submit_lock = threading.Lock()  # orders submit() vs close()
        self.batches_run = 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self._completer = threading.Thread(target=self._complete, daemon=True)
        self._completer.start()

    # ---- client API ------------------------------------------------------
    def submit(self, x, mask: Optional[np.ndarray] = None) -> Future:
        """Enqueue one item (shape ``input_shape``); resolves to the per-item
        output dict of numpy arrays. ``mask`` defaults to all-observed."""
        x = np.asarray(x, self._dtype)
        if x.shape != self._item_shape:
            raise ValueError(f"item shape {x.shape} != {self._item_shape}")
        if mask is None:
            mask = np.ones((self._mask_dim,), np.float32)
        mask = np.asarray(mask, np.float32)
        if mask.shape != (self._mask_dim,):
            raise ValueError(f"mask shape {mask.shape} != ({self._mask_dim},)")
        fut: Future = Future()
        with self._submit_lock:
            if self._closed.is_set():
                raise RuntimeError("MicroBatcher is closed")
            self._q.put((x, mask, fut))
        return fut

    def close(self):
        """Drain outstanding requests, then stop both threads."""
        with self._submit_lock:
            self._closed.set()
            self._q.put(None)  # wake the worker; nothing can enqueue after
        self._worker.join()
        self._pending.put(None)  # after the dispatcher: preserves FIFO drain
        self._completer.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- worker ----------------------------------------------------------
    def _collect(self):
        """Block for the first request, then coalesce up to batch_size more
        within one wait window measured from the first."""
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return []
        if first is None:
            return []
        group = [first]
        deadline = time.monotonic() + self._wait
        while len(group) < self._b:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            group.append(nxt)
        return group

    @staticmethod
    def _resolve(fut: Future, value=None, exc: Optional[BaseException] = None):
        """Deliver a result; a future its client already cancelled is dropped."""
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(value)
        except InvalidStateError:
            pass

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self._device.type == "cuda":
            return t.pin_memory().to(self._device, non_blocking=True)
        return t.to(self._device)

    def _run(self):
        """Dispatcher: coalesce -> pad -> copy to the device -> enqueue the call."""
        while True:
            with span("batcher.collect"):
                group = self._collect()
            if not group:
                if self._closed.is_set() and self._q.empty():
                    return
                continue
            # a failure here resolves this group's waiters instead of killing
            # the worker and stranding every later submit
            try:
                with span("batcher.assemble"):
                    xs = np.zeros((self._b,) + self._item_shape, self._dtype)
                    masks = np.ones((self._b, self._mask_dim), np.float32)
                    for i, (x, m, _) in enumerate(group):
                        xs[i] = x
                        masks[i] = m
                with span("batcher.h2d"):
                    xs, masks = self._to_device(xs), self._to_device(masks)
                with span("batcher.launch"):
                    out = self._fn(xs, masks)
            except Exception as e:
                for _, _, fut in group:
                    self._resolve(fut, exc=e)
                continue
            with span("batcher.backpressure"):
                self._pending.put((group, out))  # blocks at max_in_flight

    def _complete(self):
        """Completion thread: fetch each batch's outputs and resolve its futures."""
        while True:
            item = self._pending.get()
            if item is None:
                return
            group, out = item
            resolved = 0
            # a device error surfaces at the fetch: fail the waiters, not this thread
            try:
                with span("batcher.fetch"):
                    out = {k: v.cpu().numpy() for k, v in out.items()}
                self.batches_run += 1
                with span("batcher.resolve"):
                    for i in range(len(group)):
                        self._resolve(group[i][2], {k: v[i] for k, v in out.items()})
                        resolved += 1
            except Exception as e:
                for _, _, fut in group[resolved:]:
                    self._resolve(fut, exc=e)
