"""Timing on the card, for the probes (``cli/probe_*.py``), ``cli/profile.py``
and ``chip_smoke.py``.

``cuda_ms`` times calls by CUDA events; where the host takes longer to enqueue
a call than the card to run it, the events read the host. ``device_ms`` first
holds the card busy for longer than the host takes to enqueue the calls, so
that they run back to back and a call is timed by its kernels.
``host_enqueue_ms`` is the host's share: from an idle card until the call
returns. ``kernel_rows`` and ``busy_ms`` read the profiler's device time by
kernel. Each function needs a CUDA card when it is called; nothing here runs
at import.
"""

from __future__ import annotations

import subprocess
import time

import torch

SLEEP_CYCLES_PER_MS = 2.0e6  # torch.cuda._sleep's cycles: the H100's top clock is 1.98 GHz


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of one call, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_enqueue_ms(fn, iters: int = 10) -> float:
    """Mean host milliseconds of one call, from an idle card until the call
    returns with its work enqueued: the host's share of a served batch."""
    total = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / iters * 1e3


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of one call on the card alone: ``cuda_ms``, with the
    card first held busy (``torch.cuda._sleep``) for twice as long as the
    host takes to enqueue the ``iters`` calls, so that they run back to back
    and a call whose host side outlasts its kernels is timed by its kernels."""
    for _ in range(warmup):
        fn()
    host = host_enqueue_ms(fn, iters=3)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * iters * host + 1.0) * SLEEP_CYCLES_PER_MS))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_rows(prof, n: int) -> list:
    """(name, device ms, calls) per kernel of a profile, each over ``n`` runs,
    the longest first. Kernel rows only: operator rows and annotated ranges
    repeat their kernels' device time."""
    from torch.autograd import DeviceType

    rows = [(e.key, e.self_device_time_total / 1e3 / n, e.count / n) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    return sorted(rows, key=lambda r: -r[1])


def profile_rows(fn, runs: int = 3, tries: int = 3) -> list:
    """``kernel_rows`` of ``runs`` calls of ``fn`` (after one unprofiled).
    A profile that comes back without a kernel row is taken again, up to
    ``tries`` times: on the card's host a later profiler session of a process
    has come back empty once (chip_smoke.py's phase 18)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        rows = kernel_rows(prof, runs)
        if rows:
            break
    return rows


def busy_ms(fn, runs: int = 3) -> float:
    """The card's busy milliseconds a call: the profiler's kernel times, summed."""
    return sum(r[1] for r in profile_rows(fn, runs))
