"""Arithmetic shared by the per-layer metrics' readers (``metrics/*.py``).

Each returns None where the run gave it nothing to read, so that the metric
is left out of the line; a share of a roofline or of a peak is never made 0.
"""

from __future__ import annotations

import statistics
from typing import Optional

from perfbench import flops


def mean(ctx, span: str) -> Optional[float]:
    values = ctx.spans.get(span) or []
    return statistics.fmean(values) if values else None


def percentile(ctx, span: str, q: float) -> Optional[float]:
    """The ``q``-th percentile (numpy's linear rule) of a span's values."""
    values = sorted(ctx.spans.get(span) or [])
    if not values:
        return None
    pos = (len(values) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(values) - 1)
    return values[lo] + (values[hi] - values[lo]) * (pos - lo)


def ratio(ctx, num: str, den: str) -> Optional[float]:
    n, d = ctx.counts.get(num), ctx.counts.get(den)
    return n / d if n is not None and d else None


def idle_pct(ctx) -> Optional[float]:
    """Share of the measured window in which no device operation ran: the
    traced stretch's device busy time a unit of work (a step or a batch),
    the union of its kernels', copies' and memsets' intervals, times the
    window's work, over the window's seconds. The profiler slows the host,
    so the traced stretch's own idle share would overstate the window's."""
    t, c = ctx.trace, ctx.counts
    if t is None or not t.device or not ctx.traced_work or not c.get("window_s"):
        return None
    busy_s = t.busy_us() / 1e6 / ctx.traced_work * c["work"]
    return 100.0 * (1.0 - busy_s / c["window_s"])


def conv_k2_roofline(ctx) -> Optional[float]:
    """The ``conv_k2`` ops' bound time over the device time of all they launched."""
    t = ctx.trace
    if t is None:
        return None
    bound = device = 0.0
    for event, us in t.launched_by(flops.CONV_K2_OPS):
        args = event.get("args", {})
        work = flops.conv_k2_work(event["name"], args.get("Input Dims", []), args.get("Input type", []))
        if work is None or us <= 0:
            continue
        bound += flops.bound_s(*work)
        device += us / 1e6
    return 100.0 * bound / device if device > 0 else None


def mfu_pct(ctx) -> Optional[float]:
    """The window's matmul and convolution operations over its seconds and the peak of its compute dtype."""
    c = ctx.counts
    if not c.get("flops") or not c.get("window_s"):
        return None
    return 100.0 * c["flops"] / c["window_s"] / flops.PEAK_FLOPS[c["compute"]]
