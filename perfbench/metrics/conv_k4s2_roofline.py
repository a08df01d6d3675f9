"""Share of its roofline that the lowered stride-2 k=4 conv's forward, dx and
dw reach in the traced window: the bound time of the
``anytime3d_torch::conv_k4s2``, ``_dx`` and ``_dw`` calls over the device
time of everything they launched.

A call's work is the lowered k=2 conv's, 8C -> N at the output grid (B, D,
H, W), counted as ``conv_k2_roofline`` counts a k=2 conv
(``flops.conv_k2_ops``): a tap that lands on the SAME pad is no work. That is
2 B C N (4D - 2)(4H - 2)(4W - 2) operations for x (B, 2D, 2H, 2W, C) and the
weight (N, C, 4, 4, 4), for each of the three. Its bytes count each input
once and the output once, in the dtypes the call was given (dw: float32).
A trace without these ops (a program that does not lower the conv) reads
nothing.
"""

import math

from perfbench import flops

OPS = ("anytime3d_torch::conv_k4s2", "anytime3d_torch::conv_k4s2_dx", "anytime3d_torch::conv_k4s2_dw")


def work(op, dims, types):
    """(operations, bytes, compute dtype) of one call of ``op`` with the
    profiler's input dims and types, or None for a call it cannot read."""
    if len(dims) < 2 or len(types) < 2 or any(t not in flops.ITEMSIZE for t in types[:2]):
        return None
    a, b = list(dims[0]), list(dims[1])
    if len(a) != 5 or len(b) != 5:
        return None
    sa, sb = flops.ITEMSIZE[types[0]], flops.ITEMSIZE[types[1]]
    if op == OPS[0]:  # x (B, 2D, 2H, 2W, C), w (N, C, 4, 4, 4) -> y (B, D, H, W, N) in x's dtype
        B, C, N = a[0], a[4], b[0]
        D, H, W = (-(-n // 2) for n in a[1:4])
        out = B * D * H * W * N * sa
    elif op == OPS[1]:  # g (B, D, H, W, N), w -> dx (B, 2D, 2H, 2W, C) in g's dtype
        B, D, H, W, N = a
        C = b[1]
        out = B * 8 * D * H * W * C * sa
    elif op == OPS[2]:  # x, g (B, D, H, W, N) -> dw (N, C, 4, 4, 4) in float32
        B, C = a[0], a[4]
        D, H, W, N = b[1], b[2], b[3], b[4]
        out = N * C * 64 * 4
    else:
        return None
    return flops.conv_k2_ops(B, D, H, W, 8 * C, N), math.prod(a) * sa + math.prod(b) * sb + out, flops.COMPUTE[types[0]]


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    bound = device = 0.0
    for event, us in t.launched_by(OPS):
        args = event.get("args", {})
        w = work(event["name"], args.get("Input Dims", []), args.get("Input type", []))
        if w is None or us <= 0:
            continue
        bound += flops.bound_s(*w)
        device += us / 1e6
    return 100.0 * bound / device if device > 0 else None
