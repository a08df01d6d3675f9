"""PyTorch port, kernels: ``conv_k2`` against the JAX package, its build, and
that the port never imports JAX.

On the CPU the wrapper runs its plain version (``conv_k2_reference``); the
CUDA kernels themselves are checked on the card by tests/test_torch_cuda.py.
What the tensor-core kernels rest on is checked here without a card: the plans
that cut a shape into boxes, tiles and splits (``wgmma_plan``,
``narrow_plan``), and plain-tensor emulations of the box reads (zeros where a
box leaves the tensor, below 0 for dx as past the end for the forward and dw;
the narrow kernels' halo boxes and row table, dx's one voxel lower) against
the plain versions and the JAX package, and which kernel each dtype and shape
is routed to."""

import ctypes
import dataclasses
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from anytime3d_tpu.kernels.conv_k2 import conv_k2 as jax_conv_k2
from anytime3d_tpu.kernels.conv_k2 import _conv_k2_bwd_impl, conv_k2_xla
from anytime3d_tpu_torch.kernels import build
from anytime3d_tpu_torch.kernels import conv_k2 as k2
from anytime3d_tpu_torch.kernels.conv_k2 import (
    chunked_dx_plan,
    conv_k2,
    conv_k2_backward_reference,
    conv_k2_dw_reference,
    conv_k2_dx,
    conv_k2_dx_reference,
    conv_k2_reference,
    ffma_dw_fitted,
    ffma_dw_split,
    narrow_dw_plan,
    narrow_plan,
    wgmma_plan,
    wide_plan,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (B, D, C, N) of tests/test_kernels.py::TestConvK2: the Pallas im2col body,
# the matmul8 body, every boundary row, and the small-C XLA fallback
TEST_SHAPES = [(2, 4, 8, 16), (1, 4, 136, 8), (1, 4, 8, 8), (2, 4, 4, 8)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)  # the suite runs several workers per machine


def _inputs(B, D, C, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, D, D, D, C)).astype(np.float32)
    w = (rng.normal(size=(2, 2, 2, C, N)) * 0.1).astype(np.float32)
    return x, w


@pytest.mark.parametrize("B,D,C,N", TEST_SHAPES)
def test_plain_conv_k2_matches_jax(B, D, C, N):
    x, w = _inputs(B, D, C, N)
    before = conv_k2.launches
    y = conv_k2(torch.from_numpy(x), torch.from_numpy(w))
    assert conv_k2.launches == before  # a CPU tensor never reaches the kernel
    assert y.shape == (B, D, D, D, N) and y.is_contiguous()
    # f32 on every side, only the summation order differs (depth 8C <= 1088):
    # the 2e-4 that tests/test_kernels.py holds the Pallas kernel to
    np.testing.assert_allclose(y.numpy(), np.asarray(conv_k2_xla(jnp.asarray(x), jnp.asarray(w))), atol=2e-4, rtol=0)
    np.testing.assert_allclose(y.numpy(), np.asarray(jax_conv_k2(jnp.asarray(x), jnp.asarray(w))), atol=2e-4, rtol=0)


@pytest.mark.parametrize("B,D,C,N", TEST_SHAPES)
def test_plain_backward_matches_jax(B, D, C, N):
    """``conv_k2_backward_reference`` against ``_conv_k2_bwd_impl`` and
    ``jax.vjp(conv_k2_xla)``: f32, summation order only (atol 2e-4)."""
    x, w = _inputs(B, D, C, N)
    g = np.random.default_rng(1).normal(size=(B, D, D, D, N)).astype(np.float32)
    dx, dw = conv_k2_backward_reference(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(g))
    assert dx.shape == x.shape and dw.shape == w.shape and dw.dtype == torch.float32
    for ref_dx, ref_dw in (_conv_k2_bwd_impl(jnp.asarray(x), jnp.asarray(w), jnp.asarray(g)),
                           jax.vjp(conv_k2_xla, jnp.asarray(x), jnp.asarray(w))[1](jnp.asarray(g))):
        np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx), atol=2e-4, rtol=0)
        np.testing.assert_allclose(dw.numpy(), np.asarray(ref_dw), atol=2e-4, rtol=0)


@pytest.mark.parametrize("B,D,C,N", TEST_SHAPES)
def test_autograd_through_conv_k2_matches_jax(B, D, C, N):
    """Autograd through the wrapper on the CPU (a permuted, non-contiguous
    gradient, as a model hands it over) against ``jax.vjp`` of the JAX wrapper."""
    x, w = _inputs(B, D, C, N)
    g = np.random.default_rng(2).normal(size=(B, N, D, D, D)).astype(np.float32)
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    before = (conv_k2.launches, conv_k2.launches_dx, conv_k2.launches_dw)
    conv_k2(xt, wt).permute(0, 4, 1, 2, 3).backward(torch.from_numpy(g))
    assert (conv_k2.launches, conv_k2.launches_dx, conv_k2.launches_dw) == before
    g_last = jnp.asarray(g.transpose(0, 2, 3, 4, 1))
    ref_dx, ref_dw = jax.vjp(jax_conv_k2, jnp.asarray(x), jnp.asarray(w))[1](g_last)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_dx), atol=2e-4, rtol=0)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(ref_dw), atol=2e-4, rtol=0)


def test_bf16_input_with_f32_weight_gives_f32_weight_gradient():
    """The wrapper casts an f32 parameter to x's dtype; its gradient comes back f32."""
    x, w = _inputs(1, 4, 8, 8)
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = conv_k2(xt, wt)
    y.float().sum().backward()
    assert y.dtype == torch.bfloat16 and xt.grad.dtype == torch.bfloat16 and wt.grad.dtype == torch.float32
    ref = conv_k2_backward_reference(xt.detach(), wt.detach(), torch.ones_like(y))[1]
    np.testing.assert_allclose(wt.grad.numpy(), ref.numpy(), rtol=2e-2, atol=2e-2)  # F.conv3d sums in bf16 here


@pytest.mark.parametrize("xs,ws", [((2, 4, 4, 4, 8), (2, 2, 2, 4, 8)), ((2, 4, 4, 8), (2, 2, 2, 8, 8)),
                                   ((2, 4, 4, 4, 8), (3, 2, 2, 8, 8))])
def test_conv_k2_rejects_bad_shapes(xs, ws):
    with pytest.raises(ValueError):
        conv_k2(torch.zeros(xs), torch.zeros(ws))


# ---- the tensor-core kernels' plan and their box reads ----

FLAGSHIP_K2 = [(64, 512), (512, 128), (128, 512), (512, 64)]  # (C, N) at 16^3
# (B, D, H, W, C, N) with a plan: the flagship stages at the served and the
# train batch, and the card tests' 8^3 and 32^3 and some grids that are no cubes
PLANNED = ([(B, 16, 16, 16, C, N) for B in (8, 32) for C, N in FLAGSHIP_K2]
           + [(1, 8, 8, 8, 64, 64), (3, 8, 8, 8, 64, 128), (1, 32, 32, 32, 64, 64), (3, 32, 32, 32, 128, 64),
              (2, 4, 8, 16, 64, 64), (1, 2, 4, 32, 64, 192), (1, 2, 2, 256, 64, 64)]
           # the mid_blocked stages at 4^3: a box of two whole items (64 rows each); and 2^3, one of 16
           + [(B, 4, 4, 4, C, N) for B in (8, 32) for C, N in ((2048, 512), (512, 2048))]
           + [(2, 4, 4, 4, 64, 64), (16, 2, 2, 2, 64, 128)])
# and without: narrow or ragged channels, grids whose rows do not tile into boxes
UNPLANNED = [(2, 5, 6, 7, 64, 64), (8, 16, 17, 18, 64, 512), (1, 4, 4, 4, 64, 64), (2, 16, 16, 16, 8, 16),
             (2, 16, 16, 16, 136, 8), (2, 16, 16, 16, 16, 24), (2, 16, 16, 16, 64, 4), (1, 16, 16, 12, 64, 64),
             (1, 8, 8, 8, 96, 64), (1, 8, 8, 8, 64, 96), (7, 4, 4, 4, 2048, 512), (3, 4, 4, 4, 512, 2048),
             (8, 2, 2, 2, 64, 64)]
SMEM_PER_BLOCK = 232_448  # what one block may have on an H100
# The plans of the grids whose boxes lie inside one batch item, as they were
# before boxes could span items: (bm, bn, box, stages, smem_bytes, tiles, grid,
# dw_box, dw_stages, dw_smem_bytes, dw_grid, dw_stages_per_split). 8^3 at B=8,
# 1024 -> 256, whose 32 tiles fill a quarter of the card, has since split its
# depth into 4: 128 blocks walk its (tile, split) items (grid 32 before).
KEPT_PLANS = {
    (8, 16, 16, 16, 64, 512): (128, 128, (16, 8, 1), 3, 99456, 1024, 264, (16, 4, 1), 3, 99456, (4, 4, 16), 32),
    (8, 16, 16, 16, 512, 128): (256, 128, (16, 16, 1), 4, 197760, 128, 128, (16, 4, 1), 3, 99456, (1, 32, 8), 64),
    (8, 16, 16, 16, 128, 512): (256, 128, (16, 16, 1), 4, 197760, 512, 132, (16, 4, 1), 3, 99456, (4, 8, 8), 64),
    (8, 16, 16, 16, 512, 64): (256, 64, (16, 16, 1), 4, 164992, 128, 128, (16, 4, 1), 4, 99456, (1, 32, 8), 64),
    (32, 16, 16, 16, 64, 512): (128, 128, (16, 8, 1), 3, 99456, 4096, 264, (16, 4, 1), 3, 99456, (4, 4, 16), 128),
    (32, 16, 16, 16, 512, 128): (256, 128, (16, 16, 1), 4, 197760, 512, 132, (16, 4, 1), 3, 99456, (1, 32, 8), 256),
    (32, 16, 16, 16, 128, 512): (256, 128, (16, 16, 1), 4, 197760, 2048, 132, (16, 4, 1), 3, 99456, (4, 8, 8), 256),
    (32, 16, 16, 16, 512, 64): (256, 64, (16, 16, 1), 4, 164992, 512, 132, (16, 4, 1), 4, 99456, (1, 32, 8), 256),
    (32, 8, 8, 8, 1024, 256): (256, 128, (8, 8, 4), 4, 197760, 128, 128, (8, 8, 1), 3, 99456, (2, 64, 2), 128),
    (32, 8, 8, 8, 256, 1024): (256, 128, (8, 8, 4), 4, 197760, 512, 132, (8, 8, 1), 3, 99456, (8, 16, 2), 128),
    (8, 8, 8, 8, 1024, 256): (256, 128, (8, 8, 4), 4, 197760, 32, 128, (8, 8, 1), 3, 99456, (2, 64, 2), 32),
    (3, 8, 8, 8, 64, 128): (128, 128, (8, 8, 2), 3, 99456, 12, 12, (8, 8, 1), 3, 99456, (1, 4, 1), 24),
    (3, 32, 32, 32, 128, 64): (256, 64, (32, 8, 1), 4, 164992, 384, 132, (32, 2, 1), 4, 99456, (1, 8, 33), 47),
    # the flagship's 16^3 convs below the served batch (the lifecycle's B=4): their tiles leave the card idle, but
    # a 16^3 grid never splits its depth
    (1, 16, 16, 16, 64, 512): (128, 128, (16, 8, 1), 3, 99456, 128, 128, (16, 4, 1), 3, 99456, (4, 4, 4), 16),
    (1, 16, 16, 16, 512, 128): (256, 128, (16, 16, 1), 4, 197760, 16, 16, (16, 4, 1), 3, 99456, (1, 32, 4), 16),
    (1, 16, 16, 16, 128, 512): (256, 128, (16, 16, 1), 4, 197760, 64, 64, (16, 4, 1), 3, 99456, (4, 8, 4), 16),
    (1, 16, 16, 16, 512, 64): (256, 64, (16, 16, 1), 4, 164992, 16, 16, (16, 4, 1), 4, 99456, (1, 32, 4), 16),
    (2, 16, 16, 16, 64, 512): (128, 128, (16, 8, 1), 3, 99456, 256, 256, (16, 4, 1), 3, 99456, (4, 4, 8), 16),
    (2, 16, 16, 16, 512, 128): (256, 128, (16, 16, 1), 4, 197760, 32, 32, (16, 4, 1), 3, 99456, (1, 32, 8), 16),
    (2, 16, 16, 16, 128, 512): (256, 128, (16, 16, 1), 4, 197760, 128, 128, (16, 4, 1), 3, 99456, (4, 8, 8), 16),
    (2, 16, 16, 16, 512, 64): (256, 64, (16, 16, 1), 4, 164992, 32, 32, (16, 4, 1), 4, 99456, (1, 32, 8), 16),
    (4, 16, 16, 16, 64, 512): (128, 128, (16, 8, 1), 3, 99456, 512, 264, (16, 4, 1), 3, 99456, (4, 4, 16), 16),
    (4, 16, 16, 16, 512, 128): (256, 128, (16, 16, 1), 4, 197760, 64, 64, (16, 4, 1), 3, 99456, (1, 32, 8), 32),
    (4, 16, 16, 16, 128, 512): (256, 128, (16, 16, 1), 4, 197760, 256, 132, (16, 4, 1), 3, 99456, (4, 8, 8), 32),
    (4, 16, 16, 16, 512, 64): (256, 64, (16, 16, 1), 4, 164992, 64, 64, (16, 4, 1), 4, 99456, (1, 32, 8), 32),
}


def _origin(row, D, H, W):
    """(b, d, h, w) of a flat row index, as the kernels' producer computes it."""
    w0, row = row % W, row // W
    h0, row = row % H, row // H
    return row // D, row % D, h0, w0


def _box_read(x, origin, extents, tap, c0, sign=1, items=1):
    """The (rows, 64) tile a TMA box copy of ``x`` (B,D,H,W,C) delivers: the
    box of ``extents`` (w, h, d) by ``items`` batch items at ``origin`` (b,
    d, h, w) shifted by ``sign`` times the tap in d, h and w (+1 the forward
    and dw, -1 dx: a start coordinate may be negative), 64 channels from
    ``c0``, zeros wherever it leaves the tensor, below 0 as well as past the
    end, axis by axis (so in each item of a box that spans items)."""
    (b, d, h, w), (bw, bh, bd) = origin, extents
    d, h, w = d + sign * (tap >> 2), h + sign * ((tap >> 1) & 1), w + sign * (tap & 1)
    _, D, H, W, _ = x.shape
    out = torch.zeros(items, bd, bh, bw, 64, dtype=x.dtype)
    # per axis: the part [lo, hi) of the box that lies inside the tensor
    (d0, d1), (h0, h1), (w0, w1) = ((max(0, -lo), max(0, min(n, size - lo))) for n, size, lo in
                                    ((bd, D, d), (bh, H, h), (bw, W, w)))
    if d0 < d1 and h0 < h1 and w0 < w1:
        out[:, d0:d1, h0:h1, w0:w1] = x[b:b + items, d + d0:d + d1, h + h0:h + h1, w + w0:w + w1, c0:c0 + 64]
    return out.reshape(-1, 64)


def _emulate_forward(x, w, plan):
    """The forward as the kernel walks it: block i takes tiles i, i + grid, ...;
    a tile is 8C/64 stages of one tap and 64 channels. Returns y and how often
    each output element was written."""
    B, D, H, W, C = x.shape
    N = w.shape[-1]
    w2 = w.reshape(8 * C, N)
    y = torch.zeros(B * D * H * W, N)
    written = torch.zeros(B * D * H * W, N, dtype=torch.int32)
    n_tiles = N // plan.bn
    for block in range(plan.grid):
        for tile in range(block, plan.tiles, plan.grid):
            n0, row0 = tile % n_tiles * plan.bn, tile // n_tiles * plan.bm
            acc = torch.zeros(plan.bm, plan.bn)
            for it in range(8 * C // 64):
                tap, c0 = it * 64 // C, it * 64 % C
                acc += (_box_read(x, _origin(row0, D, H, W), plan.box, tap, c0, items=plan.box_items)
                        @ w2[it * 64:it * 64 + 64, n0:n0 + plan.bn])
            y[row0:row0 + plan.bm, n0:n0 + plan.bn] = acc
            written[row0:row0 + plan.bm, n0:n0 + plan.bn] += 1
    return y.reshape(B, D, H, W, N), written


def _emulate_dx(g, w, plan):
    """dx as the kernel walks it, with the plan of the forward from N to C
    channels: a tile is 8N/64 stages of one tap and 64 channels n; A is the
    box of g at the origin minus the tap, B the rows (tap, c0 ..) and columns
    n0 .. of ``w`` viewed [8C, N] as it lies, used transposed (K-major).
    Returns dx and how often each element was written."""
    B, D, H, W, N = g.shape
    C = w.shape[3]
    w2 = w.reshape(8 * C, N)
    dx = torch.zeros(B * D * H * W, C)
    written = torch.zeros(B * D * H * W, C, dtype=torch.int32)
    c_tiles = C // plan.bn
    for block in range(plan.grid):
        for tile in range(block, plan.tiles, plan.grid):
            c0, row0 = tile % c_tiles * plan.bn, tile // c_tiles * plan.bm
            acc = torch.zeros(plan.bm, plan.bn)
            for it in range(8 * N // 64):
                tap, n0 = it * 64 // N, it * 64 % N
                a = _box_read(g, _origin(row0, D, H, W), plan.box, tap, n0, sign=-1, items=plan.box_items)
                for j in range(plan.bn // 64):  # one 64 x 64 box of w a 64-column block
                    rows = tap * C + c0 + 64 * j
                    acc[:, 64 * j:64 * j + 64] += a @ w2[rows:rows + 64, n0:n0 + 64].T
            dx[row0:row0 + plan.bm, c0:c0 + plan.bn] = acc
            written[row0:row0 + plan.bm, c0:c0 + plan.bn] += 1
    return dx.reshape(B, D, H, W, C), written


def _emulate_dw(x, g, plan):
    """dw as the kernel walks it: per (column tile, row tile, split) the
    stages of 64 rows, two boxes of x a stage (one for each 64 output rows);
    the splits summed in ascending order. Returns dw and how often each row m
    entered each output element's sum."""
    B, D, H, W, C = x.shape
    N = g.shape[-1]
    g2 = g.reshape(-1, N)
    total = g2.shape[0] // 64
    nt, rt, splits = plan.dw_grid
    part = torch.zeros(splits, 8 * C, N)
    depth = torch.zeros(8 * C, N, dtype=torch.int64)
    for z in range(splits):
        first = z * plan.dw_stages_per_split
        for stage in range(first, min(total, first + plan.dw_stages_per_split)):
            m0 = stage * 64
            for r0 in range(0, rt * 128, 64):
                tap, c0 = r0 // C, r0 % C
                a = _box_read(x, _origin(m0, D, H, W), plan.dw_box, tap, c0, items=plan.dw_box_items)
                for n0 in range(0, nt * plan.bn, plan.bn):
                    part[z, r0:r0 + 64, n0:n0 + plan.bn] += a.T @ g2[m0:m0 + 64, n0:n0 + plan.bn]
                    depth[r0:r0 + 64, n0:n0 + plan.bn] += 64
    dw = part[0].clone()
    for z in range(1, splits):
        dw += part[z]
    return dw.reshape(2, 2, 2, C, N), depth


@pytest.mark.parametrize("B,D,H,W,C,N", PLANNED)
def test_wgmma_plan_fits_the_card_and_covers_every_row(B, D, H, W, C, N):
    plan = wgmma_plan(B, D, H, W, C, N)
    assert plan is not None
    rows = B * D * H * W
    # boxes: 64 channels = 128 bytes inner (the 128-byte swizzle), every extent
    # within the TMA's 256, bm rows a forward tile and 64 rows a dw stage
    assert 64 * 2 == 128 and max(*plan.box, *plan.dw_box, plan.box_items, plan.dw_box_items, 64) <= 256
    assert plan.bm in (128, 256) and plan.bn in (64, 128) and N % plan.bn == 0
    assert math.prod(plan.box) * plan.box_items == plan.bm and math.prod(plan.dw_box) * plan.dw_box_items == 64
    # a box spans batch items only as whole items of a grid with fewer rows than the box
    for box, items in ((plan.box, plan.box_items), (plan.dw_box, plan.dw_box_items)):
        assert items == 1 or (box == (W, H, D) and B % items == 0)
    # rings of at least 3 stages of 8 KB tiles; two blocks share an SM's shared
    # memory, except the forward at 256 rows, which has it alone
    per_sm = 2 if plan.bm == 128 else 1
    ring = plan.stages * (plan.bm // 64 + plan.bn // 64) * 64 * 64 * 2
    assert 3 <= plan.stages <= 8 and ring + 1024 <= plan.smem_bytes <= SMEM_PER_BLOCK // per_sm
    dw_ring = plan.dw_stages * (2 + plan.bn // 64) * 64 * 64 * 2
    assert 3 <= plan.dw_stages <= 8 and dw_ring + 1024 <= plan.dw_smem_bytes <= SMEM_PER_BLOCK // 2
    # forward: the boxes of consecutive tiles tile the grid, every row once
    seen = np.zeros((B, D, H, W), np.int32)
    bw, bh, bd = plan.box
    bb = plan.box_items
    for row0 in range(0, rows, plan.bm):
        b, d, h, w = _origin(row0, D, H, W)
        assert b + bb <= B and d + bd <= D and h + bh <= H and w + bw <= W
        flat = np.ravel_multi_index(np.meshgrid(np.arange(b, b + bb), np.arange(d, d + bd), np.arange(h, h + bh),
                                                np.arange(w, w + bw), indexing="ij"), (B, D, H, W)).ravel()
        assert (flat == np.arange(row0, row0 + plan.bm)).all()  # the box's rows, in order, are the tile's rows
        seen[b:b + bb, d:d + bd, h:h + bh, w:w + bw] += 1
    assert (seen == 1).all()
    items = plan.tiles * plan.splits  # (tile, split): one split of all stages but where the tiles idle the card
    assert plan.tiles == rows // plan.bm * (N // plan.bn) and 1 <= plan.grid <= min(items, per_sm * 132)
    walked = sorted(t for block in range(plan.grid) for t in range(block, items, plan.grid))
    assert walked == list(range(items))
    # dw: stages of 64 rows are boxes too; the splits are whole stages, none empty, all of them
    bw, bh, bd = plan.dw_box
    for m0 in range(0, rows, 64):
        b, d, h, w = _origin(m0, D, H, W)
        assert b + plan.dw_box_items <= B and d + bd <= D and h + bh <= H and w + bw <= W
        assert np.ravel_multi_index((b, d, h, w), (B, D, H, W)) == m0
    nt, rt, splits = plan.dw_grid
    assert nt * plan.bn == N and rt * 128 == 8 * C
    total = rows // 64
    assert (splits - 1) * plan.dw_stages_per_split < total <= splits * plan.dw_stages_per_split
    assert splits == 1 or plan.dw_stages_per_split >= 16  # each split many stages deep
    assert nt * rt * splits <= max(nt * rt, 2 * 132)  # one wave at two blocks an SM


@pytest.mark.parametrize("B,D,H,W,C,N", UNPLANNED)
def test_wgmma_plan_is_none_where_the_kernels_do_not_apply(B, D, H, W, C, N):
    assert wgmma_plan(B, D, H, W, C, N) is None


@pytest.mark.parametrize("shape", sorted(KEPT_PLANS))
def test_wgmma_plans_inside_one_item_are_kept(shape):
    """Boxes that span batch items changed no plan whose boxes lie inside one
    item: the 16^3 flagship stages, 8^3 and 32^3 give the tiles, boxes, rings
    and splits they gave before."""
    p = wgmma_plan(*shape)
    assert (p.bm, p.bn, p.box, p.stages, p.smem_bytes, p.tiles, p.grid, p.dw_box, p.dw_stages, p.dw_smem_bytes,
            p.dw_grid, p.dw_stages_per_split) == KEPT_PLANS[shape]
    assert p.box_items == p.dw_box_items == 1


@pytest.mark.parametrize("B,C,N", [(8, 2048, 512), (32, 2048, 512), (8, 512, 2048), (32, 512, 2048), (2, 64, 64)])
def test_wgmma_plan_spans_items_at_4cubed(B, C, N):
    """At 4^3 an item has 64 rows: the forward's 128-row box is two whole
    items, its 256-row box four, dw's 64-row box one; dx's plan (the forward
    from N to C) likewise. 256-row tiles where they fill 7/8 of the 132 SMs
    (B=32, 512 -> 2048: 128 of them) or where 128-row tiles would split their
    depth (every other shape here with C >= 128), else 128 rows. An odd B has
    no plan."""
    for c, n in ((C, N), (N, C)):
        p = wgmma_plan(B, 4, 4, 4, c, n)
        bm = 256 if c >= 128 else 128
        assert (p.bm, p.box, p.box_items, p.dw_box, p.dw_box_items) == (bm, (4, 4, 4), bm // 64, (4, 4, 4), 1)
        assert p.tiles == B * 64 // bm * (n // p.bn)
        if B % 4 == 0 and c >= 128:
            for rows in (128, 256):
                forced = wgmma_plan(B, 4, 4, 4, c, n, bm=rows)
                assert (forced.bm, forced.box, forced.box_items) == (rows, (4, 4, 4), rows // 64)
        assert wgmma_plan(B + 1, 4, 4, 4, c, n) is None
    assert k2._row_box(128, B, 4, 4, 4) == (4, 4, 4, 2) and k2._row_box(256, B + 1, 4, 4, 4) is None


# ---- the forward's split depth (the forward and dx of the tensor-core kernels) ----

# named (B, D, H, W, C, N) that keep one split and the tiles they had: the flagship's four 16^3 convs at B=8 and
# B=32 and below the served batch (B=1, 2, 4: a 16^3 grid never splits), and the mid_blocked stages whose tiles
# fill the card at B=32 (8^3 both ways, 4^3 512 -> 2048)
ONE_SPLIT = {f"flagship_b{B}_{C}to{N}": (B, 16, 16, 16, C, N) for B in (1, 2, 4, 8, 32) for C, N in FLAGSHIP_K2} | {
    "mid_b32_8cubed_1024to256": (32, 8, 8, 8, 1024, 256), "mid_b32_8cubed_256to1024": (32, 8, 8, 8, 256, 1024),
    "mid_b32_4cubed_512to2048": (32, 4, 4, 4, 512, 2048)}
# the shapes whose forward splits: the mid_blocked stages whose tiles fill at most half a wave of blocks, and
# their (bm, tiles, splits, stages_per_split, grid)
SPLIT = {(8, 4, 4, 4, 2048, 512): (256, 8, 16, 16, 128), (32, 4, 4, 4, 2048, 512): (256, 32, 4, 64, 128),
         (8, 4, 4, 4, 512, 2048): (256, 32, 4, 16, 128), (8, 8, 8, 8, 1024, 256): (256, 32, 4, 32, 128),
         (2, 4, 4, 4, 2048, 512): (128, 4, 16, 16, 64)}


def _check_split(plan, C, voxels, sms=132):
    """The forward's split arithmetic: every one of the 8C/64 stages in exactly one split, in order, none empty;
    more than one split only on a grid of at most 8^3 ``voxels`` an item whose tiles fill at most half a wave of
    blocks and whose depth allows two runs of 16 stages, each split then at least 16 deep and the work items
    (tile, split) within one wave."""
    per_sm = 2 if plan.bm == 128 else 1
    depth = 8 * C // 64
    runs = [range(z * plan.stages_per_split, min(depth, (z + 1) * plan.stages_per_split)) for z in range(plan.splits)]
    assert [s for r in runs for s in r] == list(range(depth)) and all(len(r) > 0 for r in runs)
    idle = 2 * plan.tiles <= per_sm * sms
    assert (plan.splits > 1) == (idle and depth >= 32 and voxels <= 512)
    assert plan.splits == 1 or (plan.stages_per_split >= 16 and plan.tiles * plan.splits <= per_sm * sms)
    assert plan.grid == min(plan.tiles * plan.splits, per_sm * sms)


@pytest.mark.parametrize("B,D,H,W,C,N", PLANNED + sorted(SPLIT) + [(1, 16, 16, 16, 512, 128), (4, 16, 16, 16, 512, 64)])
def test_wgmma_plan_split_covers_every_stage_once(B, D, H, W, C, N):
    """The forward's plan and dx's (the forward from N to C) cut their depth so: at the card's 132 SMs and at 8
    (where more shapes leave the card idle)."""
    for sms in (132, 8):
        _check_split(wgmma_plan(B, D, H, W, C, N, sms=sms), C, D * H * W, sms)
        _check_split(wgmma_plan(B, D, H, W, N, C, sms=sms), N, D * H * W, sms)


@pytest.mark.parametrize("name", sorted(ONE_SPLIT))
def test_wgmma_plan_keeps_one_split(name):
    """The shapes that fill the card keep one split of all stages and the tiles, grid and ring they had."""
    B, D, H, W, C, N = shape = ONE_SPLIT[name]
    p = wgmma_plan(*shape)
    assert (p.splits, p.stages_per_split) == (1, 8 * C // 64)
    # 4^3 512 -> 2048 at B=32 is not in KEPT_PLANS: its plan of 128 tiles of 256 rows
    kept = KEPT_PLANS.get(shape, (256, 128, (4, 4, 4), 4, 197760, 128, 128))
    assert (p.bm, p.bn, p.box, p.stages, p.smem_bytes, p.tiles, p.grid) == kept[:7]
    assert p == wgmma_plan(*shape, split=False)


@pytest.mark.parametrize("shape", sorted(SPLIT))
def test_wgmma_plan_splits_where_tiles_idle_the_card(shape):
    """Where 128-row tiles would fill at most half a wave the plan takes 256 rows (one block an SM) where the
    rows tile so, and splits: 4^3 2048 -> 512 at B=8, 8 tiles on 132 SMs, 256 stages: 16 splits of 16. At B=32
    32 tiles, 4 splits; 512 -> 2048 at B=8 (the dx of 2048 -> 512) 32 tiles of a 64-stage sum, 4 of 16; 8^3
    1024 -> 256 at B=8 32 tiles, 4 of 32. At B=2 no 256-row box tiles the rows (4 items): 4 tiles of 128 rows
    on 264 block slots, 16 splits."""
    p = wgmma_plan(*shape)
    assert (p.bm, p.tiles, p.splits, p.stages_per_split, p.grid) == SPLIT[shape]


# the plans of SPLIT's shapes without the split, as they were before it: (bm, tiles, grid, box, box_items)
UNSPLIT = {(8, 4, 4, 4, 2048, 512): (128, 16, 16, (4, 4, 4), 2), (32, 4, 4, 4, 2048, 512): (128, 64, 64, (4, 4, 4), 2),
           (8, 4, 4, 4, 512, 2048): (128, 64, 64, (4, 4, 4), 2), (8, 8, 8, 8, 1024, 256): (256, 32, 32, (8, 8, 4), 1),
           (2, 4, 4, 4, 2048, 512): (128, 4, 4, (4, 4, 4), 2)}


@pytest.mark.parametrize("shape", sorted(UNSPLIT))
def test_wgmma_plan_without_split_is_the_plan_before_it(shape):
    """``split=False`` (what the card's measurements set the split against) gives one split of all stages and
    the tiles, box and grid the plan had before the split; the dw fields do not change."""
    p, q = wgmma_plan(*shape, split=False), wgmma_plan(*shape)
    assert (p.splits, p.stages_per_split) == (1, 8 * shape[4] // 64)
    assert (p.bm, p.tiles, p.grid, p.box, p.box_items) == UNSPLIT[shape]
    assert (p.dw_box, p.dw_grid, p.dw_stages_per_split) == (q.dw_box, q.dw_grid, q.dw_stages_per_split)


def _emulate_split(src, w, plan, dx=False):
    """The forward (or, ``dx``, dx over g with the plan of the forward from N to C) as the split kernel walks
    it: block i takes the work items i, i + grid, ... of (tile, split), column tiles fastest, then splits; an
    item sums its run of stages from zero into an f32 partial [splits, rows, cols]; the partials summed in
    ascending order (as ``conv_k2_split_reduce_kernel``, without its rounding). Returns the sum and how often
    each partial element was written."""
    B, D, H, W, depth_ch = src.shape
    C, N = w.shape[3], w.shape[4]
    cols, w2 = (C if dx else N), w.reshape(8 * C, N)
    n_tiles, items, depth = cols // plan.bn, plan.tiles * plan.splits, 8 * depth_ch // 64
    part = torch.zeros(plan.splits, B * D * H * W, cols)
    written = torch.zeros(plan.splits, B * D * H * W, cols, dtype=torch.int32)
    for block in range(plan.grid):
        for item in range(block, items, plan.grid):
            n0, rest = item % n_tiles * plan.bn, item // n_tiles
            split, row0 = rest % plan.splits, rest // plan.splits * plan.bm
            acc = torch.zeros(plan.bm, plan.bn)
            first = split * plan.stages_per_split
            for it in range(first, min(depth, first + plan.stages_per_split)):
                tap, k0 = it * 64 // depth_ch, it * 64 % depth_ch
                a = _box_read(src, _origin(row0, D, H, W), plan.box, tap, k0, sign=-1 if dx else 1,
                              items=plan.box_items)
                if dx:  # B[(tap, n), c] = w[tap, c, n]: a 64 x 64 box of w a 64-column block
                    for j in range(plan.bn // 64):
                        rows = tap * C + n0 + 64 * j
                        acc[:, 64 * j:64 * j + 64] += a @ w2[rows:rows + 64, k0:k0 + 64].T
                else:
                    acc += a @ w2[it * 64:it * 64 + 64, n0:n0 + plan.bn]
            part[split, row0:row0 + plan.bm, n0:n0 + plan.bn] = acc
            written[split, row0:row0 + plan.bm, n0:n0 + plan.bn] += 1
    total = part[0].clone()
    for z in range(1, plan.splits):
        total += part[z]
    return total.reshape(B, D, H, W, cols), written


# (B, C, N) at 4^3 whose forward and dx both split: 2 and 4 splits of narrow channels, and the mid_blocked
# encoder's last stage (2048 -> 512) at B=2 and B=4, its forward in 16 splits and its dx in 4
SPLIT_EMULATED = [(2, 256, 256), (4, 512, 256), (2, 2048, 512), (4, 2048, 512)]


@pytest.mark.parametrize("B,C,N", SPLIT_EMULATED)
def test_split_depth_partials_give_the_forward_and_dx(B, C, N):
    """The split walk writes each partial element once, and the splits' partials over their runs of stages,
    summed in ascending order, equal ``conv_k2_reference`` and ``conv_k2_dx_reference`` (f32, summation order
    only: 1e-5 of the largest entry)."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(B, 4, 4, 4, C)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(2, 2, 2, C, N)) / math.sqrt(8 * C)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(B, 4, 4, 4, N)).astype(np.float32))
    for src, plan, dx, ref in ((x, wgmma_plan(B, 4, 4, 4, C, N), False, conv_k2_reference(x, w)),
                               (g, wgmma_plan(B, 4, 4, 4, N, C), True, conv_k2_dx_reference(g, w))):
        assert plan.splits > 1
        out, written = _emulate_split(src, w, plan, dx)
        assert (written == 1).all()
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5 * float(ref.abs().max()), rtol=0)


# ---- the float32 FFMA forward's split depth (ffma_split) and the persistent tensor-core dw ----

# (B, D, H, W, C, N) of the mid_blocked stages (4^3 and 8^3) at the served and the train batch and below, and
# small grids whose tiles leave the card idle
FFMA_SPLIT_SHAPES = ([(B, G, G, G, C, N) for B in (1, 2, 8, 32) for G, C, N in
                      ((8, 1024, 256), (4, 2048, 512), (4, 512, 2048), (8, 256, 1024))]
                     + [(2, 8, 8, 8, 64, 8), (2, 5, 6, 7, 24, 16), (3, 2, 2, 2, 8, 4), (1, 4, 4, 4, 136, 200)])
# (splits, stages_per_split) of the forward (and of dx, the forward from N to C) of the mid_blocked stages at the
# served batch and the train batch: 4^3 2048 -> 512 at B=8 has 16 tiles of 128 x 128 on 264 block slots, 1024
# stages deep: 16 splits of 64; at B=32 64 tiles, 4 of 256; 512 -> 2048 (the dx of 2048 -> 512) 64 tiles at
# B=8, 4 splits; 8^3 1024 -> 256 at B=8 64 tiles, 4 splits
FFMA_SPLIT = {(8, 4, 4, 4, 2048, 512): (16, 64), (32, 4, 4, 4, 2048, 512): (4, 256), (8, 4, 4, 4, 512, 2048): (4, 64),
              (32, 4, 4, 4, 512, 2048): (1, 256), (8, 8, 8, 8, 1024, 256): (4, 128), (8, 8, 8, 8, 256, 1024): (1, 128),
              (32, 8, 8, 8, 1024, 256): (1, 512), (32, 8, 8, 8, 256, 1024): (1, 128)}
# the shapes of the default layouts, which keep one split at every batch: the flagship's four 16^3 convs (and the
# dx of each), the s2d(2) stem at 32^3, the detector decoder's last conv at 32^3 (its training batch and the scene
# pass's 1024 decodes), the sub-pixel deconv on 17^3
FFMA_ONE_SPLIT = ([(B, 16, 16, 16, C, N) for B in (1, 2, 4, 8, 32) for C, N in FLAGSHIP_K2]
                  + [(B, 32, 32, 32, 8, 64) for B in (1, 8, 32)] + [(B, 32, 32, 32, 32, 8) for B in (2, 8, 32, 1024)]
                  + [(8, 17, 17, 17, 64, 64)])


@pytest.mark.parametrize("B,D,H,W,C,N", FFMA_SPLIT_SHAPES + FFMA_ONE_SPLIT)
def test_ffma_split_covers_every_stage_once(B, D, H, W, C, N):
    """The FFMA forward's split (and dx's: the forward from N to C), at 132 SMs and at 8: every one of the 8C/16
    stages in one run, in order, none empty; more than one run only on a grid of at most 8^3 voxels an item
    whose tiles fill at most half a wave of blocks (two of the 128-column tile an SM, four of the 64-column one)
    and whose depth allows two runs of 16 stages; then each run at least 16 deep and the blocks within one
    wave; the partials' workspace at most 64 MiB (the largest, 4^3 2048 -> 512 at B=32: 16 MiB)."""
    for sms in (132, 8):
        for c, n in ((C, N), (N, C)):
            splits, per_split = k2.ffma_split(B, D, H, W, c, n, sms=sms)
            stages = -(-8 * c // 16)
            runs = [range(z * per_split, min(stages, (z + 1) * per_split)) for z in range(splits)]
            assert [s for r in runs for s in r] == list(range(stages)) and all(len(r) > 0 for r in runs)
            bn, per_sm = (64, 4) if n <= 64 else (128, 2)
            tiles = -(-B * D * H * W // 128) * -(-n // bn)
            assert (splits > 1) == (D * H * W <= 512 and 2 * tiles <= per_sm * sms and stages >= 32)
            assert splits == 1 or (per_split >= 16 and tiles * splits <= per_sm * sms)
            assert (splits if splits > 1 else 0) * B * D * H * W * n * 4 <= 2**26


@pytest.mark.parametrize("shape", sorted(FFMA_SPLIT))
def test_ffma_split_of_the_mid_blocked_stages(shape):
    assert k2.ffma_split(*shape) == FFMA_SPLIT[shape]


@pytest.mark.parametrize("B,D,H,W,C,N", FFMA_ONE_SPLIT)
def test_ffma_split_keeps_one_split_on_the_default_layouts(B, D, H, W, C, N):
    """Every 16^3 and larger grid keeps the one split of all stages, forward and dx, at every batch."""
    for c, n in ((C, N), (N, C)):
        assert k2.ffma_split(B, D, H, W, c, n) == (1, -(-8 * c // 16))


def _shifted_rows(src, tap, sign):
    """Rows m of ``src`` (B,D,H,W,K) read at (d, h, w) + sign * tap, zeros off the grid: the FFMA loader's
    A operand for one tap (the forward +1, dx -1)."""
    B, D, H, W, K = src.shape
    dz, dy, dx = tap >> 2, (tap >> 1) & 1, tap & 1
    pad = F.pad(src, (0, 0, 1, 1, 1, 1, 1, 1))
    return pad[:, 1 + sign * dz:1 + sign * dz + D, 1 + sign * dy:1 + sign * dy + H,
               1 + sign * dx:1 + sign * dx + W].reshape(-1, K)


def _emulate_ffma_split(src, w2, splits, per_split, sign):
    """The FFMA forward (``sign`` 1; dx: -1 over g, ``w2`` = w^T [8N, C]) as its split instance walks the depth:
    split z sums the stages [z per_split, ...) of 16 depth entries (tap, channel) into an f32 partial, and the
    partials are added in ascending order (conv_k2_dw_reduce_kernel). Returns the sum and how often each depth
    entry entered it."""
    K = src.shape[-1]
    taps = [_shifted_rows(src, t, sign) for t in range(8)]
    a = torch.cat(taps, dim=1)  # [M, 8K], depth (tap, channel)
    seen = torch.zeros(8 * K, dtype=torch.int64)
    part = torch.zeros(splits, a.shape[0], w2.shape[1])
    for z in range(splits):
        for s in range(z * per_split, min(8 * K // 16, (z + 1) * per_split)):
            part[z] += a[:, 16 * s:16 * s + 16] @ w2[16 * s:16 * s + 16]
            seen[16 * s:16 * s + 16] += 1
    total = part[0].clone()
    for z in range(1, splits):
        total += part[z]
    return total.reshape(*src.shape[:4], -1), seen


@pytest.mark.parametrize("C,N", [(2048, 512), (512, 2048), (256, 64), (128, 24)])
def test_ffma_split_partials_give_the_forward_and_dx(C, N):
    """At 4^3, B=2 (each of these splits its forward or dx, 4 to 64 runs; 24 columns a ragged tile): the split
    runs' f32 partials summed in order equal ``conv_k2_reference`` and ``conv_k2_dx_reference`` at the f32
    tolerance of this file (summation order only: 1e-5 of the largest entry)."""
    B = 2
    rng = np.random.default_rng(19)
    x = torch.from_numpy(rng.normal(size=(B, 4, 4, 4, C)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(2, 2, 2, C, N)) / math.sqrt(8 * C)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(B, 4, 4, 4, N)).astype(np.float32))
    fwd, dx = k2.ffma_split(B, 4, 4, 4, C, N), k2.ffma_split(B, 4, 4, 4, N, C)
    assert max(fwd[0], dx[0]) > 1
    for src, w2, (splits, per), sign, ref in (
            (x, w.reshape(8 * C, N), fwd, 1, conv_k2_reference(x, w)),
            (g, w.transpose(3, 4).reshape(8 * N, C), dx, -1, conv_k2_dx_reference(g, w))):
        out, seen = _emulate_ffma_split(src, w2, splits, per, sign)
        assert (seen == 1).all()
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5 * float(ref.abs().max()), rtol=0)


# (B, D, H, W, C, N) of the persistent dw: the mid_blocked stages at 4^3, at the served and the train batch, and
# small shapes (2^3; a reduction of 32 stages over 4 tiles, in two splits); and its plan's (bn, tiles, splits,
# stages_per_split, grid) at 132 SMs
PERSISTENT_DW = {(8, 4, 4, 4, 2048, 512): (256, 256, 1, 8, 132), (8, 4, 4, 4, 512, 2048): (256, 256, 1, 8, 132),
                 (32, 4, 4, 4, 2048, 512): (256, 256, 1, 32, 132), (32, 4, 4, 4, 512, 2048): (256, 256, 1, 32, 132),
                 (2, 4, 4, 4, 256, 256): (256, 16, 1, 2, 16), (16, 2, 2, 2, 64, 256): (256, 4, 1, 2, 4),
                 (32, 4, 4, 4, 64, 256): (256, 4, 2, 16, 8)}


@pytest.mark.parametrize("shape", sorted(PERSISTENT_DW))
def test_persistent_dw_walk_covers_every_tile_and_stage_once(shape):
    """The persistent dw's plan fits one block an SM (a ring of at least 3 stages and the store's chunk buffers,
    two of 2 KB a consumer warp, in 227 KB), and its walk, block i taking items i, i + grid, ... of (split, row
    tile, column tile), splits fastest, reduces every stage of 64 rows into every output tile once; at 132 SMs
    and at 8."""
    B, D, H, W, C, N = shape
    for sms in (132, 8):
        p = wgmma_plan(*shape, sms=sms).dw_persistent
        bn, tiles, splits, per_split, grid = PERSISTENT_DW[shape] if sms == 132 else (p.bn, p.tiles, p.splits,
                                                                                        p.stages_per_split, p.grid)
        assert (p.bn, p.tiles, p.splits, p.stages_per_split, p.grid) == (bn, tiles, splits, per_split, grid)
        stage = (2 + bn // 64) * 8192
        assert 3 <= p.stages <= 8 and p.smem_bytes == 2048 + p.stages * stage + 8 * 2 * 2048 <= SMEM_PER_BLOCK
        assert bn == 256 and tiles == 8 * C // 128 * (N // bn)
        total = B * D * H * W // 64
        assert (splits - 1) * per_split < total <= splits * per_split
        assert splits == 1 or (per_split >= 16 and 2 * tiles <= sms and tiles * splits <= sms)
        assert grid == min(tiles * splits, sms)
        rows, cols = 8 * C // 128, N // bn
        depth = np.zeros((rows, cols, total), np.int32)
        for block in range(grid):
            for item in range(block, tiles * splits, grid):
                z, rest = item % splits, item // splits
                rt, ct = rest % rows, rest // rows
                depth[rt, ct, z * per_split:min(total, (z + 1) * per_split)] += 1
        assert (depth == 1).all()


def test_persistent_dw_is_kept_off_the_default_layouts():
    """The flagship's 16^3 dw, every grid of more than 4^3 an item (the mid_blocked 8^3 stages too, where the
    persistent kernel measured no faster than the grid kernel), and N not a multiple of 256 keep the grid
    kernel; ``persistent_dw=False`` gives the plan without it, every other field the same."""
    for shape in [(B, 16, 16, 16, C, N) for B in (1, 8, 32) for C, N in FLAGSHIP_K2] + [
            (B, 8, 8, 8, C, N) for B in (8, 32) for C, N in ((1024, 256), (256, 1024))] + [
            (3, 32, 32, 32, 128, 64), (1, 8, 8, 8, 64, 64), (2, 4, 4, 4, 64, 64), (2, 4, 4, 4, 64, 128)]:
        assert wgmma_plan(*shape).dw_persistent is None
    for shape in PERSISTENT_DW:
        p, q = wgmma_plan(*shape), wgmma_plan(*shape, persistent_dw=False)
        assert p.dw_persistent is not None and q.dw_persistent is None
        assert dataclasses.replace(p, dw_persistent=None) == q


def _emulate_persistent_dw(x, g, plan):
    """dw as the persistent kernel walks it: per item the stages of its split, two boxes of x a stage (one for
    each 64 output rows of the tile) against 64 rows of g; each split's partial, then the splits summed in
    ascending order."""
    B, D, H, W, C = x.shape
    N = g.shape[-1]
    walk, g2 = plan.dw_persistent, g.reshape(-1, N)
    total, rows = g2.shape[0] // 64, 8 * C // 128
    part = torch.zeros(walk.splits, 8 * C, N)
    for block in range(walk.grid):
        for item in range(block, walk.tiles * walk.splits, walk.grid):
            z, rest = item % walk.splits, item // walk.splits
            r0, n0 = rest % rows * 128, rest // rows * walk.bn
            for stage in range(z * walk.stages_per_split, min(total, (z + 1) * walk.stages_per_split)):
                m0 = stage * 64
                for half in range(2):
                    r = r0 + 64 * half
                    a = _box_read(x, _origin(m0, D, H, W), plan.dw_box, r // C, r % C, items=plan.dw_box_items)
                    part[z, r:r + 64, n0:n0 + walk.bn] += a.T @ g2[m0:m0 + 64, n0:n0 + walk.bn]
    dw = part[0].clone()
    for z in range(1, walk.splits):
        dw += part[z]
    return dw.reshape(2, 2, 2, C, N)


@pytest.mark.parametrize("B,D,C,N,sms", [(2, 4, 64, 256, 132), (32, 4, 64, 256, 8), (4, 4, 64, 256, 2)])
def test_persistent_dw_walk_gives_dw(B, D, C, N, sms):
    """The emulated persistent walk (one split; two splits; one, each block walking several items) equals
    ``conv_k2_dw_reference`` and the JAX package's dw: f32, summation order only, 1e-5 of the largest entry."""
    plan = wgmma_plan(B, D, D, D, C, N, sms=sms)
    assert plan.dw_persistent.splits == (1, 2, 1)[(132, 8, 2).index(sms)]
    rng = np.random.default_rng(23)
    x = rng.normal(size=(B, D, D, D, C)).astype(np.float32)
    g = rng.normal(size=(B, D, D, D, N)).astype(np.float32)
    dw = _emulate_persistent_dw(torch.from_numpy(x), torch.from_numpy(g), plan)
    ref = conv_k2_dw_reference(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    tol = 1e-5 * float(np.abs(ref).max())
    np.testing.assert_allclose(dw.numpy(), ref, atol=tol, rtol=0)
    jax_dw = np.asarray(_conv_k2_bwd_impl(jnp.asarray(x), jnp.zeros((2, 2, 2, C, N), jnp.float32),
                                          jnp.asarray(g))[1])
    np.testing.assert_allclose(dw.numpy(), jax_dw, atol=tol, rtol=0)


def test_persistent_dw_chunk_writes_land_on_the_swizzled_box():
    """The persistent dw's store: a warp writes accumulator entries (row lane/4 and lane/4 + 8, columns
    8 jj + 2 (lane % 4), + 1 for jj < 4) of a chunk of 32 f32 columns at buf + 128 row + 16 ((2 jj + q/2) ^
    (row % 8)) + 8 (q % 2), which under the TMA's 128-byte swizzle (the 16-byte unit XOR the row's bits 7..9 of
    a 1024-aligned box) is element (row, column) of the 16 x 32 box, each once; each of the 8 write instructions
    (jj, upper half or not) puts the 32 lanes' 8 bytes into 2 wavefronts: every bank at most twice."""
    covered = np.zeros((16, 32), np.int32)
    for jj in range(4):
        for upper in (0, 1):
            banks = np.zeros(32, np.int32)
            for lane in range(32):
                q, lr = lane % 4, lane // 4
                off = lr * 128 + (((2 * jj + (q >> 1)) ^ lr) << 4) + (q & 1) * 8 + upper * 8 * 128
                row = off // 128
                col = (((off % 128) // 16) ^ (row % 8)) * 4 + off % 16 // 4
                assert (row, col) == (lr + 8 * upper, 8 * jj + 2 * q)
                covered[row, col:col + 2] += 1
                banks[[off // 4 % 32, off // 4 % 32 + 1]] += 1
            assert banks.max() <= 2
    assert (covered == 1).all()


# small grids, cubes and not: the box spans two d-planes (8^3), part of a
# plane (4x8x16), part of a line (2x2x256); N = 128 takes the wide tile; at
# 4^3 and 2^3 (as the mid_blocked encoder and decoder reach) the box spans
# whole batch items, 2 of them for the forward at 4^3 and 16 at 2^3
EMULATED = [(1, 8, 8, 8, 64, 64), (2, 8, 8, 8, 128, 128), (1, 4, 8, 16, 64, 128), (1, 2, 4, 32, 64, 64),
            (1, 2, 2, 256, 64, 64), (1, 16, 16, 16, 64, 64), (4, 4, 4, 4, 128, 64), (16, 2, 2, 2, 64, 128)]


@pytest.mark.parametrize("B,D,H,W,C,N", EMULATED)
def test_box_reads_with_zero_fill_give_the_forward(B, D, H, W, C, N):
    """Out-of-bounds zero fill of the shifted box is SAME padding (0, 1): the
    emulated tile walk equals the plain version and ``conv_k2_xla`` (f32,
    summation order only: 1e-5 of the largest output)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, D, H, W, C)).astype(np.float32)
    w = (rng.normal(size=(2, 2, 2, C, N)) * 0.05).astype(np.float32)
    plan = wgmma_plan(B, D, H, W, C, N, sms=2)  # 4 blocks: every block walks several tiles
    y, written = _emulate_forward(torch.from_numpy(x), torch.from_numpy(w), plan)
    assert (written == 1).all()
    ref = conv_k2_reference(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    tol = 1e-5 * float(np.abs(ref).max())
    np.testing.assert_allclose(y.numpy(), ref, atol=tol, rtol=0)
    np.testing.assert_allclose(y.numpy(), np.asarray(conv_k2_xla(jnp.asarray(x), jnp.asarray(w))), atol=tol, rtol=0)


@pytest.mark.parametrize("B,D,H,W,C,N", EMULATED)
def test_box_reads_with_zero_fill_give_dw(B, D, H, W, C, N):
    """The emulated dw walk (two boxes a stage, splits summed in order) equals
    ``conv_k2_dw_reference`` and ``_conv_k2_bwd_impl``'s dw: f32, summation
    order only, 1e-5 of the largest entry."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, D, H, W, C)).astype(np.float32)
    w = np.zeros((2, 2, 2, C, N), np.float32)
    g = rng.normal(size=(B, D, H, W, N)).astype(np.float32)
    plan = wgmma_plan(B, D, H, W, C, N, sms=2 * (8 * C // 128) * (N // 64))  # several splits where the depth allows
    dw, depth = _emulate_dw(torch.from_numpy(x), torch.from_numpy(g), plan)
    assert (depth == B * D * H * W).all()  # every row entered every sum once
    ref = conv_k2_dw_reference(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    tol = 1e-5 * float(np.abs(ref).max())
    np.testing.assert_allclose(dw.numpy(), ref, atol=tol, rtol=0)
    jax_dw = np.asarray(_conv_k2_bwd_impl(jnp.asarray(x), jnp.asarray(w), jnp.asarray(g))[1])
    np.testing.assert_allclose(dw.numpy(), jax_dw, atol=tol, rtol=0)


@pytest.mark.parametrize("B,D,H,W,C,N", EMULATED)
def test_box_reads_with_zero_fill_give_dx(B, D, H, W, C, N):
    """The box of g at mirrored coordinates, zero-filled below 0, and the
    boxes of w as it lies give dx: the emulated tile walk equals
    ``conv_k2_dx_reference`` and, at the first shape, ``_conv_k2_bwd_impl``'s
    dx (f32, summation order only: 1e-5 of the largest entry; against JAX the
    2e-4 of ``test_plain_backward_matches_jax``)."""
    rng = np.random.default_rng(5)
    g = rng.normal(size=(B, D, H, W, N)).astype(np.float32)
    w = (rng.normal(size=(2, 2, 2, C, N)) * 0.05).astype(np.float32)
    plan = wgmma_plan(B, D, H, W, N, C, sms=2)  # dx's plan: the forward's with C and N swapped
    dx, written = _emulate_dx(torch.from_numpy(g), torch.from_numpy(w), plan)
    assert (written == 1).all()
    ref = conv_k2_dx_reference(torch.from_numpy(g), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(dx.numpy(), ref, atol=1e-5 * float(np.abs(ref).max()), rtol=0)
    if (B, D, H, W, C, N) == EMULATED[0]:
        x = np.zeros((B, D, H, W, C), np.float32)
        jax_dx = np.asarray(_conv_k2_bwd_impl(jnp.asarray(x), jnp.asarray(w), jnp.asarray(g))[0])
        np.testing.assert_allclose(dx.numpy(), jax_dx, atol=2e-4, rtol=0)


@pytest.mark.parametrize("B,D,H,W,C,N", PLANNED)
def test_dx_plan_fits_the_card_and_covers_every_row(B, D, H, W, C, N):
    """dx is cut by ``wgmma_plan`` with C and N swapped: there is one wherever
    the forward has one, its tiles are rows of g by columns of C, and the walk
    over them writes every element of dx once."""
    plan = wgmma_plan(B, D, H, W, N, C)
    assert plan is not None
    rows = B * D * H * W
    assert plan.bm in (128, 256) and plan.bn in (64, 128) and C % plan.bn == 0 and N % 64 == 0
    assert plan.bm == 128 or N >= 128  # 256 rows only where a tile is at least 16 stages deep
    per_sm = 2 if plan.bm == 128 else 1
    ring = plan.stages * (plan.bm // 64 + plan.bn // 64) * 64 * 64 * 2
    assert 3 <= plan.stages <= 8 and ring + 1024 <= plan.smem_bytes <= SMEM_PER_BLOCK // per_sm
    bw, bh, bd = plan.box
    assert bw * bh * bd * plan.box_items == plan.bm and max(bw, bh, bd, plan.box_items) <= 256
    for row0 in range(0, rows, plan.bm):  # the box of a tile's rows stays inside its batch items before the shift
        b, d, h, w = _origin(row0, D, H, W)
        assert b + plan.box_items <= B and d + bd <= D and h + bh <= H and w + bw <= W
        assert np.ravel_multi_index((b, d, h, w), (B, D, H, W)) == row0
    items = plan.tiles * plan.splits  # (tile, split), as the forward's
    assert plan.tiles == rows // plan.bm * (C // plan.bn) and 1 <= plan.grid <= min(items, per_sm * 132)
    written = np.zeros((rows // plan.bm, C // plan.bn), np.int32)
    for block in range(plan.grid):
        for item in range(block, items, plan.grid):
            tile = item // (C // plan.bn) // plan.splits * (C // plan.bn) + item % (C // plan.bn)
            written[tile // (C // plan.bn), tile % (C // plan.bn)] += 1
    assert (written == plan.splits).all()  # every tile once a split
    # a stage is one tap and 64 channels n: 8N/64 stages a tile, each 64 deep
    assert 8 * N % 64 == 0 and 8 * N // 64 >= 8


# ---- the narrow kernels (bf16, N = 8, 16, 32): their plan and their halo-box walk ----

# (B, D, H, W, C, N) with a narrow plan: odd batches; 8^3, 32^3 (the detector decoder's last conv at a train
# step's 32 decodes and the scene pass's 1024), 5x6x7 (one box the whole grid), 2x2x256 (a line longer than a
# box) and 9x10x40, 33^3 (ragged last boxes along every axis); every N and C
NARROW = [(3, 8, 8, 8, 8, 8), (1, 8, 8, 8, 64, 16), (3, 8, 8, 8, 32, 32), (32, 32, 32, 32, 32, 8),
          (1024, 32, 32, 32, 32, 8), (2, 32, 32, 32, 64, 8), (3, 32, 32, 32, 16, 32), (5, 5, 6, 7, 16, 8),
          (3, 5, 6, 7, 64, 32), (1, 2, 2, 256, 32, 16), (1, 2, 2, 256, 8, 8), (2, 9, 10, 40, 16, 8),
          (1, 33, 33, 33, 8, 8)]
# bfloat16 shapes whose plan walks C in chunks of 64 (C a multiple of 64 above 64): the tensor-parallel shard
# 512 -> 32 at the train and the served batch, the shards of a model axis of 4 (512 -> 16, 512 -> 8), C = 128
# and 192 (two and three chunks) at 8^3, a whole-grid box, ragged boxes along every axis
CHUNKED = [(32, 16, 16, 16, 512, 32), (8, 16, 16, 16, 512, 32), (32, 16, 16, 16, 512, 16), (32, 16, 16, 16, 512, 8),
           (2, 8, 8, 8, 128, 8), (3, 8, 8, 8, 192, 32), (3, 5, 6, 7, 128, 16), (2, 9, 10, 40, 512, 32),
           (1, 33, 33, 33, 128, 8)]
# and without: float32 rows past 128 bytes that are not whole chunks of 32 (C = 48; N = 64 at C = 512), N
# outside {8, 16, 32}, C % 8 != 0 or C neither one TMA box nor whole chunks of 64 (24, 96, 136), shapes a wgmma
# plan takes
NARROW_NONE = [((3, 8, 8, 8, 48, 8), torch.float32), ((32, 32, 32, 32, 32, 4), torch.bfloat16),
               ((32, 32, 32, 32, 32, 24), torch.bfloat16), ((2, 8, 8, 8, 64, 64), torch.bfloat16),
               ((2, 5, 6, 7, 12, 8), torch.bfloat16), ((2, 5, 6, 7, 24, 8), torch.bfloat16),
               ((2, 8, 8, 8, 96, 8), torch.bfloat16), ((2, 5, 6, 7, 136, 8), torch.bfloat16),
               ((1, 16, 16, 16, 64, 64), torch.bfloat16), ((8, 16, 16, 16, 512, 64), torch.bfloat16),
               ((8, 16, 16, 16, 512, 64), torch.float32), ((2, 8, 8, 8, 128, 64), torch.bfloat16)]


def _narrow_boxes(B, D, H, W, box):
    """Origins (b, d, h, w) of the boxes, in the kernels' order: w fastest."""
    bw, bh, bd = box
    return [(b, d, h, w) for b in range(B) for d in range(0, D, bd) for h in range(0, H, bh) for w in range(0, W, bw)]


def _narrow_smem_of(box, C, N, dw, esize, stages, chunk_d, chunked=False):
    """What ``nr::smem_bytes`` allots for elements of ``esize`` bytes: 1024 bytes of alignment room, ``stages``
    stages (the halo box of x, esize C bytes a voxel, and for dw the box of g, rows rounded up to 16), the
    forward's w (8C x N) and its table of output rows, the table of halo rows, a barrier a stage (their room
    rounded up to 16 bytes); stages in whole KiB. The float32 forward of a box of at most 512 rows splits the taps
    over the block's two halves: the second half's sums, rows x N floats, besides; where ``chunk_d`` is set, two
    chunk buffers of 256 rows x N floats; the float32 dw sums its groups' tiles in 8C x N floats. The
    ``chunked`` forward (C a chunk's 64 channels) holds the chunk's w in each stage, not once beside them."""
    bw, bh, bd = box
    rows = bw * bh * bd
    rows16 = -(-rows // 16) * 16
    kib = lambda n: -(-n // 1024) * 1024  # noqa: E731
    w_bytes = 8 * C * N * esize
    stage = (kib((bw + 1) * (bh + 1) * (bd + 1) * esize * C) + (kib(rows16 * esize * N) if dw else 0)
             + (w_bytes if chunked and not dw else 0))
    sums = 0
    if esize == 4:  # the chunked forward splits no taps
        sums = 4 * 8 * C * N if dw else 4 * rows * N if rows <= 512 and not chunked else 0
    chunks = 2 * kib(256 * 4 * N) if chunk_d else 0
    return (1024 + stages * stage + chunks + (0 if dw else (0 if chunked else w_bytes) + 4 * rows16) + 4 * rows16
            + -(-8 * stages // 16) * 16 + sums)


def _check_narrow_boxes(B, D, H, W, C, N, box, boxes, smem, dw, esize, stages=2, chunk_d=0, chunked=False):
    bw, bh, bd = box
    # the halo box (one more along each axis) within the TMA's 256 a dimension, at most 1024 rows a box,
    # an m-tile's 16 rows on one w-line unless the box spans all of W, one block an SM
    assert max(bw, bh, bd) + 1 <= 256 and bw <= W and bh <= H and bd <= D and bw * bh * bd <= 1024
    assert bw % 16 == 0 or bw == W
    # what nr::make_geom takes of the plan's choices: two stages, or three for the float32 dw and for a dw that
    # walks C in chunks; an output chunk only in the float32 forward without a tap split, 256 rows of whole d-planes, the
    # box whole chunks; the chunked forward's box within its warps' accumulators (nr::chunked_mw: 2 m-tiles a
    # warp at N = 32, 4 at N = 8 and 16)
    assert stages == 2 or (dw and stages == 3 and (esize == 4 or chunked))
    assert chunk_d == 0 or (not dw and esize == 4 and bw * bh * bd > 512 and chunk_d * bw * bh == 256
                            and bd % chunk_d == 0 and not chunked)
    # (the float32 chunked forward: its kernel's 4 rows a thread, at most 1024)
    assert not chunked or dw or -(-bw * bh * bd // 16) <= (64 if esize == 4 else 8 * (2 if N == 32 else 4))
    assert smem == _narrow_smem_of(box, C, N, dw, esize, stages, chunk_d, chunked) <= SMEM_PER_BLOCK
    # the boxes of each batch item cover every voxel of its grid once (the last along an axis ragged)
    origins = _narrow_boxes(B, D, H, W, box)
    assert len(origins) == boxes
    seen = np.zeros((D, H, W), np.int32)
    for b, d, h, w in origins[:boxes // B]:
        assert b == 0
        seen[d:d + bd, h:h + bh, w:w + bw] += 1
    assert (seen == 1).all()


def _check_narrow_walk(plan):
    """The forward: blocks i take boxes i, i + grid, ...: every box once. dw: one wave, one block an SM; runs of
    whole boxes, every box once, none empty."""
    assert 1 <= plan.grid <= min(plan.boxes, 132)
    walked = sorted(t for block in range(plan.grid) for t in range(block, plan.boxes, plan.grid))
    assert walked == list(range(plan.boxes))
    _check_narrow_dw_walk(plan)


def _check_narrow_dw_walk(plan):
    """One wave of blocks, (split, chunk) where the walk takes C in chunks; each split a run of whole boxes."""
    splits, per = plan.dw_splits, plan.dw_boxes_per_split
    assert 1 <= splits * plan.c_chunks <= 132 and (splits - 1) * per < plan.dw_boxes <= splits * per
    runs = [range(z * per, min(plan.dw_boxes, (z + 1) * per)) for z in range(splits)]
    assert all(len(r) > 0 for r in runs) and [t for r in runs for t in r] == list(range(plan.dw_boxes))


def _check_narrow_plan(B, D, H, W, C, N, plan, esize):
    """The forward's and dw's boxes, shared memory and choices, and both walks; a walk in chunks of 64
    channels where C is a bfloat16 multiple of 64 above 64, of 16 where C is a float32 multiple of 32 above
    32, its boxes holding a chunk's channels; the float32 walk in chunks is the forward's alone (no dw part)."""
    whole = 64 if esize == 2 else 32  # C above this and a multiple of it is walked in chunks
    chunk = (64 if esize == 2 else 16) if C > whole and C % whole == 0 else 0
    chunked = chunk > 0
    assert plan.c_chunks == (C // chunk if chunked else 1)
    cb = chunk if chunked else C
    _check_narrow_boxes(B, D, H, W, cb, N, plan.box, plan.boxes, plan.smem_bytes, False, esize, 2, plan.chunk_d,
                        chunked)
    if chunked and esize == 4:
        assert plan.dw_box is None and plan.dw_splits is None and plan.chunk_d == 0
        assert 1 <= plan.grid <= min(plan.boxes, 132)
        walked = sorted(t for block in range(plan.grid) for t in range(block, plan.boxes, plan.grid))
        assert walked == list(range(plan.boxes))
        return
    _check_narrow_boxes(B, D, H, W, cb, N, plan.dw_box, plan.dw_boxes, plan.dw_smem_bytes, True, esize,
                        plan.dw_stages, 0, chunked)
    _check_narrow_walk(plan)


def _check_chunked_dx_plan(B, D, H, W, C, N, plan, sms=132):
    """The chunked dx's plan: a box of 128 voxels (powers of two, w at least 8, its halo within the TMA's
    256), whose first 64 rows (w fastest) are a sub-box that tiles it in two (the two warpgroups' rows, each
    stored by one TMA box a 64-channel chunk); its shared memory (alignment room, the chunk's w' of 8N/64
    tiles of bn x 128 bytes, two staging buffers of 64 x bn bf16 a warpgroup, the halo stages of 2N-byte rows
    in whole KiB, 128 bytes of barriers) within one block; the boxes tile every item's grid once; one block
    a chunk's share of the SMs, every (box, chunk) walked once."""
    bw, bh, bd = plan.box
    sw, sh, sd = plan.sub_box
    assert bw * bh * bd == 128 and all(e & (e - 1) == 0 for e in plan.box) and bw >= 8 and max(plan.box) + 1 <= 256
    assert sw * sh * sd == 64 and (sw, sh) in ((bw, bh), (bw, bh // 2), (bw // 2, 1)) and bd % sd == 0
    assert (sh == bh or sd == 1) and (sw == bw or sh == 1)
    assert plan.bn == (128 if C % 128 == 0 else 64) and plan.chunks * plan.bn == C
    kib = lambda n: -(-n // 1024) * 1024  # noqa: E731
    halo = kib((bw + 1) * (bh + 1) * (bd + 1) * 2 * N)
    assert 2 <= plan.stages <= 4
    assert plan.smem_bytes == 1024 + (8 * N // 64) * plan.bn * 128 + 4 * plan.bn * 128 + plan.stages * halo + 128
    assert plan.smem_bytes <= SMEM_PER_BLOCK and (plan.stages == 4 or plan.smem_bytes + halo > SMEM_PER_BLOCK)
    origins = _narrow_boxes(B, D, H, W, plan.box)
    assert len(origins) == plan.boxes
    seen = np.zeros((D, H, W), np.int32)
    for b, d, h, w in origins[:plan.boxes // B]:
        seen[d:d + bd, h:h + bh, w:w + bw] += 1
    assert (seen == 1).all()
    per = plan.grid // plan.chunks
    assert plan.grid % plan.chunks == 0 and 1 <= per <= max(1, sms // plan.chunks) and per <= plan.boxes
    walked = sorted((i % plan.chunks, t) for i in range(plan.grid) for t in range(i // plan.chunks, plan.boxes, per))
    assert walked == [(k, t) for k in range(plan.chunks) for t in range(plan.boxes)]


@pytest.mark.parametrize("B,D,H,W,C,N", NARROW + CHUNKED)
def test_narrow_plan_fits_the_card_and_covers_every_row(B, D, H, W, C, N):
    """bfloat16: the narrow plan's forward and dw; where C is whole chunks of 64 (CHUNKED) or 64, also the
    chunked dx's plan (the dx of C -> N, which neither plan of the forward from N to C takes), and no chunked dx
    plan for the other shapes C takes whole (C <= 32: their dx has a narrow plan)."""
    plan = narrow_plan(B, D, H, W, C, N)
    assert plan is not None and wgmma_plan(B, D, H, W, C, N) is None
    _check_narrow_plan(B, D, H, W, C, N, plan, 2)
    dx_plan = chunked_dx_plan(B, D, H, W, C, N)
    assert (dx_plan is not None) == (plan.c_chunks > 1 or C == 64)
    if dx_plan is not None:
        assert wgmma_plan(B, D, H, W, N, C) is None and narrow_plan(B, D, H, W, N, C) is None
        _check_chunked_dx_plan(B, D, H, W, C, N, dx_plan)


# N: (the forward's box and shared memory, dw's box, stages and shared memory, dw's boxes a split)
TP_CHUNKED_PLANS = {32: ((16, 4, 4), 179_216, (16, 4, 4), 3, 217_120, 32),
                    16: ((16, 4, 4), 146_448, (16, 4, 4), 3, 192_544, 32),
                    8: ((16, 8, 4), 218_128, (16, 8, 4), 2, 216_080, 16)}
# N: the chunked dx's shared memory (8 x 4 x 4 boxes, four halo stages, chunks of 128, 33 blocks a chunk), the
# float32 forward's (16 x 8 x 8 boxes, 32 chunks of 16 channels, 128 blocks)
TP_CHUNKED_DX_SMEM = {32: 193_664, 16: 132_224, 8: 99_456}
TP_CHUNKED_F32_SMEM = {32: 220_176, 16: 203_792, 8: 195_600}


@pytest.mark.parametrize("N", [32, 16, 8])
def test_chunked_plan_of_the_tp_shard(N):
    """512 -> N at B=32 on 16^3, the flagship's last stage on one rank of a model axis of 2 (N = 32) or of 4 and
    8: C in 8 chunks of 64. The forward's box is the one of the fewest L2 bytes a row (its halo and its share of
    w, 8 x 64 x N bf16 a box) whose accumulators fit 2 m-tiles a warp at N = 32, 4 at N = 16 and 8, in two
    stages (86 KB each at N = 32); dw's takes a third stage where its box has room (16 x 4 x 4 at N = 32 and 16;
    not 16 x 8 x 4 at N = 8), 16 splits x 8 chunks, one wave of 128 blocks. dx (the forward from N to 512) has
    no narrow plan but the chunked dx's: 8 x 4 x 4 boxes (the fewest halo voxels of a 128-voxel box, 225), 4
    column chunks of 128, 33 blocks each, four halo stages. float32: the forward walks 32 chunks of 16 on
    16 x 8 x 8 boxes (the fewest L2 bytes a row among boxes of at most 1024 rows), 128 blocks, no dw part."""
    box, smem, dw_box, dw_stages, dw_smem, per_split = TP_CHUNKED_PLANS[N]
    plan = narrow_plan(32, 16, 16, 16, 512, N)
    assert plan == k2.chunked_plan(32, 16, 16, 16, 512, N) and plan.c_chunks == 8 and plan.chunk_d == 0
    assert (plan.box, plan.smem_bytes) == (box, smem)
    assert (plan.dw_box, plan.dw_stages, plan.dw_smem_bytes) == (dw_box, dw_stages, dw_smem)
    assert (plan.dw_splits, plan.dw_boxes_per_split, plan.dw_boxes) == (16, per_split, 16 * per_split)
    assert plan.grid == 132 and plan.boxes == 32 * 16**3 // (box[0] * box[1] * box[2])
    _check_narrow_plan(32, 16, 16, 16, 512, N, plan, 2)
    assert narrow_plan(32, 16, 16, 16, N, 512) is None
    dx = chunked_dx_plan(32, 16, 16, 16, 512, N)
    assert (dx.box, dx.sub_box, dx.bn, dx.chunks, dx.grid, dx.stages) == ((8, 4, 4), (8, 4, 2), 128, 4, 132, 4)
    assert dx.boxes == 1024 and dx.smem_bytes == TP_CHUNKED_DX_SMEM[N]
    _check_chunked_dx_plan(32, 16, 16, 16, 512, N, dx)
    f32 = narrow_plan(32, 16, 16, 16, 512, N, dtype=torch.float32)
    assert f32 == k2.chunked_plan(32, 16, 16, 16, 512, N, dtype=torch.float32)
    assert (f32.box, f32.boxes, f32.grid, f32.c_chunks, f32.smem_bytes) == ((16, 8, 8), 128, 128, 32,
                                                                          TP_CHUNKED_F32_SMEM[N])
    _check_narrow_plan(32, 16, 16, 16, 512, N, f32, 4)


# (B, D, H, W, C, N) of the wide forward (the chunked dx's kernel run forward: a narrow x, a wide y): the s2d(2)
# stem at the served and the train batch, a ragged grid, C = 16 and 32, N of one chunk of 64 or 128 and of three
# of 64
WIDE = [(8, 32, 32, 32, 8, 64), (32, 32, 32, 32, 8, 64), (3, 5, 6, 7, 8, 64), (2, 16, 16, 16, 16, 64),
        (2, 16, 16, 16, 32, 128), (1, 8, 8, 8, 16, 128), (2, 9, 10, 40, 32, 192)]
# and without: float32 and float16, C = 64 (wgmma_plan's), C = 24 and 4 (no narrow width), N not a multiple of
# 64 (96, 32: narrow_plan's)
WIDE_NONE = [((8, 32, 32, 32, 8, 64), torch.float32), ((8, 32, 32, 32, 8, 64), torch.float16),
             ((2, 8, 8, 8, 64, 64), torch.bfloat16), ((2, 8, 8, 8, 24, 64), torch.bfloat16),
             ((2, 8, 8, 8, 4, 64), torch.bfloat16), ((2, 8, 8, 8, 8, 96), torch.bfloat16),
             ((2, 8, 8, 8, 8, 32), torch.bfloat16)]


@pytest.mark.parametrize("B,D,H,W,C,N", WIDE)
def test_wide_plan_fits_the_card_and_covers_every_row(B, D, H, W, C, N):
    """The wide forward's plan is the chunked dx's cut with the roles of C and N swapped (x's C channels the
    narrow operand's, y's N the wide result's): a box of 128 voxels whose first 64 rows tile it, its halo of 2C-byte
    rows in whole KiB, the chunk's w of 8C/64 tiles of bn x 128 bytes, up to four stages within one block, every
    (box, chunk) walked once; and no other plan takes the shape."""
    plan = wide_plan(B, D, H, W, C, N)
    assert plan is not None and wgmma_plan(B, D, H, W, C, N) is None and narrow_plan(B, D, H, W, C, N) is None
    assert plan == k2._chunked_wide_plan(B, D, H, W, C, N, 132)
    _check_chunked_dx_plan(B, D, H, W, N, C, plan)
    for sms in (2, 7):
        _check_chunked_dx_plan(B, D, H, W, N, C, wide_plan(B, D, H, W, C, N, sms=sms), sms=sms)


@pytest.mark.parametrize("B", [8, 32])
def test_wide_plan_of_the_stem(B):
    """The s2d(2) stem's 8 -> 64 at 32^3: 8 x 4 x 4 boxes (the fewest halo voxels of a 128-voxel box, 225, in
    3600 bytes: one 4 KiB stage), one chunk of 64 columns (all of w, 8 KB, in every block), four halo stages,
    one block an SM: 58,496 bytes of shared memory."""
    plan = wide_plan(B, 32, 32, 32, 8, 64)
    assert (plan.box, plan.sub_box, plan.bn, plan.chunks, plan.grid, plan.stages) == ((8, 4, 4), (8, 4, 2), 64, 1,
                                                                                      132, 4)
    assert plan.boxes == B * 32**3 // 128 and plan.smem_bytes == 1024 + 8192 + 4 * 64 * 128 + 4 * 4096 + 128


@pytest.mark.parametrize("shape,dtype", WIDE_NONE)
def test_wide_plan_is_none_where_it_does_not_apply(shape, dtype):
    assert wide_plan(*shape, dtype=dtype) is None


@pytest.mark.parametrize("shape,dtype", NARROW_NONE)
def test_narrow_plan_is_none_where_the_kernels_do_not_apply(shape, dtype):
    assert narrow_plan(*shape, dtype=dtype) is None


# (B, D, H, W, C, N) with a dw-only narrow plan (bfloat16, C = 8 -> N = 64): the s2d(2) stem at 32^3 at the
# served and the train batch, a whole-grid box, ragged boxes along every axis
NARROW_DW = [(8, 32, 32, 32, 8, 64), (32, 32, 32, 32, 8, 64), (3, 5, 6, 7, 8, 64), (1, 33, 33, 33, 8, 64)]
# and without: float32 (its FFMA dw), float16, 8C x N past 4096 accumulators (C = 16), N outside {64} (48,
# 128), C not one TMA box (12), shapes that narrow_plan (N = 32) or wgmma_plan (C = 64) takes
NARROW_DW_NONE = [((8, 32, 32, 32, 8, 64), torch.float32), ((8, 32, 32, 32, 8, 64), torch.float16),
                  ((2, 8, 8, 8, 16, 64), torch.bfloat16), ((2, 8, 8, 8, 8, 48), torch.bfloat16),
                  ((2, 8, 8, 8, 8, 128), torch.bfloat16), ((2, 8, 8, 8, 12, 64), torch.bfloat16),
                  ((2, 8, 8, 8, 8, 32), torch.bfloat16), ((2, 8, 8, 8, 64, 64), torch.bfloat16)]


@pytest.mark.parametrize("B,D,H,W,C,N", NARROW_DW)
def test_narrow_dw_plan_fits_the_card_and_covers_every_row(B, D, H, W, C, N):
    """The stem's dw: neither wgmma_plan nor narrow_plan applies (the forward keeps FFMA, dx of 64 -> 8 its
    narrow plan); the dw-only plan's box holds x's halo and g's 128-byte rows in two stages within one block's
    shared memory (at 32^3 a 16 x 8 x 4 box: 2 x 76 KB, 158,736 bytes), every voxel in one box, every box in one
    split's run, one wave."""
    assert wgmma_plan(B, D, H, W, C, N) is None and narrow_plan(B, D, H, W, C, N) is None
    plan = narrow_dw_plan(B, D, H, W, C, N)
    assert plan is not None and plan.dw_stages == 2
    _check_narrow_boxes(B, D, H, W, C, N, plan.dw_box, plan.dw_boxes, plan.dw_smem_bytes, True, 2, plan.dw_stages)
    _check_narrow_dw_walk(plan)
    if (D, H, W) == (32, 32, 32):
        assert plan.dw_box == (16, 8, 4) and plan.dw_smem_bytes == 158_736


@pytest.mark.parametrize("shape,dtype", NARROW_DW_NONE)
def test_narrow_dw_plan_is_none_where_it_does_not_apply(shape, dtype):
    assert narrow_dw_plan(*shape, dtype=dtype) is None


@pytest.mark.parametrize("C,N", [(8, 8), (16, 8), (32, 8), (64, 8), (8, 16), (32, 16), (64, 32), (8, 64)])
def test_narrow_dw_units_cover_every_accumulator_once(C, N):
    """The bf16 dw's deal (``conv_k2_narrow_dw_kernel``): units of one m16 tile of rows (tap, c) by NW n8 tiles
    (all N/8, or 4 of N = 64's 8), ``mw`` a warp, unit u = warp + wpg m the m-tile u % (8C/16) of the column
    half warp / (8C/16): every one of the 8C x N accumulators is one warp's, a warp's units share one column
    half, and at N = 64 all 8 warps compute."""
    nt = N // 8
    nw = 4 if nt > 4 else nt
    mtiles = C // 2
    units = mtiles * (nt // nw)
    wpg = min(8, units)
    mw = units // wpg
    covered = np.zeros((8 * C, N), np.int32)
    for warp in range(wpg):
        col0 = 8 * nw * (warp // mtiles)
        for m in range(mw):
            u = warp + wpg * m
            assert u // mtiles == warp // mtiles  # one column half a warp
            covered[16 * (u % mtiles):16 * (u % mtiles) + 16, col0:col0 + 8 * nw] += 1
    assert (covered == 1).all() and mw <= (1 if nt > 4 else 4)
    assert wpg == 8 or N < 64


# (B, D, H, W, C, N) that float32 takes on the narrow kernels: NARROW's shapes whose rows are at most 128 bytes;
# and (the forward alone) those whose C is whole chunks of 32 above 32, walked in chunks of 16: CHUNKED's,
# the default DetectorConfig's 64 -> 8 at 32^3, C = 96 on a whole-grid box
NARROW_F32 = [s for s in NARROW if s[4] <= 32]
CHUNKED_F32 = CHUNKED + [(32, 32, 32, 32, 64, 8), (3, 5, 6, 7, 96, 32)]
# and without: C = 48 and 80 (rows past 128 bytes, not whole chunks of 32), N outside {8, 16, 32} (N = 64: the
# dx of 64 -> 8, a forward of 8 -> 64), C % 8 != 0, C = 24
NARROW_F32_NONE = [(2, 32, 32, 32, 48, 8), (3, 5, 6, 7, 80, 32), (32, 32, 32, 32, 32, 4), (2, 8, 8, 8, 32, 64),
                   (2, 5, 6, 7, 12, 8), (2, 5, 6, 7, 24, 16), (2, 32, 32, 32, 8, 64)]


@pytest.mark.parametrize("B,D,H,W,C,N", NARROW_F32 + CHUNKED_F32)
def test_f32_narrow_plan_fits_the_card_and_covers_every_row(B, D, H, W, C, N):
    """float32's plan: 4C-byte rows in the halo box and w of 8C x N floats in one block's shared memory (at
    32^3, C = 32, a 16 x 8 x 4 box: 2 x 98 KB of stages), every voxel in one box, every box walked once; its dw
    part: the halo box of x and the box of g (rows of 4N bytes) in three stages beside the 8C x N sum of the
    groups' tiles within the block's shared memory (at 32^3, C = 32 -> N = 8, a 16 x 4 x 4 box in 200,736
    bytes), every voxel in one box, every box in one split's run. Where C is whole chunks of 32 above 32, the
    forward alone, in chunks of 16: two stages of a chunk's halo (64-byte rows) and its w in one block's shared
    memory, at most 1024 rows a box, no dw part (dx and dw keep FFMA)."""
    plan = narrow_plan(B, D, H, W, C, N, dtype=torch.float32)
    assert plan is not None
    _check_narrow_plan(B, D, H, W, C, N, plan, 4)
    if (D, H, W, C) == (32, 32, 32, 32):
        assert plan.box == (16, 8, 4) and plan.smem_bytes > SMEM_PER_BLOCK // 2
    if (D, H, W, C, N) == (32, 32, 32, 32, 8):
        assert plan.dw_box == (16, 4, 4) and plan.dw_stages == 3 and plan.dw_smem_bytes == 200_736


@pytest.mark.parametrize("B", [32, 1024])
def test_f32_narrow_dx_plan_of_the_detector(B):
    """The detector decoder's last conv, 32 -> 8 at 32^3: its float32 dx is the forward from 8 to 32 channels,
    which has a narrow plan: a 16 x 8 x 8 box of 1024 rows (one part of the taps, 4 rows a thread) whose halo of
    8-channel rows, w' (8 x 8 x 32 floats) and two output chunks of 256 rows x 128 bytes take 173,072 bytes;
    every voxel in one box, every box walked once."""
    plan = narrow_plan(B, 32, 32, 32, 8, 32, dtype=torch.float32)
    assert plan is not None and plan.box == (16, 8, 8) and plan.smem_bytes == 107_536 + 2 * 256 * 128
    assert plan.chunk_d == 2  # two d-planes of 16 x 8 a chunk, stored through shared memory
    _check_narrow_boxes(B, 32, 32, 32, 8, 32, plan.box, plan.boxes, plan.smem_bytes, False, 4, 2, plan.chunk_d)
    _check_narrow_walk(plan)


@pytest.mark.parametrize("B,D,H,W,C,N", NARROW_F32_NONE)
def test_f32_narrow_plan_is_none_where_the_kernel_does_not_apply(B, D, H, W, C, N):
    assert narrow_plan(B, D, H, W, C, N, dtype=torch.float32) is None
    assert narrow_plan(B, D, H, W, C, N, dtype=torch.float16) is None


def _narrow_operand(x, plan_box, origin):
    """The halo box of ``x`` (B,D,H,W,ch) at ``origin`` (b, d, h, w), (bd+1, bh+1, bw+1) voxels, zeros where
    it leaves the grid, past the end or below 0 (the TMA's fill), flattened to (voxels, ch) as it lies in shared
    memory (less the swizzle)."""
    bw, bh, bd = plan_box
    b, d, h, w = origin
    _, D, H, W, ch = x.shape
    out = torch.zeros(bd, bh, bw, ch, dtype=x.dtype)
    lo = [max(0, -o) for o in (d, h, w)]
    part = x[b, d + lo[0]:max(0, d + bd), h + lo[1]:max(0, h + bh), w + lo[2]:max(0, w + bw)]
    out[lo[0]:lo[0] + part.shape[0], lo[1]:lo[1] + part.shape[1], lo[2]:lo[2] + part.shape[2]] = part
    return out.reshape(-1, ch)


def _narrow_rows(box, C):
    """The kernels' row table and tap offsets in voxels: row r of the box (w fastest) reads halo voxel
    ``vrow[r] + toff[t]`` for tap t; rows past the box, up to a multiple of 16, read voxel 0."""
    bw, bh, bd = box
    rows = bw * bh * bd
    r = torch.arange(-(-rows // 16) * 16)
    vrow = torch.where(r < rows, ((r // bw // bh) * (bh + 1) + r // bw % bh) * (bw + 1) + r % bw, 0)
    toff = [((t >> 2) * (bh + 1) + ((t >> 1) & 1)) * (bw + 1) + (t & 1) for t in range(8)]
    return vrow, toff, rows


def _narrow_a(halo, vrow, toff, C):
    """A [rows16, 8C] of a box, depth (tap, c): each 8-channel piece of a k-step read from its row's halo voxel
    shifted by the piece's tap, as the ldmatrix addresses pick it."""
    pieces = []
    for k in range(0, 8 * C, 8):
        tap, c = k // C, k % C
        pieces.append(halo[vrow + toff[tap], c:c + 8])
    return torch.cat(pieces, dim=1)


def _emulate_narrow_forward(x, w, plan, lower=0):
    """The narrow forward as its blocks walk it: block i takes boxes i, i + grid, ...; each reads its halo box
    once (``lower`` voxels below the box along d, h and w: 1 for dx), forms A from the row table and stores the
    rows that lie inside the grid. Where the plan walks C in chunks of 64, a box is ``c_chunks`` steps, each
    the halo box of the chunk's channels against the chunk's rows (tap, c) of w, summed into the box's
    accumulators before the rows are stored. Returns y and how often each output row was written."""
    B, D, H, W, C = x.shape
    N = w.shape[-1]
    bw, bh, bd = plan.box
    cc = C // plan.c_chunks
    origins = _narrow_boxes(B, D, H, W, plan.box)
    vrow, toff, rows = _narrow_rows(plan.box, cc)
    wk = [w[:, :, :, k * cc:(k + 1) * cc].reshape(8 * cc, N) for k in range(plan.c_chunks)]
    y = torch.zeros(B, D, H, W, N)
    written = torch.zeros(B, D, H, W, dtype=torch.int32)
    for block in range(plan.grid):
        for box in range(block, plan.boxes, plan.grid):
            b, d0, h0, w0 = origins[box]
            acc = 0
            for k in range(plan.c_chunks):
                halo = _narrow_operand(x[..., k * cc:(k + 1) * cc], (bw + 1, bh + 1, bd + 1),
                                       (b, d0 - lower, h0 - lower, w0 - lower))
                acc = acc + _narrow_a(halo, vrow, toff, cc) @ wk[k]
            for r in range(rows):
                d, h, ww = d0 + r // bw // bh, h0 + r // bw % bh, w0 + r % bw
                if d < D and h < H and ww < W:  # the ragged edge is not stored
                    y[b, d, h, ww] = acc[r]
                    written[b, d, h, ww] += 1
    return y, written


def _emulate_narrow_dw(x, g, plan):
    """The narrow dw as its splits walk it: split z reduces the run of boxes z * per ..., each a halo box of x
    and a box of g (zeros past the grid, and on the rows that round the box up to 16); where the plan walks C
    in chunks of 64, block (z, k) does so for chunk k's channels and writes the rows (tap, c) of its chunk in
    split z's partial; the splits' partial sums added in ascending order. Returns dw and how often each row m
    entered the sum (once a chunk)."""
    B, D, H, W, C = x.shape
    N = g.shape[-1]
    bw, bh, bd = plan.dw_box
    cc = C // plan.c_chunks
    origins = _narrow_boxes(B, D, H, W, plan.dw_box)
    vrow, toff, rows = _narrow_rows(plan.dw_box, cc)
    part = torch.zeros(plan.dw_splits, 8, C, N)
    seen = torch.zeros(B, D, H, W, dtype=torch.int64)
    for z in range(plan.dw_splits):
        for k in range(plan.c_chunks):
            for box in range(z * plan.dw_boxes_per_split, min(plan.dw_boxes, (z + 1) * plan.dw_boxes_per_split)):
                b, d0, h0, w0 = origins[box]
                halo = _narrow_operand(x[..., k * cc:(k + 1) * cc], (bw + 1, bh + 1, bd + 1), origins[box])
                gbox = torch.zeros(len(vrow), N)
                gbox[:rows] = _narrow_operand(g, plan.dw_box, origins[box])
                part[z, :, k * cc:(k + 1) * cc] += (_narrow_a(halo, vrow, toff, cc).T @ gbox).reshape(8, cc, N)
                seen[b, d0:d0 + bd, h0:h0 + bh, w0:w0 + bw] += 1
    dw = part[0].clone()
    for z in range(1, plan.dw_splits):
        dw += part[z]
    return dw.reshape(2, 2, 2, C, N), seen


# small grids: several boxes a block (the walk's stride), whole-grid boxes, a line longer than a box, ragged
# boxes along every axis; every N and every C
NARROW_EMULATED = [(3, 8, 8, 8, 8, 8), (1, 8, 8, 8, 64, 16), (3, 5, 6, 7, 32, 32), (1, 2, 2, 256, 16, 8),
                   (2, 9, 10, 40, 16, 8), (1, 33, 33, 33, 8, 16)]
# the walk in chunks of 64 channels: C = 128 and 192 at 8^3 and less, several boxes a block (3 x 8 x 8 x 16 at
# N = 32: 12 boxes of 16 x 4 x 4), a whole-grid box, every N
CHUNKED_EMULATED = [(2, 8, 8, 8, 128, 8), (3, 8, 8, 16, 128, 32), (1, 5, 6, 7, 192, 16)]
# the float32 forward's walk in chunks of 16: C = 64, 96 and 128, a whole-grid box, several boxes a block
CHUNKED_F32_EMULATED = [(2, 8, 8, 8, 64, 8), (3, 8, 8, 16, 128, 32), (1, 5, 6, 7, 96, 16)]
FORWARD_EMULATED = ([pytest.param(*s, torch.bfloat16, id="-".join(map(str, s)))
                     for s in NARROW_EMULATED + CHUNKED_EMULATED]
                    + [pytest.param(*s, torch.float32, id="-".join(map(str, s)) + "-f32")
                       for s in CHUNKED_F32_EMULATED])


@pytest.mark.parametrize("B,D,H,W,C,N,dtype", FORWARD_EMULATED)
def test_narrow_halo_reads_give_the_forward(B, D, H, W, C, N, dtype):
    """The halo box zero-filled past the grid is SAME padding (0, 1), and the row table with the taps' offsets
    gathers every shifted row: the emulated walk writes every output once and equals the plain version and
    ``conv_k2_xla`` (f32, summation order only: 1e-5 of the largest output), as does the port's op on the CPU.
    Where the plan walks C in chunks (of 64 in bfloat16, of 16 in float32), each box sums its chunks'
    products."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, D, H, W, C)).astype(np.float32)
    w = (rng.normal(size=(2, 2, 2, C, N)) * 0.05).astype(np.float32)
    plan = narrow_plan(B, D, H, W, C, N, sms=2, dtype=dtype)  # 2 blocks: each walks several boxes where there are
    assert plan.c_chunks == (C // 16 if dtype == torch.float32 else max(1, C // 64))
    y, written = _emulate_narrow_forward(torch.from_numpy(x), torch.from_numpy(w), plan)
    assert (written == 1).all()
    ref = conv_k2_reference(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    tol = 1e-5 * float(np.abs(ref).max())
    np.testing.assert_allclose(y.numpy(), ref, atol=tol, rtol=0)
    jax_y = np.asarray(conv_k2_xla(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(y.numpy(), jax_y, atol=tol, rtol=0)
    np.testing.assert_allclose(conv_k2(torch.from_numpy(x), torch.from_numpy(w)).numpy(), jax_y, atol=tol, rtol=0)


@pytest.mark.parametrize("B,D,H,W,C,N", NARROW_EMULATED + [(1, 32, 32, 32, 8, 64), (3, 5, 6, 7, 8, 64)]
                         + CHUNKED_EMULATED)
def test_narrow_halo_reads_give_dw(B, D, H, W, C, N):
    """The emulated dw walk (halo boxes of x, boxes of g, splits summed in order) reduces every row once (once
    a chunk where the plan walks C in chunks, each block a chunk's rows of its split) and equals
    ``conv_k2_dw_reference`` and ``_conv_k2_bwd_impl``'s dw: f32, summation order only, 1e-5 of the largest
    entry. The s2d(2) stem's 8 -> 64 at 32^3 (and a whole-grid box) walks the dw-only plan's boxes."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(B, D, H, W, C)).astype(np.float32)
    g = rng.normal(size=(B, D, H, W, N)).astype(np.float32)
    sms = 2 * max(1, C // 64)  # 2 splits (of every chunk): each a run of several boxes where there are
    plan = narrow_plan(B, D, H, W, C, N, sms=sms) or narrow_dw_plan(B, D, H, W, C, N, sms=sms)
    dw, seen = _emulate_narrow_dw(torch.from_numpy(x), torch.from_numpy(g), plan)
    assert (seen == plan.c_chunks).all()
    ref = conv_k2_dw_reference(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    tol = 1e-5 * float(np.abs(ref).max())
    np.testing.assert_allclose(dw.numpy(), ref, atol=tol, rtol=0)
    w = np.zeros((2, 2, 2, C, N), np.float32)
    jax_dw = np.asarray(_conv_k2_bwd_impl(jnp.asarray(x), jnp.asarray(w), jnp.asarray(g))[1])
    np.testing.assert_allclose(dw.numpy(), jax_dw, atol=tol, rtol=0)


def _emulate_narrow_dw_f32(x, g, plan):
    """The float32 narrow dw as its blocks walk it: split z reduces its run of boxes (a halo box of x and a box
    of g each); in a box, group q of the block's 256 threads takes rows q, q + groups, ..., and the thread of
    tile (tap t, channels 8 cg.., outputs 8 og..) adds those rows' products to its 8 x 8 accumulators; after
    the run the groups' tiles are summed in ascending order, then the splits' partials. Returns dw, how often
    each row m entered the sum, and how often each (tap, c, n) was some tile's."""
    B, D, H, W, C = x.shape
    N = g.shape[-1]
    bw, bh, bd = plan.dw_box
    tiles = C * N // 8
    groups = 256 // tiles
    tile_of = [(i // (N // 8) // (C // 8), i // (N // 8) % (C // 8), i % (N // 8)) for i in range(tiles)]
    covered = torch.zeros(8, C, N, dtype=torch.int32)
    for t, cg, og in tile_of:
        covered[t, 8 * cg:8 * cg + 8, 8 * og:8 * og + 8] += 1
    origins = _narrow_boxes(B, D, H, W, plan.dw_box)
    vrow, toff, rows = _narrow_rows(plan.dw_box, C)
    part = torch.zeros(plan.dw_splits, 8 * C, N)
    seen = torch.zeros(B, D, H, W, dtype=torch.int64)
    for z in range(plan.dw_splits):
        acc = torch.zeros(groups, tiles, 8, 8)
        for box in range(z * plan.dw_boxes_per_split, min(plan.dw_boxes, (z + 1) * plan.dw_boxes_per_split)):
            b, d0, h0, w0 = origins[box]
            a = _narrow_a(_narrow_operand(x, (bw + 1, bh + 1, bd + 1), origins[box]), vrow, toff, C)[:rows]
            gbox = _narrow_operand(g, plan.dw_box, origins[box])
            for q in range(groups):
                for i, (t, cg, og) in enumerate(tile_of):
                    col = t * C + 8 * cg
                    acc[q, i] += a[q::groups, col:col + 8].T @ gbox[q::groups, 8 * og:8 * og + 8]
            seen[b, d0:d0 + bd, h0:h0 + bh, w0:w0 + bw] += 1
        total = acc[0].clone()
        for q in range(1, groups):
            total += acc[q]
        for i, (t, cg, og) in enumerate(tile_of):
            part[z, t * C + 8 * cg:t * C + 8 * cg + 8, 8 * og:8 * og + 8] = total[i]
    dw = part[0].clone()
    for z in range(1, plan.dw_splits):
        dw += part[z]
    return dw.reshape(2, 2, 2, C, N), seen, covered


@pytest.mark.parametrize("B,D,H,W,C,N", [s for s in NARROW_EMULATED if s[4] <= 32] + [(2, 8, 8, 8, 32, 8)])
def test_f32_narrow_dw_groups_give_dw(B, D, H, W, C, N):
    """The float32 dw's walk: its tiles cover every (tap, c, n) once, its groups and splits reduce every row
    once, and the tiles summed group by group, then split by split, equal ``conv_k2_dw_reference`` and
    ``_conv_k2_bwd_impl``'s dw (f32, summation order only: 1e-5 of the largest entry). The detector's pairing
    (32 -> 8: one warp a group, 8 groups) at a small grid."""
    rng = np.random.default_rng(10)
    x = rng.normal(size=(B, D, H, W, C)).astype(np.float32)
    g = rng.normal(size=(B, D, H, W, N)).astype(np.float32)
    plan = narrow_plan(B, D, H, W, C, N, sms=2, dtype=torch.float32)  # 2 splits, each a run of several boxes
    dw, seen, covered = _emulate_narrow_dw_f32(torch.from_numpy(x), torch.from_numpy(g), plan)
    assert (covered == 1).all() and (seen == 1).all()
    ref = conv_k2_dw_reference(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    tol = 1e-5 * float(np.abs(ref).max())
    np.testing.assert_allclose(dw.numpy(), ref, atol=tol, rtol=0)
    jax_dw = np.asarray(_conv_k2_bwd_impl(jnp.asarray(x), jnp.zeros((2, 2, 2, C, N)), jnp.asarray(g))[1])
    np.testing.assert_allclose(dw.numpy(), jax_dw, atol=tol, rtol=0)


# NARROW_EMULATED's shapes whose dx has a narrow plan (the forward from N to C channels), and the detector's
# pairing at a small grid: dx of 32 -> 8 is a forward of 8 -> 32; in bfloat16, then in float32 (N <= 32)
NARROW_DX_EMULATED = [s for s in NARROW_EMULATED if narrow_plan(*s[:4], s[5], s[4]) is not None] + [
    (2, 8, 8, 8, 32, 8)]
NARROW_DX_CASES = ([pytest.param(*s, torch.bfloat16, id="-".join(map(str, s))) for s in NARROW_DX_EMULATED]
                   + [pytest.param(*s, torch.float32, id="-".join(map(str, s)) + "-f32") for s in NARROW_DX_EMULATED
                      if narrow_plan(*s[:4], s[5], s[4], dtype=torch.float32) is not None])


def _emulate_chunked(src, w, plan, forward=False):
    """The chunked dx (or, ``forward``, the wide forward: the same kernel run forward) as its blocks walk it:
    block i holds column chunk i % chunks of w laid out as the wrapper lays it out, [wide, 8 narrow] (dx:
    wt[c, t N + n] = w[t, c, n]; forward: wt[n, t C + c] = w[t, c, n]), and walks boxes i // chunks, + grid //
    chunks, ...; each box's halo of the narrow operand (dx: g one voxel lower; forward: x at the box; zeros
    below 0 and past the grid) gives its 128 rows' A, each 8-channel piece of a k-step from the row's voxel
    shifted by the piece's tap (dx: mirrored, w'[s] = w[7 - s]^T; forward: the tap itself, as the ldmatrix
    addresses pick it), against the chunk's columns; warpgroup j's 64 rows (box rows 64 j ..) land as the TMA
    store lays them: row r of the sub-box (w fastest) at the sub-box's origin in the box (row 64 j's voxel),
    clipped at the grid. Returns the result and how often each (voxel, chunk) was written."""
    B, D, H, W, narrow = src.shape
    wide = w.shape[4] if forward else w.shape[3]
    bw, bh, bd = plan.box
    sw, sh, sd = plan.sub_box
    C, N = (narrow, wide) if forward else (wide, narrow)
    wt = w.reshape(8, C, N).permute(*((2, 0, 1) if forward else (1, 0, 2))).reshape(wide, 8 * narrow)
    lower = 0 if forward else 1
    origins = _narrow_boxes(B, D, H, W, plan.box)
    vrow, toff, rows = _narrow_rows(plan.box, narrow)
    assert rows == len(vrow) == 128
    per = plan.grid // plan.chunks
    out = torch.zeros(B, D, H, W, wide)
    written = torch.zeros(B, D, H, W, plan.chunks, dtype=torch.int32)
    for block in range(plan.grid):
        k = block % plan.chunks
        cols = slice(k * plan.bn, (k + 1) * plan.bn)
        for box in range(block // plan.chunks, plan.boxes, per):
            b, d0, h0, w0 = origins[box]
            halo = _narrow_operand(src, (bw + 1, bh + 1, bd + 1), (b, d0 - lower, h0 - lower, w0 - lower))
            tile = _narrow_a(halo, vrow, toff if forward else toff[::-1], narrow) @ wt[cols].T
            for j in range(2):
                ow, oh, od = 64 * j % bw, 64 * j // bw % bh, 64 * j // (bw * bh)
                for r in range(64):
                    d, h, ww = d0 + od + r // (sw * sh), h0 + oh + r // sw % sh, w0 + ow + r % sw
                    if d < D and h < H and ww < W:  # the TMA clips the ragged edge
                        out[b, d, h, ww, cols] = tile[64 * j + r]
                        written[b, d, h, ww, k] += 1
    return out, written


# the chunked dx: C = 128 (one column chunk of 128, two blocks of it) and 192 (three chunks of 64), several
# boxes a block, boxes past the grid (5 x 6 x 7), every N
CHUNKED_DX_EMULATED = CHUNKED_EMULATED + [(2, 8, 8, 8, 128, 16), (2, 8, 8, 8, 64, 8), (1, 5, 6, 7, 64, 32)]


@pytest.mark.parametrize("B,D,H,W,C,N", CHUNKED_DX_EMULATED)
def test_chunked_dx_halo_reads_give_dx(B, D, H, W, C, N):
    """The chunked dx's walk (``conv_k2_chunked_dx_kernel``): halo boxes of g one voxel lower (the zeros below
    0 are the low-edge mask), A from the row table at the mirrored taps, reused for every column of the block's
    chunk, the two
    warpgroups' sub-boxes stored clipped at the grid. The emulated walk writes every (voxel, chunk) of dx
    once and equals ``conv_k2_dx_reference`` and ``_conv_k2_bwd_impl``'s dx (f32, summation order only: 1e-5
    of the largest entry); the port's ``conv_k2_dx`` on the CPU equals JAX's at these shapes too."""
    rng = np.random.default_rng(11)
    g = rng.normal(size=(B, D, H, W, N)).astype(np.float32)
    w = (rng.normal(size=(2, 2, 2, C, N)) * 0.05).astype(np.float32)
    plan = chunked_dx_plan(B, D, H, W, C, N, sms=2)  # few blocks: each walks several boxes where there are
    dx, written = _emulate_chunked(torch.from_numpy(g), torch.from_numpy(w), plan)
    assert (written == 1).all()
    ref = conv_k2_dx_reference(torch.from_numpy(g), torch.from_numpy(w)).numpy()
    tol = 1e-5 * float(np.abs(ref).max())
    np.testing.assert_allclose(dx.numpy(), ref, atol=tol, rtol=0)
    x = np.zeros((B, D, H, W, C), np.float32)
    jax_dx = np.asarray(_conv_k2_bwd_impl(jnp.asarray(x), jnp.asarray(w), jnp.asarray(g))[0])
    np.testing.assert_allclose(dx.numpy(), jax_dx, atol=tol, rtol=0)
    np.testing.assert_allclose(conv_k2_dx(torch.from_numpy(g), torch.from_numpy(w)).numpy(), jax_dx, atol=tol, rtol=0)


# the wide forward: the stem's 8 -> 64 on a small grid and a ragged one, C = 16 and 32, N in one chunk of 128 or
# three of 64, several boxes a block
WIDE_EMULATED = [(2, 8, 8, 8, 8, 64), (1, 5, 6, 7, 8, 64), (2, 4, 8, 16, 16, 128), (1, 9, 10, 11, 32, 192)]


@pytest.mark.parametrize("B,D,H,W,C,N", WIDE_EMULATED)
def test_wide_forward_halo_reads_give_the_forward(B, D, H, W, C, N):
    """The wide forward's walk (``conv_k2_chunked_dx_kernel`` run forward): halo boxes of x at the box's origin,
    one voxel higher (the zeros past the grid are the high pad), A from the row table at the unmirrored taps,
    reused for every column of the block's chunk, the two warpgroups' sub-boxes stored clipped at the grid. The
    emulated walk writes every (voxel, chunk) of y once and equals ``conv_k2_reference`` and ``conv_k2_xla`` (f32,
    summation order only: 1e-5 of the largest entry)."""
    rng = np.random.default_rng(13)
    x = rng.normal(size=(B, D, H, W, C)).astype(np.float32)
    w = (rng.normal(size=(2, 2, 2, C, N)) * 0.05).astype(np.float32)
    plan = wide_plan(B, D, H, W, C, N, sms=2)  # few blocks: each walks several boxes where there are
    y, written = _emulate_chunked(torch.from_numpy(x), torch.from_numpy(w), plan, forward=True)
    assert (written == 1).all()
    ref = conv_k2_reference(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    tol = 1e-5 * float(np.abs(ref).max())
    np.testing.assert_allclose(y.numpy(), ref, atol=tol, rtol=0)
    np.testing.assert_allclose(y.numpy(), np.asarray(conv_k2_xla(jnp.asarray(x), jnp.asarray(w))), atol=tol, rtol=0)


@pytest.mark.parametrize("B,D,H,W,C,N,dtype", NARROW_DX_CASES)
def test_narrow_mirrored_halo_reads_give_dx(B, D, H, W, C, N, dtype):
    """dx as the narrow kernel's DX instance walks it (bfloat16's and float32's, each at the plan of its
    dtype): the forward from N to C channels over g, with the halo box one voxel lower (zeros below 0, the
    low-edge mask) and w'[s] = w[7 - s]^T, each bit of the tap flipped. The emulated walk writes every dx row
    once and equals ``conv_k2_dx_reference`` and ``_conv_k2_bwd_impl``'s dx: f32, summation order only, 1e-5 of
    the largest entry."""
    rng = np.random.default_rng(9)
    g = rng.normal(size=(B, D, H, W, N)).astype(np.float32)
    w = (rng.normal(size=(2, 2, 2, C, N)) * 0.05).astype(np.float32)
    plan = narrow_plan(B, D, H, W, N, C, sms=2, dtype=dtype)  # the route's plan: 2 blocks, each walks several boxes
    wm = torch.from_numpy(w).flip(0, 1, 2).transpose(3, 4)  # (2, 2, 2, N, C), as the wrapper lays it out
    dx, written = _emulate_narrow_forward(torch.from_numpy(g), wm, plan, lower=1)
    assert (written == 1).all()
    ref = conv_k2_dx_reference(torch.from_numpy(g), torch.from_numpy(w)).numpy()
    tol = 1e-5 * float(np.abs(ref).max())
    np.testing.assert_allclose(dx.numpy(), ref, atol=tol, rtol=0)
    x = np.zeros((B, D, H, W, C), np.float32)
    jax_dx = np.asarray(_conv_k2_bwd_impl(jnp.asarray(x), jnp.asarray(w), jnp.asarray(g))[0])
    np.testing.assert_allclose(dx.numpy(), jax_dx, atol=tol, rtol=0)


@pytest.mark.parametrize("row_bytes", [16, 32, 64, 128])
def test_swizzled_rows_of_an_ldmatrix_fall_in_distinct_banks(row_bytes):
    """The narrow kernels' ``swizzle`` (the TMA's of a row's width: its 16-byte pieces XOR bits 7.. of the
    offset) keeps each piece in its row, and puts the same piece of any 8 consecutive rows (an ldmatrix
    phase, from any first row: a tap moves it by one) into 8 different 16-byte groups of the 32 banks."""
    mask = row_bytes // 16 - 1

    def swizzle(off):
        return off ^ (((off >> 7) & mask) << 4)

    for first in range(64):
        for piece in range(row_bytes // 16):
            offs = [swizzle(v * row_bytes + 16 * piece) for v in range(first, first + 8)]
            assert all(o // row_bytes == v for o, v in zip(offs, range(first, first + 8)))
            assert len({o % 128 // 16 for o in offs}) == 8


@pytest.mark.parametrize("C", [8, 16, 32])
def test_swizzled_f32_rows_read_as_float4_fall_in_distinct_banks(C):
    """The float32 forward's rows of 4C bytes (32, 64, 128) under the TMA's swizzle of that width: the kernel
    addresses piece c4 of a row as rb + (16 c4 ^ key), key from the row's start alone, which is the swizzle of
    rb + 16 c4 (a piece never carries into bit 7); 8 lanes reading one piece of 8 consecutive voxels (a float4
    phase, from any voxel) hit 8 different 16-byte bank groups."""
    row_bytes = 4 * C
    mask = row_bytes // 16 - 1

    def swizzle(off):
        return off ^ (((off >> 7) & mask) << 4)

    for first in range(64):
        for piece in range(row_bytes // 16):
            offs = []
            for v in range(first, first + 8):
                rb = v * row_bytes
                key = ((rb >> 7) & mask) << 4
                offs.append(rb + ((piece << 4) ^ key))
                assert offs[-1] == swizzle(rb + 16 * piece) and offs[-1] // row_bytes == v
            assert len({o % 128 // 16 for o in offs}) == 8


class _FakeLib:
    """Stands in for the built library on the CPU: records each entry point's arguments, returns 0; of the
    narrow dx also the bytes of w' ([8N, C] of the dtype whose code it is given), of the chunked dx those of
    its w ([C, 8N] bfloat16), of the wide forward those of its w ([N, 8C] bfloat16), as the launch is given
    them."""

    def __init__(self):
        self.calls = []
        self.wm = None
        self.wt = None

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            if name == "conv_k2_backward_input_narrow":
                C, N, dtype = args[7], args[8], args[15]
                self.wm = ctypes.string_at(args[1], 8 * N * C * (4 if dtype == 0 else 2))
            if name == "conv_k2_backward_input_chunked":
                C, N = args[7], args[8]
                self.wm = ctypes.string_at(args[1], 8 * N * C * 2)
            if name == "conv_k2_forward_wide":
                C, N = args[7], args[8]
                self.wt = ctypes.string_at(args[1], 8 * C * N * 2)
            return 0

        return entry


@pytest.fixture
def routes(monkeypatch):
    """The CUDA launchers run on CPU tensors against a fake library: which entry point each call takes."""
    lib = _FakeLib()
    monkeypatch.setattr(k2, "_lib", lambda: lib)
    monkeypatch.setattr(k2, "_check_cuda_operand", lambda *a: None)
    monkeypatch.setattr(k2, "_sms", lambda t: 132)
    monkeypatch.setattr(k2, "_stream", lambda t: 0)
    return lib


# (B, D, H, W, C, N, dtype, forward, dx, dw): the entry points each kernel takes ("/split": with the plan's
# depth split, the entry then launching the reduce too). The detector's 32 -> 8, bf16 and float32: all three
# narrow (dx by the plan of 8 -> 32); bf16 64 -> 8: the forward and dw narrow, dx (8 -> 64 has no narrow plan)
# the chunked dx, whose plan takes C = 64; float32 64 -> 8 (256-byte rows, and 8 -> 64): all FFMA, the
# forward's 32 stages in 2 splits (8^3: its 8 tiles leave the card idle), dw on the tile of 32 columns; bf16
# with a plan: all three wgmma, at 4^3 (mid_blocked) the forward and dx with their split and dw on the
# persistent kernel, at 16^3 and B=4 (the lifecycle's) without either, at 8^3 and N = 64 dw on the grid
# kernel; float32 at 4^3: FFMA, the forward and dx split; the s2d(2) stem 8 -> 64: the forward on the wide
# plan (the chunked dx's kernel run forward) in bf16, FFMA in float32, dx narrow (64 -> 8), dw on the dw-only
# narrow plan in bf16, on the FFMA tile of 64 rows in float32; bf16 with C a multiple of 64 above 64 and N <=
# 32 (the tensor-parallel shard 512 -> 32, 128 -> 8, and 192 -> 16, whose dx takes column chunks of 64): the
# forward and dw walk C in chunks, dx (the forward from N to C, which neither plan of that forward takes) the
# chunked dx; float32 with C a multiple of 32 above 32 and N <= 32 (512 -> 32, 64 -> 8): the forward walks C
# in chunks of 16, dx FFMA, dw FFMA on the tile of 32 columns; 8 -> 128 in bf16, whose forward takes the wide
# plan and whose dx would be the chunked forward from 128 to 8 but keeps the FFMA kernel (dw FFMA on the tile
# of 64 rows, 8C = 64); and 16 -> 64 in bf16: the forward wide, dx (64 -> 16) narrow, dw FFMA on the 128 x 64
# tile (8C = 128; 8C x N past the dw-only plan's accumulators)
ROUTES = [(4, 16, 16, 16, 512, 32, torch.bfloat16, "forward_chunked", "backward_input_chunked",
           "backward_weight_narrow"),
          (2, 8, 8, 8, 128, 8, torch.bfloat16, "forward_chunked", "backward_input_chunked", "backward_weight_narrow"),
          (1, 5, 6, 7, 192, 16, torch.bfloat16, "forward_chunked", "backward_input_chunked",
           "backward_weight_narrow"),
          (4, 16, 16, 16, 512, 32, torch.float32, "forward_chunked", "backward_input", "backward_weight"),
          (2, 16, 16, 16, 8, 128, torch.bfloat16, "forward_wide", "backward_input", "backward_weight"),
          (2, 8, 8, 8, 16, 64, torch.bfloat16, "forward_wide", "backward_input_narrow", "backward_weight"),
          (2, 8, 8, 8, 32, 8, torch.bfloat16, "forward_narrow", "backward_input_narrow", "backward_weight_narrow"),
          (2, 8, 8, 8, 32, 8, torch.float32, "forward_narrow", "backward_input_narrow", "backward_weight_narrow"),
          (2, 8, 8, 8, 64, 8, torch.bfloat16, "forward_narrow", "backward_input_chunked", "backward_weight_narrow"),
          (2, 8, 8, 8, 64, 8, torch.float32, "forward_chunked", "backward_input", "backward_weight"),
          (1, 8, 8, 8, 64, 64, torch.bfloat16, "forward_wgmma", "backward_input_wgmma", "backward_weight_wgmma"),
          (8, 4, 4, 4, 2048, 512, torch.bfloat16, "forward_wgmma/split", "backward_input_wgmma/split",
           "backward_weight_persistent"),
          (32, 4, 4, 4, 512, 2048, torch.bfloat16, "forward_wgmma", "backward_input_wgmma/split",
           "backward_weight_persistent"),
          (8, 4, 4, 4, 2048, 512, torch.float32, "forward/split", "backward_input/split", "backward_weight"),
          (4, 16, 16, 16, 512, 128, torch.bfloat16, "forward_wgmma", "backward_input_wgmma", "backward_weight_wgmma"),
          (1, 32, 32, 32, 8, 64, torch.bfloat16, "forward_wide", "backward_input_narrow", "backward_weight_narrow"),
          (1, 32, 32, 32, 8, 64, torch.float32, "forward", "backward_input", "backward_weight")]
_COUNTERS = ("launches_narrow", "launches_dx_narrow", "launches_dw_narrow", "launches_split", "launches_dx_split",
             "launches_dw_wide", "launches_ffma_split", "launches_dx_ffma_split", "launches_dw_persistent",
             "launches_chunked", "launches_dw_chunked", "launches_dx_chunked", "launches_chunked_f32", "launches_wide",
             "launches_dw_ffma_fit")


@pytest.mark.parametrize("B,D,H,W,C,N,dtype,fwd,dx,dw", ROUTES)
def test_each_kernel_takes_its_route(routes, B, D, H, W, C, N, dtype, fwd, dx, dw):
    """The launchers' choice, from shape and dtype alone: the narrow forward with the plan of its dtype and the
    dtype's code; the narrow dx with the plan of the forward from N to C, ``narrow_plan(B, D, H, W, N, C)`` of
    its dtype, and w'[s] = w[7 - s]^T laid out as (2, 2, 2, N, C); the narrow dw with the plan's dw part (or the
    dw-only plan's, or the chunked plan's) and the dtype's code; the chunked forward with its plan's box, grid,
    shared memory and the dtype's code; the chunked dx with its plan's box, chunk width, stages, grid and
    shared memory, and w laid out as [C, 8N], wt[c, t N + n] = w[t, c, n]; the wide forward with its plan's box,
    chunk width, stages, grid and shared memory, and w laid out as [N, 8C], wt[n, t C + c] = w[t, c, n]; the
    tensor-core forward and dx with their plan's tiles and splits, and
    where it splits a workspace for its partials; the FFMA forward and dx with ``ffma_split``'s (dx: of the
    forward from N to C) and likewise a workspace; the FFMA dw with ``ffma_dw_split``'s splits of its dtype;
    the persistent dw with its plan; the counters of the route taken."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(B, D, H, W, C, generator=gen).to(dtype)
    w = torch.randn(2, 2, 2, C, N, generator=gen)
    g = torch.randn(B, D, H, W, N, generator=gen).to(dtype)
    before = [getattr(conv_k2, c) for c in _COUNTERS]
    k2._launch_forward(x, w), k2._launch_dx(g, w), k2._launch_dw(x, g)
    assert [name for name, _ in routes.calls] == [f"conv_k2_{route.split('/')[0]}" for route in (fwd, dx, dw)]
    moved = [getattr(conv_k2, c) - b for c, b in zip(_COUNTERS, before)]
    wide = dw == "backward_weight_narrow" and N == 64
    chunked = fwd == "forward_chunked"
    dx_chunked = dx == "backward_input_chunked"
    wg_split, ffma_split = [[int(r.endswith("/split") and ("wgmma" in r) == tc) for r in (fwd, dx)] for tc in (1, 0)]
    assert moved == [int(fwd.endswith(("narrow", "chunked"))), int(dx.endswith(("narrow", "chunked"))),
                     int(dw.endswith("narrow")), *wg_split, int(wide), *ffma_split,
                     int(dw == "backward_weight_persistent"), int(chunked),
                     int(chunked and dw == "backward_weight_narrow"), int(dx_chunked),
                     int(chunked and dtype == torch.float32), int(fwd == "forward_wide"),
                     int(dw == "backward_weight" and ffma_dw_fitted(C, N))]
    fargs = routes.calls[0][1]
    dargs = next(a for name, a in routes.calls if name.startswith("conv_k2_backward_input"))
    code = k2._DTYPE_CODES[dtype]
    for kernel, args, plan_cn in (("forward", fargs, (C, N)), ("dx", dargs, (N, C))):
        route = fwd if kernel == "forward" else dx
        if route.startswith(("forward_wgmma", "backward_input_wgmma")):
            plan = wgmma_plan(B, D, H, W, *plan_cn)
            assert args[4:] == (B, D, H, W, C, N, *plan.box, plan.box_items, plan.bm, plan.bn, plan.stages, plan.grid,
                                plan.smem_bytes, plan.tiles, plan.splits, plan.stages_per_split, None, 0)
            assert (plan.splits > 1) == route.endswith("/split") == (args[3] != 0)  # the partials' workspace
        if route.split("/")[0] in ("forward", "backward_input"):
            splits, per_split = k2.ffma_split(B, D, H, W, *plan_cn)
            assert args[4:] == (splits, per_split, B, D, H, W, C, N, code, None, 0)
            assert (splits > 1) == route.endswith("/split") == (args[3] != 0)
    (_, wargs) = routes.calls[-1]
    if fwd == "forward_narrow":
        plan = narrow_plan(B, D, H, W, C, N, dtype=dtype)
        assert fargs[3:] == (B, D, H, W, C, N, *plan.box, plan.grid, plan.smem_bytes, plan.chunk_d, code, None, 0)
    if chunked:
        plan = narrow_plan(B, D, H, W, C, N, dtype=dtype)
        assert plan.c_chunks == C // (16 if dtype == torch.float32 else 64)
        assert narrow_plan(B, D, H, W, N, C, dtype=dtype) is None
        assert fargs[3:] == (B, D, H, W, C, N, *plan.box, plan.grid, plan.smem_bytes, code, None, 0)
    if dx_chunked:
        plan = chunked_dx_plan(B, D, H, W, C, N)
        assert dargs[3:] == (B, D, H, W, C, N, *plan.box, plan.bn, plan.stages, plan.grid, plan.smem_bytes, None, 0)
        wt = w.to(dtype).reshape(8, C, N).permute(1, 0, 2).reshape(C, 8 * N)
        assert torch.equal(torch.frombuffer(bytearray(routes.wm), dtype=dtype).reshape(C, 8 * N), wt)
    if fwd == "forward_wide":
        plan = wide_plan(B, D, H, W, C, N)
        assert fargs[3:] == (B, D, H, W, C, N, *plan.box, plan.bn, plan.stages, plan.grid, plan.smem_bytes, None, 0)
        wt = w.to(dtype).reshape(8, C, N).permute(2, 0, 1).reshape(N, 8 * C)
        assert torch.equal(torch.frombuffer(bytearray(routes.wt), dtype=dtype).reshape(N, 8 * C), wt)
    if dw == "backward_weight":
        assert wargs[4:6] == ffma_dw_split(B * D * H * W, C, N, dtype=dtype)
    if (C, N) == (8, 128):  # dx's plan, the forward from 128 to 8, walks in chunks: not dx's route
        assert narrow_plan(B, D, H, W, N, C, dtype=dtype).c_chunks == 2
    if dw == "backward_weight_persistent":
        plan = wgmma_plan(B, D, H, W, C, N)
        walk = plan.dw_persistent
        assert wargs[4:] == (B, D, H, W, C, N, *plan.dw_box, plan.dw_box_items, walk.bn, walk.stages, walk.grid,
                             walk.smem_bytes, walk.tiles, walk.splits, walk.stages_per_split, None, 0)
    if dw == "backward_weight_narrow":
        plan = narrow_plan(B, D, H, W, C, N, dtype=dtype) or narrow_dw_plan(B, D, H, W, C, N, dtype=dtype)
        assert wargs[4:] == (plan.dw_splits, plan.dw_boxes_per_split, B, D, H, W, C, N, *plan.dw_box,
                             plan.dw_smem_bytes, plan.dw_stages, code, None, 0)
    if dx == "backward_input_narrow":
        plan = narrow_plan(B, D, H, W, N, C, dtype=dtype)
        assert dargs[3:] == (B, D, H, W, C, N, *plan.box, plan.grid, plan.smem_bytes, plan.chunk_d, code, None, 0)
        # w' lies as w flipped in every tap bit, each tap transposed
        wm = w.to(dtype).flip(0, 1, 2).transpose(3, 4).contiguous()
        assert torch.equal(torch.frombuffer(bytearray(routes.wm), dtype=dtype).reshape(wm.shape), wm)


# ---- the FFMA dw: its splits and its loaders' walk ----

# (B, D, H, W, C, N): the flagship stages at the served and the train batch, and
# small shapes: ragged grids, 8C < 128, 8C not a multiple of 128, N <= 64 and
# N % 128 != 0, a grid smaller than a stage, few rows (one split) and many; the
# tiles fitted to a narrow side at full size: the tensor-parallel shard 512 ->
# 32 at B=32 and the s2d(2) stem's 8 -> 64 at 32^3, B=8 and B=32
FFMA_DW_SPLIT = ([(B, 16, 16, 16, C, N) for B in (8, 32) for C, N in FLAGSHIP_K2]
                 + [(2, 5, 6, 7, 8, 16), (2, 5, 6, 7, 136, 8), (1, 4, 4, 4, 64, 200), (2, 9, 10, 11, 24, 68),
                    (1, 16, 16, 16, 136, 96), (3, 2, 2, 2, 8, 4), (4, 16, 16, 16, 512, 40), (1, 1, 1, 1, 8, 4)]
                 + [(32, 16, 16, 16, 512, 32), (8, 32, 32, 32, 8, 64), (32, 32, 32, 32, 8, 64)])


def _expected_dw_tile(C, N, dtype):
    """(rows, columns, blocks an SM) of the FFMA dw's tile as ``csrc/conv_k2.cu::launch_dw`` picks it: 128 x 32 on
    64 threads where N <= 32 (seven blocks of three 10 KiB float32 stages and 1 KiB each fit an SM's 228 KiB;
    eight, by registers, in bfloat16), 64 x 64 on 64 threads where 8C <= 64 (eight), else the forward's: 128 x 64
    (four) where N <= 64, 128 x 128 (two)."""
    if N <= 32:
        return 128, 32, 7 if dtype == torch.float32 else 8
    if 8 * C <= 64:
        return 64, 64, 8
    return (128, 64, 4) if N <= 64 else (128, 128, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,N", sorted({(C, N) for _, _, _, _, C, N in FFMA_DW_SPLIT}))
def test_ffma_dw_tile_of_each_dtype(C, N, dtype):
    """The tile ``ffma_dw_split`` counts with is the one ``launch_dw`` picks, its blocks an SM those that fit."""
    assert k2._ffma_dw_tile(C, N, torch.empty((), dtype=dtype).element_size()) == _expected_dw_tile(C, N, dtype)


@pytest.mark.parametrize("B,D,H,W,C,N", FFMA_DW_SPLIT)
def test_ffma_dw_split_covers_every_row_once(B, D, H, W, C, N):
    """The splits are whole 16-row stages that reduce every row once, none
    empty; output tiles times splits make at most one wave at 132 SMs (two
    blocks of the 128-column tile an SM, four of the 64-column one, seven or
    eight of the tiles fitted to a narrow side); a split is at least 16
    stages deep, so few rows make one split, and a fitted tile takes at most
    512; the workspace holds at most 16 MiB."""
    rows = B * D * H * W
    splits, per_split = ffma_dw_split(rows, C, N)
    stages = -(-rows // 16)
    assert splits >= 1 and per_split >= 1
    seen = np.zeros(rows, np.int32)
    for z in range(splits):
        first = z * per_split * 16  # a whole number of stages
        rows_z = seen[first:first + per_split * 16]
        assert rows_z.size > 0  # no split is empty
        rows_z += 1
    assert (seen == 1).all()
    bm, bn, per_sm = _expected_dw_tile(C, N, torch.float32)
    tiles = -(-8 * C // bm) * -(-N // bn)
    assert tiles * splits <= max(tiles, per_sm * 132)
    assert splits == 1 or per_split >= 16
    assert splits <= 512 or not ffma_dw_fitted(C, N)  # the reduce adds a fitted tile's splits one by one
    if stages < 32:
        assert splits == 1
    workspace_bytes = (splits if splits > 1 else 0) * 8 * C * N * 4
    assert workspace_bytes <= 2**24


@pytest.mark.parametrize("B", [8, 32])
def test_ffma_dw_split_at_the_flagship_stages(B):
    """At 16^3 the four stages have 16, 32, 32 and 32 output tiles (the last 128
    x 64): 16, 8, 8 and 16 splits, a wave of 256, 256, 256 and 512 blocks. The
    tiles fitted to a narrow side: the shard 512 -> 32 at 16^3 has 32 tiles of
    128 x 32, 28 splits (896 blocks of 924, seven an SM); the stem's 8 -> 64 at
    32^3 one tile of 64 x 64 and 512 splits, the most a fitted tile takes (a
    wave would be 1056), 32 stages deep at B=8 and 128 at B=32."""
    got = [ffma_dw_split(B * 16**3, C, N) for C, N in FLAGSHIP_K2]
    assert [s for s, _ in got] == [16, 8, 8, 16]
    assert [p * 16 for _, p in got] == [B * 256, B * 512, B * 512, B * 256]  # rows a split
    assert ffma_dw_split(B * 16**3, 512, 32) == (28, -(-B * 256 // 28))
    assert ffma_dw_split(B * 32**3, 8, 64) == (512, 4 * B)


def _emulate_ffma_dw(x, g, splits, per_split, tile):
    """dw as the FFMA kernel's loaders walk it. Split z reduces the stages from
    z * per_split on; loader row lr of a stage is row m_begin + lr + 16 s,
    whose (d, h, w) is found by division once and then carried forward 16 rows
    a stage; 8 tap bits from it (and whether m lies in the split) decide which
    shifted rows of x are copied and which are zeros (a copy of source size 0).
    The blocks of a split are ``tile``'s (rows, columns) of the [8C, N]
    output: each adds the stage's rows (tap, c) and columns of its tile, zeros
    past 8C and N, and stores those that lie inside. The splits' partial sums
    are added in ascending order. Returns dw, how often each row m entered the
    sum and how often each output was stored by a split."""
    B, D, H, W, C = x.shape
    N = g.shape[-1]
    bm, bn = tile
    M, S = B * D * H * W, D * H * W
    R = 8 * C
    rt, ct = -(-R // bm), -(-N // bn)
    x2, g2 = x.reshape(M, C), g.reshape(M, N)
    shifts = [(dz * H + dy) * W + dx for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
    step = 16 % S
    sd, sh, sw = step // (H * W), step // W % H, step % W
    part = torch.zeros(splits, rt * bm, ct * bn)
    stored = torch.zeros(splits, R, N, dtype=torch.int32)
    seen = torch.zeros(M, dtype=torch.int64)
    for z in range(splits):
        m_begin = z * per_split * 16
        m_end = min(M, m_begin + per_split * 16)
        m = m_begin + torch.arange(16)
        d, h, w = m % S // (H * W), m // W % H, m % W
        for _ in range(-(-(m_end - m_begin) // 16)):
            assert torch.equal(torch.stack([d, h, w]), torch.stack([m % S // (H * W), m // W % H, m % W]))
            live = m < m_end
            inside = torch.where(live, 0xFF, 0)
            inside = torch.where(w + 1 >= W, inside & 0x55, inside)
            inside = torch.where(h + 1 >= H, inside & 0x33, inside)
            inside = torch.where(d + 1 >= D, inside & 0x0F, inside)
            a = torch.zeros(16, rt * bm)  # the stage's A of every row tile, zeros past 8C
            for t, shift in enumerate(shifts):
                ok = (inside >> t) & 1 == 1
                a[ok, t * C:(t + 1) * C] = x2[m[ok] + shift]
            b = torch.zeros(16, ct * bn)  # and B of every column tile, zeros past N
            b[:, :N] = torch.where(live[:, None], g2[m.clamp(max=M - 1)], 0.0)
            for i in range(rt):
                for j in range(ct):
                    rows, cols = slice(i * bm, (i + 1) * bm), slice(j * bn, (j + 1) * bn)
                    part[z, rows, cols] += a[:, rows].T @ b[:, cols]
            seen[m[live]] += 1
            m = m + 16
            w = w + sw
            h, w = h + (w >= W).long(), torch.where(w >= W, w - W, w)
            h = h + sh
            d, h = d + (h >= H).long(), torch.where(h >= H, h - H, h)
            d = d + sd
            d = torch.where(d >= D, d - D, d)
        for i in range(rt):  # each block stores the outputs of its tile that lie inside
            for j in range(ct):
                stored[z, i * bm:(i + 1) * bm, j * bn:(j + 1) * bn] += 1
    dw = part[0, :R, :N].clone()
    for z in range(1, splits):
        dw += part[z, :R, :N]
    return dw.reshape(2, 2, 2, C, N), seen, stored


# a ragged grid with 8C < 128 (C = 8), a tile over two taps (C = 64) and 8C not
# a multiple of 128 (C = 136), all in one split; several splits on a ragged grid
# and at 16^3; a grid smaller than a stage (the carried position wraps); the
# tiles fitted to a narrow side: N = 32 over four row tiles of 128 x 32 (C = 64),
# C = 8 on the tile of 64 x 64 in one column tile (N = 64) and in two (N = 96,
# the second ragged), several splits each
FFMA_DW_EMULATED = [(2, 5, 6, 7, 8, 16), (2, 5, 6, 7, 64, 24), (2, 5, 6, 7, 136, 8), (2, 9, 10, 11, 8, 16),
                    (1, 16, 16, 16, 136, 8), (3, 2, 2, 2, 8, 4), (2, 9, 10, 11, 64, 32), (2, 9, 10, 11, 8, 64),
                    (1, 16, 16, 16, 8, 96)]


@pytest.mark.parametrize("B,D,H,W,C,N", FFMA_DW_EMULATED)
def test_ffma_dw_loader_walk_gives_dw(B, D, H, W, C, N):
    """The emulated walk of the FFMA dw (stages of 16 rows, zero-filled shifted
    rows of x, the blocks of its tile, the splits of ``ffma_dw_split`` summed
    in order) reduces every row once, stores every output once a split, and
    equals ``conv_k2_dw_reference`` and ``_conv_k2_bwd_impl``'s dw: f32,
    summation order only, 1e-5 of the largest entry."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, D, H, W, C)).astype(np.float32)
    g = rng.normal(size=(B, D, H, W, N)).astype(np.float32)
    splits, per_split = ffma_dw_split(B * D * H * W, C, N)
    bm, bn, _ = k2._ffma_dw_tile(C, N)
    dw, seen, stored = _emulate_ffma_dw(torch.from_numpy(x), torch.from_numpy(g), splits, per_split, (bm, bn))
    assert (seen == 1).all() and (stored == 1).all()
    ref = conv_k2_dw_reference(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    tol = 1e-5 * float(np.abs(ref).max())
    np.testing.assert_allclose(dw.numpy(), ref, atol=tol, rtol=0)
    w = np.zeros((2, 2, 2, C, N), np.float32)
    jax_dw = np.asarray(_conv_k2_bwd_impl(jnp.asarray(x), jnp.asarray(w), jnp.asarray(g))[1])
    np.testing.assert_allclose(dw.numpy(), jax_dw, atol=tol, rtol=0)


# (rows, columns, a thread's rows, lanes of a warp along the columns) of the FFMA dw's tiles (gemm::DwTile): the
# forward's two and the two fitted to a narrow side
DW_TILES = [(128, 128, 16, 8), (128, 64, 8, 8), (128, 32, 8, 4), (64, 64, 8, 8)]


@pytest.mark.parametrize("esize", [4, 2])
@pytest.mark.parametrize("bm,bn,tm,lc", DW_TILES)
def test_ffma_dw_tile_threads_cover_every_output_and_stage_once(bm, bn, tm, lc, esize):
    """The index arithmetic of ``conv_k2_dw_kernel`` over a block's threads: each output of the tile is held by
    exactly one thread (rows row0 + RUN_STEP j + 0..3, columns col0 + 0..3 and col0 + WARP_N / 2 + 0..3), and
    each element of a stage's A [16][bm] and B [16][bn] is loaded by exactly one of the loaders' pieces (A in
    16-byte pieces, B in pieces of 4 elements). The fitted tiles run on 64 threads, the forward's on 128; every
    thread holds 8 x 8 outputs but on the 128 x 128 tile, 16 x 8. A quarter warp reads one or two addresses of A
    (a broadcast) and 64 or 128 consecutive bytes of B."""
    lane_rows, warp_n = 32 // lc, 8 * lc
    warp_m = lane_rows * tm
    threads = (bm // warp_m) * (bn // warp_n) * 32
    assert threads == (64 if (bm, bn) in ((128, 32), (64, 64)) else 128)
    held = np.zeros((bm, bn), np.int32)
    for tid in range(threads):
        warp, lane = divmod(tid, 32)
        row0 = (warp // (bn // warp_n)) * warp_m + (lane // lc) * 4
        col0 = (warp % (bn // warp_n)) * warp_n + (lane % lc) * 4
        for i in range(tm):
            r = row0 + (i // 4) * lane_rows * 4 + i % 4
            for half in range(2):
                held[r, col0 + half * warp_n // 2:col0 + half * warp_n // 2 + 4] += 1
    assert (held == 1).all()
    for quarter in range(4):  # the rows and columns a quarter warp reads at one k
        lanes = range(8 * quarter, 8 * quarter + 8)
        assert len({lane // lc for lane in lanes}) == 8 // lc  # rows row0: 4 apart, one float4 of A each
        assert sorted({lane % lc for lane in lanes}) == list(range(lc))  # columns col0: consecutive float4 of B
    row_threads = threads // 16
    a_elems = 16 // esize
    a_per, a_step = bm // a_elems // row_threads, row_threads * a_elems
    b_per, b_step = bn // 4 // row_threads, row_threads * 4
    assert 1 <= a_per <= 8 and b_per >= 1
    a_seen, b_seen = np.zeros((16, bm), np.int32), np.zeros((16, bn), np.int32)
    for tid in range(threads):
        lr, lp = divmod(tid, row_threads)
        for i in range(a_per):
            a_seen[lr, lp * a_elems + i * a_step:lp * a_elems + i * a_step + a_elems] += 1
        for i in range(b_per):
            b_seen[lr, lp * 4 + i * b_step:lp * 4 + i * b_step + 4] += 1
    assert (a_seen == 1).all() and (b_seen == 1).all()


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "isfile", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("conv_k2")
    assert not build.library_path("conv_k2").exists()


def test_library_path_keyed_by_sources_and_flags(monkeypatch):
    path = build.library_path("conv_k2")
    assert path.name == "libconv_k2.so" and path.parent.parent == build.BUILD_ROOT
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    flagged = build.library_path("conv_k2")
    assert flagged != path
    monkeypatch.setattr(build, "EXTRA_DEFINES", ("CONV_K2_WAIT_TRAP_NS=1000ull",))
    assert build.library_path("conv_k2") not in (path, flagged)


def test_library_path_of_given_defines(monkeypatch):
    """A build's own ``defines`` stand in for ``EXTRA_DEFINES`` in its path: each probe build of the narrow
    kernels has its own library, and none is the port's."""
    monkeypatch.setattr(build, "EXTRA_DEFINES", ())
    port = build.library_path("conv_k2")
    probes = [build.library_path("conv_k2", (f"CONV_K2_NARROW_PROBE={m}",)) for m in (1, 2, 3)]
    assert len({port, *probes}) == 4 and build.library_path("conv_k2", ()) == port
    monkeypatch.setattr(build, "EXTRA_DEFINES", ("CONV_K2_NARROW_PROBE=1",))
    assert build.library_path("conv_k2") == probes[0]


def test_probe_narrow_needs_a_card(monkeypatch):
    from anytime3d_tpu_torch.cli import probe_narrow

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA GPU"):
        probe_narrow.main()


def test_probe_split_needs_a_card(monkeypatch):
    from anytime3d_tpu_torch.cli import probe_split

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA GPU"):
        probe_split.main([])


def test_default_build_waits_without_a_trap():
    """The barrier wait's time bound is a debug define: the default build has
    no defines, and every ``__trap`` of the tensor-core source lies under it."""
    assert build.EXTRA_DEFINES == ()
    guarded = 0
    for line in (build.CSRC / "conv_k2_wgmma.cuh").read_text().splitlines():
        if line.startswith("#ifdef CONV_K2_WAIT_TRAP_NS"):
            guarded += 1
        elif line.startswith(("#else", "#endif")):
            guarded = 0
        assert "__trap" not in line or guarded


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import without jax, flax or orbax
    (a subprocess: this test process has jax loaded by conftest.py)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import anytime3d_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'orbax', 'anytime3d_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 28


def test_chip_smoke_fails_alone_and_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero and prints no result in a directory that
    holds nothing else of the repo, and (on this machine) without a GPU."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes(open(os.path.join(REPO, "chip_smoke.py"), "rb").read())
    runs = [tmp_path] if torch.cuda.is_available() else [tmp_path, REPO]
    for cwd in runs:
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0, cwd
        assert '"ok"' not in out.stdout, cwd
