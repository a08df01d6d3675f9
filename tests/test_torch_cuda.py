"""PyTorch port on the card: the ``conv_k2`` CUDA kernels (forward, dx, dw)
against their plain versions, their refusals, the three ``torch.library``
ops under ``opcheck``, a small serving slice (eager and exported), a small
train step and the anytime protocol on the GPU against the CPU, the small
image model (``pascal_nolbo``'s layout) served and trained on the card
against the CPU, the batch prefetcher's stream ordering, the kernels at the
detector decoder's N = 8, the narrow kernels (forward, dx and dw of N = 8,
16, 32, bf16 and f32) at the edges of their plan, and a small detector on
the card against the CPU.

Every test here needs a CUDA GPU and ``nvcc`` and skips without them. This
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda
"""

import copy
import dataclasses
import threading

import numpy as np
import pytest
import torch

from anytime3d_tpu_torch.anytime.engine import anytime_eval
from anytime3d_tpu_torch.data.packing import pack_voxels, pack_voxels_blocked
from anytime3d_tpu_torch.data.prefetch import DevicePrefetcher
from anytime3d_tpu_torch.kernels import build
from anytime3d_tpu_torch.kernels import conv_k2 as k2
from anytime3d_tpu_torch.kernels.conv_k2 import (
    chunked_dx_plan,
    conv_k2,
    conv_k2_backward_reference,
    conv_k2_dw,
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
from anytime3d_tpu_torch.kernels.conv_k4s2 import (
    conv_k4s2,
    conv_k4s2_dw,
    conv_k4s2_dw_reference,
    conv_k4s2_dx,
    conv_k4s2_dx_reference,
    conv_k4s2_reference,
    k4s2_plans,
)
from anytime3d_tpu_torch.models.configs import loss_config, modelnet_nolbo, pascal_nolbo
from anytime3d_tpu_torch.models.detector import DetectorConfig, DetectorReconstructor
from anytime3d_tpu_torch.models.mmvae import MultiModalVAE
from anytime3d_tpu_torch.nn.autoencoder3d import Decoder3DConfig
from anytime3d_tpu_torch.nn.blocks import Conv3d
from anytime3d_tpu_torch.serving.export import export_detector, export_infer, load_infer, make_infer_fn, make_packed_infer
from anytime3d_tpu_torch.train.state import create_train_state
from anytime3d_tpu_torch.train.step import make_eval_step, make_train_step

pytestmark = pytest.mark.cuda

# (C, N) of the flagship model's four k=2 stages at 16^3
FLAGSHIP = [(64, 512), (512, 128), (128, 512), (512, 64)]
# (B, grid, C, N) that the tensor-core kernels take in bfloat16: rows that tile
# into boxes at 8^3, 16^3 and 32^3, odd batches, both tile widths
PLANNED = [(1, 8, 64, 64), (3, 8, 64, 128), (1, 16, 128, 64), (3, 16, 64, 128), (1, 32, 64, 64), (3, 32, 128, 128),
           (8, 16, 64, 512), (8, 16, 512, 128), (8, 16, 128, 512), (8, 16, 512, 64)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    # a wrong barrier phase in a tensor-core kernel traps after 4 s here instead of hanging the card
    build.EXTRA_DEFINES = ("CONV_K2_WAIT_TRAP_NS=4000000000ull",)
    # the plain versions in true f32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,N", FLAGSHIP + [(8, 16), (136, 8), (16, 4)])
def test_kernel_matches_plain(cuda, C, N, dtype):
    # flagship stages at B=8, 16^3; the others on a small ragged grid, so
    # partial tiles and every boundary row are exercised
    B, D = (8, 16) if (C, N) in FLAGSHIP else (2, 5)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(B, D, D + 1, D + 2, C, generator=gen).to(cuda, dtype)
    w = (torch.randn(2, 2, 2, C, N, generator=gen) / (8 * C) ** 0.5).to(cuda, dtype)
    with torch.inference_mode():
        before = conv_k2.launches
        y = conv_k2(x, w)
        assert conv_k2.launches == before + 1
        ref = conv_k2_reference(x, w)
    torch.cuda.synchronize()
    assert y.shape == ref.shape and y.dtype == dtype
    err = float((y.float() - ref.float()).abs().max())
    # f32: summation order only, ~1e-5 at these depths; bf16: each side rounds
    # an f32 sum once, so 2 bf16 ulps at the largest output
    tol = 1e-4 if dtype == torch.float32 else 2.0**-7 * float(ref.float().abs().max())
    assert err <= tol, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,G,C,N", PLANNED)
def test_kernel_matches_plain_on_planned_shapes(cuda, B, G, C, N, dtype):
    """Shapes with a plan: bfloat16 goes through the tensor-core forward (both
    counters move), float32 through the FFMA kernel (only ``launches``)."""
    assert wgmma_plan(B, G, G, G, C, N) is not None
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(B, G, G, G, C, generator=gen).to(cuda, dtype)
    w = (torch.randn(2, 2, 2, C, N, generator=gen) / (8 * C) ** 0.5).to(cuda, dtype)
    with torch.inference_mode():
        before = conv_k2.launches, conv_k2.launches_wgmma
        y = conv_k2(x, w)
        assert conv_k2.launches == before[0] + 1
        assert conv_k2.launches_wgmma == before[1] + (dtype == torch.bfloat16)
        ref = conv_k2_reference(x, w)
    torch.cuda.synchronize()
    assert y.shape == ref.shape and y.dtype == dtype
    err = float((y.float() - ref.float()).abs().max())
    # as test_kernel_matches_plain: f32 summation order; bf16 one rounding of an f32 sum on each side
    tol = 1e-4 if dtype == torch.float32 else 2.0**-7 * float(ref.float().abs().max())
    assert err <= tol, err


# dw, kernel or plain version, against the float64 sum of the same bf16
# products, relative to the largest entry: see chip_smoke.py's K2_TOL_DW_F64_REL
DW_TOL_F64_REL = 1e-4


def _dw_float64(x, g):
    """dw as a float64 product of the same operands, tap by tap."""
    _, D, H, W, _ = x.shape
    xp = torch.nn.functional.pad(x.double(), (0, 0) + (0, 1) * 3)
    g64 = g.double().flatten(0, 3)
    taps = [xp[:, dz:dz + D, dy:dy + H, dx:dx + W].flatten(0, 3).T @ g64
            for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
    return torch.stack(taps).reshape(2, 2, 2, x.shape[-1], g.shape[-1])


def _counts():
    return conv_k2.launches, conv_k2.launches_dx, conv_k2.launches_dw


def _wgmma_counts():
    return conv_k2.launches_wgmma, conv_k2.launches_dx_wgmma, conv_k2.launches_dw_wgmma


def _narrow_counts():
    return conv_k2.launches_narrow, conv_k2.launches_dx_narrow, conv_k2.launches_dw_narrow


def _dx_float64(g, w):
    """dx as a float64 product of the same operands, tap by tap: g shifted
    down by the tap (zeros below the low edge) times w[tap] transposed."""
    _, D, H, W, N = g.shape
    gp = torch.nn.functional.pad(g.double(), (0, 0) + (1, 0) * 3)
    w64 = w.double().reshape(8, w.shape[3], N)
    taps = [gp[:, 1 - dz:1 - dz + D, 1 - dy:1 - dy + H, 1 - dx:1 - dx + W].flatten(0, 3) @ w64[4 * dz + 2 * dy + dx].T
            for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
    return sum(taps).reshape(*g.shape[:4], w.shape[3])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,N", FLAGSHIP + [(8, 16), (136, 8), (16, 24)])
def test_backward_kernels_match_plain(cuda, C, N, dtype):
    """dx and dw through autograd against ``conv_k2_backward_reference``:
    flagship stages at B=8, 16^3; the others on a small ragged grid (partial
    tiles, every boundary row, a reduction that does not fill its splits)."""
    B, D = (8, 16) if (C, N) in FLAGSHIP else (2, 5)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(B, D, D + 1, D + 2, C, generator=gen).to(cuda, dtype).requires_grad_()
    w = (torch.randn(2, 2, 2, C, N, generator=gen) / (8 * C) ** 0.5).to(cuda).requires_grad_()  # an f32 parameter
    g = torch.randn(B, D, D + 1, D + 2, N, generator=gen).to(cuda, dtype)
    before, before_wg = _counts(), _wgmma_counts()
    y = conv_k2(x, w)
    # a permuted view, as autograd hands gradients over
    y.backward(g.permute(0, 4, 1, 2, 3).contiguous().permute(0, 2, 3, 4, 1))
    assert _counts() == (before[0] + 1, before[1] + 1, before[2] + 1)
    # float32, and grids without a wgmma plan: no tensor-core launch (8 -> 16 takes the narrow kernels in both types)
    assert _wgmma_counts() == before_wg
    with torch.no_grad():
        dx_ref, dw_ref = conv_k2_backward_reference(x, w, g)
    torch.cuda.synchronize()
    assert x.grad.dtype == dtype and x.grad.shape == x.shape
    assert w.grad.dtype == torch.float32 and w.grad.shape == w.shape
    err_dx = float((x.grad.float() - dx_ref.float()).abs().max())
    err_dw = float((w.grad - dw_ref).abs().max())
    # dx: as the forward (f32: summation order over a depth <= 4096; bf16: one
    # rounding of an f32 sum on each side, 2 ulps at the largest entry).
    # dw: f32 sums of up to 32768 O(1) products on both sides, in another
    # order: 1e-5 of the largest entry (measured ~1e-6).
    tol_dx = 1e-4 if dtype == torch.float32 else 2.0**-7 * float(dx_ref.float().abs().max())
    tol_dw = 1e-5 * float(dw_ref.abs().max()) + 1e-5
    assert err_dx <= tol_dx, err_dx
    assert err_dw <= tol_dw, err_dw


@pytest.mark.parametrize("B,G,C,N", PLANNED)
def test_backward_kernels_match_plain_on_planned_shapes(cuda, B, G, C, N):
    """bfloat16 shapes with a plan, through autograd: the forward, dx and dw on
    the tensor-core kernels (their counters move); dx and dw also held to a
    float64 product of the same operands; dw the same bits from two calls."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(B, G, G, G, C, generator=gen).to(cuda, torch.bfloat16).requires_grad_()
    w = (torch.randn(2, 2, 2, C, N, generator=gen) / (8 * C) ** 0.5).to(cuda).requires_grad_()  # an f32 parameter
    g = torch.randn(B, G, G, G, N, generator=gen).to(cuda, torch.bfloat16)
    before, before_wg = _counts(), _wgmma_counts()
    y = conv_k2(x, w)
    y.backward(g.permute(0, 4, 1, 2, 3).contiguous().permute(0, 2, 3, 4, 1))  # a permuted view
    assert _counts() == (before[0] + 1, before[1] + 1, before[2] + 1)
    assert _wgmma_counts() == (before_wg[0] + 1, before_wg[1] + 1, before_wg[2] + 1)
    with torch.no_grad():
        dx_ref, dw_ref = conv_k2_backward_reference(x, w, g)
        again = conv_k2_dw(x.detach(), g), conv_k2_dw(x.detach(), g)
        dw64 = _dw_float64(x.detach(), g)
        dx64 = _dx_float64(g, w.detach().to(torch.bfloat16))
    torch.cuda.synchronize()
    assert w.grad.dtype == torch.float32 and w.grad.shape == w.shape
    assert torch.equal(again[0], again[1]) and torch.equal(again[0], w.grad)  # no atomics: the same bits every run
    err_dx = float((x.grad.float() - dx_ref.float()).abs().max())
    assert err_dx <= 2.0**-7 * float(dx_ref.float().abs().max()), err_dx
    # dx, kernel and plain version, against float64: an f32 sum rounded once to bf16 (half an ulp of the
    # largest entry) and the sum's own error, as chip_smoke.py holds the forward
    tol_dx64 = (2.0**-8 + DW_TOL_F64_REL) * float(dx64.abs().max())
    assert float((x.grad.double() - dx64).abs().max()) <= tol_dx64
    assert float((dx_ref.double() - dx64).abs().max()) <= tol_dx64
    # dw: the exact products of bf16 operands summed in f32, on the tensor cores
    # in another order and with other intermediate roundings than the plain
    # version's. Each is held to the float64 sum: sqrt(rows) roundings of 2^-24
    # relative to partial sums of the size of the largest entry.
    top = float(dw64.abs().max())
    tol = DW_TOL_F64_REL * top
    assert float((w.grad.double() - dw64).abs().max()) <= tol
    assert float((dw_ref.double() - dw64).abs().max()) <= tol


# (C, N) of the mid_blocked stages at 4^3: the encoder's last (s2d of 8^3) and the decoder's first (then d2s)
MID_4CUBED = [(2048, 512), (512, 2048)]


@pytest.mark.parametrize("B", [8, 32])
@pytest.mark.parametrize("C,N", MID_4CUBED)
def test_wgmma_at_4cubed_matches_plain_and_float64(cuda, B, C, N):
    """At 4^3 an item has 64 rows, so a tile's box spans two whole items (four
    at 256 rows): the forward, dx and dw on the tensor cores (their counters
    move) against their plain versions and float64 products of the same bf16
    operands; dw twice, the same bits; the forward also on the other tile
    height (``wgmma_plan(..., bm=...)``), which must give the plan's bits."""
    gen = torch.Generator().manual_seed(17)
    x = torch.randn(B, 4, 4, 4, C, generator=gen).to(cuda, torch.bfloat16)
    w = (torch.randn(2, 2, 2, C, N, generator=gen) / (8 * C) ** 0.5).to(cuda, torch.bfloat16)
    g = torch.randn(B, 4, 4, 4, N, generator=gen).to(cuda, torch.bfloat16)
    plan = wgmma_plan(B, 4, 4, 4, C, N)
    for p in (plan, wgmma_plan(B, 4, 4, 4, N, C)):
        assert p.box == (4, 4, 4) and p.box_items == p.bm // 64
    with torch.inference_mode():
        before, before_wg = _counts(), _wgmma_counts()
        y, dx = conv_k2(x, w), k2.conv_k2_dx(g, w)
        dw = conv_k2_dw(x, g), conv_k2_dw(x, g)
        assert _counts() == (before[0] + 1, before[1] + 1, before[2] + 2)
        assert _wgmma_counts() == (before_wg[0] + 1, before_wg[1] + 1, before_wg[2] + 2)
        y_other = torch.empty_like(y)
        k2.forward_wgmma(x, w, y_other, wgmma_plan(B, 4, 4, 4, C, N, bm=384 - plan.bm))
        y_ref, (dx_ref, dw_ref) = conv_k2_reference(x, w), conv_k2_backward_reference(x, w, g)
        y64 = sum(torch.nn.functional.pad(x.double(), (0, 0) + (0, 1) * 3)[
            :, t >> 2:(t >> 2) + 4, (t >> 1) & 1:((t >> 1) & 1) + 4, t & 1:(t & 1) + 4] @ w.double().reshape(8, C, N)[t]
            for t in range(8))
        dx64, dw64 = _dx_float64(g, w), _dw_float64(x, g)
    torch.cuda.synchronize()
    assert torch.equal(dw[0], dw[1]) and torch.equal(y, y_other)
    for out, ref, exact in ((y, y_ref, y64), (dx, dx_ref, dx64)):
        # one rounding of an f32 sum to bf16 on each side (2 ulps of the largest entry); against float64 half
        # an ulp and the sum's own error, as chip_smoke.py holds the forward
        assert float((out.float() - ref.float()).abs().max()) <= 2.0**-7 * float(ref.float().abs().max())
        tol64 = (2.0**-8 + DW_TOL_F64_REL) * float(exact.abs().max())
        assert float((out.double() - exact).abs().max()) <= tol64
        assert float((ref.double() - exact).abs().max()) <= tol64
    tol = DW_TOL_F64_REL * float(dw64.abs().max())
    assert float((dw[0].double() - dw64).abs().max()) <= tol and float((dw_ref.double() - dw64).abs().max()) <= tol


def _split_counts():
    return conv_k2.launches_split, conv_k2.launches_dx_split


def _check_split_forward_and_dx(cuda, B, C, N, seed):
    """conv_k2 and dx at 4^3 twice: the plans' split counters move, the same bits both runs, and each within 2
    bf16 ulps of the largest entry of the plain version (as every bf16 forward) and within half an ulp and
    the sum's own error of a float64 product of the same operands (the 4^3 tolerances). Returns the plans'
    splits (forward, dx)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(B, 4, 4, 4, C, generator=gen).to(cuda, torch.bfloat16)
    w = (torch.randn(2, 2, 2, C, N, generator=gen) / (8 * C) ** 0.5).to(cuda, torch.bfloat16)
    g = torch.randn(B, 4, 4, 4, N, generator=gen).to(cuda, torch.bfloat16)
    fwd_splits, dx_splits = wgmma_plan(B, 4, 4, 4, C, N).splits, wgmma_plan(B, 4, 4, 4, N, C).splits
    with torch.inference_mode():
        before, before_split = _wgmma_counts(), _split_counts()
        y, dx = conv_k2(x, w), k2.conv_k2_dx(g, w)
        again = conv_k2(x, w), k2.conv_k2_dx(g, w)
        moved = [a - b for a, b in zip(_split_counts(), before_split)]
        assert _wgmma_counts()[:2] == (before[0] + 2, before[1] + 2)
        assert moved == [2 * (fwd_splits > 1), 2 * (dx_splits > 1)]
        y_ref, dx_ref = conv_k2_reference(x, w), k2.conv_k2_dx_reference(g, w)
        y64 = sum(torch.nn.functional.pad(x.double(), (0, 0) + (0, 1) * 3)[
            :, t >> 2:(t >> 2) + 4, (t >> 1) & 1:((t >> 1) & 1) + 4, t & 1:(t & 1) + 4] @ w.double().reshape(8, C, N)[t]
            for t in range(8))
        dx64 = _dx_float64(g, w)
    torch.cuda.synchronize()
    assert torch.equal(y, again[0]) and torch.equal(dx, again[1])
    for out, ref, exact in ((y, y_ref, y64), (dx, dx_ref, dx64)):
        assert float((out.float() - ref.float()).abs().max()) <= 2.0**-7 * float(ref.float().abs().max())
        tol64 = (2.0**-8 + DW_TOL_F64_REL) * float(exact.abs().max())
        assert float((out.double() - exact).abs().max()) <= tol64
    return fwd_splits, dx_splits


@pytest.mark.parametrize("B", [2, 8, 32])
@pytest.mark.parametrize("C,N", MID_4CUBED)
def test_split_forward_and_dx_at_4cubed_match_plain_and_float64(cuda, B, C, N):
    """The tensor-core forward and dx whose plan splits the depth (every one of these but the forward of
    512 -> 2048 at B=32, whose 128 tiles fill the card): each split's f32 partial to the workspace, then the
    reduce in ascending order, rounded once, both launched by the one call into the library; held to the plain
    version and float64, the same bits from two runs, the split counters moving with the plans."""
    no_split = (32, 512)  # a plan of 512 -> 2048 at B=32: 128 tiles of 256 rows fill the card
    fwd_splits, dx_splits = _check_split_forward_and_dx(cuda, B, C, N, seed=21)
    assert (fwd_splits > 1) == ((B, C) != no_split) and (dx_splits > 1) == ((B, N) != no_split)


@pytest.mark.parametrize("B", [2, 8])
@pytest.mark.parametrize("C,N", [(512, 64), (64, 512)])
def test_split_with_64_columns_matches_plain_and_float64(cuda, B, C, N):
    """The split instances of 64-column tiles: the forward of 512 -> 64 at 4^3 and the dx of 64 -> 512 (the
    plan of 512 -> 64: 4 splits of 16 stages, 128-row tiles at B=2, 256 at B=8), as the test above; the
    8-stage sum of 64 -> 512 and the dx of 512 -> 64 keep one split."""
    fwd_splits, dx_splits = _check_split_forward_and_dx(cuda, B, C, N, seed=23)
    assert (fwd_splits > 1, dx_splits > 1) == ((C == 512), (N == 512))
    assert wgmma_plan(B, 4, 4, 4, 512, 64).bn == 64


def _f32_forward64(x, w):
    """conv_k2(x, w) as a float64 product of the same operands, tap by tap."""
    _, D, H, W, C = x.shape
    xp = torch.nn.functional.pad(x.double(), (0, 0) + (0, 1) * 3)
    w64 = w.double().reshape(8, C, -1)
    return sum(xp[:, t >> 2:(t >> 2) + D, (t >> 1) & 1:((t >> 1) & 1) + H, t & 1:(t & 1) + W] @ w64[t]
               for t in range(8))


def _ffma_split_counts():
    return conv_k2.launches_ffma_split, conv_k2.launches_dx_ffma_split


# (B, grid, C, N) of the float32 mid_blocked stages whose FFMA forward or dx splits its depth (k2.ffma_split): 4^3
# both ways at B=2, 8 and 32 (the forward of 2048 -> 512 in 64, 16 and 4 splits; the dx of 512 -> 2048 likewise;
# the forward of 512 -> 2048 at B=32, 256 tiles, in one), 8^3 1024 -> 256 at B=8 (4 splits, its dx one)
FFMA_SPLIT_CASES = [(B, 4, C, N) for B in (2, 8, 32) for C, N in MID_4CUBED] + [(8, 8, 1024, 256)]


@pytest.mark.parametrize("B,G,C,N", FFMA_SPLIT_CASES)
def test_ffma_split_forward_and_dx_match_plain_and_float64(cuda, B, G, C, N):
    """The float32 FFMA forward and dx of the mid_blocked stages: each split's f32 partial to the workspace,
    then conv_k2_dw_reduce_kernel in ascending order, both launched by one call into the library; the split
    counters moving with ``ffma_split``; the same bits from two runs; against the plain version at this file's
    f32 tolerance (1e-4: summation order, O(1) outputs) and, kernel and plain version, against a float64 product
    of the same operands: f32 chains of up to 16384 adds (2^-24 each, growing as their square root) and the
    partials' sum, 5e-5 of the largest entry."""
    fwd, dx_split = k2.ffma_split(B, G, G, G, C, N), k2.ffma_split(B, G, G, G, N, C)
    assert max(fwd[0], dx_split[0]) > 1
    gen = torch.Generator().manual_seed(29)
    x = torch.randn(B, G, G, G, C, generator=gen).to(cuda)
    w = (torch.randn(2, 2, 2, C, N, generator=gen) / (8 * C) ** 0.5).to(cuda)
    g = torch.randn(B, G, G, G, N, generator=gen).to(cuda)
    with torch.inference_mode():
        before, before_split = _counts(), _ffma_split_counts()
        y, dx = conv_k2(x, w), k2.conv_k2_dx(g, w)
        again = conv_k2(x, w), k2.conv_k2_dx(g, w)
        assert _counts()[:2] == (before[0] + 2, before[1] + 2)
        moved = [a - b for a, b in zip(_ffma_split_counts(), before_split)]
        assert moved == [2 * (fwd[0] > 1), 2 * (dx_split[0] > 1)]
        y_ref, dx_ref = conv_k2_reference(x, w), k2.conv_k2_dx_reference(g, w)
        y64, dx64 = _f32_forward64(x, w), _dx_float64(g, w)
    torch.cuda.synchronize()
    assert torch.equal(y, again[0]) and torch.equal(dx, again[1])
    for out, ref, exact in ((y, y_ref, y64), (dx, dx_ref, dx64)):
        assert out.dtype == torch.float32 and out.shape == ref.shape
        assert float((out - ref).abs().max()) <= 1e-4
        tol64 = 5e-5 * float(exact.abs().max())
        assert float((out.double() - exact).abs().max()) <= tol64
        assert float((ref.double() - exact).abs().max()) <= tol64


# (B, grid, C, N) of the tensor-core dw at the five mid_blocked shapes of the record: 4^3 both ways at B=8 and 32
# (the plan's dw on the persistent kernel) and 8^3 1024 -> 256 at B=8 (the grid kernel's, 2 splits)
PERSISTENT_DW_CASES = [(B, 4, C, N) for B in (8, 32) for C, N in MID_4CUBED] + [(8, 8, 1024, 256)]


def _check_dw(dw, x, g):
    """dw (f32) of bf16 x and g against its plain version (twice the float64 tolerance) and, with the plain
    version, against the float64 sum of the same products (DW_TOL_F64_REL of the largest entry)."""
    ref, dw64 = conv_k2_dw_reference(x, g), _dw_float64(x, g)
    tol = DW_TOL_F64_REL * float(dw64.abs().max())
    assert dw.dtype == torch.float32 and dw.shape == ref.shape
    assert float((dw - ref).abs().max()) <= 2 * tol
    assert float((dw.double() - dw64).abs().max()) <= tol and float((ref.double() - dw64).abs().max()) <= tol


@pytest.mark.parametrize("B,G,C,N", PERSISTENT_DW_CASES)
def test_persistent_dw_matches_plain_and_float64(cuda, B, G, C, N):
    """The bfloat16 dw of the mid_blocked stages: the op (``launches_dw_persistent`` moves at 4^3, where the
    plan takes the persistent kernel, and not at 8^3) and the persistent kernel launched directly
    (``persistent_dw=True``), each against its plain version and float64 and the same bits from two calls; the
    grid kernel on the same operands (``persistent_dw=False``) gives the persistent kernel's bits where the two
    cut the rows into the same splits (the same products added in the same order), else agrees within the
    plain version's tolerance."""
    walk = wgmma_plan(B, G, G, G, C, N).dw_persistent
    assert (walk is not None) == (G == 4)
    persistent = wgmma_plan(B, G, G, G, C, N, persistent_dw=True)
    grid_plan = wgmma_plan(B, G, G, G, C, N, persistent_dw=False)
    gen = torch.Generator().manual_seed(31)
    x = torch.randn(B, G, G, G, C, generator=gen).to(cuda, torch.bfloat16)
    g = torch.randn(B, G, G, G, N, generator=gen).to(cuda, torch.bfloat16)
    with torch.inference_mode():
        before, before_wg, before_p = _counts(), _wgmma_counts(), conv_k2.launches_dw_persistent
        dw, again = conv_k2_dw(x, g), conv_k2_dw(x, g)
        assert _counts()[2] == before[2] + 2 and _wgmma_counts()[2] == before_wg[2] + 2
        assert conv_k2.launches_dw_persistent == before_p + 2 * (walk is not None)
        launched, other = (torch.empty_like(dw) for _ in range(2))
        k2.dw_wgmma(x, g, launched, persistent)
        k2.dw_wgmma(x, g, other, grid_plan)
    torch.cuda.synchronize()
    assert torch.equal(dw, again)
    for out in (dw, launched):
        _check_dw(out, x, g)
    walk = persistent.dw_persistent
    if (walk.splits, walk.stages_per_split) == grid_plan.dw_grid[2:] + (grid_plan.dw_stages_per_split,):
        assert torch.equal(launched, other)
    else:
        assert float((launched - other).abs().max()) <= 2 * DW_TOL_F64_REL * float(other.abs().max())


@pytest.mark.parametrize("B,C,N", [(8, 64, 512), (8, 128, 512)])
def test_persistent_dw_at_a_flagship_stage(cuda, B, C, N):
    """The persistent dw launched at the flagship's 16^3 stages (``persistent_dw=True``; the plan keeps the
    grid kernel there): 8 and 16 tiles, the rows in 16 and 8 splits, then the reduce; against the plain version
    and float64, the same bits twice."""
    plan = wgmma_plan(B, 16, 16, 16, C, N, persistent_dw=True)
    assert plan.dw_persistent.splits > 1 and wgmma_plan(B, 16, 16, 16, C, N).dw_persistent is None
    gen = torch.Generator().manual_seed(37)
    x = torch.randn(B, 16, 16, 16, C, generator=gen).to(cuda, torch.bfloat16)
    g = torch.randn(B, 16, 16, 16, N, generator=gen).to(cuda, torch.bfloat16)
    dw, again = (torch.empty(2, 2, 2, C, N, device=cuda) for _ in range(2))
    with torch.inference_mode():
        k2.dw_wgmma(x, g, dw, plan)
        k2.dw_wgmma(x, g, again, plan)
    torch.cuda.synchronize()
    assert torch.equal(dw, again)
    _check_dw(dw, x, g)


def test_odd_batch_at_4cubed_takes_ffma(cuda):
    """B = 7 at 4^3: no box of whole items tiles the rows, so no plan; the
    forward, dx and dw run on the FFMA kernels (no tensor-core counter moves)
    and match their plain versions."""
    B, C, N = 7, 512, 256
    assert wgmma_plan(B, 4, 4, 4, C, N) is None and wgmma_plan(B, 4, 4, 4, N, C) is None
    gen = torch.Generator().manual_seed(18)
    x = torch.randn(B, 4, 4, 4, C, generator=gen).to(cuda, torch.bfloat16)
    w = (torch.randn(2, 2, 2, C, N, generator=gen) / (8 * C) ** 0.5).to(cuda, torch.bfloat16)
    g = torch.randn(B, 4, 4, 4, N, generator=gen).to(cuda, torch.bfloat16)
    with torch.inference_mode():
        before, before_wg, before_nr = _counts(), _wgmma_counts(), _narrow_counts()
        y, dx, dw = conv_k2(x, w), k2.conv_k2_dx(g, w), conv_k2_dw(x, g)
        assert _counts() == tuple(v + 1 for v in before)
        assert _wgmma_counts() == before_wg and _narrow_counts() == before_nr
        y_ref, (dx_ref, dw_ref) = conv_k2_reference(x, w), conv_k2_backward_reference(x, w, g)
    torch.cuda.synchronize()
    for out, ref in ((y, y_ref), (dx, dx_ref)):
        assert float((out.float() - ref.float()).abs().max()) <= 2.0**-7 * float(ref.float().abs().max())
    # the FFMA dw sums in f32 in another order than the plain version: 1e-5 of the largest entry (chip_smoke.py)
    assert float((dw - dw_ref).abs().max()) <= 1e-5 * float(dw_ref.abs().max())


# (B, D, H, W, C, N) at the edges of the FFMA dw's tile and splits, none with a
# plan: a ragged grid with 8C < 128 and N <= 64 (the 128 x 64 tile), 8C not a
# multiple of 128, N % 128 != 0 on the 128-column tile, bf16 rows of g only
# 8-byte aligned (N % 8 == 4), a grid smaller than a stage; one split for the
# first four, several for the rest (ffma_dw_split)
FFMA_DW_EDGES = [(2, 5, 6, 7, 8, 16), (2, 5, 6, 7, 24, 16), (2, 5, 6, 7, 136, 8), (1, 4, 4, 4, 64, 200),
                 (3, 2, 2, 2, 8, 4), (2, 9, 10, 11, 24, 68), (1, 16, 16, 16, 136, 96), (4, 16, 16, 16, 512, 40)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,D,H,W,C,N", FFMA_DW_EDGES)
def test_ffma_dw_matches_plain_at_the_tile_edges(cuda, B, D, H, W, C, N, dtype):
    """The FFMA dw, float32 and bfloat16 without a plan, against
    ``conv_k2_dw_reference``: f32 sums of the same products in another order,
    1e-5 of the largest entry (chip_smoke.py's K2_TOL_DW_REL); the same bits
    from two calls; no tensor-core launch. (8 -> 16) has a narrow plan in
    both types and takes the narrow dw, held to the same; (24 -> 16), the
    same edge without one, keeps the FFMA dw's one split."""
    assert wgmma_plan(B, D, H, W, C, N) is None
    assert (ffma_dw_split(B * D * H * W, C, N)[0] == 1) == (FFMA_DW_EDGES.index((B, D, H, W, C, N)) < 5)
    narrow = narrow_plan(B, D, H, W, C, N, dtype=dtype) is not None
    assert narrow == ((C, N) == (8, 16))
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(B, D, H, W, C, generator=gen).to(cuda, dtype)
    g = torch.randn(B, D, H, W, N, generator=gen).to(cuda, dtype)
    before, before_wg, before_nr = _counts(), _wgmma_counts(), _narrow_counts()
    with torch.no_grad():
        dw, again = conv_k2_dw(x, g), conv_k2_dw(x, g)
        ref = conv_k2_dw_reference(x, g)
    torch.cuda.synchronize()
    assert _counts() == (before[0], before[1], before[2] + 2) and _wgmma_counts() == before_wg
    assert _narrow_counts() == (before_nr[0], before_nr[1], before_nr[2] + 2 * narrow)
    assert dw.dtype == torch.float32 and dw.shape == (2, 2, 2, C, N)
    assert torch.equal(dw, again)
    err = float((dw - ref).abs().max())
    assert err <= 1e-5 * float(ref.abs().max()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [2, 8])
def test_s2d_stem_kernels_match_plain(cuda, B, dtype):
    """The classic encoder's space-to-depth(2) stem, ``conv_k2`` 8 -> 64 at
    32^3 (no tensor-core or narrow plan), and dw: in bfloat16 the forward on
    the wide plan (the chunked dx's kernel run forward: ``launches_wide``
    moves) and dw on the dw-only narrow plan (``launches_dw_narrow`` and
    ``launches_dw_wide`` move); in float32 the forward on the FFMA GEMM and
    dw on the FFMA dw's 64 x 64 tile (``launches_dw_ffma_fit`` moves).
    Against their plain versions with the forward's and dw's tolerances, and
    against float64 products: dw as every tensor-core dw, the bfloat16
    forward as the chunked kernels' (half an ulp of the largest entry, plus
    the sum's own error); dw the same bits twice."""
    C, N, G = 8, 64, 32
    assert wgmma_plan(B, G, G, G, C, N) is None and narrow_plan(B, G, G, G, C, N, dtype=dtype) is None
    wide = dtype == torch.bfloat16
    assert (narrow_dw_plan(B, G, G, G, C, N, dtype=dtype) is not None) == wide
    assert (wide_plan(B, G, G, G, C, N, dtype=dtype) is not None) == wide and ffma_dw_fitted(C, N)
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(B, G, G, G, C, generator=gen).to(cuda, dtype)
    w = (torch.randn(2, 2, 2, C, N, generator=gen) / (8 * C) ** 0.5).to(cuda, dtype)
    g = torch.randn(B, G, G, G, N, generator=gen).to(cuda, dtype)
    before, before_wg, before_nr = _counts(), _wgmma_counts(), _narrow_counts()
    before_wide = (conv_k2.launches_wide, conv_k2.launches_dw_wide, conv_k2.launches_dw_ffma_fit)
    with torch.no_grad():
        y, dw, again = conv_k2(x, w), conv_k2_dw(x, g), conv_k2_dw(x, g)
        y_ref, dw_ref = conv_k2_reference(x, w), conv_k2_dw_reference(x, g)
        y64, dw64 = _float64_forward(x, w), _dw_float64(x, g)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1], before[2] + 2)
    assert _wgmma_counts() == before_wg and _narrow_counts() == (before_nr[0], before_nr[1], before_nr[2] + 2 * wide)
    assert (conv_k2.launches_wide, conv_k2.launches_dw_wide, conv_k2.launches_dw_ffma_fit) == (
        before_wide[0] + wide, before_wide[1] + 2 * wide, before_wide[2] + 2 * (not wide))
    err = float((y.float() - y_ref.float()).abs().max())
    assert err <= (1e-4 if dtype == torch.float32 else 2.0**-7 * float(y_ref.float().abs().max())), err
    if wide:
        tol64 = (2.0**-8 + DW_TOL_F64_REL) * float(y64.abs().max())
        for out in (y, y_ref):
            assert float((out.double() - y64).abs().max()) <= tol64
    assert torch.equal(dw, again)
    err = float((dw - dw_ref).abs().max())
    assert err <= 1e-5 * float(dw_ref.abs().max()), err
    assert float((dw.double() - dw64).abs().max()) <= DW_TOL_F64_REL * float(dw64.abs().max())


def test_wide_forward_gives_the_same_bits_at_the_stem(cuda):
    """The wide forward at the stem's train batch (B=32, 32^3, 8 -> 64, bf16), 20 launches through the op:
    each the same bits as the first, and the first within 2^-7 of the largest entry of the plain version
    (each side rounds an f32 sum once to bf16). The chunked dx it runs forward gave wrong rows in most
    launches at its largest shape when a halo stage went back to the producer too early."""
    B, G, C, N = 32, 32, 8, 64
    assert wide_plan(B, G, G, G, C, N) is not None
    gen = torch.Generator().manual_seed(31)
    x = torch.randn(B, G, G, G, C, generator=gen).to(cuda, torch.bfloat16)
    w = (torch.randn(2, 2, 2, C, N, generator=gen) / (8 * C) ** 0.5).to(cuda, torch.bfloat16)
    before = conv_k2.launches_wide
    with torch.inference_mode():
        first = conv_k2(x, w)
        differ = sum(not torch.equal(conv_k2(x, w), first) for _ in range(19))
        ref = conv_k2_reference(x, w)
    assert conv_k2.launches_wide == before + 20 and differ == 0
    assert float((first.float() - ref.float()).abs().max()) <= 2.0**-7 * float(ref.float().abs().max())


# (B, D, H, W, C, N) of the FFMA dw's tiles fitted to a narrow side: 128 x 32 where N <= 32 (N = 32, 16, 8 below
# 8C of several row tiles, the tensor-parallel shard 512 -> 32 at B=8), 64 x 64 where 8C <= 64 (C = 8: N = 64 on
# ragged grids, N = 128 and 192 in two and three column tiles), and C = 8 with N = 32 (the 128 x 32 tile with
# half its rows past 8C); one split where the grid is small, several else
FFMA_DW_FITTED = [(2, 5, 6, 7, 64, 32), (2, 9, 10, 11, 24, 16), (1, 16, 16, 16, 136, 8), (8, 16, 16, 16, 512, 32),
                  (2, 5, 6, 7, 8, 64), (3, 9, 10, 11, 8, 128), (1, 16, 16, 16, 8, 192), (2, 9, 10, 11, 8, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,D,H,W,C,N", FFMA_DW_FITTED)
def test_ffma_dw_fitted_tiles_match_plain_and_float64(cuda, B, D, H, W, C, N, dtype):
    """The FFMA dw on its fitted tiles, launched straight through the library (so that bfloat16 shapes the
    narrow plans take run the FFMA dw too) with ``ffma_dw_split``'s splits of the dtype, and through the op
    where no plan takes the shape (``launches_dw_ffma_fit`` moves): against ``conv_k2_dw_reference`` (f32
    sums of the same products in another order, 1e-5 of the largest entry) and the float64 sum
    (DW_TOL_F64_REL); the same bits from two launches."""
    assert ffma_dw_fitted(C, N)
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(B, D, H, W, C, generator=gen).to(cuda, dtype)
    g = torch.randn(B, D, H, W, N, generator=gen).to(cuda, dtype)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits, per_split = ffma_dw_split(B * D * H * W, C, N, sms=sms, dtype=dtype)
    workspace = torch.empty(splits if splits > 1 else 0, 8 * C, N, device=cuda)
    dw, again = (torch.empty(2, 2, 2, C, N, device=cuda) for _ in range(2))
    for out in (dw, again):
        k2._check_launch("dw", k2._lib().conv_k2_backward_weight(
            x.data_ptr(), g.data_ptr(), out.data_ptr(), workspace.data_ptr(), splits, per_split, B, D, H, W, C, N,
            k2._DTYPE_CODES[dtype], cuda.index or 0, torch.cuda.current_stream().cuda_stream))
    with torch.no_grad():
        ref, dw64 = conv_k2_dw_reference(x, g), _dw_float64(x, g)
    plan = narrow_plan(B, D, H, W, C, N, dtype=dtype)
    planned = plan is not None and plan.dw_box is not None
    planned = planned or narrow_dw_plan(B, D, H, W, C, N, dtype=dtype) is not None
    if not planned:
        before = (conv_k2.launches_dw, conv_k2.launches_dw_ffma_fit, conv_k2.launches_dw_narrow)
        with torch.no_grad():
            op = conv_k2_dw(x, g)
        assert (conv_k2.launches_dw, conv_k2.launches_dw_ffma_fit, conv_k2.launches_dw_narrow) == (
            before[0] + 1, before[1] + 1, before[2])
        assert torch.equal(op, dw)
    torch.cuda.synchronize()
    assert torch.equal(dw, again)
    assert float((dw - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    tol64 = DW_TOL_F64_REL * float(dw64.abs().max())
    for out in (dw, ref):
        assert float((out.double() - dw64).abs().max()) <= tol64


def test_backward_launches_only_what_is_asked(cuda):
    x = torch.randn(1, 4, 4, 4, 8, device=cuda)
    w = torch.randn(2, 2, 2, 8, 8, device=cuda)
    before = _counts()
    conv_k2(x, w.clone().requires_grad_()).sum().backward()  # data in: no dx
    assert _counts() == (before[0] + 1, before[1], before[2] + 1)
    conv_k2(x.clone().requires_grad_(), w).sum().backward()  # frozen weight: no dw
    assert _counts() == (before[0] + 2, before[1] + 1, before[2] + 1)
    with torch.no_grad():
        conv_k2(x.clone().requires_grad_(), w)
    assert _counts() == (before[0] + 3, before[1] + 1, before[2] + 1)


def test_backward_kernels_pass_gradcheck_style(cuda):
    """Central differences of sum(conv_k2(x, w) * g) in float64 on the CPU
    against the kernels' dx and dw at one tiny f32 shape. (gradcheck itself
    needs float64 inputs, which the kernels do not take.)"""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(1, 2, 3, 2, 8, generator=gen)
    w = torch.randn(2, 2, 2, 8, 8, generator=gen) * 0.2
    g = torch.randn(1, 2, 3, 2, 8, generator=gen)
    xc, wc = x.to(cuda).requires_grad_(), w.to(cuda).requires_grad_()
    conv_k2(xc, wc).backward(g.to(cuda))

    def numeric(t, other_first):
        t64 = t.double()
        out = torch.zeros_like(t64)
        flat, oflat = t64.view(-1), out.view(-1)
        for i in range(flat.numel()):
            vals = []
            for eps in (1e-3, -1e-3):
                flat[i] += eps
                args = (x.double(), t64) if other_first else (t64, w.double())
                vals.append(float((conv_k2_reference(*args) * g.double()).sum()))
                flat[i] -= eps
            oflat[i] = (vals[0] - vals[1]) / 2e-3
        return out.float()

    # the function is bilinear, so central differences are exact up to f64 rounding
    np.testing.assert_allclose(xc.grad.cpu().numpy(), numeric(x, False).numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(wc.grad.cpu().numpy(), numeric(w, True).numpy(), rtol=0, atol=1e-4)


def test_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.randn(1, 4, 4, 4, 8, device=cuda)
    w = torch.randn(2, 2, 2, 8, 8, device=cuda)
    with pytest.raises(ValueError, match="N % 8"):  # dx's depth is (tap, n)
        conv_k2(x.clone().requires_grad_(), torch.randn(2, 2, 2, 8, 4, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        conv_k2(x.transpose(1, 2), w)
    with pytest.raises(TypeError):
        conv_k2(x.half(), w)
    with pytest.raises(ValueError, match="C % 8"):
        conv_k2(torch.randn(1, 4, 4, 4, 4, device=cuda), torch.randn(2, 2, 2, 4, 8, device=cuda))
    with pytest.raises(ValueError, match="on"):
        conv_k2(x, w.cpu())


def small_config(dropout_rate=0.2, planned=False):
    """modelnet_nolbo's layout at 32^3 with narrow filters. ``planned``: the
    four k=2 stages (at 8^3) are 64 -> 64, a width the tensor-core kernels take."""
    base = modelnet_nolbo(z_dim=8, category_dim=5)
    enc, dec = ((8, 64, 16, 32), (32, 16, 64, 8, 1)) if planned else ((8, 16, 16, 32), (32, 16, 16, 8, 1))
    return dataclasses.replace(
        base,
        encoder3d=dataclasses.replace(base.encoder3d, filter_nums=enc),
        decoder=dataclasses.replace(base.decoder, output_shape=(32, 32, 32, 1), filter_nums=dec),
        prior_category=dataclasses.replace(base.prior_category, unit_nums=(16, 8), dropout_rate=dropout_rate),
    )


@pytest.mark.parametrize("planned", [False, True], ids=["narrow", "planned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_small_train_step_on_card_matches_cpu(cuda, dtype, planned):
    """Three train steps of the 32^3 narrow model on the card, through the
    kernels (4 forward, 3 dx, 4 dw launches a step; 4 forward an eval step),
    against the same steps on the CPU from the same weights, batch and draws.
    float32: every metric to rtol 1e-4 at the first step (summation order; later steps
    feel Adam's sign-like first updates). bfloat16: the card's bf16 against
    the CPU's bf16, 5%. In bfloat16 the k=2 stages whose widths have a plan
    take the tensor-core kernels in the forward, in dx and in dw: all 4 at the
    planned width (every one of the 3 dx launches), 2 at the narrow one (its
    64 -> 64 stages: the encoder's first, which has no dx, and the decoder's
    last); in float32 none does."""
    cfg, loss_cfg = small_config(dropout_rate=0.0, planned=planned), loss_config("modelnet_nolbo")
    n_wgmma = 0 if dtype == torch.float32 else 4 if planned else 2
    n_dx_wgmma = 0 if dtype == torch.float32 else 3 if planned else 1
    rng = np.random.default_rng(3)
    vox = (rng.uniform(size=(4, 32, 32, 32, 1)) > 0.7).astype(np.float32)
    batch = {"input_packed_blocked": torch.from_numpy(pack_voxels_blocked(vox, 4)),
             "category_onehot": torch.from_numpy(np.eye(5, dtype=np.float32)[rng.integers(0, 5, 4)])}
    draws = {"eps_inst": torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32)),
             "eps_prior_cat": torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32)),
             "coin": torch.tensor(True), "take_prior": torch.from_numpy(rng.uniform(size=(4, 8)) < 0.3)}
    model_cpu = MultiModalVAE(cfg, generator=torch.Generator().manual_seed(0), dtype=dtype)
    model_gpu = copy.deepcopy(model_cpu).to(cuda)
    history = {}
    for name, model, dev in (("cpu", model_cpu, torch.device("cpu")), ("card", model_gpu, cuda)):
        state, step = create_train_state(model), make_train_step(model, loss_cfg)
        b, d = {k: v.to(dev) for k, v in batch.items()}, {k: v.to(dev) for k, v in draws.items()}
        before, before_wg = _counts(), _wgmma_counts()
        history[name] = []
        for _ in range(3):
            state, metrics = step(state, b, draws=d)
            history[name].append({k: float(v) for k, v in metrics.items()})
        launched = tuple(a - b0 for a, b0 in zip(_counts(), before))
        assert launched == ((12, 9, 12) if name == "card" else (0, 0, 0))
        launched_wg = tuple(a - b0 for a, b0 in zip(_wgmma_counts(), before_wg))
        assert launched_wg == ((3 * n_wgmma, 3 * n_dx_wgmma, 3 * n_wgmma) if name == "card" else (0, 0, 0))
        assert state.step == 3 and all(p.dtype == torch.float32 for p in model.parameters())
    rtol = 1e-4 if dtype == torch.float32 else 0.05
    for k, v in history["cpu"][0].items():
        np.testing.assert_allclose(history["card"][0][k], v, rtol=rtol, atol=1e-6, err_msg=k)
    for row in history["card"]:
        assert all(np.isfinite(v) for v in row.values()) and row["grads_finite"] == 1.0
    assert history["card"][2]["loss_total"] < history["card"][0]["loss_total"]
    np.testing.assert_allclose(history["card"][2]["loss_total"], history["cpu"][2]["loss_total"], rtol=max(rtol, 1e-2))
    before, before_wg = _counts(), _wgmma_counts()
    out = make_eval_step(model_gpu, loss_cfg)(b, torch.Generator(device=cuda).manual_seed(0))
    assert tuple(a - b0 for a, b0 in zip(_counts(), before)) == (4, 0, 0)
    assert tuple(a - b0 for a, b0 in zip(_wgmma_counts(), before_wg)) == (n_wgmma, 0, 0)
    assert all(torch.isfinite(v) for v in out.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mid_blocked_flagship_layout_on_card_matches_cpu(cuda, dtype):
    """``modelnet_nolbo`` at full width with ``mid_blocked`` on its encoder
    and decoder, a served batch of 2: 8 ``conv_k2`` launches (the blocked
    head's and tail's 2 each, the folded encoder stages at 8^3 and 4^3, the
    decoder's middle stages), all on the tensor cores in bfloat16 (the 4^3
    boxes span both items). float32 against the CPU within chip_smoke.py's
    ``SLICE_TOL_F32`` (1e-3: ~20 layers of f32 in another order); bfloat16
    against the CPU's float32 within its 5%."""
    base = modelnet_nolbo()
    cfg = dataclasses.replace(base, encoder3d=dataclasses.replace(base.encoder3d, mid_blocked=True),
                              decoder=dataclasses.replace(base.decoder, mid_blocked=True))
    model = MultiModalVAE(cfg, generator=torch.Generator().manual_seed(0)).eval()
    card = copy.deepcopy(model).to(dtype).to(cuda)
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.uniform(size=(2, 64, 64, 64, 1)) > 0.7).astype(np.float32))
    mask = torch.from_numpy((rng.uniform(size=(2, 64)) < 0.5).astype(np.float32))
    with torch.inference_mode():
        ref = make_infer_fn(model)(x, mask)
        before, before_wg = conv_k2.launches, conv_k2.launches_wgmma
        out = make_infer_fn(card)(x.to(cuda, dtype), mask.to(cuda))
        torch.cuda.synchronize()
    assert conv_k2.launches == before + 8
    assert conv_k2.launches_wgmma == before_wg + (8 if dtype == torch.bfloat16 else 0)
    tol = 1e-3 if dtype == torch.float32 else 0.05
    for k in ("z_mean", "pred"):
        got, want = out[k].float().cpu(), ref[k]
        assert torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= tol * max(1.0, float(want.abs().max())), k
    if dtype == torch.float32:
        assert torch.equal(out["category"].cpu(), ref["category"])


def test_small_slice_on_card_matches_cpu(cuda):
    """modelnet_nolbo's layout at 32^3 with narrow filters: served on the card
    through the kernel (4 launches a batch), equal to the CPU run within f32
    summation-order tolerance."""
    cfg = small_config()
    model = MultiModalVAE(cfg, generator=torch.Generator().manual_seed(0))
    model_gpu = copy.deepcopy(model).to(cuda)
    rng = np.random.default_rng(0)
    x = (rng.uniform(size=(4, 32, 32, 32, 1)) > 0.7).astype(np.float32)
    mask = torch.from_numpy((rng.uniform(size=(4, 8)) < 0.5).astype(np.float32))
    before = conv_k2.launches
    out = make_packed_infer(model_gpu, (32, 32, 32, 1))(torch.from_numpy(pack_voxels(x)).to(cuda), mask.to(cuda))
    assert conv_k2.launches == before + 4
    assert out["pred_packed"].device.type == "cuda"
    ref = make_infer_fn(model)(torch.from_numpy(x), mask)
    assert torch.equal(out["category"].cpu(), ref["category"])
    np.testing.assert_allclose(out["z_mean"].cpu().numpy(), ref["z_mean"].numpy(), rtol=1e-4, atol=1e-4)
    gpu = make_infer_fn(model_gpu)(torch.from_numpy(x).to(cuda), mask.to(cuda))
    np.testing.assert_allclose(gpu["pred"].cpu().numpy(), ref["pred"].numpy(), rtol=0, atol=1e-4)


def test_small_bf16_slice_on_card_takes_tensor_cores(cuda):
    """The same layout at a width with a plan, served in bfloat16 on the card:
    all 4 launches a batch on the tensor-core forward, the outputs within
    bfloat16's reach of the float32 CPU run of the same weights."""
    cfg = small_config(planned=True)
    model = MultiModalVAE(cfg, generator=torch.Generator().manual_seed(0))
    model_bf16 = copy.deepcopy(model).to(torch.bfloat16).to(cuda)
    rng = np.random.default_rng(0)
    x = (rng.uniform(size=(4, 32, 32, 32, 1)) > 0.7).astype(np.float32)
    mask = torch.from_numpy((rng.uniform(size=(4, 8)) < 0.5).astype(np.float32))
    before, before_wg = conv_k2.launches, conv_k2.launches_wgmma
    out = make_packed_infer(model_bf16, (32, 32, 32, 1))(torch.from_numpy(pack_voxels(x)).to(cuda), mask.to(cuda))
    assert (conv_k2.launches, conv_k2.launches_wgmma) == (before + 4, before_wg + 4)
    ref = make_infer_fn(model)(torch.from_numpy(x), mask)
    z = out["z_mean"].float().cpu()
    # bf16 keeps 8 bits of mantissa through every layer: 5% of the largest |z_mean|, as chip_smoke.py holds it
    assert torch.isfinite(z).all()
    assert float((z - ref["z_mean"]).abs().max()) <= 0.05 * max(1.0, float(ref["z_mean"].abs().max()))


@pytest.mark.parametrize("dtype,shape", [(torch.float32, (1, 3, 4, 5, 48, 16)), (torch.bfloat16, (1, 8, 8, 8, 64, 64)),
                                         (torch.bfloat16, (2, 8, 8, 8, 32, 8)), (torch.float32, (1, 3, 4, 5, 8, 16)),
                                         (torch.bfloat16, (4, 4, 4, 4, 64, 64)),
                                         (torch.bfloat16, (2, 4, 4, 4, 256, 256)),
                                         (torch.float32, (2, 4, 4, 4, 512, 64))],
                         ids=["f32_ffma", "bf16_wgmma", "bf16_narrow", "f32_narrow", "bf16_wgmma_4cubed",
                              "bf16_wgmma_split", "f32_ffma_split"])
@pytest.mark.parametrize("op", ["conv_k2", "conv_k2_dx", "conv_k2_dw"])
def test_ops_pass_opcheck_on_the_card(cuda, op, dtype, shape):
    """The three ops on CUDA tensors: schema, autograd registration (the
    forward's backward calls the dx and dw ops), the fake implementation
    against the kernel's output, and an AOT-autograd trace; in float32 at
    C = 48, which has no narrow plan (rows past 128 bytes that are not whole
    chunks of 32: all FFMA); in bfloat16 at a shape with
    a plan (8^3, and 4^3, whose boxes span two items), so the tensor-core
    kernels answer; at 32 -> 8, where the narrow
    forward, dx (8 -> 32) and dw do; in float32 at 8 -> 16, where the
    narrow FFMA forward, dx (16 -> 8) and dw do; in bfloat16 at 4^3, 256
    -> 256, B=2, whose forward and dx split their depth in two and reduce (and
    whose dw is the persistent kernel); and in float32 at 4^3, 512 -> 64, B=2,
    whose FFMA forward splits its depth in 16 and dx in 2."""
    *grid, C, N = shape
    assert (narrow_plan(*grid, C, N, dtype=dtype) is None) == (shape[4] > 32)
    assert (narrow_plan(*grid, N, C, dtype=dtype) is None) == (shape[4] > 32)
    if C == 256:
        assert wgmma_plan(*grid, C, N).splits == wgmma_plan(*grid, N, C).splits == 2
        assert wgmma_plan(*grid, C, N).dw_persistent is not None
    if C == 512:
        assert k2.ffma_split(*grid, C, N)[0] == 16 and k2.ffma_split(*grid, N, C)[0] == 2
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(*grid, C, generator=gen).to(cuda, dtype)
    w = (torch.randn(2, 2, 2, C, N, generator=gen) * 0.1).to(cuda)
    g = torch.randn(*grid, N, generator=gen).to(cuda, dtype)
    fn, args = {"conv_k2": (k2._conv_k2_op, (x.requires_grad_(), w.requires_grad_())),
                "conv_k2_dx": (k2._conv_k2_dx_op, (g, w.detach())),
                "conv_k2_dw": (k2._conv_k2_dw_op, (x.detach(), g))}[op]
    results = torch.library.opcheck(fn, args)
    assert set(results.values()) == {"SUCCESS"}, results


def test_exported_bf16_packed_program_takes_tensor_cores(cuda):
    """``export_infer`` of the planned 32^3 model in bfloat16 with packed IO,
    loaded with ``load_infer``: 4 forward launches a batch, all on the
    tensor-core kernel, counted by the op's CUDA implementation; the outputs
    equal the eager program's."""
    model = MultiModalVAE(small_config(planned=True), generator=torch.Generator().manual_seed(0))
    model = model.to(torch.bfloat16).to(cuda)
    fn = load_infer(export_infer(model, (4, 32, 32, 32, 1), packed_input=True, packed_output=True))
    assert fn.device.type == "cuda" and fn.input_dtype == torch.uint8
    rng = np.random.default_rng(1)
    packed = torch.from_numpy(pack_voxels((rng.uniform(size=(4, 32, 32, 32, 1)) > 0.7).astype(np.float32))).to(cuda)
    mask = torch.from_numpy((rng.uniform(size=(4, 8)) < 0.5).astype(np.float32)).to(cuda)
    before, before_wg = conv_k2.launches, conv_k2.launches_wgmma
    outs = [fn(packed, mask) for _ in range(3)]
    assert (conv_k2.launches, conv_k2.launches_wgmma) == (before + 12, before_wg + 12)
    eager = make_packed_infer(model, (32, 32, 32, 1))(packed, mask)
    # the same ops on the same weights: equal unless cuDNN picks another algorithm for the other caller
    assert torch.equal(outs[-1]["category"], eager["category"])
    for k in ("z_mean", "z_log_var"):
        assert float((outs[-1][k] - eager[k]).abs().max()) <= 2.0**-7 * max(1.0, float(eager[k].abs().max())), k
    flips = np.unpackbits((outs[-1]["pred_packed"] ^ eager["pred_packed"]).cpu().numpy()).sum()
    assert flips <= 1e-4 * 8 * eager["pred_packed"].numel()


def test_prefetched_batches_equal_direct_copies(cuda):
    """10 batches through the prefetcher's pinned buffers and side stream,
    each equal to a direct ``.to("cuda")`` of the same arrays."""
    def make(i):
        rng = np.random.default_rng(i)
        return {"bits": rng.integers(0, 256, (4, 4096), dtype=np.uint8),
                "onehot": np.eye(5, dtype=np.float32)[rng.integers(0, 5, 4)]}

    steps = iter(range(10))
    pf = DevicePrefetcher(lambda: make(next(steps)), cuda, depth=2)
    try:
        got = [pf.get() for _ in range(10)]
        for i, batch in enumerate(got):
            want = {k: torch.from_numpy(v).to(cuda) for k, v in make(i).items()}
            assert batch.keys() == want.keys()
            for k in want:
                assert batch[k].device.type == "cuda" and torch.equal(batch[k], want[k]), (i, k)
    finally:
        pf.close()


def test_prefetched_batches_of_changing_shape_equal_direct_copies(cuda):
    """A multi-scale stream (the image shape changes every other batch): each
    batch equal to a direct copy, and each slot keeps one pinned buffer a
    (key, shape, dtype), allocated once."""
    def make(i):
        side = 24 if i % 2 else 16
        return {"input": np.random.default_rng(i).uniform(size=(2, side, side + 8, 3)).astype(np.float32)}

    steps = iter(range(12))
    pf = DevicePrefetcher(lambda: make(next(steps)), cuda, depth=2)
    try:
        for i in range(12):
            batch = pf.get()
            assert torch.equal(batch["input"], torch.from_numpy(make(i)["input"]).to(cuda)), i
        for slot in pf._slots:
            assert {spec[1] for spec in slot.buffers} <= {(2, 16, 24, 3), (2, 24, 32, 3)}
    finally:
        pf.close()


def test_prefetched_batch_is_read_after_its_copy(cuda):
    """The side stream is held busy before each copy, so at ``get`` the copy
    has not run yet. Waiting on the current stream, then poisoning the pinned
    buffer the batch came from, must leave the batch intact: the current
    stream waited on the copy's event, and the device tensor owns its memory.
    (The worker cannot refill that buffer yet: the queue holds 2 batches and
    the worker stages the 4th into the 4th buffer.)"""
    holder, ready = {}, threading.Event()

    def make():
        ready.wait(10)
        with torch.cuda.stream(holder["pf"].stream):
            torch.cuda._sleep(200_000_000)  # ~0.1 s of the side stream before the copy
        return {"x": np.full((256, 1024), 7.0, np.float32)}

    pf = DevicePrefetcher(make, cuda, depth=2)
    holder["pf"] = pf
    ready.set()
    try:
        batch = pf.get()
        torch.cuda.current_stream().synchronize()
        pf._slots[0].buffers[("x", (256, 1024), torch.float32)].fill_(-1.0)
        assert bool((batch["x"] == 7.0).all())
    finally:
        pf.close()


@pytest.mark.parametrize("missing_prob", [0.0, 0.5])
def test_anytime_eval_on_card_matches_cpu(cuda, missing_prob):
    """The anytime protocol on the 32^3 narrow model, card f32 against CPU f32
    on the same weights, batch and draws: equal accuracies, losses to rtol
    1e-4 (summation order), P and R to 1e-3; 4 forward launches a clean
    batch, 6 a masked one."""
    cfg = small_config()
    rng = np.random.default_rng(4)
    vox = (rng.uniform(size=(4, 32, 32, 32, 1)) > 0.7).astype(np.float32)
    batch = {"input_packed_blocked": torch.from_numpy(pack_voxels_blocked(vox, 4)),
             "category_onehot": torch.from_numpy(np.eye(5, dtype=np.float32)[rng.integers(0, 5, 4)])}
    draws = {"eps_cat": torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32)),
             "keep": torch.from_numpy(rng.uniform(size=(4, 8)) < 0.5),
             "eps_corr": torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))}
    model = MultiModalVAE(cfg, generator=torch.Generator().manual_seed(0))
    model_gpu = copy.deepcopy(model).to(cuda)
    ref = anytime_eval(model, batch, missing_prob=missing_prob, draws=draws, return_pred=True)
    before = conv_k2.launches
    got = anytime_eval(model_gpu, {k: v.to(cuda) for k, v in batch.items()}, missing_prob=missing_prob,
                       draws={k: v.to(cuda) for k, v in draws.items()}, return_pred=True)
    assert conv_k2.launches == before + (6 if missing_prob else 4)
    assert set(got) == set(ref)
    for k, v in ref.items():
        g = got[k].cpu()
        if k.startswith("pred"):
            np.testing.assert_allclose(g.numpy(), v.numpy(), rtol=0, atol=1e-4, err_msg=k)
        elif k.startswith("acc"):
            assert float(g) == float(v), k
        elif k.startswith(("precision", "recall")):
            assert abs(float(g) - float(v)) <= 1e-3, k
        else:
            np.testing.assert_allclose(float(g), float(v), rtol=1e-4, err_msg=k)


def small_image_config():
    """pascal_nolbo's layout (Darknet19 at full width, z = 8 + 8) with the
    decoder cut to 32^3; its two k=2 stages (at 8^3) are 64 -> 64, a width
    the tensor-core kernels take. The prior nets' dropout at 0 (their masks
    cannot be injected)."""
    base = pascal_nolbo()
    return dataclasses.replace(
        base,
        decoder=dataclasses.replace(base.decoder, output_shape=(32, 32, 32, 1), filter_nums=(32, 16, 64, 8, 1)),
        prior_category=dataclasses.replace(base.prior_category, dropout_rate=0.0),
        prior_inst=dataclasses.replace(base.prior_inst, dropout_rate=0.0),
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_small_image_model_on_card_matches_cpu(cuda, dtype):
    """The image path on the card against the CPU, from the same weights,
    images, targets and draws: served (2 forward launches a batch: the
    decoder tail's two k=2 stages), then two train steps (2 forward, 2 dx and
    2 dw launches a step, all on the tensor-core kernels in bfloat16, none in
    float32). float32: served outputs to 1e-4, the first step's metrics to
    rtol 1e-4 (summation order); bfloat16: the card's bf16 against the CPU's
    bf16, 5%."""
    cfg, loss_cfg = small_image_config(), loss_config("pascal_nolbo")
    rng = np.random.default_rng(6)
    n = 2
    images = rng.uniform(size=(n, 32, 48, 3)).astype(np.float32)
    vox = (rng.uniform(size=(n, 32, 32, 32, 1)) > 0.7).astype(np.float32)
    batch = {"input": torch.from_numpy(images), "target_packed_blocked": torch.from_numpy(pack_voxels_blocked(vox, 4)),
             "category_onehot": torch.from_numpy(np.eye(12, dtype=np.float32)[[3, 3]]),
             "inst_onehot": torch.from_numpy(np.eye(10, dtype=np.float32)[[1, 7]])}
    draws = {k: torch.from_numpy(rng.normal(size=(n, 8)).astype(np.float32))
             for k in ("eps_cat", "eps_inst", "eps_prior_cat", "eps_prior_inst")}
    draws.update(coin=torch.tensor(True), take_prior=torch.from_numpy(rng.uniform(size=(n, 16)) < 0.5))
    model_cpu = MultiModalVAE(cfg, generator=torch.Generator().manual_seed(0), dtype=dtype)
    model_gpu = copy.deepcopy(model_cpu).to(cuda)
    n_wgmma = 2 if dtype == torch.bfloat16 else 0

    if dtype == torch.float32:
        mask = torch.from_numpy((rng.uniform(size=(n, 8)) < 0.5).astype(np.float32))
        ref = make_infer_fn(model_cpu)(batch["input"], mask)
        before = _counts()
        out = make_infer_fn(model_gpu)(batch["input"].to(cuda), mask.to(cuda))
        assert tuple(a - b for a, b in zip(_counts(), before)) == (2, 0, 0)
        assert torch.equal(out["category"].cpu(), ref["category"])
        for k in ("z_mean", "pred"):
            np.testing.assert_allclose(out[k].cpu().numpy(), ref[k].numpy(), rtol=0, atol=1e-4, err_msg=k)

    history = {}
    for name, model, dev in (("cpu", model_cpu, torch.device("cpu")), ("card", model_gpu, cuda)):
        state, step = create_train_state(model), make_train_step(model, loss_cfg)
        b, d = {k: v.to(dev) for k, v in batch.items()}, {k: v.to(dev) for k, v in draws.items()}
        before, before_wg = _counts(), _wgmma_counts()
        history[name] = []
        for _ in range(2):
            state, metrics = step(state, b, draws=d)
            history[name].append({k: float(v) for k, v in metrics.items()})
        launched = tuple(a - b0 for a, b0 in zip(_counts(), before))
        launched_wg = tuple(a - b0 for a, b0 in zip(_wgmma_counts(), before_wg))
        assert launched == ((4, 4, 4) if name == "card" else (0, 0, 0))
        assert launched_wg == ((2 * n_wgmma,) * 3 if name == "card" else (0, 0, 0))
    rtol = 1e-4 if dtype == torch.float32 else 0.05
    for k, v in history["cpu"][0].items():
        np.testing.assert_allclose(history["card"][0][k], v, rtol=rtol, atol=1e-6, err_msg=k)
    for row in history["card"]:
        assert all(np.isfinite(v) for v in row.values()) and row["grads_finite"] == 1.0


# (B, grid, C) of the detector decoder's final conv, N = 8 (no plan: N % 64): the tiny test model's (C=8),
# the reference scale's (C=32 at 32^3; a train step decodes B*4 = 32 grids) and the default config's (C=64)
N8_SHAPES = [(2, 8, 8), (4, 32, 32), (2, 32, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,G,C", N8_SHAPES)
def test_kernels_match_plain_at_n8(cuda, B, G, C, dtype):
    """Forward, dx and dw at N = 8 against their plain versions: in bfloat16
    the forward and dw on the narrow kernels, and dx where its forward from 8
    to C channels has a narrow plan (C = 8, 32; at C = 64 the chunked dx,
    counted as narrow too); in float32
    all three on the narrow kernels where C <= 32 (at C = 64 the forward
    walks C in chunks of 16, dx and dw stay FFMA). The counters of the narrow
    kernels move as that says, no tensor-core one does; dw gives the same
    bits twice. Tolerances as ``test_kernel_matches_plain`` and
    ``test_backward_kernels_match_plain``."""
    assert wgmma_plan(B, G, G, G, C, 8) is None
    bf16 = dtype == torch.bfloat16
    assert narrow_plan(B, G, G, G, C, 8) is not None
    plan = narrow_plan(B, G, G, G, C, 8, dtype=dtype)
    narrow_fwd, narrow_dw = plan is not None, plan is not None and plan.dw_box is not None
    narrow_dx = narrow_plan(B, G, G, G, 8, C, dtype=dtype) is not None
    assert narrow_fwd and narrow_dw == (bf16 or C <= 32) and narrow_dx == (C <= 32)
    assert (chunked_dx_plan(B, G, G, G, C, 8) is not None) == (C == 64)
    narrow_dx = narrow_dx or (bf16 and C == 64)
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(B, G, G, G, C, generator=gen).to(cuda, dtype)
    w = (torch.randn(2, 2, 2, C, 8, generator=gen) / (8 * C) ** 0.5).to(cuda, dtype)
    g = torch.randn(B, G, G, G, 8, generator=gen).to(cuda, dtype)
    before, before_wg, before_nr = _counts(), _wgmma_counts(), _narrow_counts()
    with torch.inference_mode():
        y, dx, dw = conv_k2(x, w), k2.conv_k2_dx(g, w), conv_k2_dw(x, g)
        again = conv_k2_dw(x, g)
        y_ref, dx_ref, dw_ref = conv_k2_reference(x, w), k2.conv_k2_dx_reference(g, w), conv_k2_dw_reference(x, g)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1] + 1, before[2] + 2) and _wgmma_counts() == before_wg
    assert _narrow_counts() == (before_nr[0] + narrow_fwd, before_nr[1] + narrow_dx, before_nr[2] + 2 * narrow_dw)
    assert torch.equal(dw, again)
    for out, ref in ((y, y_ref), (dx, dx_ref)):
        assert out.shape == ref.shape and out.dtype == dtype
        tol = 1e-4 if dtype == torch.float32 else 2.0**-7 * float(ref.float().abs().max())
        assert float((out.float() - ref.float()).abs().max()) <= tol
    assert dw.dtype == torch.float32 and dw.shape == (2, 2, 2, C, 8)
    assert float((dw - dw_ref.float()).abs().max()) <= 1e-5 * float(dw_ref.float().abs().max()) + 1e-5


# (B, D, H, W, C, N) at the edges of the narrow plan: C = 8 (half the warps
# idle in dw), 64 (4 m-tiles a warp) and 16, 32; N = 8, 16, 32; a whole-grid
# box of 210 rows (not a multiple of 16), a w-line longer than a box, ragged
# last boxes along every axis, and the detector's 32^3 at C = 32 -> 8 with
# several boxes a block and a split. dx is the forward from N to C: narrow
# where that has a plan (all but 64 -> 16 and 64 -> 32), among them 8 -> 32
# (the detector's dx) and 8 -> 16 with several boxes a block (16 -> 8 at 16^3,
# B = 40); and float32's forward at each C <= 32
NARROW_EDGES = [(3, 8, 8, 8, 8, 8), (1, 8, 8, 8, 64, 16), (3, 5, 6, 7, 32, 32), (1, 2, 2, 256, 16, 8),
                (2, 9, 10, 40, 16, 8), (1, 33, 33, 33, 8, 16), (2, 32, 32, 32, 64, 32), (6, 32, 32, 32, 32, 8),
                (40, 16, 16, 16, 16, 8), (3, 9, 10, 40, 32, 8)]


def _float64_forward(x, w):
    """conv_k2 as a float64 product of the same operands, tap by tap."""
    _, D, H, W, C = x.shape
    xp = torch.nn.functional.pad(x.double(), (0, 0) + (0, 1) * 3)
    w64 = w.double().reshape(8, C, -1)
    return sum(xp[:, t >> 2:(t >> 2) + D, (t >> 1) & 1:((t >> 1) & 1) + H, t & 1:(t & 1) + W] @ w64[t]
               for t in range(8))


@pytest.mark.parametrize("B,D,H,W,C,N", NARROW_EDGES)
def test_narrow_kernels_match_plain_and_float64(cuda, B, D, H, W, C, N):
    """bfloat16 shapes with a narrow plan, through autograd: the forward and
    dw on the narrow kernels, dx too where its forward from N to C has a
    narrow plan (C <= 32), else (C = 64) on the chunked dx, counted as narrow
    too (the counters move as that says, no tensor-core one does). The forward and dx against their plain versions
    (2^-7 of the largest output) and, the forward and a narrow or chunked dx,
    both sides against a float64 product (an f32 sum rounded once to bf16, half an
    ulp of the largest entry, plus the sum's own error); dw against its plain
    version (f32 sums in another order, 1e-5 of the largest entry) and both
    against the float64 sum (DW_TOL_F64_REL); dw the same bits from two
    calls."""
    assert wgmma_plan(B, D, H, W, C, N) is None and narrow_plan(B, D, H, W, C, N) is not None
    narrow_dx = narrow_plan(B, D, H, W, N, C) is not None
    assert narrow_dx == (C <= 32) and (chunked_dx_plan(B, D, H, W, C, N) is not None) == (C == 64)
    narrow_dx = narrow_dx or C == 64
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(B, D, H, W, C, generator=gen).to(cuda, torch.bfloat16).requires_grad_()
    w = (torch.randn(2, 2, 2, C, N, generator=gen) / (8 * C) ** 0.5).to(cuda).requires_grad_()  # an f32 parameter
    g = torch.randn(B, D, H, W, N, generator=gen).to(cuda, torch.bfloat16)
    before, before_wg, before_nr = _counts(), _wgmma_counts(), _narrow_counts()
    y = conv_k2(x, w)
    y.backward(g.permute(0, 4, 1, 2, 3).contiguous().permute(0, 2, 3, 4, 1))  # a permuted view
    y = y.detach()
    assert _counts() == (before[0] + 1, before[1] + 1, before[2] + 1) and _wgmma_counts() == before_wg
    assert _narrow_counts() == (before_nr[0] + 1, before_nr[1] + narrow_dx, before_nr[2] + 1)
    wb = w.detach().to(torch.bfloat16)
    with torch.no_grad():
        y_ref = conv_k2_reference(x.detach(), wb)
        dx_ref, dw_ref = conv_k2_backward_reference(x.detach(), w.detach(), g)
        again = conv_k2_dw(x.detach(), g), conv_k2_dw(x.detach(), g)
        dw64 = _dw_float64(x.detach(), g)
        y64 = _float64_forward(x.detach(), wb)
        dx64 = _dx_float64(g, wb)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and y.shape == (B, D, H, W, N)
    assert float((y.float() - y_ref.float()).abs().max()) <= 2.0**-7 * float(y_ref.float().abs().max())
    tol_y64 = (2.0**-8 + DW_TOL_F64_REL) * float(y64.abs().max())
    assert float((y.double() - y64).abs().max()) <= tol_y64
    assert float((y_ref.double() - y64).abs().max()) <= tol_y64
    assert x.grad.dtype == torch.bfloat16 and x.grad.shape == x.shape
    assert float((x.grad.float() - dx_ref.float()).abs().max()) <= 2.0**-7 * float(dx_ref.float().abs().max())
    if narrow_dx:
        tol_dx64 = (2.0**-8 + DW_TOL_F64_REL) * float(dx64.abs().max())
        assert float((x.grad.double() - dx64).abs().max()) <= tol_dx64
        assert float((dx_ref.double() - dx64).abs().max()) <= tol_dx64
    assert w.grad.dtype == torch.float32 and torch.equal(again[0], again[1]) and torch.equal(again[0], w.grad)
    assert float((w.grad - dw_ref).abs().max()) <= 1e-5 * float(dw_ref.abs().max())
    tol_dw64 = DW_TOL_F64_REL * float(dw64.abs().max())
    assert float((w.grad.double() - dw64).abs().max()) <= tol_dw64
    assert float((dw_ref.double() - dw64).abs().max()) <= tol_dw64


@pytest.mark.parametrize("B,D,H,W,C,N", [s for s in NARROW_EDGES if s[4] <= 32])
def test_f32_narrow_forward_matches_plain_and_float64(cuda, B, D, H, W, C, N):
    """float32 shapes with a narrow plan, through autograd: the forward, dx
    and dw on the narrow FFMA kernels (their counters move). The forward
    against its plain version (true f32, summation order only: 1e-4, as
    ``test_kernel_matches_plain``) and both against a float64 product (f32
    sums of at most 256 products: 1e-5 of the largest entry); dx and dw
    against their plain versions as ``test_backward_kernels_match_plain``
    (``test_f32_narrow_backward_matches_plain_and_float64`` holds them to
    float64)."""
    plan = narrow_plan(B, D, H, W, C, N, dtype=torch.float32)
    assert plan is not None and wgmma_plan(B, D, H, W, C, N) is None
    gen = torch.Generator().manual_seed(13)
    x = torch.randn(B, D, H, W, C, generator=gen).to(cuda).requires_grad_()
    w = (torch.randn(2, 2, 2, C, N, generator=gen) / (8 * C) ** 0.5).to(cuda).requires_grad_()
    g = torch.randn(B, D, H, W, N, generator=gen).to(cuda)
    before, before_wg, before_nr = _counts(), _wgmma_counts(), _narrow_counts()
    y = conv_k2(x, w)
    y.backward(g)
    y = y.detach()
    assert _counts() == (before[0] + 1, before[1] + 1, before[2] + 1) and _wgmma_counts() == before_wg
    assert _narrow_counts() == (before_nr[0] + 1, before_nr[1] + 1, before_nr[2] + 1)
    with torch.no_grad():
        y_ref = conv_k2_reference(x.detach(), w.detach())
        dx_ref, dw_ref = conv_k2_backward_reference(x.detach(), w.detach(), g)
        y64 = _float64_forward(x.detach(), w.detach())
    torch.cuda.synchronize()
    assert y.dtype == torch.float32 and y.shape == (B, D, H, W, N)
    assert float((y - y_ref).abs().max()) <= 1e-4
    tol_y64 = 1e-5 * float(y64.abs().max())
    assert float((y.double() - y64).abs().max()) <= tol_y64
    assert float((y_ref.double() - y64).abs().max()) <= tol_y64
    assert float((x.grad - dx_ref).abs().max()) <= 1e-4
    assert float((w.grad - dw_ref).abs().max()) <= 1e-5 * float(dw_ref.abs().max()) + 1e-5


@pytest.mark.parametrize("B,D,H,W,C,N", [s for s in NARROW_EDGES if s[4] <= 32])
def test_f32_narrow_backward_matches_plain_and_float64(cuda, B, D, H, W, C, N):
    """float32 dx and dw of shapes with a narrow plan, called as the ops:
    dx on the narrow FFMA kernel's DX instance (the forward from N to C, its
    halo box one voxel lower), dw on the narrow FFMA dw (their counters
    move, no other design's). dx against its plain version (true f32,
    summation order only: 1e-4) and both against a float64 product (f32 sums
    of at most 256 products: 1e-5 of the largest entry); dw against its
    plain version (f32 sums in another order: 1e-5 of the largest entry and
    1e-5) and both against the float64 sum (DW_TOL_F64_REL); dw the same bits
    from two calls."""
    assert narrow_plan(B, D, H, W, N, C, dtype=torch.float32) is not None
    gen = torch.Generator().manual_seed(17)
    x = torch.randn(B, D, H, W, C, generator=gen).to(cuda)
    w = (torch.randn(2, 2, 2, C, N, generator=gen) / (8 * C) ** 0.5).to(cuda)
    g = torch.randn(B, D, H, W, N, generator=gen).to(cuda)
    before, before_wg, before_nr = _counts(), _wgmma_counts(), _narrow_counts()
    with torch.no_grad():
        dx, dw, again = k2.conv_k2_dx(g, w), conv_k2_dw(x, g), conv_k2_dw(x, g)
        dx_ref, dw_ref = k2.conv_k2_dx_reference(g, w), conv_k2_dw_reference(x, g)
        dx64, dw64 = _dx_float64(g, w), _dw_float64(x, g)
    torch.cuda.synchronize()
    assert _counts() == (before[0], before[1] + 1, before[2] + 2) and _wgmma_counts() == before_wg
    assert _narrow_counts() == (before_nr[0], before_nr[1] + 1, before_nr[2] + 2)
    assert dx.dtype == torch.float32 and dx.shape == (B, D, H, W, C)
    assert float((dx - dx_ref).abs().max()) <= 1e-4
    tol_dx64 = 1e-5 * float(dx64.abs().max())
    assert float((dx.double() - dx64).abs().max()) <= tol_dx64
    assert float((dx_ref.double() - dx64).abs().max()) <= tol_dx64
    assert dw.dtype == torch.float32 and dw.shape == (2, 2, 2, C, N) and torch.equal(dw, again)
    assert float((dw - dw_ref).abs().max()) <= 1e-5 * float(dw_ref.abs().max()) + 1e-5
    tol_dw64 = DW_TOL_F64_REL * float(dw64.abs().max())
    assert float((dw.double() - dw64).abs().max()) <= tol_dw64
    assert float((dw_ref.double() - dw64).abs().max()) <= tol_dw64


def small_detector_config():
    """The detector with Darknet53Tiny, a 32-wide head, 3 predictors, z = 4 and
    the CLI's pixel-shuffle decoder cut to 16^3 (its last conv 16 -> 8 at 8^3)."""
    return DetectorConfig(predictor_num=3, z_inst_dim=4, backbone="darknet53tiny", head_filter_nums=(32,),
                          head_filter_sizes=(3,), max_detections=8, shape_samples=4,
                          decoder=Decoder3DConfig(input_dim=4, output_shape=(16, 16, 16, 1), filter_nums=(32, 16, 1),
                                                  filter_sizes=(4, 4, 4), strides=(1, 2, 2)))


def test_small_detector_on_card_matches_cpu(cuda):
    """``detect`` on the card equal to the CPU from the same weights and frame
    (equal ``valid`` and the same slots; f32, summation order: 1e-4), the
    posterior-mean shapes of the K slots (one forward launch), and the
    exported per-frame program on the card, which syncs with the host nowhere."""
    model_cpu = DetectorReconstructor(small_detector_config(), generator=torch.Generator().manual_seed(0))
    model_gpu = copy.deepcopy(model_cpu).to(cuda)
    frame = torch.from_numpy(np.random.default_rng(7).uniform(size=(1, 64, 64, 3)).astype(np.float32))
    with torch.inference_mode():
        ref = model_cpu.detect(frame, 0.3, 0.5)
        out = model_gpu.detect(frame.to(cuda), 0.3, 0.5)
        shapes_ref = model_cpu.reconstruct(ref["z_mean"], ref["z_log_var"], sample=False)
        before = _counts()
        shapes = model_gpu.reconstruct(out["z_mean"], out["z_log_var"], sample=False)
        assert tuple(a - b for a, b in zip(_counts(), before)) == (1, 0, 0)
    assert torch.equal(out["valid"].cpu(), ref["valid"])
    for k in ref:
        if k != "valid":
            np.testing.assert_allclose(out[k].cpu().numpy(), ref[k].numpy(), rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(shapes.cpu().numpy(), shapes_ref.numpy(), rtol=0, atol=1e-4)
    fn = load_infer(export_detector(model_gpu, (1, 64, 64, 3), 0.3, 0.5))
    frame_gpu = frame.to(cuda)
    fn(frame_gpu)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        served = fn(frame_gpu)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(served["valid"].cpu(), ref["valid"])
    np.testing.assert_allclose(served["vox"].cpu().numpy(), shapes_ref.numpy(), rtol=0, atol=1e-4)


# sha256 over np.packbits(instance_grid(cls, inst, 32) > 0.5) for cls 0..7, inst 0..3, in that order: the
# native voxelizer's grids, which tests/test_torch_voxelize.py holds bit-equal to the JAX package's and to this digest
INSTANCE_GRIDS_SHA256 = "adc83819f9edd454563080cc31fad453f4964f6cee72bbe0a0d265e0adc4e16e"


def instance_grids_digest() -> str:
    import hashlib

    from anytime3d_tpu_torch.data.instances import instance_grid

    digest = hashlib.sha256()
    for cls in range(8):
        for inst in range(4):
            digest.update(np.packbits(instance_grid(cls, inst, 32) > 0.5).tobytes())
    return digest.hexdigest()


def test_native_instance_grids_on_the_card_host(cuda):
    """The native voxelizer built with ``-march=native`` on the card's host
    gives the structural shapes that the CPU tests hold to the JAX package's."""
    from anytime3d_tpu_torch.data import voxelize

    before = voxelize.voxelize.numpy_calls
    assert instance_grids_digest() == INSTANCE_GRIDS_SHA256
    assert voxelize.voxelize.numpy_calls == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_classifier_step_on_card_matches_cpu(cuda, dtype):
    """Two darknet19 classifier steps (B=2, 64x64, 10 classes) on the card
    against the CPU from the same weights and batch: f32 logits to 1e-4 of
    their largest entry and the first step's metrics to rtol 1e-4 (summation
    order), top-1 / top-5 equal; bf16 the card's against the CPU's bf16, 5%.
    No conv_k2 launch: the 2-D convolutions are cuDNN's."""
    from anytime3d_tpu_torch.models.classifier import Classifier, ClassifierConfig
    from anytime3d_tpu_torch.train.classifier_step import make_classifier_train_step

    rng = np.random.default_rng(9)
    batch = {"images": torch.from_numpy(rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)),
             "labels": torch.from_numpy(np.eye(10, dtype=np.float32)[[2, 7]])}
    model_cpu = Classifier(ClassifierConfig(num_classes=10), generator=torch.Generator().manual_seed(0), dtype=dtype)
    model_gpu = copy.deepcopy(model_cpu).to(cuda)
    if dtype == torch.float32:
        with torch.no_grad():
            ref, got = model_cpu(batch["images"]), model_gpu(batch["images"].to(cuda)).cpu()
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-4 * float(ref.abs().max()))
    history = {}
    before = _counts()
    for name, model, dev in (("cpu", model_cpu, torch.device("cpu")), ("card", model_gpu, cuda)):
        state, step = create_train_state(model), make_classifier_train_step(model)
        b = {k: v.to(dev) for k, v in batch.items()}
        history[name] = [{k: float(v) for k, v in step(state, b)[1].items()} for _ in range(2)]
    assert _counts() == before
    rtol = 1e-4 if dtype == torch.float32 else 0.05
    for k, v in history["cpu"][0].items():
        if k.startswith("top") and dtype == torch.float32:
            assert history["card"][0][k] == v, k
        else:
            np.testing.assert_allclose(history["card"][0][k], v, rtol=rtol, atol=1e-6, err_msg=k)
    for row in history["card"]:
        assert all(np.isfinite(v) for v in row.values()) and row["grads_finite"] == 1.0


def test_kmeans_sincos_on_card_matches_cpu(cuda):
    """``kmeans_sincos`` (k = 30, 300 iterations) on the card against the CPU
    on 2048 seeded Euler triples: the assignments equal, the centres within
    1e-5 (float32 distances; the float64 sums' atomic order); the Lloyd loop
    reads nothing back to the host."""
    from anytime3d_tpu_torch.ops import kmeans

    rng = np.random.default_rng(11)
    e = (rng.uniform(-np.pi, np.pi, (2048, 3)) * np.array([1.0, 0.3, 0.2])).astype(np.float32)
    x = np.concatenate([np.sin(e), np.cos(e)], axis=-1)
    got = kmeans.kmeans_sincos(x, 30, 300, seed=2, device=cuda)
    want = kmeans.kmeans_sincos(x, 30, 300, seed=2)
    assert np.array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    xs = torch.from_numpy(x).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kmeans._fit(xs, xs[:30].clone(), 20)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_pascal_nolbo_step_on_a_fixture_batch_on_card_matches_cpu(cuda):
    """One float32 train step of ``pascal_nolbo`` at the fixture's 2 classes
    (Darknet19 at full width, the 64^3 decoder narrowed) on a batch of the
    Pascal3D fixture's val crops (the port's decoder and warp, no
    augmentation), card against CPU from the same weights and draws: every
    metric to rtol 1e-4, every gradient leaf to 1e-3 of its largest entry
    (summation order)."""
    import os

    from anytime3d_tpu_torch.cli.train import build_batch_fn
    from anytime3d_tpu_torch.data.pascal3d import Pascal3DSingleObjectLoader
    from anytime3d_tpu_torch.train.step import compute_losses

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "pascal3d")
    base = pascal_nolbo(category_dim=2)
    cfg = dataclasses.replace(
        base, decoder=dataclasses.replace(base.decoder, filter_nums=(32, 16, 64, 8, 1)),
        prior_category=dataclasses.replace(base.prior_category, dropout_rate=0.0),
        prior_inst=dataclasses.replace(base.prior_inst, dropout_rate=0.0))
    loader = Pascal3DSingleObjectLoader(root, "val", workers=1)
    batch = {k: torch.from_numpy(v) for k, v in build_batch_fn(loader, cfg, 2, image_size=(64, 64))(0).items()}
    loader.close()
    assert batch["category_onehot"].shape == (2, 2) and batch["input"].shape == (2, 64, 64, 3)
    rng = np.random.default_rng(12)
    draws = {k: torch.from_numpy(rng.normal(size=(2, 8)).astype(np.float32))
             for k in ("eps_cat", "eps_inst", "eps_prior_cat", "eps_prior_inst")}
    draws.update(coin=torch.tensor(True), take_prior=torch.from_numpy(rng.uniform(size=(2, 16)) < 0.5))
    model_cpu = MultiModalVAE(cfg, generator=torch.Generator().manual_seed(0))
    model_gpu = copy.deepcopy(model_cpu).to(cuda)
    out = {}
    for name, model, dev in (("cpu", model_cpu, torch.device("cpu")), ("card", model_gpu, cuda)):
        model.zero_grad()
        loss, metrics = compute_losses(model, loss_config("pascal_nolbo"), {k: v.to(dev) for k, v in batch.items()},
                                       draws={k: v.to(dev) for k, v in draws.items()})
        loss.backward()
        out[name] = ({k: float(v) for k, v in metrics.items()},
                     {k: p.grad.detach().cpu() for k, p in model.named_parameters() if p.grad is not None})
    for k, v in out["cpu"][0].items():
        np.testing.assert_allclose(out["card"][0][k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    assert out["card"][1].keys() == out["cpu"][1].keys()
    for k, g in out["cpu"][1].items():
        top = float(g.abs().max())
        assert float((out["card"][1][k] - g).abs().max()) <= 1e-3 * max(top, 1e-12), k


def test_mapping_geometry_on_card_matches_cpu(cuda):
    """The mapping layer at small sizes, card against CPU: a BA step's
    residuals, Jacobians and reduced system (f32, 1e-4 of each array's
    largest entry) and its update (f64, 1e-9); a pose-graph step (f32, 1e-4);
    keypoints, descriptors and matches on a frame and its shifted copy
    (keypoints and matches equal: every response is summed in one order on
    both); the two-view pose (1e-3)."""
    import chip_smoke
    from anytime3d_tpu_torch.geometry import ba, features, posegraph, twoview

    cpu = torch.device("cpu")
    prob = chip_smoke.ba_problem(4, 96, 0)

    def on(p, dev, dtype=torch.float32):
        return ba.BAProblem(*(getattr(p, f.name).to(dev, dtype) for f in dataclasses.fields(p)))

    pieces = {}
    for dev in (cuda, cpu):
        p = on(prob, dev)
        r = ba._residual_and_jacobians(p.poses, p.points, p.observations, p.mask, p.intrinsics)
        pieces[dev.type] = list(r) + list(ba._schur_reduce(*r, 1e-3)[:2])
    for got, want in zip(pieces["cuda"], pieces["cpu"]):
        assert chip_smoke.rel_err(got, want) <= 1e-4
    new = {dev.type: ba.ba_step(on(prob, dev, torch.float64))[0] for dev in (cuda, cpu)}
    assert chip_smoke.rel_err(new["cuda"].points, new["cpu"].points) <= 1e-9
    _, hist = ba.solve(on(prob, cuda), iters=5)
    assert float(hist[-1]) < float(hist[0])

    graph = chip_smoke.pose_graph(8, 16, 1)
    steps = {dev.type: posegraph.pgo_step(posegraph.PoseGraph(
        *(getattr(graph, f.name).to(dev) for f in dataclasses.fields(graph)))) for dev in (cuda, cpu)}
    assert chip_smoke.rel_err(steps["cuda"][0].poses, steps["cpu"][0].poses) <= 1e-4

    rgb = chip_smoke.photo_frame(96, 128, 2).astype(np.float32) / 255.0
    frames = [torch.from_numpy(rgb), torch.from_numpy(np.roll(rgb, (2, 3), (0, 1)))]
    out = {}
    for dev in (cuda, cpu):
        ka, kb = (features.detect_keypoints(f.to(dev), 64) for f in frames)
        da, db = (features.extract_descriptors(f.to(dev), k) for f, k in zip(frames, (ka, kb)))
        out[dev.type] = (ka, kb, da, db, features.match_descriptors(da, db, ka.valid, kb.valid))
    (ka, kb, da, db, m), (cka, ckb, cda, cdb, cm) = out["cuda"], out["cpu"]
    for got, want in ((ka, cka), (kb, ckb)):
        assert torch.equal(got.rowcol.cpu(), want.rowcol) and torch.equal(got.valid.cpu(), want.valid)
    assert chip_smoke.rel_err(da, cda) <= 1e-5 and chip_smoke.rel_err(db, cdb) <= 1e-5
    assert torch.equal(m.valid.cpu(), cm.valid) and torch.equal(m.index_b.cpu()[cm.valid], cm.index_b[cm.valid])
    assert int(m.valid.sum()) >= 10

    p1, p2, r_true, _ = chip_smoke.two_view_pair(128, 3)
    w = torch.ones(128)
    res = {dev.type: twoview.two_view_pose(p1.to(dev), p2.to(dev), w.to(dev)) for dev in (cuda, cpu)}
    assert chip_smoke.rel_err(res["cuda"].rotation, res["cpu"].rotation) <= 1e-3
    assert np.abs(res["cuda"].rotation.cpu().numpy() - r_true).max() < 1e-2


def test_one_rank_nccl_mesh_step_equals_the_plain_step(cuda):
    """The small model's train step with ``mesh=make_mesh()`` (one rank,
    NCCL) against the step without it, 3 steps in bf16 from the same weights,
    batch and draws, cuDNN deterministic: the metrics and the parameters equal
    bit for bit (the all-reduces are sums of one)."""
    import torch.distributed as dist

    from anytime3d_tpu_torch.parallel import mesh as mesh_module

    cfg, loss_cfg = small_config(dropout_rate=0.0, planned=True), loss_config("modelnet_nolbo")
    rng = np.random.default_rng(4)
    vox = (rng.uniform(size=(4, 32, 32, 32, 1)) > 0.7).astype(np.float32)
    batch = {"input_packed_blocked": torch.from_numpy(pack_voxels_blocked(vox, 4)).to(cuda),
             "category_onehot": torch.from_numpy(np.eye(5, dtype=np.float32)[rng.integers(0, 5, 4)]).to(cuda)}
    draws = {"eps_inst": torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32)).to(cuda),
             "eps_prior_cat": torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32)).to(cuda),
             "coin": torch.tensor(True, device=cuda),
             "take_prior": torch.from_numpy(rng.uniform(size=(4, 8)) < 0.3).to(cuda)}
    model = MultiModalVAE(cfg, generator=torch.Generator().manual_seed(0), dtype=torch.bfloat16).to(cuda)
    twin = copy.deepcopy(model)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        mesh = mesh_module.make_mesh(device="cuda")
        assert dist.get_backend(mesh.get_group("data")) == "nccl"
        rows = {}
        for name, m, mesh_arg in (("plain", model, None), ("mesh", twin, mesh)):
            state, step = create_train_state(m), make_train_step(m, loss_cfg, mesh=mesh_arg)
            rows[name] = [{k: float(v) for k, v in step(state, batch, draws=draws)[1].items()} for _ in range(3)]
        assert rows["plain"] == rows["mesh"]
        assert all(torch.equal(p, q) for p, q in zip(model.parameters(), twin.parameters()))
    finally:
        torch.backends.cudnn.deterministic = saved
        if dist.is_initialized():
            dist.destroy_process_group()
        mesh_module._mesh.cache_clear()


# (C, N) of the flagship's four k=2 stages on one model rank of a "model" axis of 2 (tensor parallelism: each
# shards its output channels)
TP_SHARDS = [(64, 256), (512, 64), (128, 256), (512, 32)]


def _chunked_counts():
    """The launches whose plan walks in chunks: the forward, dx (the chunked dx), dw, and the float32 forward."""
    return (conv_k2.launches_chunked, conv_k2.launches_dx_chunked, conv_k2.launches_dw_chunked,
            conv_k2.launches_chunked_f32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,N", TP_SHARDS)
def test_tp_shard_kernels_match_plain(cuda, C, N, dtype):
    """Forward, dx and dw at a tensor-parallel shard of a flagship stage, B=8
    at 16^3, through autograd against the plain versions: in bfloat16 on the
    tensor cores, but 512 -> 32 (N = 32 has no wgmma plan): its forward and dw
    on the chunked narrow kernels (C in 8 chunks of 64), its dx (the forward
    from 32 to 512, which no plan of that forward takes) on the chunked dx; in
    float32 all on the FFMA GEMM, but 512 -> 32's forward on the chunked
    float32 kernel (C in 32 chunks of 16)."""
    B, G = 8, 16
    bf16 = dtype == torch.bfloat16
    planned = bf16 and N % 64 == 0
    chunked = N == 32  # the forward in both types; dx and dw in bfloat16
    assert (wgmma_plan(B, G, G, G, C, N) is not None) == (N % 64 == 0)
    plan = narrow_plan(B, G, G, G, C, N, dtype=dtype)
    assert (plan is not None) == chunked and (plan is None or plan.c_chunks == C // (64 if bf16 else 16))
    assert narrow_plan(B, G, G, G, N, C, dtype=dtype) is None
    assert (chunked_dx_plan(B, G, G, G, C, N) is not None) == chunked
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(B, G, G, G, C, generator=gen).to(cuda, dtype).requires_grad_()
    w = (torch.randn(2, 2, 2, C, N, generator=gen) / (8 * C) ** 0.5).to(cuda).requires_grad_()  # an f32 parameter
    g = torch.randn(B, G, G, G, N, generator=gen).to(cuda, dtype)
    before, before_wg, before_nr, before_ch = _counts(), _wgmma_counts(), _narrow_counts(), _chunked_counts()
    y = conv_k2(x, w)
    y.backward(g)
    assert _counts() == tuple(n + 1 for n in before)
    assert _wgmma_counts() == tuple(n + planned for n in before_wg)
    both = chunked and bf16
    assert _narrow_counts() == (before_nr[0] + chunked, before_nr[1] + both, before_nr[2] + both)
    assert _chunked_counts() == (before_ch[0] + chunked, before_ch[1] + both, before_ch[2] + both,
                                 before_ch[3] + (chunked and not bf16))
    with torch.no_grad():
        y_ref = conv_k2_reference(x, w)
        dx_ref, dw_ref = conv_k2_backward_reference(x, w, g)
    torch.cuda.synchronize()
    # y and dx as test_kernel_matches_plain (f32: summation order; bf16: one rounding of an f32 sum on each
    # side); dw: f32 sums of 32768 products in another order (FFMA, or the chunked kernel's rounded adds of
    # each k-step's product), or the tensor cores' adds (DW_TOL_F64_REL of each side against float64, so
    # twice that between them)
    for got, ref in ((y, y_ref), (x.grad, dx_ref)):
        assert got.dtype == dtype and got.shape == ref.shape
        tol = 1e-4 if dtype == torch.float32 else 2.0**-7 * float(ref.float().abs().max())
        assert float((got.float() - ref.float()).abs().max()) <= tol
    tol_dw = (2 * DW_TOL_F64_REL if planned else 1e-5) * float(dw_ref.abs().max()) + 1e-5
    assert w.grad.dtype == torch.float32 and float((w.grad - dw_ref).abs().max()) <= tol_dw


def _opcheck_ops(cuda, shape, C, N, seed, dtype=torch.bfloat16):
    """The op and its arguments for ``torch.library.opcheck`` of each of the three ops on seeded operands of
    ``dtype`` and ``shape`` + (C,) and + (N,), w an f32 parameter: {op: (op, args)}."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(*shape, C, generator=gen).to(cuda, dtype)
    w = (torch.randn(2, 2, 2, C, N, generator=gen) * 0.05).to(cuda)
    g = torch.randn(*shape, N, generator=gen).to(cuda, dtype)
    return {"conv_k2": (k2._conv_k2_op, (x.requires_grad_(), w.requires_grad_())),
            "conv_k2_dx": (k2._conv_k2_dx_op, (g, w.detach())),
            "conv_k2_dw": (k2._conv_k2_dw_op, (x.detach(), g))}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("op", ["conv_k2", "conv_k2_dx", "conv_k2_dw"])
def test_tp_shard_without_a_plan_passes_opcheck(cuda, op, dtype):
    """The three ops at the 512 -> 32 shard (B=2 at 16^3), which no
    tensor-core plan takes. In bfloat16 the forward and dw on the chunked
    narrow plan, dx (the forward from 32 to 512, which no plan of that forward
    takes) on the chunked dx: each one's narrow and chunked counters move, no
    tensor-core one. In float32 the forward on the chunked float32 plan (its
    narrow, chunked and float32 chunked counters move), dx and dw on the FFMA
    GEMM (none of them moves)."""
    shape = (2, 16, 16, 16)
    assert wgmma_plan(*shape, 512, 32) is None and wgmma_plan(*shape, 32, 512) is None
    assert narrow_plan(*shape, 512, 32).c_chunks == 8 and narrow_plan(*shape, 32, 512) is None
    assert narrow_plan(*shape, 512, 32, dtype=torch.float32).c_chunks == 32 and chunked_dx_plan(*shape, 512, 32)
    fn, args = _opcheck_ops(cuda, shape, 512, 32, 6, dtype)[op]
    before, before_wg, before_nr, before_ch = _counts(), _wgmma_counts(), _narrow_counts(), _chunked_counts()
    results = torch.library.opcheck(fn, args)
    assert set(results.values()) == {"SUCCESS"}, results
    assert _wgmma_counts() == before_wg and _counts() != before
    nr = [a - b for a, b in zip(_narrow_counts(), before_nr)]
    ch = [a - b for a, b in zip(_chunked_counts(), before_ch)]
    # the forward's opcheck also runs its backward: dx and dw, on their routes
    if dtype == torch.float32:
        assert ch[1:3] == [0, 0] and nr[1:] == [0, 0] and nr[0] == ch[0] == ch[3] and (ch[0] > 0) == (op == "conv_k2")
    elif op == "conv_k2":
        assert min(ch[:3]) > 0 and nr == ch[:3] and ch[3] == 0
    else:
        k = 1 if op == "conv_k2_dx" else 2
        assert ch[k] > 0 and nr[k] == ch[k] and sum(nr) + sum(ch) == 2 * ch[k]


@pytest.mark.parametrize("op", ["conv_k2", "conv_k2_dx", "conv_k2_dw"])
def test_unplanned_bf16_shape_passes_opcheck(cuda, op):
    """The FFMA route's own check in bfloat16: the three ops at 96 -> 32 (B=2
    at 16^3; C neither a multiple of 64 nor one TMA box), which no plan takes,
    so every launch is the FFMA GEMM's (no tensor-core, narrow or chunked
    counter moves)."""
    shape = (2, 16, 16, 16)
    for cin, cout in ((96, 32), (32, 96)):
        assert wgmma_plan(*shape, cin, cout) is None and narrow_plan(*shape, cin, cout) is None
    assert narrow_dw_plan(*shape, 96, 32) is None
    fn, args = _opcheck_ops(cuda, shape, 96, 32, 7)[op]
    before, before_wg, before_nr, before_ch = _counts(), _wgmma_counts(), _narrow_counts(), _chunked_counts()
    results = torch.library.opcheck(fn, args)
    assert set(results.values()) == {"SUCCESS"}, results
    assert _counts() != before and _wgmma_counts() == before_wg
    assert _narrow_counts() == before_nr and _chunked_counts() == before_ch


def test_chunked_dx_gives_the_same_bits_at_the_tp_shard(cuda):
    """The chunked dx at the shard's own shape (B=32, 16^3, 512 -> 32, bf16),
    20 launches through the op: each the same bits as the first, and the
    first within 2^-7 of the largest entry of the plain version (each side
    rounds an f32 sum once to bf16). A halo stage handed back to the producer
    before the products had read its rows gave wrong rows in most launches
    at this shape, and in none of the smaller ones."""
    B, G, C, N = 32, 16, 512, 32
    assert chunked_dx_plan(B, G, G, G, C, N) is not None
    gen = torch.Generator().manual_seed(29)
    g = torch.randn(B, G, G, G, N, generator=gen).to(cuda, torch.bfloat16)
    w = (torch.randn(2, 2, 2, C, N, generator=gen) / (8 * C) ** 0.5).to(cuda, torch.bfloat16)
    with torch.inference_mode():
        first = conv_k2_dx(g, w)
        differ = sum(not torch.equal(conv_k2_dx(g, w), first) for _ in range(19))
        ref = conv_k2_dx_reference(g, w)
    assert differ == 0
    assert float((first.float() - ref.float()).abs().max()) <= 2.0**-7 * float(ref.float().abs().max())


# (B, D, H, W, C) of the chunked routes (bfloat16, C a multiple of 64 above 64; float32, of 32 above 32): two,
# three and eight chunks of 64 (8, 12 and 32 of 16), ragged boxes along every axis (5x6x7: one whole-grid box;
# 9x10x40: boxes cut at each edge), and the shard's 16^3; C = 192, dx's column chunks of 64
CHUNKED_GRIDS = [(3, 5, 6, 7, 128), (2, 9, 10, 40, 512), (2, 16, 16, 16, 128), (4, 16, 16, 16, 512),
                 (2, 8, 8, 8, 192)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N", [8, 16, 32])
@pytest.mark.parametrize("B,D,H,W,C", CHUNKED_GRIDS)
def test_chunked_kernels_match_plain_and_float64(cuda, B, D, H, W, C, N, dtype):
    """The chunked kernels, called as the ops (their narrow and chunked
    counters move, no tensor-core one). bfloat16: the forward, dx (the
    chunked dx on the tensor cores) and dw (on two stages or three, as its
    plan finds room: both among these shapes); the forward and dx against
    their plain versions (2^-7 of the largest output: each side rounds an f32
    sum once to bf16) and against the float64 product (half an ulp of the
    largest entry, plus the sum's own error); dw against its plain version
    (f32 sums in another order, 1e-5 of the largest entry) and against the
    float64 sum (DW_TOL_F64_REL), the same bits from two calls. float32: the
    forward alone walks C in chunks (exact FFMA): against its plain version
    (true f32, summation order only: 1e-4, as ``test_kernel_matches_plain``)
    and both against the float64 product (f32 sums of 8C products: 1e-5 of
    the largest entry for 256 of them, times the square root of 8C / 256)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    bf16 = dtype == torch.bfloat16
    plan = narrow_plan(B, D, H, W, C, N, sms=sms, dtype=dtype)
    assert plan is not None and plan.c_chunks == C // (64 if bf16 else 16) and wgmma_plan(B, D, H, W, C, N) is None
    assert (plan.dw_box is None) == (not bf16) and chunked_dx_plan(B, D, H, W, C, N, sms=sms) is not None
    gen = torch.Generator().manual_seed(23)
    x = torch.randn(B, D, H, W, C, generator=gen).to(cuda, dtype)
    w = (torch.randn(2, 2, 2, C, N, generator=gen) / (8 * C) ** 0.5).to(cuda, dtype)
    g = torch.randn(B, D, H, W, N, generator=gen).to(cuda, dtype)
    before, before_wg, before_nr, before_ch = _counts(), _wgmma_counts(), _narrow_counts(), _chunked_counts()
    if not bf16:
        with torch.inference_mode():
            y = conv_k2(x, w)
            assert _counts() == (before[0] + 1, before[1], before[2]) and _wgmma_counts() == before_wg
            assert _narrow_counts() == (before_nr[0] + 1, before_nr[1], before_nr[2])
            assert _chunked_counts() == (before_ch[0] + 1, before_ch[1], before_ch[2], before_ch[3] + 1)
            y_ref, y64 = conv_k2_reference(x, w), _float64_forward(x, w)
        torch.cuda.synchronize()
        assert y.dtype == torch.float32 and y.shape == (B, D, H, W, N)
        assert float((y - y_ref).abs().max()) <= 1e-4
        tol_y64 = 1e-5 * (8 * C / 256) ** 0.5 * float(y64.abs().max())
        for out in (y, y_ref):
            assert float((out.double() - y64).abs().max()) <= tol_y64
        return
    with torch.inference_mode():
        y, dx, dw, again = conv_k2(x, w), conv_k2_dx(g, w), conv_k2_dw(x, g), conv_k2_dw(x, g)
        assert _counts() == (before[0] + 1, before[1] + 1, before[2] + 2) and _wgmma_counts() == before_wg
        assert _narrow_counts() == (before_nr[0] + 1, before_nr[1] + 1, before_nr[2] + 2)
        assert _chunked_counts() == (before_ch[0] + 1, before_ch[1] + 1, before_ch[2] + 2, before_ch[3])
        y_ref, dx_ref, dw_ref = conv_k2_reference(x, w), conv_k2_dx_reference(g, w), conv_k2_dw_reference(x, g)
        y64, dx64, dw64 = _float64_forward(x, w), _dx_float64(g, w), _dw_float64(x, g)
    torch.cuda.synchronize()
    for out, ref, exact, shape in ((y, y_ref, y64, (B, D, H, W, N)), (dx, dx_ref, dx64, (B, D, H, W, C))):
        assert out.dtype == torch.bfloat16 and out.shape == shape
        top = float(ref.float().abs().max())
        assert float((out.float() - ref.float()).abs().max()) <= 2.0**-7 * top
        tol64 = (2.0**-8 + DW_TOL_F64_REL) * float(exact.abs().max())
        for got in (out, ref):
            assert float((got.double() - exact).abs().max()) <= tol64
    assert dw.dtype == torch.float32 and torch.equal(dw, again)
    assert float((dw - dw_ref).abs().max()) <= 1e-5 * float(dw_ref.abs().max())
    tol_dw64 = DW_TOL_F64_REL * float(dw64.abs().max())
    for out in (dw, dw_ref):
        assert float((out.double() - dw64).abs().max()) <= tol_dw64


# (B, D, H, W) and (C, N) of the wide forward: the stem's 8 -> 64, C = 16 and 32, N in one chunk of 64, one of
# 128 and three of 64 (192); ragged boxes along every axis (5x6x7: one box, past the grid on every side;
# 9x10x40: boxes cut at each edge), 16^3 and 32^3
WIDE_GRIDS = [(3, 5, 6, 7), (2, 9, 10, 40), (2, 16, 16, 16), (1, 32, 32, 32)]
WIDE_PAIRS = [(8, 64), (16, 128), (32, 192), (32, 64), (8, 192)]


@pytest.mark.parametrize("C,N", WIDE_PAIRS)
@pytest.mark.parametrize("B,D,H,W", WIDE_GRIDS)
def test_wide_forward_matches_plain_and_float64(cuda, B, D, H, W, C, N):
    """The bfloat16 forward of a narrow input and a wide output on the wide plan (the chunked dx's kernel run
    forward: the halo box of x at the box, zeros past the grid; the taps unmirrored), called as the op
    (``launches_wide`` moves, no tensor-core, narrow or chunked counter): against its plain version (2^-7 of
    the largest output: each side rounds an f32 sum once to bf16) and the float64 product (half an ulp of
    the largest entry, plus the sum's own error); the same bits from two calls."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = wide_plan(B, D, H, W, C, N, sms=sms)
    assert plan is not None and plan.chunks * plan.bn == N
    gen = torch.Generator().manual_seed(37)
    x = torch.randn(B, D, H, W, C, generator=gen).to(cuda, torch.bfloat16)
    w = (torch.randn(2, 2, 2, C, N, generator=gen) / (8 * C) ** 0.5).to(cuda, torch.bfloat16)
    before, before_wg, before_nr, before_ch = _counts(), _wgmma_counts(), _narrow_counts(), _chunked_counts()
    before_wide = conv_k2.launches_wide
    with torch.inference_mode():
        y, again = conv_k2(x, w), conv_k2(x, w)
        y_ref, y64 = conv_k2_reference(x, w), _float64_forward(x, w)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 2, before[1], before[2]) and conv_k2.launches_wide == before_wide + 2
    assert (_wgmma_counts(), _narrow_counts(), _chunked_counts()) == (before_wg, before_nr, before_ch)
    assert y.dtype == torch.bfloat16 and y.shape == (B, D, H, W, N) and torch.equal(y, again)
    assert float((y.float() - y_ref.float()).abs().max()) <= 2.0**-7 * float(y_ref.float().abs().max())
    tol64 = (2.0**-8 + DW_TOL_F64_REL) * float(y64.abs().max())
    for out in (y, y_ref):
        assert float((out.double() - y64).abs().max()) <= tol64


@pytest.mark.parametrize("op", ["conv_k2", "conv_k2_dw"])
def test_wide_forward_passes_opcheck(cuda, op):
    """The forward op on the wide plan at the stem's 8 -> 64 (B=2 at 16^3, bf16): schema, autograd (its
    backward's dx, from 64 to 8, and dw, on the dw-only narrow plan), the fake implementation against the
    kernel's output, an AOT-autograd trace; ``launches_wide`` moves. And dw there in float32, on the FFMA dw's
    64 x 64 tile (``launches_dw_ffma_fit`` moves)."""
    shape = (2, 16, 16, 16)
    dtype = torch.bfloat16 if op == "conv_k2" else torch.float32
    assert wide_plan(*shape, 8, 64) is not None and narrow_dw_plan(*shape, 8, 64) is not None
    fn, args = _opcheck_ops(cuda, shape, 8, 64, 8, dtype)[op]
    counter = "launches_wide" if op == "conv_k2" else "launches_dw_ffma_fit"
    before = getattr(conv_k2, counter)
    results = torch.library.opcheck(fn, args)
    assert set(results.values()) == {"SUCCESS"}, results
    assert getattr(conv_k2, counter) > before


# ---- the lowered stride-2 k=4 conv (kernels/conv_k4s2.py) ----

# (grid, C, N) of the flagship encoder's two stride-2 k=4 stages: 16^3 -> 8^3 and 8^3 -> 4^3, in the train and
# serve cells alike (B=32)
K4S2_STAGES = [(16, 128, 256), (8, 256, 512)]


def _k4s2_counts():
    return conv_k4s2.launches, conv_k4s2.launches_dx, conv_k4s2.launches_dw


def _k4s2_float64(x, w, g):
    """y, dx and dw of the k=4 s=2 SAME conv as float64 products of the same operands: ``F.conv3d`` on x
    padded (1, 1) and its gradients, in float64."""
    x64, w64 = x.double().requires_grad_(), w.double().requires_grad_()
    y = torch.nn.functional.conv3d(torch.nn.functional.pad(x64.permute(0, 4, 1, 2, 3), (1, 1) * 3), w64, stride=2)
    y = y.permute(0, 2, 3, 4, 1)
    dx, dw = torch.autograd.grad(y, (x64, w64), g.double())
    return y.detach(), dx, dw


@pytest.mark.parametrize("B", [2, 8, 32])
@pytest.mark.parametrize("n,C,N", K4S2_STAGES)
def test_k4s2_kernels_match_plain_and_float64(cuda, B, n, C, N):
    """The forward, dx and dw on the tensor cores (each counter moves once; dw twice, the same bits) against
    their plain versions (the lowering in PyTorch; 2^-7 of the largest entry for the bf16 outputs, each side
    rounding an f32 sum once) and float64 products of the same bf16 operands (half an ulp of the largest
    entry plus the sum's own error; dw DW_TOL_F64_REL of its largest)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert k4s2_plans(B, n // 2, n // 2, n // 2, C, N, sms=sms) is not None
    gen = torch.Generator().manual_seed(41 + B)
    x = torch.randn(B, n, n, n, C, generator=gen).to(cuda, torch.bfloat16)
    w = (torch.randn(N, C, 4, 4, 4, generator=gen) / (64 * C) ** 0.5).to(cuda)  # a float32 parameter
    g = torch.randn(B, n // 2, n // 2, n // 2, N, generator=gen).to(cuda, torch.bfloat16)
    before = _k4s2_counts()
    with torch.inference_mode():
        y, dx = conv_k4s2(x, w), conv_k4s2_dx(g, w, x.shape[1:4])
        dw = conv_k4s2_dw(x, g), conv_k4s2_dw(x, g)
        y_ref, dx_ref = conv_k4s2_reference(x, w), conv_k4s2_dx_reference(g, w, x.shape[1:4])
        dw_ref = conv_k4s2_dw_reference(x, g)
    y64, dx64, dw64 = _k4s2_float64(x, w.to(torch.bfloat16), g)
    torch.cuda.synchronize()
    assert _k4s2_counts() == (before[0] + 1, before[1] + 1, before[2] + 2)
    assert y.dtype == dx.dtype == torch.bfloat16 and dw[0].dtype == torch.float32
    assert y.shape == y64.shape and dx.shape == x.shape and dw[0].shape == w.shape
    assert torch.equal(dw[0], dw[1])
    for out, ref, exact in ((y, y_ref, y64), (dx, dx_ref, dx64)):
        assert float((out.float() - ref.float()).abs().max()) <= 2.0**-7 * float(ref.float().abs().max())
        tol64 = (2.0**-8 + DW_TOL_F64_REL) * float(exact.abs().max())
        assert float((out.double() - exact).abs().max()) <= tol64
        assert float((ref.double() - exact).abs().max()) <= tol64
    tol = DW_TOL_F64_REL * float(dw64.abs().max())
    assert float((dw[0].double() - dw64).abs().max()) <= tol and float((dw_ref.double() - dw64).abs().max()) <= tol


@pytest.mark.parametrize("n,C,N", K4S2_STAGES)
def test_conv3d_lowers_k4s2_in_bf16(cuda, n, C, N):
    """``Conv3d`` at a flagship stage in bf16 takes the lowering (one launch of each kernel), and its
    output and both gradients match ``F.conv3d`` (cuDNN, as the layer ran before) on the same operands:
    2^-7 of the largest entry (each side rounds its f32 sums once to bf16; cuDNN's dw of the bf16 weight
    is bf16 too). In float32 the layer stays on ``F.conv3d``: no counter moves."""
    layer = Conv3d(C, N, 4, 2, generator=torch.Generator().manual_seed(5)).to(cuda)
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(8, n, n, n, C, generator=gen).to(cuda, torch.bfloat16).requires_grad_()
    g = torch.randn(8, n // 2, n // 2, n // 2, N, generator=gen).to(cuda, torch.bfloat16)
    before = _k4s2_counts()
    y = layer(x)
    dx, dw = torch.autograd.grad(y, (x, layer.weight), g)
    torch.cuda.synchronize()
    assert _k4s2_counts() == (before[0] + 1, before[1] + 1, before[2] + 1)
    assert y.dtype == dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    xc, wc = x.detach().requires_grad_(), layer.weight.detach().requires_grad_()
    y_ref = torch.nn.functional.conv3d(torch.nn.functional.pad(xc.permute(0, 4, 1, 2, 3), (1, 1) * 3),
                                       wc.to(torch.bfloat16), stride=2).permute(0, 2, 3, 4, 1)
    dx_ref, dw_ref = torch.autograd.grad(y_ref, (xc, wc), g)
    for out, ref in ((y, y_ref), (dx, dx_ref), (dw, dw_ref)):
        assert out.shape == ref.shape
        assert float((out.float() - ref.float()).abs().max()) <= 2.0**-7 * float(ref.float().abs().max())
    before = _k4s2_counts()
    with torch.no_grad():
        layer(x.detach().float())
    assert _k4s2_counts() == before


@pytest.mark.parametrize("op", ["conv_k4s2", "conv_k4s2_dw"])
def test_k4s2_ops_pass_opcheck(cuda, op):
    """The forward op (its backward: the dx and dw ops) and the dw op at B=2, 8^3 -> 4^3, 256 -> 512 under
    ``torch.library.opcheck``: schema, autograd, the fake implementation against the kernel's output, an
    AOT-autograd trace."""
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(2, 8, 8, 8, 256, generator=gen).to(cuda, torch.bfloat16)
    w = (torch.randn(512, 256, 4, 4, 4, generator=gen) / 128.0).to(cuda)
    if op == "conv_k4s2":
        fn, args = torch.ops.anytime3d_torch.conv_k4s2.default, (x.requires_grad_(), w.requires_grad_())
    else:
        g = torch.randn(2, 4, 4, 4, 512, generator=gen).to(cuda, torch.bfloat16)
        fn, args = torch.ops.anytime3d_torch.conv_k4s2_dw.default, (x, g)
    before = _k4s2_counts()
    results = torch.library.opcheck(fn, args)
    assert set(results.values()) == {"SUCCESS"}, results
    assert _k4s2_counts() != before


def test_flagship_encoder_launches_no_legacy_cudnn_kernel(cuda):
    """The flagship encoder's forward and backward in bf16 (B=8) under the profiler: its two stride-2 k=4
    stages run the lowering (2 launches of each kernel), and no kernel is cuDNN's legacy
    ``implicit_convolveNd_sgemm`` or ``wgrad_alg1_nd_float_engine``."""
    model = MultiModalVAE(modelnet_nolbo(), generator=torch.Generator().manual_seed(0)).to(cuda)
    encoder = model.encoder3d
    x = (torch.rand(8, 64, 64, 64, 1, generator=torch.Generator().manual_seed(1)) > 0.7).to(cuda, torch.bfloat16)
    encoder.dtype = torch.bfloat16
    encoder(x).float().sum().backward()  # warm: builds the kernels
    torch.cuda.synchronize()
    before = _k4s2_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        encoder(x).float().sum().backward()
        torch.cuda.synchronize()
    assert _k4s2_counts() == (before[0] + 2, before[1] + 2, before[2] + 2)
    names = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}
    assert names, "the profiler saw no kernel"
    legacy = sorted(n for n in names if "implicit_convolveNd_sgemm" in n or "wgrad_alg1_nd" in n)
    assert not legacy, legacy

