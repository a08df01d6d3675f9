"""Stride-2 k=4 SAME 3-D convolution (no bias) in bfloat16 on the tensor
cores: an exact lowering onto ``conv_k2``'s kernels, and its plain PyTorch
version.

It replaces no TPU kernel: the JAX package leaves these convolutions (the
voxel encoder's stride-2 stages, ``nn.Conv(f, (4, 4, 4), strides 2, SAME)``)
to XLA. On the H100 ``F.conv3d`` ran them in bfloat16 on cuDNN's legacy
engines (``implicit_convolveNd_sgemm`` forward, ``wgrad_alg1_nd_float_engine``
dw), off the tensor cores: half the flagship step's device time.

The lowering. Take ``x`` (B, 2D, 2H, 2W, C), NDHWC, and ``w`` (N, C, 4, 4,
4), OIDHW. SAME pads each axis (1, 1). Let X be the space-to-depth(2) of the
padded ``x``, (B, D+1, H+1, W+1, 8C), channels (pd, ph, pw, c), and W2
(2, 2, 2, 8C, N) with W2[bd, bh, bw, (pd, ph, pw, c), n] = w[n, c, 2bd+pd,
2bh+ph, 2bw+pw] (:func:`lower_weight`). Then y[j] = sum over the 8 taps b of
X[j + b] W2[b], j in the (D, H, W) grid: a k=2 VALID conv whose input grid is
one voxel larger than its output. (Odd grids pad (1, 2); the plain versions
take them, the kernels do not.)

What bounds the kernels: operations, 2 B C N (4D - 2)(4H - 2)(4W - 2) a
product counting only the taps that land on x's grid (57 GFLOP for each of
forward, dx and dw at the flagship's 16^3 128 -> 256, B=32; the kernels
also multiply the pad's zeros, 2 B D H W 64 C N in all, 69 GFLOP).
The design (``csrc/conv_k2_wgmma.cuh``, "The lowered stride-2 k=4 conv"): the
output grid tiles as ``conv_k2``'s does, so the three products run on the
``wgmma`` kernels on the plan of (B, D, H, W, 8C, N) (:func:`k4s2_plans`);
X is never written, the forward and dw read x's eight phase grids through
strided TMA maps whose zero fill is the pad; dx is written straight into x's
grid, a column tile holding one phase of x's own space-to-depth. The
forward's operands are x and W2 (the weight cast and re-laid in one copy);
the backward saves x and the weight as given, never X, and dw comes out in
float32 in W2's layout and goes back through the relayout.

The forward, dx and dw are the custom operators ``anytime3d_torch::conv_k4s2``,
``::conv_k4s2_dx`` and ``::conv_k4s2_dw``: a CUDA implementation that launches
the kernels, a CPU one that is the plain version, a fake one for
``torch.export``, and the forward's backward, which calls the dx and dw ops.
Their arguments give B, the output grid, C and N (the roofline reader of the
benchmark counts their work from them). ``Conv3d`` takes the lowering
through :func:`lowers`; every other conv stays on ``F.conv3d``.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F

from anytime3d_tpu_torch.kernels import conv_k2 as k2
from anytime3d_tpu_torch.kernels.conv_k2 import WgmmaPlan, wgmma_plan

_TAPS = [(bd, bh, bw) for bd in (0, 1) for bh in (0, 1) for bw in (0, 1)]


def _pads(n: int) -> tuple[int, int]:
    """SAME's (lo, hi) pad of one axis of size ``n`` for k=4, s=2: the output is ceil(n/2)."""
    return 1, 2 * -(-n // 2) + 1 - n


def lower_input(x: torch.Tensor) -> torch.Tensor:
    """X: the space-to-depth(2) of ``x`` (B, D, H, W, C) padded as SAME pads
    it, (B, ceil(D/2)+1, ..., 8C), channels (pd, ph, pw, c)."""
    from anytime3d_tpu_torch.nn.blocks import space_to_depth3d

    pads = [0, 0]
    for n in reversed(x.shape[1:4]):
        pads += _pads(n)
    return space_to_depth3d(F.pad(x, pads), 2)


def lower_weight(w: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """W2 (2, 2, 2, 8C, N) of ``w`` (N, C, 4, 4, 4): W2[bd, bh, bw, (pd, ph,
    pw, c), n] = w[n, c, 2bd+pd, 2bh+ph, 2bw+pw], cast to ``dtype`` in the
    same copy."""
    N, C = w.shape[:2]
    w2 = torch.empty((2, 2, 2, 2, 2, 2, C, N), dtype=dtype or w.dtype, device=w.device)
    w2.copy_(w.reshape(N, C, 2, 2, 2, 2, 2, 2).permute(2, 4, 6, 3, 5, 7, 1, 0))
    return w2.reshape(2, 2, 2, 8 * C, N)


def raise_weight(w2: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`lower_weight`: (2, 2, 2, 8C, N) -> (N, C, 4, 4, 4)."""
    C, N = w2.shape[3] // 8, w2.shape[4]
    return w2.reshape(2, 2, 2, 2, 2, 2, C, N).permute(7, 6, 0, 3, 1, 4, 2, 5).reshape(N, C, 4, 4, 4)


def conv_k4s2_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain forward: the k=2 VALID conv of X with W2 (``w`` cast to ``x``'s dtype)."""
    Xc = lower_input(x).permute(0, 4, 1, 2, 3)
    y = F.conv3d(Xc, lower_weight(w, x.dtype).permute(4, 3, 0, 1, 2))
    return y.permute(0, 2, 3, 4, 1).contiguous()


def conv_k4s2_dx_reference(g: torch.Tensor, w: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Plain dx (B, *size, C) in ``g``'s dtype: the transposed k=2 conv of g
    with W2 gives the gradient of X, whose depth-to-space(2) cropped to x's
    grid (past the low pad) is dx."""
    from anytime3d_tpu_torch.nn.blocks import depth_to_space3d

    dX = F.conv_transpose3d(g.permute(0, 4, 1, 2, 3), lower_weight(w, g.dtype).permute(4, 3, 0, 1, 2))
    dx = depth_to_space3d(dX.permute(0, 2, 3, 4, 1), 2)
    D, H, W = size
    return dx[:, 1:1 + D, 1:1 + H, 1:1 + W].contiguous()


def conv_k4s2_dw_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain dw (N, C, 4, 4, 4), float32 (float64 for float64 operands): for
    each tap b the contraction of X[j + b] with g[j], summed in that dtype,
    through the inverse relayout."""
    dtype = k2._dw_dtype(x.dtype)
    X, gf = lower_input(x).to(dtype), g.to(dtype)
    _, D, H, W, _ = g.shape
    dw2 = torch.stack([torch.einsum("bdhwc,bdhwn->cn", X[:, bd:bd + D, bh:bh + H, bw:bw + W], gf)
                       for bd, bh, bw in _TAPS])
    return raise_weight(dw2.reshape(2, 2, 2, *dw2.shape[1:])).contiguous()


@functools.lru_cache(maxsize=256)  # a model asks for the same few shapes at every step
def k4s2_plans(B: int, D: int, H: int, W: int, C: int, N: int, sms: int = 132) -> tuple[WgmmaPlan, WgmmaPlan] | None:
    """(forward and dw plan, dx plan) of the lowered conv of x (B, 2D, 2H, 2W,
    C) into y (B, D, H, W, N), or None where the tensor-core kernels do not
    take it: the forward's is ``wgmma_plan(B, D, H, W, 8C, N)`` (its dw
    fields dw's), dx's the unsplit plan of a forward from N to 8C channels,
    whose column tiles must each hold channels of one phase (C a multiple of
    its ``bn``); C a multiple of 64, so that a depth chunk or a dw row tile
    lies in one phase. Pure arithmetic; ``sms`` is the card's count of
    multiprocessors."""
    if C % 64:
        return None
    fwd = wgmma_plan(B, D, H, W, 8 * C, N, sms=sms)
    dx = wgmma_plan(B, D, H, W, N, 8 * C, sms=sms, split=False)
    if fwd is None or dx is None or C % dx.bn:
        return None
    return fwd, dx


def lowering_plans(shape: Sequence[int], N: int, kernel_size: int, stride: int, dtype: torch.dtype,
                   device_type: str, sms: int = 132) -> tuple[WgmmaPlan, WgmmaPlan] | None:
    """The plans of ``Conv3d``'s lowering for an input of ``shape`` (B, D, H,
    W, C), ``dtype`` and ``device_type`` and N output channels, or None where
    it stays on ``F.conv3d``: a kernel other than k=4 s=2, float32 (cuDNN's
    TF32 there), a CPU tensor, an odd grid (dx's phase layout needs even),
    and any shape without a plan (the C = 1 stem among them)."""
    if (kernel_size, stride) != (4, 2) or dtype != torch.bfloat16 or device_type != "cuda" or len(shape) != 5:
        return None
    B, D, H, W, C = shape
    if D % 2 or H % 2 or W % 2:
        return None
    return k4s2_plans(B, D // 2, H // 2, W // 2, C, N, sms=sms)


def lowers(x: torch.Tensor, w: torch.Tensor, kernel_size: int, stride: int) -> bool:
    """Whether ``Conv3d`` runs ``x`` and its weight ``w`` through :func:`conv_k4s2` (:func:`lowering_plans`)."""
    sms = k2._sms(x) if x.device.type == "cuda" else 0
    return lowering_plans(tuple(x.shape), w.shape[0], kernel_size, stride, x.dtype, x.device.type, sms) is not None


def _plans(x_or_g: torch.Tensor, D: int, H: int, W: int, C: int, N: int, what: str) -> tuple[WgmmaPlan, WgmmaPlan]:
    k2._check_cuda_operand(what, "operand", x_or_g)
    plans = None
    if x_or_g.dtype == torch.bfloat16:
        plans = k4s2_plans(x_or_g.shape[0], D, H, W, C, N, sms=k2._sms(x_or_g))
    if plans is None:
        raise ValueError(f"{what} has no tensor-core plan for B={x_or_g.shape[0]}, grid {(D, H, W)}, C={C}, N={N}, "
                         f"{x_or_g.dtype}")
    return plans


def _coarse(x: torch.Tensor) -> tuple[int, int, int]:
    if any(n % 2 for n in x.shape[1:4]):
        raise ValueError(f"conv_k4s2 kernels take even grids; got {tuple(x.shape)}")
    return tuple(n // 2 for n in x.shape[1:4])


@torch.library.custom_op("anytime3d_torch::conv_k4s2", mutates_args=(), device_types="cpu")
def _conv_k4s2_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The forward: the plain version on the CPU, the kernel on CUDA (``w`` cast to ``x``'s dtype)."""
    return conv_k4s2_reference(x, w)


@_conv_k4s2_op.register_kernel("cuda")
def _launch_forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    B, C, N = x.shape[0], x.shape[-1], w.shape[0]
    D, H, W = _coarse(x)
    plan, _ = _plans(x, D, H, W, C, N, "conv_k4s2")
    w2 = lower_weight(w, x.dtype)
    y = torch.empty((B, D, H, W, N), dtype=x.dtype, device=x.device)
    k2._check_operands("conv_k4s2", 8 * C, N, x, w2, y)
    part = k2._split_workspace(plan.splits, y)
    k2._check_launch("conv_k4s2 (wgmma)", k2._lib().conv_k4s2_forward_wgmma(
        x.data_ptr(), w2.data_ptr(), y.data_ptr(), 0 if part is None else part.data_ptr(), B, D, H, W, C, N,
        *plan.box, plan.box_items, plan.bm, plan.bn, plan.stages, plan.grid, plan.smem_bytes, plan.tiles, plan.splits,
        plan.stages_per_split, x.device.index, k2._stream(x)))
    conv_k4s2.launches += 1
    return y


@_conv_k4s2_op.register_fake
def _(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x.new_empty((x.shape[0], *(-(-n // 2) for n in x.shape[1:4]), w.shape[0]))


@torch.library.custom_op("anytime3d_torch::conv_k4s2_dx", mutates_args=(), device_types="cpu")
def _conv_k4s2_dx_op(g: torch.Tensor, w: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """dx of x's grid ``size`` (D, H, W): the plain version on the CPU, the kernel on CUDA."""
    return conv_k4s2_dx_reference(g, w, size)


@_conv_k4s2_dx_op.register_kernel("cuda")
def _launch_dx(g: torch.Tensor, w: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    B, D, H, W, N = g.shape
    C = w.shape[1]
    if tuple(size) != (2 * D, 2 * H, 2 * W):
        raise ValueError(f"conv_k4s2 dx kernel takes x's grid twice g's; got {tuple(size)} for {tuple(g.shape)}")
    _, plan = _plans(g, D, H, W, C, N, "conv_k4s2 dx")
    w2 = lower_weight(w, g.dtype)
    dx = torch.empty((B, *size, C), dtype=g.dtype, device=g.device)
    k2._check_operands("conv_k4s2 dx", 8 * C, N, g, w2, dx, depth_is_n=True)
    k2._check_launch("conv_k4s2 dx (wgmma)", k2._lib().conv_k4s2_backward_input_wgmma(
        g.data_ptr(), w2.data_ptr(), dx.data_ptr(), B, D, H, W, C, N, *plan.box, plan.box_items, plan.bm, plan.bn,
        plan.stages, plan.grid, plan.smem_bytes, plan.tiles, g.device.index, k2._stream(g)))
    conv_k4s2.launches_dx += 1
    return dx


@_conv_k4s2_dx_op.register_fake
def _(g: torch.Tensor, w: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    return g.new_empty((g.shape[0], *size, w.shape[1]))


@torch.library.custom_op("anytime3d_torch::conv_k4s2_dw", mutates_args=(), device_types="cpu")
def _conv_k4s2_dw_op(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dw (N, C, 4, 4, 4): the plain version on the CPU, the kernel on CUDA."""
    return conv_k4s2_dw_reference(x, g)


@_conv_k4s2_dw_op.register_kernel("cuda")
def _launch_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    k2._check_cuda_operand("conv_k4s2 dw", "g", g)
    B, C, N = x.shape[0], x.shape[-1], g.shape[-1]
    D, H, W = _coarse(x)
    if g.dtype != x.dtype or tuple(g.shape[:4]) != (B, D, H, W):
        raise ValueError(f"conv_k4s2 dw takes g of x's dtype on the output grid; got {tuple(x.shape)} {x.dtype}, "
                         f"{tuple(g.shape)} {g.dtype}")
    plan, _ = _plans(x, D, H, W, C, N, "conv_k4s2 dw")
    walk = plan.dw_persistent
    splits = plan.dw_grid[2] if walk is None else walk.splits
    dw2 = torch.empty((2, 2, 2, 8 * C, N), dtype=torch.float32, device=x.device)
    workspace = torch.empty((splits if splits > 1 else 0, 64 * C, N), dtype=torch.float32, device=x.device)
    k2._check_operands("conv_k4s2 dw", 8 * C, N, x, g, dw2, workspace)
    if walk is None:
        k2._check_launch("conv_k4s2 dw (wgmma)", k2._lib().conv_k4s2_backward_weight_wgmma(
            x.data_ptr(), g.data_ptr(), dw2.data_ptr(), workspace.data_ptr(), splits, plan.dw_stages_per_split,
            B, D, H, W, C, N, *plan.dw_box, plan.dw_box_items, plan.bn, plan.dw_stages, plan.dw_smem_bytes,
            x.device.index, k2._stream(x)))
    else:
        k2._check_launch("conv_k4s2 dw (persistent wgmma)", k2._lib().conv_k4s2_backward_weight_persistent(
            x.data_ptr(), g.data_ptr(), dw2.data_ptr(), workspace.data_ptr(), B, D, H, W, C, N, *plan.dw_box,
            plan.dw_box_items, walk.bn, walk.stages, walk.grid, walk.smem_bytes, walk.tiles, walk.splits,
            walk.stages_per_split, x.device.index, k2._stream(x)))
    conv_k4s2.launches_dw += 1
    return raise_weight(dw2).contiguous()


@_conv_k4s2_dw_op.register_fake
def _(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return x.new_empty((g.shape[-1], x.shape[-1], 4, 4, 4), dtype=k2._dw_dtype(x.dtype))


def _setup_context(ctx, inputs, output) -> None:
    ctx.save_for_backward(*inputs)  # x and the weight as given: never X


def _backward(ctx, g: torch.Tensor):
    """dx and dw through their ops, each only where a gradient is asked for;
    dw in the weight's dtype straight from the op's float32 sum."""
    x, w = ctx.saved_tensors
    g = g.to(x.dtype).contiguous()
    dx = _conv_k4s2_dx_op(g, w, list(x.shape[1:4])) if ctx.needs_input_grad[0] else None
    dw = _conv_k4s2_dw_op(x, g).to(w.dtype) if ctx.needs_input_grad[1] else None
    return dx, dw


_conv_k4s2_op.register_autograd(_backward, setup_context=_setup_context)


def conv_k4s2_dx(g: torch.Tensor, w: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """dx (B, *size, C) of :func:`conv_k4s2` from the output gradient ``g``
    (B, D, H, W, N), ``w`` (N, C, 4, 4, 4) and x's grid ``size``: the op
    ``anytime3d_torch::conv_k4s2_dx``, one kernel launch on CUDA (adding one to
    ``conv_k4s2.launches_dx``), the plain version on the CPU."""
    return _conv_k4s2_dx_op(g, w, list(size))


def conv_k4s2_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dw (N, C, 4, 4, 4), float32, of :func:`conv_k4s2` from its input ``x``
    and the output gradient ``g``: the op ``anytime3d_torch::conv_k4s2_dw``,
    the kernel (and the reduce of its splits) on CUDA, adding one to
    ``conv_k4s2.launches_dw``; the plain version on the CPU. The same bits
    from run to run."""
    return _conv_k4s2_dw_op(x, g)


def conv_k4s2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """k=4 s=2 SAME conv of ``x`` (B, D, H, W, C) with ``w`` (N, C, 4, 4, 4),
    differentiable in both: the op ``anytime3d_torch::conv_k4s2``. A CUDA
    tensor goes through the tensor-core kernels, forward and backward (bfloat16
    on an even grid with a plan, :func:`k4s2_plans`), or the call raises; a CPU
    tensor through the plain versions. ``w`` may be a float32 parameter beside
    a bfloat16 ``x``: it is cast inside the op and its gradient comes back in
    float32. Each kernel launch adds one to ``conv_k4s2.launches`` (forward),
    ``conv_k4s2.launches_dx`` or ``conv_k4s2.launches_dw``."""
    if x.dim() != 5 or w.dim() != 5 or tuple(w.shape[1:]) != (x.shape[-1], 4, 4, 4):
        raise ValueError(f"conv_k4s2 takes x (B,D,H,W,C) and w (N,C,4,4,4); got {tuple(x.shape)}, {tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")
    return _conv_k4s2_op(x.contiguous(), w)


conv_k4s2.launches = 0
conv_k4s2.launches_dx = 0
conv_k4s2.launches_dw = 0
