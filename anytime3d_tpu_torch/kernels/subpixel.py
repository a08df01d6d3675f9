"""The stride-2 k=4 SAME transposed 3-D conv in its sub-pixel form: one k=2
conv at the coarse grid emitting 8 C_out phase channels, a parity slice, and
an interleave.

Counterpart of ``anytime3d_tpu/kernels/subpixel.py``. Per axis, output 2m + p
(p in {0, 1}) of the transposed conv is ``W[p] x[m + p - 1] + W[p + 2] x[m +
p]`` (W the flax kernel): each parity is a dense 2-tap conv of the input at
an offset of its own. So the input padded by one voxel on each side goes
through one 2x2x2 VALID conv over the (D+1)^3 window positions, and parity p
reads positions [p, p + D) of each axis. Here that conv is ``conv_k2`` (the
hand-written kernel) over the input padded by one voxel at the low end:
``conv_k2``'s SAME padding adds the high one. Its grid is (D+1)^3, odd where
D is even, so no ``wgmma_plan`` tiles it: in bfloat16 and float32 it runs
the FFMA kernels (or the narrow ones at N = 8, 16, 32 phase channels).

``convtranspose_kernel_to_subpixel`` maps a flax ``ConvTranspose`` kernel
(4, 4, 4, C_in, C_out) to the (2, 2, 2, C_in, 8 C_out) kernel of this form,
exactly, so weights carry over. No model of the JAX package uses the form
(its decoders reach the same function through ``depth_to_space3d`` or
``ConvTransposeEquiv3D``); it is ported as the JAX package exports it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from anytime3d_tpu_torch.kernels.conv_k2 import conv_k2
from anytime3d_tpu_torch.nn.blocks import lecun_normal_


def subpixel_deconv3d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-2 k=4 SAME transposed conv as a k=2 conv, a parity slice and an
    interleave. ``x`` (B, D, H, W, C_in), ``w`` (2, 2, 2, C_in, 8 C_out), its
    last axis ordered (pd, ph, pw, c). Returns (B, 2D, 2H, 2W, C_out) in
    ``x``'s dtype."""
    b, d, h, ww = x.shape[:4]
    c_out = w.shape[-1] // 8
    # one voxel at the low end of each axis; conv_k2's SAME adds the high one: the (D+1)^3 VALID windows
    y = conv_k2(F.pad(x, (0, 0, 1, 0, 1, 0, 1, 0)), w)
    y = y.reshape(b, d + 1, h + 1, ww + 1, 2, 2, 2, c_out)
    # parity (pd, ph, pw) reads window positions [p, p + D) of each axis
    out = torch.stack([y[:, pd:pd + d, ph:ph + h, pw:pw + ww, pd, ph, pw]
                       for pd in (0, 1) for ph in (0, 1) for pw in (0, 1)], dim=4)  # (B, D, H, W, 8, C)
    out = out.reshape(b, d, h, ww, 2, 2, 2, c_out).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return out.reshape(b, 2 * d, 2 * h, 2 * ww, c_out)


def convtranspose_kernel_to_subpixel(w_t: torch.Tensor) -> torch.Tensor:
    """A flax ``ConvTranspose`` kernel (4, 4, 4, C_in, C_out), stride 2, SAME
    -> the sub-pixel kernel (2, 2, 2, C_in, 8 C_out): per axis, parity p takes
    W[p] on the earlier tap and W[p + 2] on the later one (tap t is W[p + 2t])."""
    if tuple(w_t.shape[:3]) != (4, 4, 4):
        raise ValueError(f"expected a (4, 4, 4, C_in, C_out) kernel, got {tuple(w_t.shape)}")
    c_in, c_out = w_t.shape[3], w_t.shape[4]
    # w_t[p + 2t] along each axis: index (t, p) of the (2, 2) view of the 4 taps
    k = w_t.reshape(2, 2, 2, 2, 2, 2, c_in, c_out)  # (td, pd, th, ph, tw, pw, c_in, c_out)
    k = k.permute(0, 2, 4, 6, 1, 3, 5, 7)  # (td, th, tw, c_in, pd, ph, pw, c_out)
    return k.reshape(2, 2, 2, c_in, 8 * c_out).contiguous()


class SubpixelDeconv3D(nn.Module):
    """flax ``SubpixelDeconv3D``: the stride-2 k=4 SAME transposed conv (no
    bias) with a (2, 2, 2, C_in, 8 features) ``weight``, the parameter count
    of the transposed conv. Its init is flax's ``variance_scaling(1.0,
    'fan_in', 'truncated_normal', in_axis=(0, 1, 2, 3))`` on that shape, whose
    fan-in is 8 C_in."""

    def __init__(self, in_features: int, features: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(2, 2, 2, in_features, 8 * features))
        lecun_normal_(self.weight, 8 * in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return subpixel_deconv3d(x, self.weight.to(x.dtype))
