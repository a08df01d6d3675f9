"""Building blocks: conv / transposed conv / dense + norm + activation, the
2-D max-pool.

Counterpart of ``anytime3d_tpu/nn/blocks.py``. Activations are channels-last,
NDHWC ``(B, D, H, W, C)`` and NHWC ``(B, H, W, C)`` for images, as in the JAX
package; convolutions hand cuDNN a channels-first view of that storage. Each block computes what its flax counterpart
computes, including flax's SAME padding and initialisers (truncated
lecun-normal kernels, zero biases, ones/zeros for the norms).

Compute dtype: parameters stay float32 (the optimizer updates them) and
every layer casts them to the dtype of the input it is given, as flax does
with its ``dtype`` argument; the norms take their statistics in float32. The
modules that own a stack (``Encoder3D``, ``Decoder3D``, ``PriorNet``,
``MultiModalVAE``) take the ``dtype`` and cast their input to it on entry.

Submodules are named as flax names them, lowercased (flax ``Conv_0`` is
``conv_0`` here), so ``convert.params_from_flax`` maps a flax tree to a
``state_dict`` by name alone.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from anytime3d_tpu_torch.kernels.conv_k2 import conv_k2
from anytime3d_tpu_torch.kernels.conv_k4s2 import conv_k4s2, lowers


def depth_to_space3d(x: torch.Tensor, b: int) -> torch.Tensor:
    """(B, D, H, W, C*b^3) -> (B, D*b, H*b, W*b, C); channel order (bd, bh, bw, c)."""
    B, D, H, W, Cb = x.shape
    C = Cb // b**3
    x = x.reshape(B, D, H, W, b, b, b, C).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(B, D * b, H * b, W * b, C)


def space_to_depth3d(x: torch.Tensor, b: int) -> torch.Tensor:
    """(B, D, H, W, C) -> (B, D/b, H/b, W/b, C*b^3); inverse of ``depth_to_space3d``."""
    B, D, H, W, C = x.shape
    x = x.reshape(B, D // b, b, H // b, b, W // b, b, C).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(B, D // b, H // b, W // b, b * b * b * C)


ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "elu": F.elu,
    "relu": F.relu,
    "lrelu": lambda x: F.leaky_relu(x, negative_slope=0.1),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "none": lambda x: x,
}


def activation(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    if name is None:
        return ACTIVATIONS["none"]
    return ACTIVATIONS[str(name).lower()]


def _num_groups(channels: int, max_groups: int = 32) -> int:
    """Largest divisor of ``channels`` that is <= max_groups."""
    g = min(max_groups, channels)
    while channels % g != 0:
        g -= 1
    return g


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: Optional[torch.Generator],
                  scale: float = 1.0) -> torch.Tensor:
    """flax ``lecun_normal()``: normal truncated at +-2 std, rescaled to
    variance 1/fan_in; with ``scale``, flax ``variance_scaling(scale,
    'fan_in', 'truncated_normal')``, variance scale/fan_in."""
    std = math.sqrt(scale / fan_in) / 0.87962566103423978  # std of N(0,1) cut at +-2
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class Dense(nn.Linear):
    """``nn.Linear`` that computes in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` computed in float32, returned in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(), self.bias.float(), self.eps)
        return y.to(x.dtype)


def dense(in_features: int, features: int, generator: Optional[torch.Generator]) -> Dense:
    """flax ``nn.Dense``: lecun-normal kernel, zero bias."""
    layer = torch.nn.utils.skip_init(Dense, in_features, features)  # no draw from the global RNG
    lecun_normal_(layer.weight, in_features, generator)
    nn.init.zeros_(layer.bias)
    return layer


def layer_norm(features: int) -> LayerNorm:
    """flax ``nn.LayerNorm()``, whose epsilon is 1e-6 (PyTorch's default is 1e-5)."""
    return LayerNorm(features, eps=1e-6)


def _same_pads(k: int, s: int, size: int) -> tuple[int, int]:
    """flax/XLA SAME padding (lo, hi) of one axis: output ceil(size/s), extra on the high side."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups=_num_groups(C), epsilon=1e-5)`` over the
    last (channel) axis: groups of contiguous channels, statistics in float32."""

    eps = 1e-5

    def __init__(self, channels: int):
        super().__init__()
        self.num_groups = _num_groups(channels)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, G = x.shape[0], x.shape[-1], self.num_groups
        xf = x.float().reshape(B, -1, G, C // G)
        var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True, correction=0)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return (y * self.weight + self.bias).to(x.dtype)


def group_norm(channels: int) -> GroupNorm:
    return GroupNorm(channels)


class PhaseGroupNorm(nn.Module):
    """flax ``PhaseGroupNorm``: GroupNorm over a phase-folded tensor (B, D, H,
    W, phases * f), channels ordered (phase, c), with the statistics of the
    fine grid: group g pools every voxel, every phase and a slice of the f
    fine channels (``_num_groups(f)`` groups, not ``_num_groups(phases * f)``),
    in float32; scale and bias are (f,), shared by the phases."""

    eps = 1e-5

    def __init__(self, features: int, phases: int = 8):
        super().__init__()
        self.features, self.phases = features, phases
        self.num_groups = _num_groups(features)
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, f, G = x.shape[0], self.features, self.num_groups
        if x.shape[-1] != self.phases * f:
            raise ValueError(f"PhaseGroupNorm: {x.shape[-1]} channels, expected {self.phases} x {f}")
        xf = x.float().reshape(B, -1, self.phases, G, f // G)
        var, mean = torch.var_mean(xf, dim=(1, 2, 4), keepdim=True, correction=0)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(B, -1, self.phases, f)
        return (y * self.weight + self.bias).reshape(x.shape).to(x.dtype)


# The variance scale of flax's TRANSPOSE_MATCH_INIT (variance_scaling(1/8,
# 'fan_in', 'truncated_normal')): a k=2 conv of the blocked tail then starts
# with the outputs' std of the stride-2 transposed conv it replaces, whose fine
# outputs sum 8 of its 64 taps.
TRANSPOSE_MATCH_SCALE = 1.0 / 8.0


class ConvK2(nn.Module):
    """flax ``nn.Conv(features, (2, 2, 2), padding='SAME', use_bias=False)``
    through the ``conv_k2`` kernel. ``weight`` keeps flax's (2, 2, 2, C, N)."""

    def __init__(self, in_features: int, features: int, generator: Optional[torch.Generator] = None,
                 init_scale: float = 1.0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(2, 2, 2, in_features, features))
        lecun_normal_(self.weight, 8 * in_features, generator, init_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_k2(x, self.weight)


def _same_pad_list(x: torch.Tensor, kernel_size: int, stride: int) -> list[int]:
    """``F.pad``'s list of flax SAME pads over the spatial axes of channels-last
    ``x`` (the last spatial axis first, as ``F.pad`` lists them)."""
    pads = []
    for size in reversed(x.shape[1:-1]):
        pads += _same_pads(kernel_size, stride, size)
    return pads


class Conv2d(nn.Module):
    """flax ``nn.Conv(features, (k, k), strides=(s, s), padding='SAME',
    use_bias=False)`` on NHWC, via ``F.conv2d``. ``weight`` is OIHW."""

    def __init__(self, in_features: int, features: int, kernel_size: int, stride: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(features, in_features, k, k))
        lecun_normal_(self.weight, k * k * in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = _same_pad_list(x, self.kernel_size, self.stride)
        xc = x.permute(0, 3, 1, 2)
        if any(pads):
            xc = F.pad(xc, pads)
        y = F.conv2d(xc, self.weight.to(x.dtype), stride=self.stride)
        return y.permute(0, 2, 3, 1).contiguous()


def maxpool2d(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    """flax ``nn.max_pool(x, (window, window), strides=(stride, stride),
    padding='SAME')`` on NHWC: the overhang is padded with -inf, never zero
    (an ELU output goes below 0). A window's gradient goes to its first
    largest element in row-major order, as XLA's ``select_and_scatter`` sends it."""
    pads = _same_pad_list(x, window, stride)
    xc = x.permute(0, 3, 1, 2)
    if any(pads):
        xc = F.pad(xc, pads, value=float("-inf"))
    return F.max_pool2d(xc, window, stride).permute(0, 2, 3, 1).contiguous()


class Conv3d(nn.Module):
    """flax ``nn.Conv(features, (k, k, k), strides=(s, s, s), padding='SAME',
    use_bias=False)`` on NDHWC, via ``F.conv3d``. ``weight`` is OIDHW. A k=4
    s=2 conv of a bfloat16 CUDA input whose lowered shape has a plan runs on
    the tensor-core kernels of ``conv_k4s2`` instead (``kernels/conv_k4s2.py::
    lowering_plans``)."""

    def __init__(self, in_features: int, features: int, kernel_size: int, stride: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(features, in_features, k, k, k))
        lecun_normal_(self.weight, k**3 * in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if lowers(x, self.weight, self.kernel_size, self.stride):
            return conv_k4s2(x, self.weight)
        xc = F.pad(x.permute(0, 4, 1, 2, 3), _same_pad_list(x, self.kernel_size, self.stride))
        y = F.conv3d(xc, self.weight.to(x.dtype), stride=self.stride)
        return y.permute(0, 2, 3, 4, 1).contiguous()


class ConvTranspose3d(nn.Module):
    """flax ``nn.ConvTranspose(features, (k, k, k), strides=(s, s, s),
    padding='SAME', use_bias=False)`` on NDHWC, via ``F.conv_transpose3d``.

    flax (``transpose_kernel=False``) correlates the stride-dilated input,
    padded (pad_a, pad_b), with its kernel as stored. ``F.conv_transpose3d``
    with no padding correlates it, padded (k-1, k-1), with the kernel flipped;
    so ``weight`` holds flax's kernel flipped in D, H and W, as (Cin, Cout, k,
    k, k), and the result is cropped to flax's window. For k=4 that is
    ``[1 : 1 + s*D]`` on each axis."""

    def __init__(self, in_features: int, features: int, kernel_size: int, stride: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(in_features, features, k, k, k))
        lecun_normal_(self.weight, k**3 * in_features, generator)  # flax's fan-in: k^3 * Cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size, self.stride
        # lax.conv_transpose's SAME padding of the dilated input
        pad_a = k - 1 if s > k - 1 else -(-(k + s - 2) // 2)
        pad_b = k + s - 2 - pad_a
        y = F.conv_transpose3d(x.permute(0, 4, 1, 2, 3), self.weight.to(x.dtype), stride=s)
        start = k - 1 - pad_a
        crop = [slice(start, start + (n - 1) * s + 1 + pad_a + pad_b - k + 1) for n in x.shape[1:4]]
        y = y[:, :, crop[0], crop[1], crop[2]]
        return y.permute(0, 2, 3, 4, 1).contiguous()


def conv_transpose_equiv_kernel(weight: torch.Tensor) -> torch.Tensor:
    """``ConvTranspose3d``'s (Cin, Cout, 4, 4, 4) stride-2 weight (flax's
    kernel flipped) -> the (8 Cout, Cin, 3, 3, 3) ``F.conv3d`` weight of its
    exact phase decomposition (flax ``conv_transpose_equiv_kernel``): with
    SAME padding, output phase p of an axis is y[2i + p] = K[p] x[i - 1 + p] +
    K[p + 2] x[i + p], a 2-tap conv with taps K[2t + p] at k=3 positions t + p
    (K the flax kernel); the other taps are zero. Output channels in the
    order (pd, ph, pw, c)."""
    cin, cout = weight.shape[:2]
    k = weight.flip(2, 3, 4)  # flax's kernel, as (Cin, Cout, kd, kh, kw)
    k3 = weight.new_zeros(8, cout, cin, 3, 3, 3)
    for i in range(8):
        pd, ph, pw = i >> 2, (i >> 1) & 1, i & 1
        k3[i, :, :, pd:pd + 2, ph:ph + 2, pw:pw + 2] = k[:, :, pd::2, ph::2, pw::2].transpose(0, 1)
    return k3.reshape(8 * cout, cin, 3, 3, 3)


class ConvTransposeEquiv3D(ConvTranspose3d):
    """flax ``ConvTransposeEquiv3D``: ``nn.ConvTranspose(features, (4, 4, 4),
    strides 2, SAME, use_bias=False)`` computed as one zero-structured k=3
    SAME conv at the coarse grid emitting 8 * features phase channels, then
    depth-to-space(2). The same function, parameter tensor and init as
    ``ConvTranspose3d``, whose layout ``weight`` keeps (flax's kernel flipped,
    (Cin, Cout, 4, 4, 4)), so a classic stage's weight loads unchanged; the
    k=3 kernel is embedded from it at each call. On the H100 the phase form
    beats ``F.conv_transpose3d`` at ``modelnet_nolbo_acc``'s last stage in
    bfloat16 and in float32 with cuDNN's TF32 (PyTorch's default), forward
    and backward (``cli/probe_transpose.py``)."""

    def __init__(self, in_features: int, features: int, generator: Optional[torch.Generator] = None):
        super().__init__(in_features, features, 4, 2, generator)

    def forward(self, x: torch.Tensor, phase_output: bool = False) -> torch.Tensor:
        """``phase_output``: return the (B, D, H, W, 8 * Cout) phase tensor,
        channels (pd, ph, pw, c), whose depth-to-space(2) is the output."""
        xc = F.pad(x.permute(0, 4, 1, 2, 3), (1, 1) * 3)
        u = F.conv3d(xc, conv_transpose_equiv_kernel(self.weight).to(x.dtype)).permute(0, 2, 3, 4, 1)
        return u.contiguous() if phase_output else depth_to_space3d(u, 2)


class ConvBlock2D(nn.Module):
    """Conv2D (no bias) + GroupNorm + activation. (flax's ``use_norm=False``
    form, a conv with a bias, has no caller and is not ported.)"""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3, strides: int = 1,
                 act: str = "elu", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_0 = Conv2d(in_features, features, kernel_size, strides, generator=generator)
        self.groupnorm_0 = group_norm(features)
        self.act = activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.groupnorm_0(self.conv_0(x)))


class ConvBlock3D(nn.Module):
    """Conv3D (no bias) + GroupNorm + activation. A k=2 s=1 conv runs on the
    ``conv_k2`` kernel; other sizes on ``F.conv3d``."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 4, strides: int = 2,
                 act: str = "elu", generator: Optional[torch.Generator] = None):
        super().__init__()
        if (kernel_size, strides) == (2, 1):
            self.conv_0 = ConvK2(in_features, features, generator)
        else:
            self.conv_0 = Conv3d(in_features, features, kernel_size, strides, generator)
        self.groupnorm_0 = group_norm(features)
        self.act = activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.groupnorm_0(self.conv_0(x)))


class DeconvBlock3D(nn.Module):
    """ConvTranspose3D (no bias) + GroupNorm + activation."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 4, strides: int = 2,
                 act: str = "elu", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.convtranspose_0 = ConvTranspose3d(in_features, features, kernel_size, strides, generator)
        self.groupnorm_0 = group_norm(features)
        self.act = activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.groupnorm_0(self.convtranspose_0(x)))


class DeconvEquivBlock3D(nn.Module):
    """``DeconvBlock3D`` (k=4, s=2) through ``ConvTransposeEquiv3D``; the
    norm and activation run at the fine grid after the interleave, as in the
    classic block."""

    def __init__(self, in_features: int, features: int, act: str = "elu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.convtransposeequiv3d_0 = ConvTransposeEquiv3D(in_features, features, generator)
        self.groupnorm_0 = group_norm(features)
        self.act = activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.groupnorm_0(self.convtransposeequiv3d_0(x)))


class DenseBlock(nn.Module):
    """Flatten + Dense + LayerNorm (eps 1e-6, as flax) + activation."""

    def __init__(self, in_features: int, features: int, act: str = "elu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense_0 = dense(in_features, features, generator)
        self.layernorm_0 = layer_norm(features)
        self.act = activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.layernorm_0(self.dense_0(x.reshape(x.shape[0], -1))))
