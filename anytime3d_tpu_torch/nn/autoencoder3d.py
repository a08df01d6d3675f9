"""3-D convolutional voxel encoder/decoder, blocked layouts.

Counterpart of ``anytime3d_tpu/nn/autoencoder3d.py``. The configs mirror the
JAX dataclasses field by field. The modules port the layout the flagship
``modelnet_nolbo`` runs:

- ``Encoder3D`` on the blocked-head path: space-to-depth(4) of the input
  (skipped with ``blocked_input``), two k=2 s=1 convs at the coarse grid (the
  ``conv_k2`` kernel), then the remaining stride-2 k=4 stages, a final conv
  and a mean pool;
- ``Decoder3D`` on the blocked-tail path: dense to a small grid, transposed
  convs, two k=2 s=1 convs emitting phase channels (the ``conv_k2`` kernel),
  one depth-to-space(4) (skipped with ``blocked_output``) and the final
  activation;
- ``Decoder3D`` on the pixel-shuffle path (the detector's decoder, and any
  ``final_mode='pixel_shuffle'`` config without a blocked tail): dense to a
  small grid, a transposed conv for every stage but the last, then one stride-1
  conv of ``max(1, ceil(k/s))`` emitting ``s^3`` phase channels (at 2x2x2,
  every config of the repo, the ``conv_k2`` kernel), depth-to-space(s) and the
  final activation.

The train step keeps the whole voxel round trip in the coarse layout
(``blocked_input`` and ``blocked_output``), so the fine 64^3 x 1 grid is never
laid out on the device.

Layouts and flags the slice does not use raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from anytime3d_tpu_torch.nn.blocks import (
    ConvBlock3D,
    Conv3d,
    ConvK2,
    DeconvBlock3D,
    DenseBlock,
    activation,
    depth_to_space3d,
    group_norm,
    space_to_depth3d,
)


@dataclasses.dataclass(frozen=True)
class Encoder3DConfig:
    output_dim: int = 400
    filter_nums: Tuple[int, ...] = (64, 128, 256, 512)
    filter_sizes: Tuple[int, ...] = (4, 4, 4, 4, 4)
    strides: Tuple[int, ...] = (2, 2, 2, 2, 1)
    final_pool: str = "average"  # 'average' | 'max' | 'none'
    act: str = "elu"
    final_act: str = "none"  # 'sigmoid' | 'none'
    stem_space_to_depth: int = 1
    head_blocked: bool = False
    mid_blocked: bool = False

    @property
    def all_filters(self) -> Tuple[int, ...]:
        return tuple(self.filter_nums) + (self.output_dim,)


@dataclasses.dataclass(frozen=True)
class Decoder3DConfig:
    input_dim: int = 200
    output_shape: Tuple[int, int, int, int] = (64, 64, 64, 1)
    filter_nums: Tuple[int, ...] = (512, 256, 128, 64, 1)
    filter_sizes: Tuple[int, ...] = (4, 4, 4, 4, 4)
    strides: Tuple[int, ...] = (1, 2, 2, 2, 2)
    act: str = "elu"
    final_act: str = "sigmoid"
    final_mode: str = "pixel_shuffle"  # 'pixel_shuffle' | 'transpose' | 'transpose_equiv'
    tail_blocked: bool = False
    mid_blocked: bool = False
    tail_init_match_transpose: bool = False
    tail_phase_norm: bool = False
    mid_equiv: bool = False


def encoder_head_blocked_active(cfg: Encoder3DConfig) -> bool:
    """True when the encoder takes the blocked-head path (s2d(4) stem)."""
    return cfg.head_blocked and len(cfg.all_filters) > 2 and cfg.strides[0] == 2 and cfg.strides[1] == 2


def decoder_tail_blocked_active(cfg: Decoder3DConfig) -> bool:
    """True when the decoder takes the blocked-tail path (d2s(4) final)."""
    return (
        cfg.tail_blocked
        and cfg.final_mode == "pixel_shuffle"
        and len(cfg.filter_nums) >= 2
        and cfg.strides[-1] == 2
        and cfg.strides[-2] == 2
    )


def _refuse(what: list[str]) -> None:
    if what:
        raise NotImplementedError(f"not ported yet: {', '.join(what)}")


class Encoder3D(nn.Module):
    """Voxel grid (B, D, H, W, C) -> latent vector (B, output_dim)."""

    def __init__(self, config: Encoder3DConfig, in_channels: int = 1,
                 generator: Optional[torch.Generator] = None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        cfg = config
        self.dtype = dtype  # compute dtype; None: that of the input
        _refuse([name for name, on in (
            ("the classic encoder (head_blocked off)", not encoder_head_blocked_active(cfg)),
            ("mid_blocked", cfg.mid_blocked),
            (f"final_pool={cfg.final_pool!r}", cfg.final_pool != "average"),
        ) if on])
        filters, sizes, strides = cfg.all_filters, cfg.filter_sizes, cfg.strides
        stages = [(filters[0] * 8, 2, 1), (filters[1], 2, 1)]  # the blocked head
        stages += list(zip(filters[2:-1], sizes[2:-1], strides[2:-1]))
        cin = 64 * in_channels
        for i, (f, k, s) in enumerate(stages):
            self.add_module(f"convblock3d_{i}", ConvBlock3D(cin, f, k, s, cfg.act, generator))
            cin = f
        self.num_blocks = len(stages)
        # final conv: no norm, no activation
        self.conv_0 = Conv3d(cin, filters[-1], sizes[-1], strides[-1], generator)
        self.final_act = activation(cfg.final_act)

    def forward(self, x: torch.Tensor, blocked_input: bool = False) -> torch.Tensor:
        """``blocked_input``: ``x`` is already (B, D/4, H/4, W/4, 64*C), the
        space-to-depth(4) layout, and the relayout is skipped."""
        x = x.to(self.dtype or x.dtype)
        if not blocked_input:
            x = space_to_depth3d(x, 4)
        for i in range(self.num_blocks):
            x = getattr(self, f"convblock3d_{i}")(x)
        x = self.conv_0(x).mean(dim=(1, 2, 3))
        return self.final_act(x)


class Decoder3D(nn.Module):
    """Latent vector (B, input_dim) -> occupancy grid (B, D, H, W, C)."""

    def __init__(self, config: Decoder3DConfig, generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        cfg = config
        self.dtype = dtype  # compute dtype; None: that of the input
        self.blocked = decoder_tail_blocked_active(cfg)
        pixel_shuffle = cfg.final_mode == "pixel_shuffle" and cfg.strides[-1] > 1
        _refuse([name for name, on in (
            (f"the decoder with final_mode={cfg.final_mode!r}, tail_blocked={cfg.tail_blocked} and last stride "
             f"{cfg.strides[-1]}", not (self.blocked or pixel_shuffle)),
            ("mid_blocked", cfg.mid_blocked),
            ("mid_equiv", cfg.mid_equiv),
            ("tail_phase_norm", cfg.tail_phase_norm),
            ("tail_init_match_transpose", cfg.tail_init_match_transpose),
        ) if on])
        self.spatial = tuple(n // math.prod(cfg.strides) for n in cfg.output_shape[:-1])
        self.channels = max(cfg.filter_nums[0] // 64, 8)
        self.denseblock_0 = DenseBlock(cfg.input_dim, math.prod(self.spatial) * self.channels,
                                       cfg.act, generator)
        n_mid = len(cfg.filter_nums) - (2 if self.blocked else 1)
        cin = self.channels
        for i, (f, k, s) in enumerate(zip(cfg.filter_nums[:n_mid], cfg.filter_sizes[:n_mid],
                                          cfg.strides[:n_mid])):
            self.add_module(f"deconvblock3d_{i}", DeconvBlock3D(cin, f, k, s, cfg.act, generator))
            cin = f
        self.num_blocks = n_mid
        if self.blocked:
            # blocked tail: the last two stride-2 stages as k=2 convs at the coarse grid
            f4 = cfg.filter_nums[-2]
            self.conv_0 = ConvK2(cin, f4 * 8, generator)
            self.groupnorm_0 = group_norm(f4 * 8)
            self.conv_1 = ConvK2(f4 * 8, cfg.filter_nums[-1] * 64, generator)
            self.act = activation(cfg.act)
        else:
            # pixel shuffle: a stride-1 SAME conv of ceil(k/s) emitting f * s^3 phase channels
            f, k, self.shuffle = cfg.filter_nums[-1], cfg.filter_sizes[-1], cfg.strides[-1]
            size = max(1, -(-k // self.shuffle))
            features = f * self.shuffle**3
            self.conv_0 = ConvK2(cin, features, generator) if size == 2 else Conv3d(cin, features, size, 1, generator)
        self.final_act = activation(cfg.final_act)

    def forward(self, z: torch.Tensor, blocked_output: bool = False) -> torch.Tensor:
        """``blocked_output`` (blocked tail only): return the grid as (B, D/4,
        H/4, W/4, 64*C), the layout depth-to-space(4) would read, with the
        final activation applied: element for element the space-to-depth(4)
        of the normal output."""
        if blocked_output and not self.blocked:
            raise ValueError("blocked_output requires the blocked-tail layout")
        z = z.to(self.dtype or z.dtype)
        # the dense output is laid out channels-last, (B, *spatial, channels)
        x = self.denseblock_0(z).reshape(z.shape[0], *self.spatial, self.channels)
        for i in range(self.num_blocks):
            x = getattr(self, f"deconvblock3d_{i}")(x)
        if not self.blocked:
            return self.final_act(depth_to_space3d(self.conv_0(x), self.shuffle))
        x = self.act(self.groupnorm_0(self.conv_0(x)))
        x = self.conv_1(x)
        if not blocked_output:
            x = depth_to_space3d(x, 4)
        return self.final_act(x)
