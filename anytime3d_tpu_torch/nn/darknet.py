"""Darknet image backbones and the 2-D encoder head.

Counterpart of ``anytime3d_tpu/nn/darknet.py``: GroupNorm in place of
BatchNorm and SAME-padded stride-2 convs, as in the JAX package. Images are
NHWC ``(B, H, W, 3)``; each backbone casts its input to the compute
``dtype`` on entry (parameters stay float32 and are cast at use).

Submodules are named as flax names them, lowercased: ``convblock2d_{i}``,
``_resblock_{i}`` (flax ``_ResBlock_{i}``; a legal PyTorch name) and the
head's bare ``conv_0``, so ``convert.params_from_flax`` maps a flax tree by
name alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from anytime3d_tpu_torch.nn.blocks import ConvBlock2D, Conv2d, maxpool2d

# Darknet19's stack: (features, kernel) convs and "M" for a 2x2 stride-2 max-pool
_DARKNET19 = ((32, 3), "M", (64, 3), "M", (128, 3), (64, 1), (128, 3), "M", (256, 3), (128, 1), (256, 3), "M",
              (512, 3), (256, 1), (512, 3), (256, 1), (512, 3), "M",
              (1024, 3), (512, 1), (1024, 3), (512, 1), (1024, 3))
# Darknet53Tiny's: 3x3 convs, "M" a 2x2 stride-2 pool, "M1" a 2x2 stride-1 pool
_DARKNET53_TINY = (16, "M", 32, "M", 64, "M", 128, "M", 256, "M", 512, "M1", 1024)


class _Backbone(nn.Module):
    """Holds the compute dtype and the channel count of the last map."""

    out_features: int

    def __init__(self, dtype: Optional[torch.dtype]):
        super().__init__()
        self.dtype = dtype  # compute dtype; None: that of the input

    def _cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype or x.dtype)


class Darknet19(_Backbone):
    """YOLOv2's 19-conv backbone (18 here; the head's 1x1 conv is the 19th):
    448x448x3 -> 14x14x1024, stride 32, five 2x2 max-pools."""

    def __init__(self, act: str = "elu", in_channels: int = 3, generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(dtype)
        self.layers = []  # the forward's order: block names and "M"
        cin, i = in_channels, 0
        for item in _DARKNET19:
            if item == "M":
                self.layers.append(item)
                continue
            f, k = item
            self.add_module(f"convblock2d_{i}", ConvBlock2D(cin, f, k, act=act, generator=generator))
            self.layers.append(f"convblock2d_{i}")
            cin, i = f, i + 1
        self.out_features = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._cast(x)
        for name in self.layers:
            x = maxpool2d(x) if name == "M" else getattr(self, name)(x)
        return x


class _ResBlock(nn.Module):
    """1x1 bottleneck, 3x3 conv, and the skip."""

    def __init__(self, features: int, act: str, generator: Optional[torch.Generator]):
        super().__init__()
        self.convblock2d_0 = ConvBlock2D(features, features // 2, 1, act=act, generator=generator)
        self.convblock2d_1 = ConvBlock2D(features // 2, features, 3, act=act, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.convblock2d_1(self.convblock2d_0(x))


class Darknet53(_Backbone):
    """The 53-conv residual backbone; returns the maps after the 256-, 512- and
    1024-channel stages (strides 8, 16 and 32)."""

    STAGES = ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4))  # (features, residual blocks)

    def __init__(self, act: str = "elu", in_channels: int = 3, generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(dtype)
        # flax numbers each class on its own: the convs 0.. (stem, then one a stage), the blocks 0..
        self.convblock2d_0 = ConvBlock2D(in_channels, 32, 3, act=act, generator=generator)
        self.stages = []
        cin, r = 32, 0
        for s, (f, n) in enumerate(self.STAGES):
            self.add_module(f"convblock2d_{s + 1}", ConvBlock2D(cin, f, 3, strides=2, act=act, generator=generator))
            for j in range(n):
                self.add_module(f"_resblock_{r + j}", _ResBlock(f, act, generator))
            self.stages.append((f"convblock2d_{s + 1}", [f"_resblock_{r + j}" for j in range(n)]))
            cin, r = f, r + n
        self.out_features = cin

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = self.convblock2d_0(self._cast(x))
        maps = []
        for down, blocks in self.stages:
            x = getattr(self, down)(x)
            for name in blocks:
                x = getattr(self, name)(x)
            maps.append(x)
        return maps[2], maps[3], maps[4]


class Darknet53Tiny(_Backbone):
    """The 7-conv tiny backbone; returns the 256-channel map (stride 16) and
    the last one (stride 32: its sixth pool has stride 1)."""

    def __init__(self, act: str = "elu", in_channels: int = 3, generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(dtype)
        self.layers = []
        cin, i = in_channels, 0
        for item in _DARKNET53_TINY:
            if isinstance(item, str):
                self.layers.append(item)
                continue
            self.add_module(f"convblock2d_{i}", ConvBlock2D(cin, item, 3, act=act, generator=generator))
            self.layers.append(f"convblock2d_{i}")
            cin, i = item, i + 1
        self.out_features = cin

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = self._cast(x)
        x_8 = None
        for name in self.layers:
            if name == "M":
                x = maxpool2d(x)
            elif name == "M1":
                x = maxpool2d(x, stride=1)
            else:
                x = getattr(self, name)(x)
                if name == "convblock2d_4":
                    x_8 = x
        return x_8, x


class Head2D(nn.Module):
    """Conv stack and a bare 1x1 projection, then ``last_pooling``: ``'max'``
    (a global max over H and W: the single-object encoder head, whose flat
    output holds the latent blocks), ``'average'`` (a global mean) or None
    (the map itself, (B, H, W, output_dim): the detector's fully
    convolutional head)."""

    def __init__(self, in_features: int, output_dim: int, filter_nums: Sequence[int] = (1024, 1024, 1024, 1024),
                 filter_sizes: Sequence[int] = (3, 3, 3, 1), last_pooling: Optional[str] = "max", act: str = "elu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if last_pooling not in ("max", "average", None):
            raise ValueError(f"Head2D last_pooling must be 'max', 'average' or None; got {last_pooling!r}")
        self.last_pooling = last_pooling
        cin = in_features
        for i, (f, k) in enumerate(zip(filter_nums, filter_sizes)):
            self.add_module(f"convblock2d_{i}", ConvBlock2D(cin, f, k, act=act, generator=generator))
            cin = f
        self.num_blocks = len(filter_nums)
        self.conv_0 = Conv2d(cin, output_dim, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_blocks):
            x = getattr(self, f"convblock2d_{i}")(x)
        x = self.conv_0(x)
        if self.last_pooling == "max":
            # amax, not max(dim=): tied maxima share the gradient evenly, as jnp.max's does
            return torch.amax(x, dim=(1, 2))
        if self.last_pooling == "average":
            return x.mean(dim=(1, 2))
        return x


BACKBONES = {
    "darknet19": Darknet19,
    "darknet53": Darknet53,
    "darknet53tiny": Darknet53Tiny,
}
