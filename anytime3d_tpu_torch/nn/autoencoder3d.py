"""3-D convolutional voxel encoder/decoder in every layout of the JAX package.

Counterpart of ``anytime3d_tpu/nn/autoencoder3d.py``. The configs mirror the
JAX dataclasses field by field.

- ``Encoder3D``, blocked head (``head_blocked``): space-to-depth(4) of the
  input (skipped with ``blocked_input``), two k=2 s=1 convs at the coarse grid
  (the ``conv_k2`` kernel), then the remaining stages. Classic: an optional
  space-to-depth(b) stem (``stem_space_to_depth``; a k=4 s=2 stem becomes k=2
  s=1 over 8 channels at b=2, the ``conv_k2`` kernel), then every stage as
  configured. With ``mid_blocked`` every k=4 s=2 stage whose input grid is at
  least 2 on each axis is a space-to-depth(2) and a k=2 s=1 conv over 8 times
  the channels (``conv_k2``): the same 4-tap family, reparameterized. Both end
  in a final conv (no norm) and a mean, max or no pool.
- ``Decoder3D``: dense to a small grid, then a transposed conv for every stage
  but the last (``DeconvEquivBlock3D``, the same function in its phase
  lowering, for the k=4 s=2 stages under ``mid_equiv``; under ``mid_blocked`` a
  k=2 conv emitting 8 f phase channels, ``conv_k2``, then depth-to-space(2),
  GroupNorm(f) and the activation at the fine grid), then one of: the
  blocked tail (two k=2 convs emitting phase channels, ``conv_k2``; its norm
  per phase, or with ``tail_phase_norm`` the fine grid's ``PhaseGroupNorm``;
  ``tail_init_match_transpose`` scales their init variance by 1/8), one
  depth-to-space(4) (skipped with ``blocked_output``); the pixel shuffle (a
  stride-1 conv of ``max(1, ceil(k/s))`` emitting ``s^3`` phase channels,
  ``conv_k2`` at k=2, and depth-to-space(s)); ``ConvTransposeEquiv3D``
  (``final_mode='transpose_equiv'`` at k=4 s=2; ``blocked_output`` gives the
  space-to-depth(4) layout of its fine output straight from the phase
  tensor); else a ``ConvTranspose3d`` (``final_mode='transpose'``, or any
  last stride of 1). The final activation last.

The train step keeps the whole voxel round trip in the coarse layout
(``blocked_input`` and ``blocked_output``) where the layout has it, so the
fine 64^3 x 1 grid is never laid out on the device.

Submodules carry the names flax gives them, lowercased and numbered per
class (``_decoder_stage_names``; a ``mid_blocked`` decoder stage is a flax
``Conv_i`` and ``GroupNorm_j`` of the decoder itself, numbered with the tail's).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Tuple

import torch
import torch.nn as nn

from anytime3d_tpu_torch.nn.blocks import (
    TRANSPOSE_MATCH_SCALE,
    ConvBlock3D,
    Conv3d,
    ConvK2,
    ConvTranspose3d,
    ConvTransposeEquiv3D,
    DeconvBlock3D,
    DeconvEquivBlock3D,
    DenseBlock,
    PhaseGroupNorm,
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


def decoder_final_equiv_active(cfg: Decoder3DConfig) -> bool:
    """True when the decoder's final stage is ``ConvTransposeEquiv3D``."""
    return cfg.final_mode == "transpose_equiv" and cfg.strides[-1] == 2 and cfg.filter_sizes[-1] == 4


def phase2_to_block4(u: torch.Tensor, c: int) -> torch.Tensor:
    """(B, D, H, W, 8 C) phase tensor, channels (pd, ph, pw, c) -> the
    space-to-depth(4) layout of its fine output, (B, D/2, H/2, W/2, 64 C),
    channels (bd, bh, bw, c): fine index o = 2j + p with j = 2i + q gives o =
    4i + 2q + p, so the block-4 index is b = 2q + p per axis. A relayout."""
    x = space_to_depth3d(u, 2)  # channels (qd, qh, qw), (pd, ph, pw), c
    B, D, H, W, _ = x.shape
    x = x.reshape(B, D, H, W, 2, 2, 2, 2, 2, 2, c).permute(0, 1, 2, 3, 4, 7, 5, 8, 6, 9, 10)
    return x.reshape(B, D, H, W, 64 * c)


def _decoder_stage_names(cfg: Decoder3DConfig) -> list[str]:
    """flax's names of the decoder's conv stages, in order (flax numbers its
    submodules per class), as the JAX package lists them."""
    names: list[str] = []
    counts: dict[str, int] = {}

    def fresh(cls_name: str) -> str:
        i = counts.get(cls_name, 0)
        counts[cls_name] = i + 1
        return f"{cls_name}_{i}"

    blocked = decoder_tail_blocked_active(cfg)
    n_mid = len(cfg.filter_nums) - (2 if blocked else 1)
    for k, s in zip(cfg.filter_sizes[:n_mid], cfg.strides[:n_mid]):
        if cfg.mid_blocked and s == 2 and k == 4:
            names.append(fresh("Conv"))
        elif cfg.mid_equiv and s == 2 and k == 4:
            names.append(fresh("DeconvEquivBlock3D"))
        else:
            names.append(fresh("DeconvBlock3D"))
    if blocked:
        return names + [fresh("Conv"), fresh("Conv")]
    k, s = cfg.filter_sizes[-1], cfg.strides[-1]
    if cfg.final_mode == "transpose_equiv" and s == 2 and k == 4:
        names.append(fresh("ConvTransposeEquiv3D"))
    elif cfg.final_mode == "pixel_shuffle" and s > 1:
        names.append(fresh("Conv"))
    else:
        names.append(fresh("ConvTranspose"))
    return names


# stage pairs that hold the same parameter tensors in two lowerings, and the
# conv each block holds
_COMPATIBLE = {("deconvblock3d", "deconvequivblock3d"), ("deconvequivblock3d", "deconvblock3d"),
               ("convtranspose", "convtransposeequiv3d"), ("convtransposeequiv3d", "convtranspose")}
_INNER = {"deconvblock3d": "convtranspose_0", "deconvequivblock3d": "convtransposeequiv3d_0"}


def remap_decoder_params(state: Mapping[str, torch.Tensor], src_cfg: Decoder3DConfig,
                         dst_cfg: Decoder3DConfig) -> dict[str, torch.Tensor]:
    """Rename a ``Decoder3D`` state dict (keys relative to the decoder) from
    the ``src_cfg`` layout to the ``dst_cfg`` layout, for layouts that share
    their parameter tensors: the classic transposed convs and their phase
    lowering (``'transpose'`` <-> ``'transpose_equiv'``, ``mid_equiv``), whose
    weights have one layout here. Raises ``ValueError`` where a stage pair is
    not tensor-compatible (a blocked tail or pixel shuffle is another
    parameterization), where the stage counts differ, or where a block's conv
    holds a leaf beyond its weight (it would be dropped). The JAX package's
    ``remap_decoder_params`` on flax trees, for loading a classic checkpoint
    into an ``*_acc`` config or back."""
    src_names = [n.lower() for n in _decoder_stage_names(src_cfg)]
    dst_names = [n.lower() for n in _decoder_stage_names(dst_cfg)]
    if len(src_names) != len(dst_names):
        raise ValueError(f"layout stage mismatch: {src_names} vs {dst_names}")
    out = dict(state)
    moved: dict[str, torch.Tensor] = {}
    for s_name, d_name in zip(src_names, dst_names):
        if s_name == d_name:
            continue
        s_cls, d_cls = s_name.rsplit("_", 1)[0], d_name.rsplit("_", 1)[0]
        if (s_cls, d_cls) not in _COMPATIBLE:
            raise ValueError(f"stages {s_name} -> {d_name} are not tensor-compatible "
                             "(different parameterizations, not just lowerings)")
        for key in [k for k in out if k.startswith(s_name + ".")]:
            rest = key[len(s_name) + 1:]
            if s_cls in _INNER and rest.startswith(_INNER[s_cls] + "."):
                leaf = rest[len(_INNER[s_cls]) + 1:]
                if leaf != "weight":
                    raise ValueError(f"stage {s_name}: leaf {leaf!r} beyond the weight has no counterpart in "
                                     f"{_INNER[d_cls]}; the remap would drop it")
                rest = f"{_INNER[d_cls]}.{leaf}"
            moved[f"{d_name}.{rest}"] = out.pop(key)
    out.update(moved)
    return out


def _conv(in_features: int, features: int, k: int, s: int, generator: Optional[torch.Generator]) -> nn.Module:
    """flax ``nn.Conv`` (k, s, SAME, no bias): ``conv_k2`` at k=2 s=1, else ``F.conv3d``."""
    return ConvK2(in_features, features, generator) if (k, s) == (2, 1) else Conv3d(in_features, features, k, s,
                                                                                      generator)


def _mid_blocked_stage(cfg: Encoder3DConfig, k: int, s: int, grid: Tuple[int, int, int]) -> bool:
    """Whether an encoder stage of kernel ``k`` and stride ``s`` whose input
    grid is ``grid`` runs as space-to-depth(2) + a k=2 s=1 conv, as the JAX
    encoder decides it from the shape it is traced with."""
    return cfg.mid_blocked and s == 2 and k == 4 and min(grid) >= 2


class Encoder3D(nn.Module):
    """Voxel grid (B, D, H, W, C) -> latent vector (B, output_dim), or with
    ``final_pool='none'`` the final conv's map.

    ``grid``: the (D, H, W) of the input, which decides which stages
    ``mid_blocked`` folds (flax decides at trace time; here the parameters'
    shapes depend on it). None assumes every stage's grid is at least 2 on
    each axis; a forward on a grid that decides otherwise raises."""

    def __init__(self, config: Encoder3DConfig, in_channels: int = 1,
                 generator: Optional[torch.Generator] = None, dtype: Optional[torch.dtype] = None,
                 grid: Optional[Tuple[int, int, int]] = None):
        super().__init__()
        cfg = config
        if cfg.final_pool not in ("average", "max", "none"):
            raise ValueError(f"unknown final_pool {cfg.final_pool!r}")
        self.config = cfg
        self.dtype = dtype  # compute dtype; None: that of the input
        self.blocked = encoder_head_blocked_active(cfg)
        self.final_pool = cfg.final_pool
        filters, sizes, strides = cfg.all_filters, list(cfg.filter_sizes), list(cfg.strides)
        if self.blocked:
            self.fold = 4
            stages = [(filters[0] * 8, 2, 1), (filters[1], 2, 1)]
            stages += list(zip(filters[2:-1], sizes[2:-1], strides[2:-1]))
        else:
            self.fold = cfg.stem_space_to_depth
            if self.fold > 1:
                if strides[0] % self.fold != 0:
                    raise ValueError("stem_space_to_depth must divide the stem stride")
                sizes[0] = max(1, -(-sizes[0] // self.fold))  # the stem's receptive field, ceil-divided
                strides[0] //= self.fold
            stages = list(zip(filters[:-1], sizes[:-1], strides[:-1]))
        self.stages = stages  # (features, kernel, stride) as configured
        g = tuple(n // self.fold for n in grid) if grid is not None else None
        cin = in_channels * self.fold**3
        self.mid = []  # per stage: space-to-depth(2) then a k=2 s=1 conv
        for i, (f, k, s) in enumerate(stages):
            mid = _mid_blocked_stage(cfg, k, s, g if g is not None else (2, 2, 2))
            if mid:
                self.add_module(f"convblock3d_{i}", ConvBlock3D(8 * cin, f, 2, 1, cfg.act, generator))
            else:
                self.add_module(f"convblock3d_{i}", ConvBlock3D(cin, f, k, s, cfg.act, generator))
            self.mid.append(mid)
            if g is not None:
                g = tuple(-(-n // s) for n in g)  # SAME: ceil(n / s)
            cin = f
        # final conv: no norm, no activation
        self.conv_0 = _conv(cin, filters[-1], cfg.filter_sizes[-1], cfg.strides[-1], generator)
        self.final_act = activation(cfg.final_act)

    def forward(self, x: torch.Tensor, blocked_input: bool = False) -> torch.Tensor:
        """``blocked_input`` (blocked head only): ``x`` is already (B, D/4,
        H/4, W/4, 64*C), the space-to-depth(4) layout, and the relayout is
        skipped."""
        if blocked_input and not self.blocked:
            raise ValueError("blocked_input requires the blocked-head layout")
        x = x.to(self.dtype or x.dtype)
        if self.fold > 1 and not blocked_input:
            x = space_to_depth3d(x, self.fold)
        for i, (_, k, s) in enumerate(self.stages):
            if _mid_blocked_stage(self.config, k, s, x.shape[1:4]) != self.mid[i]:
                raise ValueError(f"Encoder3D stage {i} was built {'with' if self.mid[i] else 'without'} the "
                                 f"mid_blocked fold, which a {tuple(x.shape[1:4])} grid decides otherwise; "
                                 "build it with grid= the input's (D, H, W)")
            if self.mid[i]:
                x = space_to_depth3d(x, 2)
            x = getattr(self, f"convblock3d_{i}")(x)
        x = self.conv_0(x)
        if self.final_pool == "average":
            x = x.mean(dim=(1, 2, 3))
        elif self.final_pool == "max":
            x = x.amax(dim=(1, 2, 3))  # a tie's gradient is shared evenly, as jnp.max's
        return self.final_act(x)


class Decoder3D(nn.Module):
    """Latent vector (B, input_dim) -> occupancy grid (B, D, H, W, C)."""

    def __init__(self, config: Decoder3DConfig, generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        cfg = config
        self.dtype = dtype  # compute dtype; None: that of the input
        self.blocked = decoder_tail_blocked_active(cfg)
        self.spatial = tuple(n // math.prod(cfg.strides) for n in cfg.output_shape[:-1])
        self.channels = max(cfg.filter_nums[0] // 64, 8)
        self.denseblock_0 = DenseBlock(cfg.input_dim, math.prod(self.spatial) * self.channels,
                                       cfg.act, generator)
        names = [n.lower() for n in _decoder_stage_names(cfg)]
        n_mid = len(cfg.filter_nums) - (2 if self.blocked else 1)
        # the middle stages as (conv or block name, norm name or None): a mid_blocked stage is a conv of the
        # decoder's own and a GroupNorm numbered as flax numbers them, the tail's after them
        self.stages = []
        norms = 0
        cin = self.channels
        for name, f, k, s in zip(names[:n_mid], cfg.filter_nums, cfg.filter_sizes, cfg.strides):
            norm = None
            if name.startswith("conv_"):  # mid_blocked: k=2 to 8 f phase channels, d2s(2), norm and act
                self.add_module(name, ConvK2(cin, 8 * f, generator))
                norm, norms = f"groupnorm_{norms}", norms + 1
                self.add_module(norm, group_norm(f))
            elif name.startswith("deconvequivblock3d"):
                self.add_module(name, DeconvEquivBlock3D(cin, f, cfg.act, generator))
            else:
                self.add_module(name, DeconvBlock3D(cin, f, k, s, cfg.act, generator))
            self.stages.append((name, norm))
            cin = f
        f, k, s = cfg.filter_nums[-1], cfg.filter_sizes[-1], cfg.strides[-1]
        self.final = names[-1]
        self.final_features = f
        self.act = activation(cfg.act)
        if self.blocked:
            # the last two stride-2 stages as k=2 convs at the coarse grid
            f4 = cfg.filter_nums[-2]
            scale = TRANSPOSE_MATCH_SCALE if cfg.tail_init_match_transpose else 1.0
            self.tail = (names[-2], names[-1])
            self.add_module(names[-2], ConvK2(cin, f4 * 8, generator, scale))
            self.tail_norm = "phasegroupnorm_0" if cfg.tail_phase_norm else f"groupnorm_{norms}"
            self.add_module(self.tail_norm, PhaseGroupNorm(f4, 8) if cfg.tail_phase_norm else group_norm(f4 * 8))
            self.add_module(names[-1], ConvK2(f4 * 8, f * 64, generator, scale))
        elif self.final.startswith("convtransposeequiv3d"):
            self.convtransposeequiv3d_0 = ConvTransposeEquiv3D(cin, f, generator)
        elif self.final.startswith("conv_"):
            # pixel shuffle: a stride-1 SAME conv of ceil(k/s) emitting f * s^3 phase channels
            self.shuffle = s
            self.add_module(self.final, _conv(cin, f * s**3, max(1, -(-k // s)), 1, generator))
        else:
            self.convtranspose_0 = ConvTranspose3d(cin, f, k, s, generator)
        self.final_act = activation(cfg.final_act)

    def forward(self, z: torch.Tensor, blocked_output: bool = False) -> torch.Tensor:
        """``blocked_output`` (the blocked tail or ``transpose_equiv``): return
        the grid as (B, D/4, H/4, W/4, 64*C), the layout depth-to-space(4)
        would read, with the final activation applied: element for element
        the space-to-depth(4) of the normal output."""
        equiv = self.final.startswith("convtransposeequiv3d")
        if blocked_output and not (self.blocked or equiv):
            raise ValueError("blocked_output requires the blocked-tail or transpose_equiv layout")
        z = z.to(self.dtype or z.dtype)
        # the dense output is laid out channels-last, (B, *spatial, channels)
        x = self.denseblock_0(z).reshape(z.shape[0], *self.spatial, self.channels)
        for name, norm in self.stages:
            x = getattr(self, name)(x)
            if norm is not None:
                x = self.act(getattr(self, norm)(depth_to_space3d(x, 2)))
        if self.blocked:
            first, second = (getattr(self, n) for n in self.tail)
            x = second(self.act(getattr(self, self.tail_norm)(first(x))))
            if not blocked_output:
                x = depth_to_space3d(x, 4)
        elif equiv:
            x = self.convtransposeequiv3d_0(x, phase_output=blocked_output)
            if blocked_output:
                x = phase2_to_block4(x, self.final_features)
        elif self.final.startswith("conv_"):
            x = depth_to_space3d(getattr(self, self.final)(x), self.shuffle)
        else:
            x = self.convtranspose_0(x)
        return self.final_act(x)
