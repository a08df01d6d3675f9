"""Bit-packed voxel transfer: 1 bit per voxel, MSB first, as ``np.packbits``.

Counterpart of ``anytime3d_tpu/data/packing.py:55-144``. The host packs with
``np.packbits``; the device unpacks and packs with shifts and masks, bit for
bit the same. The ``*_blocked`` pair orders the bits as the space-to-depth
layout the blocked encoder head reads, so a training batch unpacks straight
into it.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch


def pack_voxels(vox: np.ndarray) -> np.ndarray:
    """Host: (B, ...) occupancy (> 0.5 is occupied) -> (B, ceil(N/8)) uint8, MSB first."""
    b = vox.shape[0]
    return np.packbits(np.asarray(vox).reshape(b, -1) > 0.5, axis=-1)


def _shifts(device: torch.device) -> torch.Tensor:
    return torch.arange(7, -1, -1, dtype=torch.uint8, device=device)  # MSB first


def pack_voxels_device(vox: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """(B, ...) occupancy or probability -> (B, N/8) uint8 of ``vox > threshold``,
    MSB first, on ``vox``'s device. N must be divisible by 8."""
    b = vox.shape[0]
    bits = vox.reshape(b, -1) > threshold
    n = bits.shape[1]
    if n % 8:
        raise ValueError(f"flat size {n} not divisible by 8")
    shifted = bits.reshape(b, n // 8, 8).to(torch.uint8) << _shifts(vox.device)
    return shifted.sum(dim=-1, dtype=torch.uint8)  # disjoint bits: the sum is the bitwise or


def unpack_voxels(packed: torch.Tensor, shape: Sequence[int], dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, ceil(N/8)) uint8 -> (B, *shape) in {0, 1}, on ``packed``'s device."""
    b = packed.shape[0]
    n = math.prod(shape)
    bits = (packed[:, :, None] >> _shifts(packed.device)) & 1
    return bits.reshape(b, -1)[:, :n].reshape(b, *shape).to(dtype)


def blocked_shape(shape: Sequence[int], block: int = 4) -> Tuple[int, ...]:
    """The space-to-depth(block) coarse layout of a (D, H, W, C) grid."""
    d, h, w, c = shape
    if d % block or h % block or w % block:
        raise ValueError(f"grid {tuple(shape)} not divisible by block {block}")
    return (d // block, h // block, w // block, block**3 * c)


def pack_voxels_blocked(vox: np.ndarray, block: int = 4) -> np.ndarray:
    """Host: (B, D, H, W[, C]) occupancy -> (B, N/8) uint8 with the bits in
    space-to-depth(block) order (channel order (bd, bh, bw, c)), so that
    :func:`unpack_voxels_blocked` lands them in the blocked layout with no
    relayout on the device."""
    v = np.asarray(vox)
    if v.ndim == 4:
        v = v[..., None]
    B, D, H, W, C = v.shape
    b = block
    if D % b or H % b or W % b:
        raise ValueError(f"grid {(D, H, W)} not divisible by block {b}")
    v = v.reshape(B, D // b, b, H // b, b, W // b, b, C).transpose(0, 1, 3, 5, 2, 4, 6, 7)
    return pack_voxels(v.reshape(B, -1))


def unpack_voxels_blocked(packed: torch.Tensor, shape: Sequence[int], block: int = 4,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`pack_voxels_blocked`: (B, N/8) uint8 -> the coarse
    layout (B, D/b, H/b, W/b, b^3*C) of a (D, H, W, C) grid."""
    return unpack_voxels(packed, blocked_shape(shape, block), dtype=dtype)
