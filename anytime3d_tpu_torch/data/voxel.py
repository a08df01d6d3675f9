"""Voxel utilities: binarization, nearest-neighbour zoom, axis conversion.

Counterpart of ``anytime3d_tpu/data/voxel.py``, NumPy only: the ModelNet
shards' 32^3 -> 64^3 conversion (transpose the (z, x, y) axis order, zoom 2x
by nearest neighbour, binarize again).
"""

from __future__ import annotations

import numpy as np


def binarize(vox: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    return (vox >= threshold).astype(np.float32)


def zoom_nearest(vox: np.ndarray, factor: int = 2) -> np.ndarray:
    """Integer-factor nearest-neighbour upsample of a (..., D, H, W) grid:
    ``np.repeat`` along each spatial axis."""
    out = np.repeat(vox, factor, axis=-3)
    out = np.repeat(out, factor, axis=-2)
    return np.repeat(out, factor, axis=-1)


def convert_axis_32to64(vox_batch: np.ndarray) -> np.ndarray:
    """(B, 32, 32, 32) -> (B, 64, 64, 64): transpose the (z, x, y) axis order,
    zoom 2x, binarize at 0.5."""
    v = np.transpose(vox_batch, (0, 2, 3, 1))
    v = zoom_nearest(v, 2)
    return binarize(v, 0.5)
