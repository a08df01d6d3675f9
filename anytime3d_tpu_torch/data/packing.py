"""Bit-packed voxel transfer: 1 bit per voxel, MSB first, as ``np.packbits``.

Counterpart of ``anytime3d_tpu/data/packing.py``. The host packs with
``np.packbits``; the device unpacks and packs with shifts and masks, bit for
bit the same. The ``*_blocked`` pair orders the bits as the space-to-depth
layout the blocked encoder head reads, so a training batch unpacks straight
into it. The host's blocked pack runs in the fused native packer
``csrc/pack.cpp`` (threshold, reorder and pack in one threaded pass, through
ctypes, which releases the interpreter lock) when ``g++`` can build it, and
in NumPy otherwise; the NumPy path is the oracle the native one is tested
against. ``pack_voxels_blocked.native_calls`` and ``.numpy_calls`` count the
calls each path took.
"""

from __future__ import annotations

import ctypes
import math
import os
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from anytime3d_tpu_torch.kernels import build

_PACK_SRC = Path(__file__).resolve().parent / "csrc" / "pack.cpp"
_lock = threading.Lock()  # guards the build, the load and the counts: the prefetch thread packs too
_native: dict = {}  # "lib" once loaded, or "error" once the build has failed


def native_packer() -> ctypes.CDLL:
    """The fused packer's library, built with ``g++`` on first use; raises
    RuntimeError where it cannot be built (and again on every later call)."""
    with _lock:
        if "lib" not in _native and "error" not in _native:
            try:
                lib = ctypes.CDLL(str(build.build_host(_PACK_SRC)))
            except (RuntimeError, OSError) as e:
                _native["error"] = RuntimeError(f"native packer unavailable: {e}")
            else:
                lib.pack_blocked_batch.argtypes = [
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                    ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32,
                ]
                lib.pack_blocked_batch.restype = ctypes.c_int32
                _native["lib"] = lib
    if "error" in _native:
        raise _native["error"]
    return _native["lib"]


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


def pack_voxels_blocked(vox: np.ndarray, block: int = 4, native: Optional[bool] = None) -> np.ndarray:
    """Host: (B, D, H, W[, C]) occupancy -> (B, N/8) uint8 with the bits in
    space-to-depth(block) order (channel order (bd, bh, bw, c)), so that
    :func:`unpack_voxels_blocked` lands them in the blocked layout with no
    relayout on the device.

    ``native``: True packs with the native packer or raises; False with
    NumPy; None with the native packer where it can be built, else NumPy.
    Both give the same bytes."""
    v = np.asarray(vox)
    if v.ndim == 4:
        v = v[..., None]
    B, D, H, W, C = v.shape
    b = block
    if D % b or H % b or W % b:
        raise ValueError(f"grid {(D, H, W)} not divisible by block {b}")
    lib = None
    if native is not False:
        try:
            lib = native_packer()
        except RuntimeError:
            if native:
                raise
    if lib is not None:
        vf = np.ascontiguousarray(v, dtype=np.float32)
        out = np.empty((B, (D * H * W * C + 7) // 8), np.uint8)
        rc = lib.pack_blocked_batch(vf.ctypes.data, B, D, H, W, C, b, out.ctypes.data, min(8, os.cpu_count() or 1))
        if rc != 0:
            raise ValueError(f"native packer refused shape {v.shape}, block {b} (code {rc})")
        _count("native_calls")
        return out
    v = v.reshape(B, D // b, b, H // b, b, W // b, b, C).transpose(0, 1, 3, 5, 2, 4, 6, 7)
    _count("numpy_calls")
    return pack_voxels(v.reshape(B, -1))


def _count(path: str) -> None:
    with _lock:
        setattr(pack_voxels_blocked, path, getattr(pack_voxels_blocked, path) + 1)


pack_voxels_blocked.native_calls = 0
pack_voxels_blocked.numpy_calls = 0


def unpack_voxels_blocked(packed: torch.Tensor, shape: Sequence[int], block: int = 4,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`pack_voxels_blocked`: (B, N/8) uint8 -> the coarse
    layout (B, D/b, H/b, W/b, b^3*C) of a (D, H, W, C) grid."""
    return unpack_voxels(packed, blocked_shape(shape, block), dtype=dtype)
