"""Mesh voxelization: the native C++ voxelizer through ctypes, and its NumPy
counterpart; OFF mesh loading; host NMS.

Counterpart of ``anytime3d_tpu/data/voxelize.py``, NumPy only. The native
path (``csrc/voxelizer.cpp``, the port's copy of the JAX package's
``native/voxelizer.cpp``) is built with ``g++`` by
``kernels/build.py::build_host`` on first use: a conservative surface
rasterization, then a solid fill by z-parity, both threaded. The NumPy path
samples the same parity rays but rasterizes no surface and keeps duplicate
crossings, so its grids are not the native ones: on the procedural instance
shapes of ``data/instances.py`` about a third of the occupied voxels differ.
``voxelize.native_calls`` and ``.numpy_calls`` count the calls each path took.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from anytime3d_tpu_torch.kernels import build

_SRC = Path(__file__).resolve().parent / "csrc" / "voxelizer.cpp"
_lock = threading.Lock()  # guards the build, the load and the counts
_native: dict = {}  # "lib" once loaded, or "error" once the build has failed


def native_voxelizer() -> ctypes.CDLL:
    """The voxelizer's library, built with ``g++`` on first use; raises
    RuntimeError where it cannot be built (and again on every later call)."""
    with _lock:
        if "lib" not in _native and "error" not in _native:
            try:
                lib = ctypes.CDLL(str(build.build_host(_SRC)))
            except (RuntimeError, OSError) as e:
                _native["error"] = RuntimeError(f"native voxelizer unavailable: {e}")
            else:
                lib.voxelize_mesh.argtypes = [
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                    ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32,
                ]
                lib.voxelize_mesh.restype = None
                lib.nms_host.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_void_p]
                lib.nms_host.restype = None
                _native["lib"] = lib
    if "error" in _native:
        raise _native["error"]
    return _native["lib"]


def native_available() -> bool:
    """True where the native library builds and loads."""
    try:
        native_voxelizer()
    except RuntimeError:
        return False
    return True


def _library(native: Optional[bool]) -> Optional[ctypes.CDLL]:
    """The native library, or None for the NumPy path: ``native`` True
    raises where it cannot be built, False never builds it, None takes it
    where it builds."""
    if native is False:
        return None
    try:
        return native_voxelizer()
    except RuntimeError:
        if native:
            raise
        return None


def normalize_mesh(verts: np.ndarray, dim: int, pad: float = 0.05) -> np.ndarray:
    """Scale and center vertices into the [0, dim] cube, aspect kept, with
    ``pad`` of the cube as margin on each side."""
    v = np.asarray(verts, np.float32)
    mins, maxs = v.min(axis=0), v.max(axis=0)
    extent = float((maxs - mins).max())
    if extent <= 0:
        extent = 1.0
    scale = dim * (1.0 - 2 * pad) / extent
    center = (mins + maxs) / 2.0
    return (v - center) * scale + dim / 2.0


def voxelize(verts: np.ndarray, tris: np.ndarray, dim: int = 64, solid: bool = True, normalize: bool = True,
             threads: int = 0, native: Optional[bool] = None) -> np.ndarray:
    """Triangle mesh -> (dim, dim, dim) float32 occupancy grid, indexed
    [x, y, z] in the mesh's (normalized) coordinates.

    ``solid`` fills the inside; otherwise the surface alone. ``threads``: the
    native path's worker threads, 0 for one a core (the grid does not depend
    on it). ``native``: True voxelizes natively or raises; False in NumPy;
    None natively where the library builds, else in NumPy."""
    verts = np.ascontiguousarray(verts, np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    if normalize:
        verts = np.ascontiguousarray(normalize_mesh(verts, dim), np.float32)
    lib = _library(native)
    if lib is None:
        _count("numpy_calls")
        return _voxelize_numpy(verts, tris, dim, solid)
    out = np.zeros(dim * dim * dim, np.uint8)
    lib.voxelize_mesh(verts.ctypes.data, len(verts), tris.ctypes.data, len(tris), dim, 1 if solid else 0,
                      out.ctypes.data, threads)
    _count("native_calls")
    return out.reshape(dim, dim, dim).astype(np.float32)


def _count(path: str) -> None:
    with _lock:
        setattr(voxelize, path, getattr(voxelize, path) + 1)


voxelize.native_calls = 0
voxelize.numpy_calls = 0


def _voxelize_numpy(verts: np.ndarray, tris: np.ndarray, dim: int, solid: bool) -> np.ndarray:
    """z-column crossing parity (solid) or the crossings alone (surface), on
    rays jittered off the voxel centers as the native fill's are."""
    grid = np.zeros((dim, dim, dim), np.float32)
    tv = verts[tris]  # (T, 3, 3)
    # the jitter keeps rays off shared triangle edges, where parity would break
    xs = np.arange(dim) + 0.5 + 1.2345e-4
    ys = np.arange(dim) + 0.5 + 3.1713e-4
    for x_i, cx in enumerate(xs):
        # only the triangles spanning this x slab
        span = (tv[:, :, 0].min(axis=1) <= cx + 0.5) & (tv[:, :, 0].max(axis=1) >= cx - 0.5)
        sub = tv[span]
        if len(sub) == 0:
            continue
        for y_i, cy in enumerate(ys):
            v0, v1, v2 = sub[:, 0], sub[:, 1], sub[:, 2]
            d1 = (v1[:, 0] - v0[:, 0]) * (cy - v0[:, 1]) - (v1[:, 1] - v0[:, 1]) * (cx - v0[:, 0])
            d2 = (v2[:, 0] - v1[:, 0]) * (cy - v1[:, 1]) - (v2[:, 1] - v1[:, 1]) * (cx - v1[:, 0])
            d3 = (v0[:, 0] - v2[:, 0]) * (cy - v2[:, 1]) - (v0[:, 1] - v2[:, 1]) * (cx - v2[:, 0])
            inside = ~(((d1 < 0) | (d2 < 0) | (d3 < 0)) & ((d1 > 0) | (d2 > 0) | (d3 > 0)))
            area = d1 + d2 + d3
            ok = inside & (np.abs(area) > 1e-12)
            if not ok.any():
                continue
            w0 = d2[ok] / area[ok]
            w1 = d3[ok] / area[ok]
            w2 = d1[ok] / area[ok]
            z_hits = np.sort(w0 * v0[ok, 2] + w1 * v1[ok, 2] + w2 * v2[ok, 2])
            if solid:
                for i in range(0, len(z_hits) - 1, 2):
                    za = max(0, int(np.ceil(z_hits[i] - 0.5)))
                    zb = min(dim - 1, int(np.floor(z_hits[i + 1] - 0.5)))
                    grid[x_i, y_i, za : zb + 1] = 1.0
            else:
                zi = np.clip((z_hits - 0.5).round().astype(int), 0, dim - 1)
                grid[x_i, y_i, zi] = 1.0
    return grid


def nms_native(boxes: np.ndarray, iou_thresh: float = 0.5) -> np.ndarray:
    """Greedy host NMS over (n, 5) [x0, y0, x1, y1, score] boxes -> (n,) bool
    keep mask: the native library's, or ``ops.nms.nms_indices`` where it
    cannot be built."""
    boxes = np.ascontiguousarray(boxes, np.float32)
    keep = np.zeros(len(boxes), np.uint8)
    lib = _library(None)
    if lib is None:
        from anytime3d_tpu_torch.ops.nms import nms_indices

        keep[nms_indices(boxes, iou_thresh)] = 1
        return keep.astype(bool)
    lib.nms_host(boxes.ctypes.data, len(boxes), iou_thresh, keep.ctypes.data)
    return keep.astype(bool)


def load_off(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """An OFF mesh (the ModelNet CAD format) -> (verts (V, 3) float32, tris
    (T, 3) int32); polygons are fan-triangulated."""
    with open(path) as fh:
        header = fh.readline().strip()
        if header.startswith("OFF") and len(header) > 3:
            counts = header[3:].split()  # "OFF<V> <F> <E>" on one line
        else:
            counts = fh.readline().split()
        n_v, n_f = int(counts[0]), int(counts[1])
        verts = np.array([[float(x) for x in fh.readline().split()[:3]] for _ in range(n_v)], np.float32)
        tris: List[List[int]] = []
        for _ in range(n_f):
            parts = [int(x) for x in fh.readline().split()]
            poly = parts[1 : 1 + parts[0]]
            for i in range(1, len(poly) - 1):
                tris.append([poly[0], poly[i], poly[i + 1]])
    return verts, np.array(tris, np.int32).reshape(-1, 3)
