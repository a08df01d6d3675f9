"""Multi-object grid targets.

Counterpart of ``anytime3d_tpu/data/pascal3d.py::build_grid_targets``, NumPy
only. The Pascal3D loaders decode and warp with ``cv2`` and are not ported
yet.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def build_grid_targets(objects: Sequence[dict], grid_size: Tuple[int, int],
                       predictors_per_cell: int) -> Dict[str, np.ndarray]:
    """YOLO grid tensors of one image from its object dicts.

    Each object: ``bbox`` (x0, y0, x1, y1) normalized, ``euler_rad`` (3,),
    ``inst_onehot`` (I,), ``voxel_index`` int, and optionally ``bbox3d_whl``
    (3,). ``grid_size`` is (cols, rows). An object lands in the cell holding
    its center, in the first free predictor slot; an object whose center is
    off the image, or whose cell is full, is dropped. Returns ``objness``
    (gr, gc, P, 1), ``bbox`` (gr, gc, P, 4) as (h, w, x, y) with (x, y)
    relative to the cell, ``sin``/``cos`` (gr, gc, P, 3), ``inst`` (gr, gc,
    P, I), ``voxel_slot`` (gr, gc, P) int32 into the image's voxel list (-1:
    empty), and ``bbox3d`` (gr, gc, P, 3) when every object has a size."""
    gc_n, gr_n = grid_size
    p = predictors_per_cell
    inst_dim = len(objects[0]["inst_onehot"]) if objects else 1
    objness = np.zeros((gr_n, gc_n, p, 1), np.float32)
    bbox = np.zeros((gr_n, gc_n, p, 4), np.float32)
    sin_t = np.zeros((gr_n, gc_n, p, 3), np.float32)
    cos_t = np.zeros((gr_n, gc_n, p, 3), np.float32)
    inst_t = np.zeros((gr_n, gc_n, p, inst_dim), np.float32)
    slot_t = np.full((gr_n, gc_n, p), -1, np.int32)
    with_b3 = bool(objects) and all("bbox3d_whl" in o for o in objects)
    b3_t = np.zeros((gr_n, gc_n, p, 3), np.float32)
    for obj in objects:
        x0, y0, x1, y1 = obj["bbox"]
        cx, cy = (x0 + x1) / 2.0, (y0 + y1) / 2.0
        if not (0.0 <= cx < 1.0 and 0.0 <= cy < 1.0):
            continue
        gc_i, gr_i = int(cx * gc_n), int(cy * gr_n)
        free = np.nonzero(objness[gr_i, gc_i, :, 0] == 0)[0]
        if len(free) == 0:
            continue
        slot = free[0]
        objness[gr_i, gc_i, slot, 0] = 1.0
        bbox[gr_i, gc_i, slot] = [y1 - y0, x1 - x0, cx * gc_n - gc_i, cy * gr_n - gr_i]
        euler = np.asarray(obj["euler_rad"], np.float32)
        sin_t[gr_i, gc_i, slot] = np.sin(euler)
        cos_t[gr_i, gc_i, slot] = np.cos(euler)
        inst_t[gr_i, gc_i, slot] = obj["inst_onehot"]
        slot_t[gr_i, gc_i, slot] = obj["voxel_index"]
        if with_b3:
            b3_t[gr_i, gc_i, slot] = obj["bbox3d_whl"]
    out = {"objness": objness, "bbox": bbox, "sin": sin_t, "cos": cos_t, "inst": inst_t, "voxel_slot": slot_t}
    if with_b3:
        out["bbox3d"] = b3_t
    return out
