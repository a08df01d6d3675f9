"""Batch collation for the detector's train step.

Counterpart of ``anytime3d_tpu/data/collate.py``, NumPy only: each image's
ragged voxel list is padded to a fixed number of slots and the grid targets
are stacked, so every batch has one shape.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def collate_multiobject(images: np.ndarray, targets: Dict[str, np.ndarray], voxel_lists: Sequence[np.ndarray],
                        max_slots: int = 8) -> Dict[str, np.ndarray]:
    """Pad each image's voxel list to ``max_slots`` and clamp the slot indices:
    an object whose voxel index overflows the budget keeps its grid targets
    (objectness, box, orientation) but loses its shape target (slot -1)."""
    b = len(voxel_lists)
    voxels = np.zeros((b, max_slots, *voxel_lists[0].shape[1:]), np.float32)
    slot = targets["voxel_slot"].copy()
    for i, vl in enumerate(voxel_lists):
        n = min(len(vl), max_slots)
        voxels[i, :n] = vl[:n]
        slot[i][slot[i] >= max_slots] = -1
    out = {
        "images": images.astype(np.float32),
        "objness": targets["objness"],
        "bbox": targets["bbox"],
        "sin": targets["sin"],
        "cos": targets["cos"],
        "inst": targets["inst"],
        "voxel_slot": slot,
        "voxels": voxels,
    }
    if "bbox3d" in targets:
        out["bbox3d"] = targets["bbox3d"]
    return out
