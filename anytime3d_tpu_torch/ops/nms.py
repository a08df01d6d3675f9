"""Fixed-size greedy non-maximum suppression on the device.

Counterpart of ``anytime3d_tpu/ops/nms.py``. The box set has a static size
K, the loop over it is unrolled in Python and every step is a tensor op on
the boxes' device, so no step waits for the host. The greedy order is a
stable descending sort, as ``jnp.argsort`` is stable: tied scores keep their
slot order.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch


def box_iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of boxes laid out [x_min, y_min, x_max, y_max, ...], (N, N).

    The reference's area convention: no +1 pixel correction, and negative
    extents give negative areas, as the NumPy code computes them."""
    x_min, y_min, x_max, y_max = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = (y_max - y_min) * (x_max - x_min)
    w = (torch.minimum(x_max[:, None], x_max[None, :]) - torch.maximum(x_min[:, None], x_min[None, :])).clamp_min(0.0)
    h = (torch.minimum(y_max[:, None], y_max[None, :]) - torch.maximum(y_min[:, None], y_min[None, :])).clamp_min(0.0)
    inter = w * h
    union = area[:, None] + area[None, :] - inter
    return inter / (union + 1e-12)


def nms(boxes: torch.Tensor, iou_threshold: float = 0.5, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy NMS over a fixed-size box set; returns the (N,) keep mask.

    ``boxes``: (N, 5+) [x_min, y_min, x_max, y_max, score]; ``valid``: (N,)
    bool, padding slots marked False never win. A box is kept iff it is valid
    and no kept box before it in descending score order overlaps it above
    ``iou_threshold``. The walk runs in sorted order: step i reads the i-th
    box's row of the IoU matrix, so every index is a Python int."""
    n = boxes.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=boxes.device)
    scores = torch.where(valid, boxes[:, 4], torch.full_like(boxes[:, 4], float("-inf")))
    order = torch.sort(scores, descending=True, stable=True).indices
    iou = box_iou_matrix(boxes)[order][:, order]  # the matrix in greedy order
    overlaps = iou > iou_threshold
    overlaps &= ~torch.eye(n, dtype=torch.bool, device=boxes.device)  # a box never suppresses itself
    valid_sorted = valid[order]
    kept = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    suppressed = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    for i in range(n):
        is_kept = valid_sorted[i] & ~suppressed[i]
        kept[i] = is_kept
        suppressed |= overlaps[i] & is_kept
    return torch.zeros_like(kept).scatter_(0, order, kept)


def nms_indices(boxes_np, iou_threshold: float = 0.5) -> List[int]:
    """Host convenience: the indices of the kept boxes, by score, highest first."""
    boxes_np = np.asarray(boxes_np)
    if len(boxes_np) == 0:
        return []
    keep = nms(torch.from_numpy(np.asarray(boxes_np, np.float32)), iou_threshold).numpy()
    idx = np.nonzero(keep)[0]
    return list(idx[np.argsort(-boxes_np[idx, 4])])
