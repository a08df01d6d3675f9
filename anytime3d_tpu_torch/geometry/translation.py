"""Object translation from its 2-D box, its 3-D size and its rotation.

Counterpart of ``anytime3d_tpu/geometry/translation.py``. Each of 128
corner-correspondence hypotheses is a 4x4 linear system whose null vector
(by SVD) is the translation; the hypothesis whose reprojected box best
overlaps the detected one wins. All hypotheses of all objects are one
batched ``torch.linalg.svd`` on the device. The null vector's sign is
arbitrary, but the result does not depend on it: it is divided by its last
entry, and the sign test reads the product of its last two.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from anytime3d_tpu_torch.geometry.projection import KITTI_PROJ, as_matrix


def _hypothesis_signs() -> np.ndarray:
    """(128, 4, 3) signs of the corner offsets (dx, dy, dz) that meet the
    (x_min, y_min, x_max, y_max) constraints, in the reference's loop order."""
    xmin_sets = [[(-1, -1, -1), (-1, -1, 1)], [(-1, 1, -1), (-1, 1, 1)]]
    xmax_sets = [[(1, 1, -1), (1, 1, 1)], [(1, -1, 1), (1, -1, -1)]]
    ymin_sets = [[(-1, -1, 1), (1, -1, 1)], [(-1, 1, 1), (1, 1, 1)]]
    ymax_sets = [[(-1, 1, -1), (1, 1, -1)], [(-1, -1, -1), (1, -1, -1)]]
    hyps = []
    for xs, xm in zip(xmin_sets + xmax_sets, xmax_sets + xmin_sets):
        for ys, ym in zip(ymin_sets, ymax_sets):
            for a in xs:
                for b in ys:
                    for c in xm:
                        for d in ym:
                            hyps.append((a, b, c, d))
    return np.asarray(hyps, dtype=np.float32)


_SIGNS = _hypothesis_signs()


def recover_translation(bbox2d: torch.Tensor, bbox3d_whl: torch.Tensor, r: torch.Tensor,
                        proj=KITTI_PROJ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Translations ``t`` (..., 3) and the best hypothesis' IoU (...).

    ``bbox2d`` (..., 4) = [x_min, y_min, x_max, y_max] in pixels;
    ``bbox3d_whl`` (..., 3) the metric (w, h, l); ``r`` (..., 3, 3) the
    rotation. An IoU < 0 means no hypothesis was valid, and ``t`` is then 0."""
    x_min, y_min, x_max, y_max = bbox2d[..., :4].unbind(-1)
    w, h, l = bbox3d_whl.unbind(-1)
    half = torch.stack([w / 2.0, l / 2.0, h / 2.0], dim=-1)  # (dx, dy, dz)
    offsets = torch.as_tensor(_SIGNS, device=half.device) * half[..., None, None, :]  # (..., 128, 4, 3)
    # M = proj @ [[I | R o], [0 0 0 1]] for each constraint's corner offset o: (..., 128, 4, 4, 4)
    ro = torch.einsum("...ij,...hkj->...hki", r, offsets)
    m = torch.zeros(*ro.shape[:-1], 4, 4, dtype=ro.dtype, device=ro.device)
    m[..., 0, 0] = m[..., 1, 1] = m[..., 2, 2] = m[..., 3, 3] = 1.0
    m[..., :3, 3] = ro
    m = torch.einsum("ij,...kjl->...kil", as_matrix(proj, ro), m)
    vals = [v[..., None, None] for v in (x_min, y_min, x_max, y_max)]
    rows = torch.stack([
        m[..., 0, 0, :] - vals[0] * m[..., 0, 2, :],
        m[..., 1, 1, :] - vals[1] * m[..., 1, 2, :],
        m[..., 2, 0, :] - vals[2] * m[..., 2, 2, :],
        m[..., 3, 1, :] - vals[3] * m[..., 3, 2, :],
    ], dim=-2)  # (..., 128, 4, 4)
    t = torch.linalg.svd(rows, full_matrices=True).Vh[..., -1, :]  # the null vector, (..., 128, 4)
    sign_ok = t[..., 3] * t[..., 2] > 0
    t = t / torch.where(t[..., 3:] == 0, torch.ones_like(t[..., 3:]), t[..., 3:])
    # reproject each constraint's corner through its own M
    p = torch.einsum("...kij,...j->...ki", m, t)  # (..., 128, 4, 4)
    uv = p[..., :2] / p[..., 2:3]
    x_min_p, y_min_p, x_max_p, y_max_p = uv[..., 0, 0], uv[..., 1, 1], uv[..., 2, 0], uv[..., 3, 1]
    x_min, y_min, x_max, y_max = (v[..., None] for v in (x_min, y_min, x_max, y_max))
    order_ok = (x_min_p < x_max_p) & (y_min_p < y_max_p)
    area_p = (x_max_p - x_min_p) * (y_max_p - y_min_p)
    area_g = (x_max - x_min) * (y_max - y_min)
    inter = (torch.minimum(x_max_p, x_max) - torch.maximum(x_min_p, x_min)) * (
        torch.minimum(y_max_p, y_max) - torch.maximum(y_min_p, y_min))
    iou = inter / (area_p + area_g - inter)
    ious = torch.where(sign_ok & order_ok & (iou < 1.0), iou, torch.full_like(iou, -1.0))
    best = torch.argmax(ious, dim=-1, keepdim=True)  # the first of tied maxima, as jnp.argmax
    best_iou = torch.gather(ious, -1, best)[..., 0]
    t_best = torch.gather(t[..., :3], -2, best[..., None].expand(*best.shape, 3))[..., 0, :]
    return torch.where(best_iou[..., None] > 0, t_best, torch.zeros_like(t_best)), best_iou
