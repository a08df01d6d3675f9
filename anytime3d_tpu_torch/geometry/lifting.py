"""Metric lifting: voxel grids to scaled point clouds, detections to poses.

Counterpart of ``anytime3d_tpu/geometry/lifting.py``. Point clouds keep a
fixed shape, (D^3, 3) with an occupancy mask, so nothing depends on the
data's shape. The lift runs in float32 on the detections' device, whatever
dtype the detector computed in (the SVD takes no bfloat16).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from anytime3d_tpu_torch.geometry.projection import (
    KITTI_PROJ,
    KITTI_PROJ_INV,
    compose_object_rotation,
    project_bbox3d_corners,
)
from anytime3d_tpu_torch.geometry.translation import recover_translation


def voxel_grid_points(dim: int = 64, device=None) -> torch.Tensor:
    """(dim^3, 3) float32 voxel index coordinates, in (i, j, k) raster order."""
    r = torch.arange(dim, dtype=torch.float32, device=device)
    ii, jj, kk = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([ii, jj, kk], dim=-1).reshape(-1, 3)


def rescale_transform_points(voxels: torch.Tensor, whl: torch.Tensor, pose: torch.Tensor,
                             threshold: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """An occupancy grid (D, D, D) -> world points (D^3, 3) and their mask.

    The occupied points are shifted to their min corner, scaled so that the
    largest coordinate maps to the largest side of the box, centred, then
    moved by the 4x4 ``pose``. Empty entries hold zeros."""
    pts = voxel_grid_points(voxels.shape[0], voxels.device)
    mask = voxels.reshape(-1) > threshold
    inf = torch.tensor(float("inf"), device=pts.device)
    mins = torch.where(mask[:, None], pts, inf).amin(dim=0)
    mins = torch.where(torch.isfinite(mins), mins, torch.zeros_like(mins))
    p = pts - mins
    top = torch.where(mask[:, None], p, -inf).amax()
    top = torch.where(torch.isfinite(top) & (top > 0), top, torch.ones_like(top))
    p = p * (whl.float().amax() / top)
    maxs = torch.where(mask[:, None], p, -inf).amax(dim=0)
    maxs = torch.where(torch.isfinite(maxs), maxs, torch.zeros_like(maxs))
    p = p - maxs / 2.0
    pose = pose.float()
    world = p @ pose[:3, :3].T + pose[:3, 3]
    return torch.where(mask[:, None], world, torch.zeros_like(world)), mask


def lift_detections(bbox2d_norm: torch.Tensor, bbox3d_whl: torch.Tensor, ori_sin: torch.Tensor,
                    ori_cos: torch.Tensor, image_size: Tuple[int, int], valid: Optional[torch.Tensor] = None,
                    proj=KITTI_PROJ, proj_inv=KITTI_PROJ_INV) -> Dict[str, torch.Tensor]:
    """Detections -> poses. ``bbox2d_norm`` (K, 5) [x0, y0, x1, y1, score]
    normalized, ``bbox3d_whl`` (K, 3), ``ori_sin``/``ori_cos`` (K, 3),
    ``image_size`` (cols, rows) of the frame in pixels.

    The rotation is the ray-corrected Euler composition at the box's center,
    the translation the best of the SVD hypotheses; ``valid`` folds in the
    reference's gates: the box clear of the left, right and bottom borders by
    a tenth of the frame, a depth beyond 0.1 and a hypothesis found."""
    bbox2d_norm, bbox3d_whl, ori_sin, ori_cos = (t.float() for t in (bbox2d_norm, bbox3d_whl, ori_sin, ori_cos))
    cols, rows = image_size
    scale = torch.tensor([cols, rows, cols, rows], dtype=torch.float32, device=bbox2d_norm.device)
    px_boxes = bbox2d_norm[:, :4] * scale
    centers = torch.stack([(px_boxes[:, 0] + px_boxes[:, 2]) / 2.0, (px_boxes[:, 1] + px_boxes[:, 3]) / 2.0], dim=-1)
    r = compose_object_rotation(ori_sin, ori_cos, centers, proj_inv=proj_inv)
    t, iou = recover_translation(px_boxes, bbox3d_whl, r, proj)
    pose = torch.zeros(r.shape[0], 4, 4, dtype=r.dtype, device=r.device)
    pose[:, :3, :3] = r
    pose[:, :3, 3] = t
    pose[:, 3, 3] = 1.0
    corners = project_bbox3d_corners(proj, r, t, bbox3d_whl)
    b = bbox2d_norm
    ok = (b[:, 0] > 1e-1) & (b[:, 2] < 1.0 - 1e-1) & (b[:, 3] < 1.0 - 1e-1) & (t[:, 2] > 1e-1) & (iou > 0)
    if valid is not None:
        ok = ok & valid
    return {
        "pose": pose,
        "translation": t,
        "rotation": r,
        "bbox2d_px": px_boxes,
        "bbox3d_corners_px": corners,
        "hypothesis_iou": iou,
        "valid": ok,
    }
