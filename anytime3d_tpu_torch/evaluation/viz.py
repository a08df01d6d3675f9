"""Drawing on frames: 2-D boxes, projected 3-D boxes and a whole scene.

Counterpart of ``anytime3d_tpu/evaluation/viz.py``, drawn by ``cv2.rectangle``
and ``cv2.line`` as the JAX module draws. ``cv2`` is imported where a
function draws, so that the metric paths never need it.

``draw_bbox2d`` and ``draw_bbox3d`` draw into the caller's array when it is
already a C-contiguous array (``np.ascontiguousarray`` hands it back as it
is) and into a contiguous copy otherwise, as the JAX functions do; either
way they return the array drawn on. ``draw_scene`` takes the output of
``models.pipeline.scene_reconstruction`` as it is, tensors on any device,
and moves what it draws to the host once.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

# the box's edges as pairs of corners; a corner's index is 4*sx + 2*sy + sz of its sign bits, the order of
# geometry.project_bbox3d_corners
_EDGES = [
    (0, 1), (0, 2), (1, 3), (2, 3),  # the -x face
    (4, 5), (4, 6), (5, 7), (6, 7),  # the +x face
    (0, 4), (1, 5), (2, 6), (3, 7),  # between them
]
_CROSSES = [(0, 5), (1, 4), (2, 7), (3, 6)]  # the X marks on the front and back faces


def draw_bbox2d(image: np.ndarray, bbox_px, color=(0, 255, 0), thickness: int = 2) -> np.ndarray:
    """The box (x0, y0, x1, y1) in pixels, truncated to integers."""
    import cv2

    img = np.ascontiguousarray(image)
    cv2.rectangle(img, (int(bbox_px[0]), int(bbox_px[1])), (int(bbox_px[2]), int(bbox_px[3])), color=color,
                  thickness=thickness)
    return img


def draw_bbox3d(image: np.ndarray, corners_px, color=(255, 0, 255), cross_color=(255, 0, 0),
                thickness: int = 2) -> np.ndarray:
    """The 12 edges of a projected box, ``corners_px`` (8, 2) pixels from
    ``geometry.project_bbox3d_corners``, and the X marks of its front and
    back faces, one pixel wide."""
    import cv2

    img = np.ascontiguousarray(image)
    c = np.asarray(corners_px).astype(int)
    for a, b in _EDGES:
        cv2.line(img, tuple(c[a]), tuple(c[b]), color=color, thickness=thickness)
    for a, b in _CROSSES:
        cv2.line(img, tuple(c[a]), tuple(c[b]), color=cross_color, thickness=1)
    return img


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def draw_scene(image, scene: Mapping) -> np.ndarray:
    """A new uint8 frame from ``image`` (H, W, 3) in [0, 1] (an array or a
    tensor) with the 2-D box of every kept detection (``valid_det``, else
    ``valid``) and the 3-D box of every lifted one (``valid``)."""
    img = np.ascontiguousarray((_host(image) * 255).astype(np.uint8))
    valid = _host(scene["valid"])
    valid_det = _host(scene["valid_det"]) if "valid_det" in scene else valid
    boxes2d = _host(scene["bbox2d"])
    corners = _host(scene["bbox3d_corners_px"])
    rows, cols = img.shape[:2]
    for k in range(len(valid_det)):
        if not valid_det[k]:
            continue
        img = draw_bbox2d(img, boxes2d[k, :4] * np.array([cols, rows, cols, rows]))
        if valid[k]:
            img = draw_bbox3d(img, corners[k])
    return img
