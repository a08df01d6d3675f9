"""The scene pass: one frame -> detections -> shapes -> metric poses.

Counterpart of ``anytime3d_tpu/models/pipeline.py``: ``detect``, then the
shape decode of every detection slot, then ``lift_detections``, in one
function of (model, image), every array of a fixed size K on the model's
device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from anytime3d_tpu_torch.geometry import KITTI_PROJ, KITTI_PROJ_INV, lift_detections
from anytime3d_tpu_torch.models.detector import DetectorReconstructor


def scene_reconstruction(model: DetectorReconstructor, image: torch.Tensor, image_size_px: Tuple[int, int],
                         obj_thresh: float = 0.5, iou_thresh: float = 0.5, proj=KITTI_PROJ,
                         proj_inv=KITTI_PROJ_INV, sample_shapes: bool = True,
                         generator: Optional[torch.Generator] = None,
                         eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """``image`` (1, H, W, 3) in [0, 1]; ``image_size_px`` (cols, rows) of the
    original frame. Returns (K, .) detections, ``shapes`` (K, D, H, W), world
    ``pose`` (K, 4, 4), the projected 3-D box corners, ``valid`` (the
    detection kept and lifted: clear of the borders, in front of the camera,
    a hypothesis found) and ``valid_det`` (the detection kept). With
    ``sample_shapes`` each shape averages ``shape_samples`` posterior decodes,
    drawn from ``generator`` or given as ``eps`` (K*S, z). Runs under
    ``inference_mode``."""
    with torch.inference_mode():
        det = model.detect(image, obj_thresh, iou_thresh)
        shapes = model.reconstruct(det["z_mean"], det["z_log_var"], sample_shapes, generator, eps)
        # the detector's bbox3d channels are (w, h, l)
        lifted = lift_detections(det["bbox2d"], det["bbox3d"], det["ori_sin"], det["ori_cos"],
                                 image_size=image_size_px, valid=det["valid"], proj=proj, proj_inv=proj_inv)
    out = {name: det[name] for name in ("bbox2d", "bbox3d", "ori_sin", "ori_cos", "z_mean", "z_log_var")}
    out.update(shapes=shapes, pose=lifted["pose"], bbox3d_corners_px=lifted["bbox3d_corners_px"],
               hypothesis_iou=lifted["hypothesis_iou"], valid=lifted["valid"], valid_det=det["valid"])
    return out
