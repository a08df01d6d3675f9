"""Multi-object detection evaluation: box precision and recall, VOC AP at one
IoU threshold, and the orientation error of matched pairs.

Counterpart of ``anytime3d_tpu/evaluation/detection.py``: host NumPy around
the per-frame ``DetectorReconstructor.detect`` on the model's device.
Predicted boxes are matched greedily, highest score first, to the ground
truth decoded from the grid targets, each ground-truth box taken once.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import numpy as np
import torch

from anytime3d_tpu_torch.models.detector import DetectorReconstructor


def grid_targets_to_boxes(objness: np.ndarray, bbox: np.ndarray):
    """(gh, gw, P, .) grid targets -> normalized [x0, y0, x1, y1] boxes (N, 4)
    and their (row, col, predictor) cells (N, 3): the inverse of
    ``data.pascal3d.build_grid_targets``, whose box layout is (h, w, x, y)
    with (x, y) relative to the cell."""
    gh, gw, p = objness.shape[:3]
    out, idx = [], []
    for r in range(gh):
        for c in range(gw):
            for k in range(p):
                if objness[r, c, k, 0] <= 0.5:
                    continue
                h, w, x, y = bbox[r, c, k]
                cx, cy = (c + x) / gw, (r + y) / gh
                out.append([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2])
                idx.append([r, c, k])
    return np.asarray(out, np.float32).reshape(-1, 4), np.asarray(idx, np.int32).reshape(-1, 3)


def _iou(a: np.ndarray, b: np.ndarray) -> float:
    x0, y0 = max(a[0], b[0]), max(a[1], b[1])
    x1, y1 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, x1 - x0) * max(0.0, y1 - y0)
    area = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / area if area > 0 else 0.0


def average_precision(detections, gt_count: int, iou_thresh: float = 0.5) -> float:
    """VOC AP (all points) from ``detections``, (score, is_tp) pairs over the
    whole set, and ``gt_count`` ground-truth boxes: the precision envelope
    integrated over the recall steps."""
    if gt_count == 0 or not detections:
        return 0.0
    order = np.argsort([-s for s, _ in detections], kind="stable")
    tp_cum = fp_cum = 0
    precisions, recalls = [], []
    for i in order:
        if detections[i][1]:
            tp_cum += 1
        else:
            fp_cum += 1
        precisions.append(tp_cum / (tp_cum + fp_cum))
        recalls.append(tp_cum / gt_count)
    prec, rec = np.asarray(precisions), np.asarray(recalls)
    for i in range(len(prec) - 2, -1, -1):
        prec[i] = max(prec[i], prec[i + 1])
    ap, prev_r = 0.0, 0.0
    for p, r in zip(prec, rec):
        ap += p * (r - prev_r)
        prev_r = r
    return float(ap)


def _gt_record(image: np.ndarray, gt_boxes: np.ndarray, g: int) -> Dict[str, float]:
    """A ground-truth box's normalized area, its largest IoU with another
    ground-truth box of the image, and the mean brightness inside it."""
    x0, y0, x1, y1 = gt_boxes[g]
    h_px, w_px = image.shape[:2]
    c0, c1 = int(max(x0, 0) * w_px), int(min(x1, 1) * w_px)
    r0, r1 = int(max(y0, 0) * h_px), int(min(y1, 1) * h_px)
    crop = image[r0:max(r1, r0 + 1), c0:max(c1, c0 + 1)]
    overlap = max((_iou(gt_boxes[g], gt_boxes[o]) for o in range(len(gt_boxes)) if o != g), default=0.0)
    return {
        "area": float(max(x1 - x0, 0) * max(y1 - y0, 0)),
        "max_gt_overlap": float(overlap),
        "brightness": float(crop.mean()) if crop.size else 0.0,
    }


def evaluate_detector(model: DetectorReconstructor, batch_fn: Callable[[int], Mapping], num_batches: int = 8,
                      obj_thresh: float = 0.5, iou_thresh: float = 0.5, top_1_per_cell: bool = True,
                      collect_diagnostics: bool = False) -> Dict[str, float]:
    """Detection precision and recall at ``iou_thresh``, ``map50`` and the
    matched orientation MAE over ``num_batches`` batches of ``batch_fn``
    (collated multi-object batches, ``data/collate.py``: float images and
    grid targets, as numpy arrays or tensors), one frame at a time.
    ``collect_diagnostics`` adds ``fn_records`` and ``tp_records``: each
    ground-truth box's area, crowding and brightness, split by missed and
    found."""
    device = next(model.parameters()).device

    def detect(image: np.ndarray) -> Dict[str, np.ndarray]:
        with torch.inference_mode():
            det = model.detect(torch.as_tensor(image).to(device), obj_thresh, iou_thresh, top_1_per_cell)
        return {k: (v.float() if v.is_floating_point() else v).cpu().numpy() for k, v in det.items()}

    tp = fp = fn_ = 0
    ori_err, n_matched = 0.0, 0
    scored: list = []  # (score, is_tp) over the whole set, for the AP
    fn_records: list = []
    tp_records: list = []
    for b in range(num_batches):
        batch = {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in batch_fn(b).items()}
        images = batch["images"]
        for i in range(images.shape[0]):
            det = detect(images[i : i + 1])
            valid = det["valid"]
            boxes, sin_p, cos_p = det["bbox2d"][valid], det["ori_sin"][valid], det["ori_cos"][valid]
            order = np.argsort(-boxes[:, 4]) if len(boxes) else []
            gt_boxes, gt_idx = grid_targets_to_boxes(batch["objness"][i], batch["bbox"][i])
            taken = np.zeros(len(gt_boxes), bool)
            for j in order:
                best, best_iou = -1, iou_thresh
                for g in range(len(gt_boxes)):
                    if taken[g]:
                        continue
                    iou = _iou(boxes[j, :4], gt_boxes[g])
                    if iou >= best_iou:
                        best, best_iou = g, iou
                if best >= 0:
                    taken[best] = True
                    tp += 1
                    scored.append((float(boxes[j, 4]), True))
                    r, c, k = gt_idx[best]
                    ang = np.arctan2(sin_p[j], cos_p[j]) - np.arctan2(batch["sin"][i][r, c, k], batch["cos"][i][r, c, k])
                    ori_err += float(np.abs(np.arctan2(np.sin(ang), np.cos(ang))).mean())
                    n_matched += 1
                else:
                    fp += 1
                    scored.append((float(boxes[j, 4]), False))
            fn_ += int((~taken).sum())
            if collect_diagnostics:
                for g in range(len(gt_boxes)):
                    (tp_records if taken[g] else fn_records).append(_gt_record(images[i], gt_boxes, g))
    out = {
        "det_precision": tp / max(tp + fp, 1),
        "det_recall": tp / max(tp + fn_, 1),
        "map50": average_precision(scored, gt_count=tp + fn_, iou_thresh=iou_thresh),
        "ori_mae_rad": ori_err / max(n_matched, 1),
        "num_tp": float(tp),
        "num_fp": float(fp),
        "num_fn": float(fn_),
    }
    if collect_diagnostics:
        out["fn_records"] = fn_records
        out["tp_records"] = tp_records
    return out
