"""Evaluation protocols: missing-rate sweeps, PR curves, per-class latents,
reconstruction dumps, detection metrics, and drawing detections on frames."""

from anytime3d_tpu_torch.evaluation.detection import evaluate_detector, grid_targets_to_boxes
from anytime3d_tpu_torch.evaluation.dump import dump_reconstructions
from anytime3d_tpu_torch.evaluation.protocols import category_vectors, evaluate_epoch, missing_rate_sweep, pr_curve
from anytime3d_tpu_torch.evaluation.viz import draw_bbox2d, draw_bbox3d, draw_scene

__all__ = [
    "evaluate_detector",
    "grid_targets_to_boxes",
    "missing_rate_sweep",
    "pr_curve",
    "category_vectors",
    "evaluate_epoch",
    "dump_reconstructions",
    "draw_bbox2d",
    "draw_bbox3d",
    "draw_scene",
]
