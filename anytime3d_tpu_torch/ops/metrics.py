"""Voxel precision, recall and IoU; top-k accuracy of class logits.

Counterpart of ``anytime3d_tpu/ops/metrics.py``.
"""

from __future__ import annotations

import torch


def voxel_tp_fp_fn(target: torch.Tensor, pred: torch.Tensor,
                   threshold: float = 0.5) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-sample TP/FP/FN counts at an occupancy threshold, three (B,) float32
    tensors. ``target`` is a {0, 1} grid, ``pred`` holds probabilities; both
    are flattened per sample."""
    n = target.shape[0]
    y = target.reshape(n, -1).float()
    p = (pred.reshape(n, -1) >= threshold).float()
    return (y * p).sum(dim=-1), ((1.0 - y) * p).sum(dim=-1), (y * (1.0 - p)).sum(dim=-1)


def voxel_precision_recall(target: torch.Tensor, pred: torch.Tensor, threshold: float = 0.5,
                           eps: float = 1e-10) -> tuple[torch.Tensor, torch.Tensor]:
    """Batch-mean voxel precision and recall at ``threshold``."""
    tp, fp, fn = voxel_tp_fp_fn(target, pred, threshold)
    return (tp / (tp + fp + eps)).mean(), (tp / (tp + fn + eps)).mean()


def voxel_iou(target: torch.Tensor, pred: torch.Tensor, threshold: float = 0.5,
              eps: float = 1e-10) -> torch.Tensor:
    """Batch-mean voxel intersection-over-union at ``threshold``."""
    tp, fp, fn = voxel_tp_fp_fn(target, pred, threshold)
    return (tp / (tp + fp + fn + eps)).mean()


def top_k_stable(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries of the last axis, ties broken by the
    lower index, as ``jax.lax.top_k`` breaks them (``torch.topk`` promises no
    order among ties): the first ``k`` of a stable descending sort."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]


def topk_accuracy(logits: torch.Tensor, onehot: torch.Tensor, k: int = 1) -> torch.Tensor:
    """Batch-mean top-k accuracy against one-hot targets, a float32 scalar.
    Tied logits rank the lower index first, as ``jax.lax.top_k`` (and, for
    k = 1, ``argmax``) ranks them."""
    gt = onehot.argmax(dim=-1)
    top = top_k_stable(logits.float(), k)
    return (top == gt[:, None]).any(dim=-1).float().mean()
