"""Loss and train step of classifier pretraining (the backbone pretrainer).

Counterpart of ``anytime3d_tpu/train/classifier_step.py``: softmax
cross-entropy on the float32 logits with optional label smoothing, the
kernel L2, and top-1 / top-5 accuracy; the update is the guarded Adam step
of the voxel models (``train/step.py::apply_gradients_if_finite``). With a
``mesh`` the means are over the global batch whose rows this rank holds,
and the gradients are all-reduced in float32 (``train/step.py``'s doc).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch

from anytime3d_tpu_torch.models.classifier import Classifier
from anytime3d_tpu_torch.ops.losses import softmax_cross_entropy
from anytime3d_tpu_torch.ops.metrics import topk_accuracy
from anytime3d_tpu_torch.parallel.mesh import all_reduce_grads, global_mean, rank_share, reduce_metrics
from anytime3d_tpu_torch.train.state import TrainState, l2_penalty
from anytime3d_tpu_torch.train.step import apply_gradients_if_finite


@dataclasses.dataclass(frozen=True)
class ClassifierLossConfig:
    l2_weight: float = 5e-4
    label_smoothing: float = 0.0


def classifier_losses(model: Classifier, cfg: ClassifierLossConfig, batch: Mapping[str, torch.Tensor],
                      mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss_total, metrics) of ``batch`` (``images`` (B, H, W, 3), ``labels``
    (B, K) one-hot): ``loss_ce``, ``loss_total``, ``top1`` and ``top5``
    (top-min(5, K)), every metric a float32 scalar; with a ``mesh``, this
    rank's share of the global batch's loss and the global metrics."""
    logits = model(batch["images"]).float()
    onehot = batch["labels"].float()
    if cfg.label_smoothing > 0:
        onehot = onehot * (1.0 - cfg.label_smoothing) + cfg.label_smoothing / onehot.shape[-1]
    ce = global_mean(softmax_cross_entropy(logits, onehot), mesh)
    total = ce + rank_share(l2_penalty(dict(model.named_parameters()), cfg.l2_weight), mesh)
    with torch.no_grad():
        metrics = {
            "loss_ce": ce.detach(),
            "loss_total": total.detach(),
            # this shard's accuracies, shares of the global batch's
            "top1": rank_share(topk_accuracy(logits, batch["labels"], k=1), mesh),
            "top5": rank_share(topk_accuracy(logits, batch["labels"], k=min(5, logits.shape[-1])), mesh),
        }
    return total, reduce_metrics(metrics, mesh)


def classifier_loss_and_grads(model: Classifier, cfg: ClassifierLossConfig, batch: Mapping[str, torch.Tensor],
                              mesh=None):
    """(gradients by parameter name, metrics); with a ``mesh``, all-reduced in float32."""
    total, metrics = classifier_losses(model, cfg, batch, mesh)
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(total, params)))
    if mesh is not None:
        grads = all_reduce_grads(grads, mesh)
    return grads, metrics


def make_classifier_train_step(model: Classifier, cfg: ClassifierLossConfig = ClassifierLossConfig(), mesh=None):
    """``step(state, batch, generator=None) -> (state, metrics)``; the state is
    updated in place. The step draws nothing: ``generator`` is the trainer's
    and goes unused. With a ``mesh``, the step of the global batch whose rows
    ``batch`` holds."""

    def step(state: TrainState, batch: Mapping[str, torch.Tensor], generator: Optional[torch.Generator] = None):
        grads, metrics = classifier_loss_and_grads(model, cfg, batch, mesh)
        return apply_gradients_if_finite(state, grads, metrics)

    return step


def make_classifier_eval_step(model: Classifier, cfg: ClassifierLossConfig = ClassifierLossConfig(), mesh=None):
    """``eval(batch, generator=None) -> metrics``, no gradient."""

    def step(batch: Mapping[str, torch.Tensor], generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            return classifier_losses(model, cfg, batch, mesh)[1]

    return step
