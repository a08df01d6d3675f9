"""Metric protocols of the reference evaluation scripts.

Counterpart of ``anytime3d_tpu/evaluation/protocols.py``:

- ``missing_rate_sweep``: anytime degradation at missing rates
  {0.3, 0.5, 0.7, 0.9}, uncorrected against prior-corrected;
- ``pr_curve``: precision, recall and IoU over decode thresholds, with the
  acceptance-probability tail of the reference's PR-curve notebook;
- ``category_vectors``: per-class mean latents, the eval priors of models
  without a category prior net;
- ``evaluate_epoch``: one pass at a fixed missing rate.

``batch_fn(b)`` returns a batch of numpy arrays (``cli.train.build_batch_fn``)
or tensors; it is moved to the model's device here. Each batch's draws come
from a ``torch.Generator`` on that device seeded as the JAX package seeds its
PRNG key, so a run is repeatable, though its numbers are not JAX's.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from anytime3d_tpu_torch.anytime.engine import anytime_eval
from anytime3d_tpu_torch.data.prefetch import to_device
from anytime3d_tpu_torch.models.mmvae import MultiModalVAE
from anytime3d_tpu_torch.ops.metrics import voxel_tp_fp_fn
from anytime3d_tpu_torch.train.step import materialize_batch

BatchFn = Callable[[int], Mapping]


def _device(model: MultiModalVAE) -> torch.device:
    return next(model.parameters()).device


def _mean_metrics(model: MultiModalVAE, batch_fn: BatchFn, num_batches: int, seed_of: Callable[[int], int],
                  **kwargs) -> Dict[str, float]:
    """``anytime_eval`` over ``num_batches`` batches, batch b drawing from a
    generator seeded ``seed_of(b)``; the mean of each metric."""
    device = _device(model)
    sums: Dict[str, float] = {}
    for b in range(num_batches):
        generator = torch.Generator(device=device).manual_seed(seed_of(b))
        metrics = anytime_eval(model, to_device(batch_fn(b), device), generator, **kwargs)
        for k, v in metrics.items():
            sums[k] = sums.get(k, 0.0) + float(v)
    return {k: v / num_batches for k, v in sums.items()}


def missing_rate_sweep(model: MultiModalVAE, batch_fn: BatchFn, rates: Sequence[float] = (0.3, 0.5, 0.7, 0.9),
                       num_batches: int = 8, prior_means: Optional[torch.Tensor] = None, seed: int = 0,
                       correction: str = "resample") -> Dict[float, Dict[str, float]]:
    """Metrics per missing rate, each the mean over ``num_batches`` batches;
    batch b at ``rate`` draws from seed ``seed*10000 + int(rate*100)*100 + b``.
    ``correction='mean'`` snaps the masked dims to the prior mean."""
    return {
        rate: _mean_metrics(model, batch_fn, num_batches,
                            lambda b, rate=rate: seed * 10_000 + int(rate * 100) * 100 + b,
                            missing_prob=rate, prior_means=prior_means, correction=correction)
        for rate in rates
    }


def _prf(target: torch.Tensor, pred: torch.Tensor, threshold: float) -> torch.Tensor:
    """(precision, recall, IoU), batch means at ``threshold``, as one tensor."""
    tp, fp, fn = voxel_tp_fp_fn(target, pred, threshold)
    return torch.stack([(tp / (tp + fp + 1e-10)).mean(), (tp / (tp + fn + 1e-10)).mean(),
                        (tp / (tp + fp + fn + 1e-10)).mean()])


def pr_curve(target: torch.Tensor, pred: torch.Tensor, thresholds: Optional[Sequence[float]] = None,
             acceptance_div: int = 0, seed: int = 0,
             keeps: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, np.ndarray]:
    """Precision, recall and IoU of ``pred`` (probabilities, compared in
    float32) against ``target`` at each decode threshold (default
    ``linspace(0.05, 0.95, 19)``); ``target`` and ``pred`` in one layout.

    ``acceptance_div > 0`` appends the notebook's acceptance tail: for
    ``i in [0, acceptance_div)`` only voxels with ``pred >= 1.0`` count, each
    kept with probability ``accept_prob = 0.1**i`` (a Bernoulli mask from a
    generator seeded ``seed*1000 + i``, or ``keeps[i]``). Returns float32
    arrays ``threshold``, ``accept_prob`` (NaN on the threshold rows; the tail
    rows have threshold 1.0), ``precision``, ``recall`` and ``iou``. One
    device-to-host copy for the whole curve."""
    if thresholds is None:
        thresholds = np.linspace(0.05, 0.95, 19)
    thr = np.asarray(thresholds, np.float32)
    pred = pred.float()
    rows = [_prf(target, pred, float(t)) for t in thr]
    accept = [np.nan] * len(thr)
    for i in range(acceptance_div):
        accept_prob = 0.1**i
        if keeps is not None:
            keep = keeps[i].to(pred.device).bool()
        else:
            gen = torch.Generator(device=pred.device).manual_seed(seed * 1000 + i)
            keep = torch.rand(pred.shape, generator=gen, device=pred.device) < accept_prob
        rows.append(_prf(target, torch.where(keep, pred, torch.zeros_like(pred)), 1.0))
        accept.append(accept_prob)
    p, r, iou = torch.stack(rows).cpu().numpy().T
    return {
        "threshold": np.concatenate([thr, np.ones(acceptance_div, np.float32)]),
        "accept_prob": np.asarray(accept, np.float32),
        "precision": p.astype(np.float32),
        "recall": r.astype(np.float32),
        "iou": iou.astype(np.float32),
    }


def category_vectors(model: MultiModalVAE, batch_fn: BatchFn, num_classes: int,
                     num_batches: int = 16) -> np.ndarray:
    """Per-class mean of the posterior means: (num_classes, z_dim) float32,
    the external priors of models without a category prior net. Classes
    never seen stay at zero."""
    device = _device(model)
    sums, counts = None, np.zeros(num_classes)
    was_training = model.training
    model.eval()
    try:
        for b in range(num_batches):
            batch = to_device(batch_fn(b), device)
            with torch.no_grad():
                x, blocked_in, _ = materialize_batch(model, batch)
                z = model.encode(x["input"], blocked_input=blocked_in).mean.float().cpu().numpy()
            labels = batch["category_onehot"].argmax(dim=-1).cpu().numpy()
            if sums is None:
                sums = np.zeros((num_classes, z.shape[-1]), np.float64)
            np.add.at(sums, labels, z)
            np.add.at(counts, labels, 1)
    finally:
        model.train(was_training)
    return (sums / np.maximum(counts, 1)[:, None]).astype(np.float32)


def evaluate_epoch(model: MultiModalVAE, batch_fn: BatchFn, num_batches: int, missing_prob: float = 0.0,
                   prior_means: Optional[torch.Tensor] = None, seed: int = 0,
                   correction: str = "resample") -> Dict[str, float]:
    """Mean loss, P, R and accuracy over ``num_batches`` batches at one
    missing rate (with the corrected set when masking); batch b draws from
    seed ``seed + b``."""
    return _mean_metrics(model, batch_fn, num_batches, lambda b: seed + b, missing_prob=missing_prob,
                         prior_means=prior_means, correction=correction)
