"""The detector's train step: YOLO grid losses plus the shape loss of a fixed
number of responsible cells an image.

Counterpart of ``anytime3d_tpu/train/detector_step.py``. Terms: objectness
BCE (weighted between object and empty slots), the 2-D box ((h, w) in log
space, (x, y) direct), the orientation's Gaussian NLL with the predicted
log-variance, the 3-D size in log space and the KL to given instance-prior
means (each when the batch has it), and the focal voxel loss (a per-voxel
mean) of the top-K target cells' sampled latents decoded in one decoder
call, with their voxel precision and recall. Losses run in float32 whatever
the model computes in.

The top-K cells are picked by a stable descending sort: the target mask is
0/1, so ties are the rule, and ``jax.lax.top_k`` breaks them by the lower
index. The latents' draws come from a ``torch.Generator`` or are given as
``draws["eps_z"]`` (B, K, z), the draw the JAX step makes from its key.

With a ``mesh`` (``parallel.make_mesh``) the step is the single-device step
on the global batch whose rows this rank holds: the batch-wide counts that
normalise the terms (the object count, the grid's size, the decoded cells)
are all-reduced before the division, the draws are the global batch's rows
(``train.step.sharded_draws``), the metrics are summed over the ranks and
the gradients all-reduced in float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple

import torch

from anytime3d_tpu_torch.data.packing import unpack_voxels
from anytime3d_tpu_torch.models.detector import DetectorReconstructor
from anytime3d_tpu_torch.ops.losses import focal_binary_loss, gaussian_kl
from anytime3d_tpu_torch.ops.metrics import top_k_stable, voxel_tp_fp_fn
from anytime3d_tpu_torch.ops.sampling import reparameterize
from anytime3d_tpu_torch.parallel.mesh import (
    all_reduce_grads,
    all_reduce_sum,
    data_rank_and_size,
    rank_share,
    reduce_metrics,
)
from anytime3d_tpu_torch.train.state import TrainState, l2_penalty
from anytime3d_tpu_torch.train.step import apply_gradients_if_finite, sharded_draws

Batch = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DetectorLossConfig:
    """Field for field the JAX package's."""

    lambda_obj: float = 1.0
    lambda_noobj: float = 0.5
    lambda_bbox: float = 5.0
    lambda_ori: float = 1.0
    lambda_bbox3d: float = 1.0
    lambda_shape: float = 1.0
    lambda_kl: float = 0.1
    gamma: float = 0.6
    l2_weight: float = 5e-4
    shape_decode_per_image: int = 4  # objects decoded per image and step


def materialize_detector_batch(model: DetectorReconstructor, batch: Batch) -> Dict[str, torch.Tensor]:
    """The transfer forms on the device: ``voxels_packed`` (B, S, N/8) uint8
    becomes ``voxels`` (B, S, D, H, W, 1) float32 (the grid is the decoder's),
    uint8 ``images`` become float32 / 255."""
    out = dict(batch)
    if "voxels_packed" in out:
        grid = model.config.decoder.output_shape
        pk = out.pop("voxels_packed")
        out["voxels"] = unpack_voxels(pk.reshape(-1, pk.shape[-1]), grid).reshape(pk.shape[0], pk.shape[1], *grid)
    if out["images"].dtype == torch.uint8:
        out["images"] = out["images"].float() / 255.0
    return out


def detector_losses(model: DetectorReconstructor, cfg: DetectorLossConfig, batch: Batch,
                    generator: Optional[torch.Generator] = None,
                    draws: Optional[Mapping[str, torch.Tensor]] = None,
                    mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns ``(total, metrics)``. Batch: ``images`` (B, H, W, 3) float or
    uint8; grid targets ``objness`` (B, gh, gw, P, 1), ``bbox`` (h, w, x, y),
    ``sin``/``cos`` (..., 3), optionally ``bbox3d`` (..., 3) and
    ``z_prior_mean`` (..., z); ``voxels`` (B, S, D, H, W, 1) or
    ``voxels_packed`` with ``voxel_slot`` (B, gh, gw, P) int indices into them
    (-1: none). The model's parameters are the ones differentiated. With a
    ``mesh``, this rank's rows of the global batch (see the module's doc)."""
    model.train()
    batch = materialize_detector_batch(model, batch)
    fields = model(batch["images"])
    mask = batch["objness"][..., 0]  # (B, gh, gw, P)
    n_obj = all_reduce_sum(mask.sum(), mesh).clamp_min(1.0)
    metrics: Dict[str, torch.Tensor] = {}

    p_obj = fields["objness"][..., 0].float().clamp(1e-6, 1 - 1e-6)
    bce = -(mask * torch.log(p_obj) + (1.0 - mask) * torch.log(1.0 - p_obj))
    w = cfg.lambda_obj * mask + cfg.lambda_noobj * (1.0 - mask)
    loss_obj = (w * bce).sum() / (mask.numel() * data_rank_and_size(mesh)[1])
    metrics["loss_obj"] = loss_obj

    bbox2d = fields["bbox2d"].float()
    pred_hw, tgt_hw = torch.log(bbox2d[..., :2].clamp_min(1e-6)), torch.log(batch["bbox"][..., :2].clamp_min(1e-6))
    se = (torch.square(pred_hw - tgt_hw) + torch.square(bbox2d[..., 2:] - batch["bbox"][..., 2:])).sum(-1)
    loss_bbox = cfg.lambda_bbox * (mask * se).sum() / n_obj
    metrics["loss_bbox"] = loss_bbox

    lv = fields["rad_log_var"].float().clamp(-6.0, 6.0)
    err = torch.square(fields["ori_sin"].float() - batch["sin"]) + torch.square(fields["ori_cos"].float() - batch["cos"])
    nll = (0.5 * torch.exp(-lv) * err + 0.5 * lv).sum(-1)
    loss_ori = cfg.lambda_ori * (mask * nll).sum() / n_obj
    metrics["loss_ori"] = loss_ori
    total = loss_obj + loss_bbox + loss_ori

    if "bbox3d" in batch:  # log space: a size error is relative
        pred3 = torch.log(fields["bbox3d"].float().clamp_min(1e-3))
        se3 = torch.square(pred3 - torch.log(batch["bbox3d"].clamp_min(1e-3))).sum(-1)
        metrics["loss_bbox3d"] = cfg.lambda_bbox3d * (mask * se3).sum() / n_obj
        total = total + metrics["loss_bbox3d"]

    if "z_prior_mean" in batch:  # unit-variance instance priors
        prior = batch["z_prior_mean"]
        kl = gaussian_kl(fields["z_mean"].float(), fields["z_log_var"].float().clamp(-10.0, 10.0), prior,
                         torch.zeros_like(prior))
        metrics["loss_kl"] = cfg.lambda_kl * (mask * kl).sum() / n_obj
        total = total + metrics["loss_kl"]

    if "voxels" in batch and cfg.shape_decode_per_image > 0:
        b, k = mask.shape[0], cfg.shape_decode_per_image
        flat_mask = mask.reshape(b, -1)
        top_idx = top_k_stable(flat_mask, k)  # (B, K) cells
        zdim = fields["z_mean"].shape[-1]
        pick = top_idx[..., None].expand(b, k, zdim)
        zm = torch.gather(fields["z_mean"].reshape(b, -1, zdim), 1, pick)
        zlv = torch.gather(fields["z_log_var"].reshape(b, -1, zdim), 1, pick)
        slot = torch.gather(batch["voxel_slot"].reshape(b, -1).long(), 1, top_idx)
        vmask = (torch.gather(flat_mask, 1, top_idx) > 0).reshape(-1).float()
        with sharded_draws(mesh):
            z = reparameterize(zm, zlv.clamp(-10.0, 10.0), generator, (draws or {}).get("eps_z")).reshape(b * k, zdim)
        pred_vox = model.decoder(z).float()
        voxels = batch["voxels"]
        tgt_vox = voxels[torch.arange(b, device=voxels.device)[:, None], slot.clamp_min(0)].reshape(
            b * k, *voxels.shape[2:])
        per = focal_binary_loss(pred_vox, tgt_vox, gamma=cfg.gamma)
        # a per-voxel mean: the per-sample voxel sum outweighs the detection terms through the shared trunk
        n_dec = all_reduce_sum(vmask.sum(), mesh).clamp_min(1.0)
        loss_shape = cfg.lambda_shape * (per * vmask).sum() / (n_dec * float(math.prod(voxels.shape[2:])))
        metrics["loss_shape"] = loss_shape
        total = total + loss_shape
        with torch.no_grad():
            tp, fp, fn = voxel_tp_fp_fn(tgt_vox, pred_vox)
            sel = vmask > 0
            zero = torch.zeros_like(tp)
            metrics["precision"] = torch.where(sel, tp / (tp + fp + 1e-10), zero).sum() / n_dec
            metrics["recall"] = torch.where(sel, tp / (tp + fn + 1e-10), zero).sum() / n_dec

    total = total + rank_share(l2_penalty(dict(model.named_parameters()), cfg.l2_weight), mesh)
    metrics["loss_total"] = total
    return total, reduce_metrics({name: v.detach() for name, v in metrics.items()}, mesh)


def detector_loss_and_grads(model: DetectorReconstructor, cfg: DetectorLossConfig, batch: Batch,
                            generator: Optional[torch.Generator] = None,
                            draws: Optional[Mapping[str, torch.Tensor]] = None, mesh=None):
    """(gradients by parameter name, metrics): zero for a parameter no term
    reaches, as JAX's are; with a ``mesh``, all-reduced in float32."""
    total, metrics = detector_losses(model, cfg, batch, generator, draws, mesh)
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(total, params, allow_unused=True, materialize_grads=True)))
    if mesh is not None:
        grads = all_reduce_grads(grads, mesh)
    return grads, metrics


def make_detector_train_step(model: DetectorReconstructor, cfg: DetectorLossConfig = DetectorLossConfig(),
                             mesh=None):
    """Build ``step(state, batch, generator=None, draws=None) -> (state,
    metrics)``: the losses, their gradients, the update zeroed whole on a
    non-finite gradient, Adam. ``state`` is updated in place; ``metrics`` are
    scalars on the device. With a ``mesh``, the step of the global batch
    whose rows ``batch`` and ``draws`` hold."""

    def step(state: TrainState, batch: Batch, generator: Optional[torch.Generator] = None,
             draws: Optional[Mapping[str, torch.Tensor]] = None):
        grads, metrics = detector_loss_and_grads(model, cfg, batch, generator, draws, mesh)
        return apply_gradients_if_finite(state, grads, metrics)

    return step
