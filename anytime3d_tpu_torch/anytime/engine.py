"""The anytime observation protocol, prior correction, and Gaussian fusion.

Counterpart of ``anytime3d_tpu/anytime/engine.py`` (the reference's getEval
loop):

1. encode an observation into a Gaussian latent posterior;
2. simulate partial observation by masking each latent dim with probability
   ``missing_prob``, filling masked dims with the mean of the class-prior means;
3. classify by nearest prior mean; decode -> the uncorrected reconstruction;
4. correct: re-classify with the distance over observed dims only, replace
   masked dims with draws from the nearest class prior, decode again.

Random draws come from an explicit ``torch.Generator`` on the model's device,
or are handed in (``draws``, ``eps``), so a test can give both packages the
same numbers. ``anytime_eval_jit`` has no counterpart: eager PyTorch needs no
compiled wrapper, and every rate of a sweep runs the same code.
``fuse_sequence_sharded`` splits a stream of observations over the ranks of
a mesh (``parallel.make_mesh``) and sums their information with one
all-reduce.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch

from anytime3d_tpu_torch.models.mmvae import MultiModalVAE
from anytime3d_tpu_torch.nn.blocks import depth_to_space3d
from anytime3d_tpu_torch.ops.losses import focal_binary_loss
from anytime3d_tpu_torch.ops.metrics import voxel_tp_fp_fn
from anytime3d_tpu_torch.ops.sampling import mask_latent, reparameterize
from anytime3d_tpu_torch.train.step import materialize_batch

# --------------------------------------------------------------------------
# classification + correction primitives
# --------------------------------------------------------------------------


def _prior_distance(z: torch.Tensor, prior_means: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, K) squared distances of each z to each prior mean, over the dims ``mask`` keeps."""
    d2 = (z[:, None, :] - prior_means[None, :, :]).square()  # (B, K, D)
    if mask is not None:
        d2 = d2 * mask[:, None, :]
    return d2.sum(dim=-1)


def classify_by_prior(z: torch.Tensor, prior_means: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """argmin_k sum_d [mask_d *] (z_d - mu_kd)^2 -> (B,) class indices.

    ``mask`` (B, D) restricts the distance to observed dims. Ties go to the
    lowest index, as with ``jnp.argmin``."""
    return _prior_distance(z, prior_means, mask).argmin(dim=-1)


def correct_latent(z: torch.Tensor, mask: torch.Tensor, prior_means: torch.Tensor,
                   prior_log_vars: Optional[torch.Tensor] = None, mode: str = "resample",
                   gate_margin: float = 0.2, generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Replace the missing dims (``mask`` 0) with the nearest class prior,
    nearest under the distance over observed dims.

    ``mode='resample'`` draws them from N(mu_k, exp(lv_k)) (``prior_log_vars``
    default 0; the normal draw is ``eps`` when given, else from
    ``generator``); ``'mean'`` snaps them to mu_k. A ``_gated`` suffix
    corrects only samples whose nearest-prior decision is confident: the
    relative margin (d2 - d1) / (d2 + 1e-9) between the two nearest priors
    exceeds ``gate_margin``; the others keep ``z``."""
    gated = mode.endswith("_gated")
    base = mode[: -len("_gated")] if gated else mode
    if base not in ("resample", "mean"):
        raise ValueError(f"unknown correction mode {mode!r}")
    dist = _prior_distance(z, prior_means, mask)  # (B, K)
    nearest = dist.argmin(dim=-1)
    mu = prior_means[nearest]
    if base == "resample":
        lv = prior_log_vars[nearest] if prior_log_vars is not None else torch.zeros_like(mu)
        fill = reparameterize(mu, lv, generator, eps)
    else:
        fill = mu
    corrected = torch.where(mask > 0, z, fill)
    if not gated:
        return corrected
    top2 = -torch.topk(-dist, 2, dim=-1).values  # the two smallest distances, ascending
    margin = (top2[:, 1] - top2[:, 0]) / (top2[:, 1] + 1e-9)
    return torch.where((margin > gate_margin)[:, None], corrected, z)


# --------------------------------------------------------------------------
# full anytime evaluation protocol
# --------------------------------------------------------------------------


def category_prior_means(model: MultiModalVAE, dtype: torch.dtype) -> torch.Tensor:
    """(K, z_cat_dim) class anchors: the category prior net over all K
    one-hots, in eval mode (no dropout)."""
    cfg = model.config
    if cfg.prior_category is None:
        raise ValueError("prior_means required for models without a category priornet")
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    try:
        eye = torch.eye(cfg.prior_category.input_dim, dtype=dtype, device=device)
        return model.priors_category(eye)[0]
    finally:
        model.train(was_training)


def _shape_metrics(pred: torch.Tensor, target: torch.Tensor, gamma: float) -> Dict[str, torch.Tensor]:
    """Focal loss, precision and recall of a decode, in float32."""
    pred, target = pred.float(), target.float()
    tp, fp, fn = voxel_tp_fp_fn(target, pred)
    return {
        "loss_shape": focal_binary_loss(pred, target, gamma=gamma).mean(),
        "precision": (tp / (tp + fp + 1e-10)).mean(),
        "recall": (tp / (tp + fn + 1e-10)).mean(),
    }


def anytime_eval(model: MultiModalVAE, batch: Mapping[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None, missing_prob: float = 0.0,
                 prior_means: Optional[torch.Tensor] = None, correction: str = "resample",
                 gamma: float = 0.6, return_pred: bool = False,
                 draws: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """Run the anytime protocol on one batch; returns scalar metrics on the
    model's device.

    ``batch`` is any form the train step takes (voxel ``input``,
    ``input_packed``, ``input_packed_blocked``; images with a voxel
    ``target``, ``target_packed`` or ``target_packed_blocked``; see
    ``train.step.materialize_batch``), with ``category_onehot`` for the
    accuracies and, for a dual-latent model with an instance prior,
    ``inst_onehot`` for ``acc_inst``. Encode and decode run in the blocked
    layout when the model has it: every metric is a sum of elementwise terms
    and does not depend on the layout.

    Only the category block is masked and corrected. A dual-latent model's
    instance block is sampled and appended to it before each decode, and
    ``acc_inst`` is the share of samples whose nearest instance prior mean,
    over every instance under the sample's category (prior net in eval
    mode), is its own instance.

    ``prior_means`` (K, z_cat_dim): class anchors; None takes them from the
    category prior net (:func:`category_prior_means`), which a model without
    one lacks (``ValueError``): pass it the per-class mean latents of
    ``evaluation.protocols.category_vectors``. An AE model's latent is its
    encoder's output, with no draw. Outputs: ``loss_shape``,
    ``precision``, ``recall``, ``acc_category`` (and ``acc_inst``), and with
    ``missing_prob > 0`` the same but ``acc_inst`` with a ``_corrected``
    suffix. ``return_pred`` adds the decoded grids ``pred`` (and
    ``pred_corrected``) in the dense (B, D, H, W, C) layout.

    Draws, in order, from ``generator`` unless given in ``draws``: ``eps_cat``
    (the category block's posterior sample), ``keep`` (the observation mask,
    true where observed), ``eps_inst`` (the instance block's sample) and
    ``eps_corr`` (the correction's prior sample)."""
    mcfg = model.config
    draws = draws or {}
    masked = missing_prob > 0.0
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            b, blocked_in, blocked_out = materialize_batch(model, batch)
            enc = model.encode(b["input"], blocked_input=blocked_in)
            inst = None
            if enc.mean_category is not None:
                mean, log_var = enc.mean_category, enc.log_var_category
                if mcfg.z_inst_dim > 0:
                    inst = (enc.mean_inst, enc.log_var_inst)
            else:  # single-latent models carry the latent in the inst slot
                mean, log_var = enc.mean_inst, enc.log_var_inst
            if prior_means is None:
                prior_means = category_prior_means(model, mean.dtype)
            prior_means = prior_means.to(mean.device)

            z = _sample(mean, log_var, generator, draws.get("eps_cat"))
            if masked:
                # missing dims <- the mean of the prior means
                z, mask = mask_latent(z, missing_prob, prior_means.mean(dim=0), generator, draws.get("keep"))
            onehot = batch.get("category_onehot")
            gt = onehot.argmax(dim=-1) if onehot is not None else None
            metrics: Dict[str, torch.Tensor] = {}

            z_inst = None
            if inst is not None:
                z_inst = _sample(*inst, generator, draws.get("eps_inst"))
                if mcfg.prior_inst is not None and onehot is not None and "inst_onehot" in batch:
                    metrics["acc_inst"] = _instance_accuracy(model, z_inst, onehot, batch["inst_onehot"])

            def decode_and_score(z_: torch.Tensor, suffix: str) -> None:
                if gt is not None:  # nearest prior mean over every dim, the filled ones included
                    hit = classify_by_prior(z_, prior_means) == gt
                    metrics[f"acc_category{suffix}"] = hit.float().mean()
                if z_inst is not None:
                    z_ = torch.cat([z_, z_inst], dim=-1)
                pred = model.decode(z_, blocked_output=blocked_out)
                metrics.update({f"{k}{suffix}": v for k, v in _shape_metrics(pred, b["target"], gamma).items()})
                if return_pred:
                    dense = depth_to_space3d(pred, model.decoder_block) if blocked_out else pred
                    metrics[f"pred{suffix}"] = dense

            decode_and_score(z, "")
            if masked:
                z_corr = correct_latent(z, mask, prior_means, mode=correction, generator=generator,
                                        eps=draws.get("eps_corr"))
                decode_and_score(z_corr, "_corrected")
            return metrics
    finally:
        model.train(was_training)


def _sample(mean: torch.Tensor, log_var: Optional[torch.Tensor], generator: Optional[torch.Generator],
            eps: Optional[torch.Tensor]) -> torch.Tensor:
    """A posterior sample, or the mean itself for an AE model (no log-var)."""
    return mean if log_var is None else reparameterize(mean, log_var, generator, eps)


def _instance_accuracy(model: MultiModalVAE, z_inst: torch.Tensor, category_onehot: torch.Tensor,
                       inst_onehot: torch.Tensor) -> torch.Tensor:
    """Share of samples whose nearest instance prior mean, over every
    instance under the sample's own category, is its instance."""
    b, n = z_inst.shape[0], model.config.inst_dim
    cat_rep = category_onehot.repeat_interleave(n, dim=0)
    inst_rep = torch.eye(n, dtype=category_onehot.dtype, device=z_inst.device).repeat(b, 1)
    means = model.priors_inst(torch.cat([cat_rep, inst_rep], dim=-1))[0].reshape(b, n, -1)
    nearest = (z_inst[:, None, :] - means).square().sum(dim=-1).argmin(dim=-1)
    return (nearest == inst_onehot.argmax(dim=-1)).float().mean()


# --------------------------------------------------------------------------
# recursive Gaussian latent fusion (the mapping backend primitive)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class GaussianBelief:
    """Diagonal-Gaussian belief over a latent, in information form:
    ``precision`` = 1/var summed over observations, ``info`` = mean * precision.
    ``from_moments``, ``mean`` and ``log_var`` convert to and from moment form."""

    info: torch.Tensor  # (D,) or (B, D)
    precision: torch.Tensor  # same shape

    @classmethod
    def from_moments(cls, mean: torch.Tensor, log_var: torch.Tensor) -> "GaussianBelief":
        prec = torch.exp(-log_var)
        return cls(info=mean * prec, precision=prec)

    @classmethod
    def uninformative(cls, shape, eps: float = 1e-6, device="cuda") -> "GaussianBelief":
        return cls(info=torch.zeros(shape, device=device), precision=torch.full(shape, eps, device=device))

    @property
    def mean(self) -> torch.Tensor:
        return self.info / self.precision

    @property
    def log_var(self) -> torch.Tensor:
        return -torch.log(self.precision)


@dataclasses.dataclass
class OccupancyBelief:
    """Log-odds fusion of decoded occupancy grids (a product of experts over
    views): the running sum of per-view logit(p) and the number of votes,
    a scalar or, under visibility masks, per voxel. The sum is associative and
    order-free, and thresholding the mean log-odds at 0.5 is per-voxel
    majority over the views."""

    log_odds: torch.Tensor
    count: torch.Tensor

    @classmethod
    def empty(cls, shape, dtype: torch.dtype = torch.float32, device="cuda") -> "OccupancyBelief":
        return cls(log_odds=torch.zeros(shape, dtype=dtype, device=device),
                   count=torch.zeros((), dtype=dtype, device=device))

    @property
    def probs(self) -> torch.Tensor:
        """Fused occupancy: the sigmoid of the mean log-odds."""
        return torch.sigmoid(self.log_odds / torch.clamp(self.count, min=1.0))


def fuse_occupancy(belief: OccupancyBelief, probs: torch.Tensor, mask: Optional[torch.Tensor] = None,
                   epsilon: float = 1e-6) -> OccupancyBelief:
    """Add one decoded occupancy grid (probabilities) to the belief.

    ``mask`` (same shape, 1 where this observation sees the voxel): only seen
    voxels vote, ``count`` becomes per voxel, and unseen voxels stay at the
    0.5 prior."""
    p = probs.float().clamp(epsilon, 1.0 - epsilon)
    vote = torch.log(p) - torch.log1p(-p)
    if mask is not None:
        m = mask.float()
        return OccupancyBelief(log_odds=belief.log_odds + m * vote, count=belief.count + m)
    return OccupancyBelief(log_odds=belief.log_odds + vote, count=belief.count + 1.0)


def fuse_observation(belief: GaussianBelief, mean: torch.Tensor, log_var: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> GaussianBelief:
    """Information-filter update: add an observation's precision where it is
    observed (``mask`` 1; None observes every dim). Unobserved dims keep their
    prior."""
    prec_obs = torch.exp(-log_var)
    if mask is not None:
        prec_obs = prec_obs * mask
    return GaussianBelief(info=belief.info + mean * prec_obs, precision=belief.precision + prec_obs)


def fuse_sequence(means: torch.Tensor, log_vars: torch.Tensor, masks: Optional[torch.Tensor] = None,
                  prior: Optional[GaussianBelief] = None) -> GaussianBelief:
    """Fuse a (T, ...) sequence of observations in order; returns the final belief."""
    if prior is None:
        prior = GaussianBelief.uninformative(means.shape[1:], device=means.device)
    belief = prior
    for t in range(means.shape[0]):
        belief = fuse_observation(belief, means[t], log_vars[t], None if masks is None else masks[t])
    return belief


def fuse_sequence_sharded(mesh, means: torch.Tensor, log_vars: torch.Tensor, masks: Optional[torch.Tensor] = None,
                          prior: Optional[GaussianBelief] = None, axis: str = "data") -> GaussianBelief:
    """``fuse_sequence`` with the (T, ...) stream split over the ``axis``
    ranks of ``mesh``: every rank holds the whole stream and fuses its
    contiguous T/N chunk from zero information, one float32 all-reduce (SUM)
    adds the ranks' information and precision, and the prior joins once,
    after it. The fusion is a sum, so this is ``fuse_sequence`` up to the
    order of the float additions. T must divide by N."""
    import torch.distributed as dist

    n, rank = mesh.size(mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(axis)
    t = means.shape[0]
    if t % n:
        raise ValueError(f"stream length {t} % mesh axis '{axis}'={n} != 0")
    if prior is None:
        prior = GaussianBelief.uninformative(means.shape[1:], device=means.device)
    chunk = slice(rank * t // n, (rank + 1) * t // n)
    zero = torch.zeros(means.shape[1:], dtype=torch.float32, device=means.device)
    local = fuse_sequence(means[chunk], log_vars[chunk], None if masks is None else masks[chunk],
                          prior=GaussianBelief(info=zero, precision=zero))
    sums = torch.stack([local.info, local.precision]).float()
    dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return GaussianBelief(info=prior.info + sums[0], precision=prior.precision + sums[1])
