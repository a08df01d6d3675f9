"""The anytime engine as a streaming API: beliefs about an object that
sharpen as observations come in, and a shape to decode at any time.

Counterpart of ``anytime3d_tpu/anytime/reconstructor.py``::

    rec = AnytimeReconstructor(model)                  # class anchors from the prior net
    belief = rec.new_object()                          # prior-only belief
    mean, log_var = rec.encode_observation(x)          # one frame's posterior
    belief = rec.observe(belief, mean[0], log_var[0], mask)
    shape = rec.decode(belief)                         # the anytime decode
    label = rec.classify(belief)                       # nearest class anchor
    belief = rec.correct(belief)                       # the prior into unobserved dims

Beliefs are ``anytime.engine`` dataclasses of tensors, batched over any
leading axes; the fusion is the information-filter update of
``engine.fuse_observation``. Model calls run without autograd.
``observe_stream(mesh=)`` splits the stream over the ranks of a mesh
(``engine.fuse_sequence_sharded``).
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import torch

from anytime3d_tpu_torch.anytime.engine import (
    GaussianBelief,
    OccupancyBelief,
    classify_by_prior,
    fuse_observation,
    fuse_occupancy,
    fuse_sequence,
    fuse_sequence_sharded,
)
from anytime3d_tpu_torch.models.mmvae import MultiModalVAE
from anytime3d_tpu_torch.ops.sampling import reparameterize


class AnytimeReconstructor:
    """``params``: a ``state_dict`` loaded into ``model`` (strict), or None
    to use its weights as they are. ``prior_means`` (K, D) are the class
    anchors of ``classify`` and ``correct``; None takes them from the
    category prior net over the K one-hots in eval mode, as ``anytime_eval``
    does, and its log-variances in place of ``prior_log_vars``. A model without a
    category prior needs them given (``evaluation.protocols.category_vectors``)."""

    def __init__(self, model: MultiModalVAE, params: Optional[Mapping[str, torch.Tensor]] = None,
                 prior_means: Optional[torch.Tensor] = None, prior_log_vars: Optional[torch.Tensor] = None):
        self.model = model
        if params is not None:
            model.load_state_dict(params)
        self.device = next(model.parameters()).device
        if prior_means is None:
            prior_means, prior_log_vars = _category_priors(model)
        self.prior_means = prior_means.to(self.device)
        self.prior_log_vars = None if prior_log_vars is None else prior_log_vars.to(self.device)

    # ---- the latent belief
    def new_object(self, batch_shape: Sequence[int] = ()) -> GaussianBelief:
        """Uninformative belief over the anchors' latent, (*batch_shape, D)."""
        return GaussianBelief.uninformative((*batch_shape, self.prior_means.shape[-1]), device=self.device)

    def encode_observation(self, image_or_voxel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """A batch of frames (B, H, W, 3) or grids (B, D, H, W, C) -> the
        (mean, log_var) blocks that fusion takes: the category block, or the
        one latent block there is; an AE's log-var is zero."""
        with torch.no_grad():
            enc = self.model.encode(image_or_voxel)
        mean = enc.mean_category if enc.mean_category is not None else enc.mean_inst
        log_var = enc.log_var_category if enc.mean_category is not None else enc.log_var_inst
        return mean, torch.zeros_like(mean) if log_var is None else log_var

    def observe(self, belief: GaussianBelief, mean: torch.Tensor, log_var: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> GaussianBelief:
        """Fuse one observation; ``mask`` (1 where observed) as ``fuse_observation``."""
        return fuse_observation(belief, mean, log_var, mask)

    def observe_stream(self, belief: GaussianBelief, means: torch.Tensor, log_vars: torch.Tensor,
                       masks: Optional[torch.Tensor] = None, mesh=None, axis: str = "data") -> GaussianBelief:
        """Fuse a stacked (T, ...) stream of observations in order
        (``engine.fuse_sequence``), from ``belief``; with a ``mesh``
        (``parallel.make_mesh``), split over its ``axis`` ranks
        (``engine.fuse_sequence_sharded``)."""
        if mesh is not None:
            return fuse_sequence_sharded(mesh, means, log_vars, masks, prior=belief, axis=axis)
        return fuse_sequence(means, log_vars, masks, prior=belief)

    # ---- anytime outputs
    def decode(self, belief: GaussianBelief, generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Decode the belief's mean, or with a ``generator`` (or the normal
        draw ``eps``) a sample of the belief; a (D,) belief decodes as a batch of 1."""
        z = belief.mean
        if generator is not None or eps is not None:
            z = reparameterize(z, belief.log_var, generator, eps)
        return self.decode_z(z)

    def decode_z(self, z: torch.Tensor) -> torch.Tensor:
        """Latent (B, D) or (D,) -> occupancy probabilities (B, D, H, W, C)."""
        if z.dim() == 1:
            z = z[None]
        with torch.no_grad():
            return self.model.decode(z)

    def _observed(self, belief: GaussianBelief, observed_precision: float) -> Tuple[torch.Tensor, torch.Tensor,
                                                                                      torch.Tensor]:
        """(z, precision, mask) of a belief as batches: ``mask`` 1 where the
        precision exceeds ``observed_precision``."""
        z, prec = belief.mean, belief.precision
        if z.dim() == 1:
            z, prec = z[None], prec[None]
        return z, prec, (prec > observed_precision).to(z.dtype)

    def classify(self, belief: GaussianBelief, observed_precision: float = 1e-3) -> torch.Tensor:
        """(B,) index of the nearest anchor over the observed dims."""
        z, _, mask = self._observed(belief, observed_precision)
        return classify_by_prior(z, self.prior_means, mask=mask)

    def correct(self, belief: GaussianBelief, observed_precision: float = 1e-3) -> GaussianBelief:
        """Fuse the nearest class prior into the dims with next to no
        observations; the observed dims keep their belief."""
        squeeze = belief.mean.dim() == 1
        z, prec, mask = self._observed(belief, observed_precision)
        nearest = classify_by_prior(z, self.prior_means, mask=mask)
        mu = self.prior_means[nearest]
        lv = self.prior_log_vars[nearest] if self.prior_log_vars is not None else torch.zeros_like(mu)
        fused = fuse_observation(GaussianBelief(info=z * prec, precision=prec), mu, lv, mask=1.0 - mask)
        if squeeze:
            return GaussianBelief(info=fused.info[0], precision=fused.precision[0])
        return fused

    # ---- occupancy-space fusion
    def new_shape_belief(self, grid_shape: Sequence[int]) -> OccupancyBelief:
        """Empty log-odds accumulator over the decoder's output grid."""
        return OccupancyBelief.empty(tuple(grid_shape), device=self.device)

    def observe_decoded(self, belief: OccupancyBelief, z_or_belief, mask: Optional[torch.Tensor] = None
                        ) -> OccupancyBelief:
        """Decode one observation's latent (a z, or a ``GaussianBelief``'s
        mean) and fuse its grid into the product-of-experts belief;
        ``mask`` is this view's per-voxel visibility (``engine.fuse_occupancy``)."""
        z = z_or_belief.mean if isinstance(z_or_belief, GaussianBelief) else z_or_belief
        return fuse_occupancy(belief, self.decode_z(z), mask)


def _category_priors(model: MultiModalVAE) -> Tuple[torch.Tensor, torch.Tensor]:
    """The category prior net's (K, D) means and log-variances over the K
    one-hots, in eval mode (no dropout), float32."""
    if model.config.prior_category is None:
        raise ValueError("prior_means required for models without a category priornet")
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            eye = torch.eye(model.config.prior_category.input_dim, device=next(model.parameters()).device)
            mean, log_var = model.priors_category(eye)
        return mean.float(), log_var.float()
    finally:
        model.train(was_training)
