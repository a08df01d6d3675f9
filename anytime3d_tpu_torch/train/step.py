"""Loss assembly and the train and eval steps of the MultiModalVAE family.

Counterpart of ``anytime3d_tpu/train/step.py``. One config-driven loss:
focal BCE on the voxels, KL of the posterior to the class prior (or to
N(0, I)), the prior-repulsion regulariser, an optional kernel L2, and voxel
precision and recall, all in float32 whatever the model computes in.

Random draws: where the JAX step splits a PRNG key, this step draws from an
explicit ``torch.Generator`` on the model's device, or takes the draws
themselves in ``draws`` (``eps_post``, ``eps_prior``, ``coin``,
``take_prior``), so a test can hand both packages the same numbers.

The explicit data-parallel step waits for the port of the mesh; batches with
image inputs or explicit targets wait for the image family.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from anytime3d_tpu_torch.data.packing import unpack_voxels, unpack_voxels_blocked
from anytime3d_tpu_torch.models.mmvae import MultiModalVAE
from anytime3d_tpu_torch.nn.blocks import space_to_depth3d
from anytime3d_tpu_torch.ops.losses import focal_binary_loss, gaussian_kl, prior_repulsion, standard_gaussian_kl
from anytime3d_tpu_torch.ops.metrics import voxel_tp_fp_fn
from anytime3d_tpu_torch.ops.sampling import reparameterize
from anytime3d_tpu_torch.train.state import TrainState, grads_finite_flag, l2_penalty

Batch = Mapping[str, torch.Tensor]
Draws = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Per-variant training-loss values; the per-name ones are in
    ``models.configs.loss_config``. Field for field the JAX package's."""

    gamma: float = 0.6  # weight of the occupied voxels in the BCE
    b_range: bool = False  # remap the BCE targets {0,1} -> {-1,2}; no variant sets it
    input_remap: bool = False  # encoder input 2x - 1 (the loss target stays in [0,1])
    kl_weight: float = 1.0
    reg_weight: float = 1.0
    # prior-repulsion margin = scale * z_dim, per latent block
    reg_margin_scale_category: float = 3.0
    reg_margin_scale_inst: float = 3.0
    l2_weight: float = 5e-4  # kernel L2; skipped at 0
    # decoder-input prior mixing: one coin per step picks the mixed branch
    # with probability mix_coin_prob; in it each latent element takes the
    # prior sample with probability mix_element_prob
    mix_coin_prob: float = 0.0
    mix_element_prob: float = 0.5


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"not ported yet: {what}")


def materialize_batch(model: MultiModalVAE, batch: Batch) -> Tuple[Dict[str, torch.Tensor], bool, bool]:
    """Unpack or re-lay a voxel batch on the device; returns
    ``(batch, blocked_in, blocked_out)`` with ``input`` and ``target`` set.

    The target is the input grid (voxel -> voxel models ship one copy for both
    roles). When the model supports blocked IO, both come in the
    space-to-depth(4) coarse layout: ``input_packed_blocked`` batches (bits
    pre-ordered on the host by ``pack_voxels_blocked``) unpack straight into
    it; ``input_packed`` and dense ``input`` batches pay one relayout. The
    losses and TP/FP/FN are sums of elementwise terms, so the layout changes
    no metric."""
    for key in ("target", "target_packed", "target_packed_blocked"):
        if key in batch:
            raise _not_ported(f"batches with an explicit {key!r} (image -> shape models)")
    if "input" in batch and batch["input"].dtype == torch.uint8:
        raise _not_ported("uint8 image inputs")
    block = model.blocked_io_block
    grid = model.config.decoder.output_shape
    out = dict(batch)
    if "input_packed_blocked" in out:
        if block is None:
            raise ValueError("input_packed_blocked requires a blocked-IO model "
                             "(blocked-head encoder + blocked-tail decoder)")
        vox = unpack_voxels_blocked(out.pop("input_packed_blocked"), grid, block)
    elif "input_packed" in out:
        vox = unpack_voxels(out.pop("input_packed"), grid)
        if block is not None:
            vox = space_to_depth3d(vox, block)
    else:
        vox = out["input"]
        if block is not None:
            vox = space_to_depth3d(vox, block)
    out["input"] = out["target"] = vox
    blocked = block is not None
    return out, blocked, blocked


def _encode_and_sample(model: MultiModalVAE, cfg: LossConfig, batch: Batch, generator: Optional[torch.Generator],
                       deterministic: bool, blocked: bool, blocked_out: bool, draws: Optional[Draws]) -> Dict:
    """Shared forward: prior -> posterior -> z draw -> prior mixing -> decoder."""
    mcfg = model.config
    draws = draws or {}
    x = batch["input"]
    if cfg.input_remap:
        x = 2.0 * x - 1.0
    out: Dict = {}
    enc = model.encode(x, blocked_input=blocked)
    out["enc"] = enc

    prior_cat = None
    if mcfg.prior_category is not None:
        prior_cat = model.priors_category(batch["category_onehot"], generator)
        out["prior_cat"] = prior_cat

    if enc.mean_category is not None and mcfg.z_inst_dim > 0:
        raise _not_ported("the dual (category + instance) latent")
    z = reparameterize(enc.mean, enc.log_var, generator, draws.get("eps_post"))

    # decoder-input prior mixing, before any latent dropout
    if not deterministic and cfg.mix_coin_prob > 0.0 and prior_cat is not None:
        z_prior = reparameterize(prior_cat[0], prior_cat[1], generator, draws.get("eps_prior"))
        coin, take = draws.get("coin"), draws.get("take_prior")
        if coin is None:
            coin = torch.rand((), generator=generator, device=z.device) < cfg.mix_coin_prob
        if take is None:
            take = torch.rand(z.shape, generator=generator, device=z.device) < cfg.mix_element_prob
        z = torch.where(coin.bool() & take.bool(), z_prior, z)

    if mcfg.latent_dropout and not deterministic:
        raise _not_ported("latent_dropout (the `_dr` variants)")

    out["z"] = z
    out["pred"] = model.decode(z, blocked_output=blocked_out)
    return out


def compute_losses(model: MultiModalVAE, cfg: LossConfig, batch: Batch,
                   generator: Optional[torch.Generator] = None, deterministic: bool = False,
                   draws: Optional[Draws] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns ``(total_loss, metrics)``. Batch keys: ``input`` (a dense
    (B, D, H, W, 1) grid), ``input_packed`` or ``input_packed_blocked``
    (bit-packed uint8, ``data/packing.py``), and ``category_onehot`` for the
    prior variants. The model's parameters are the ones differentiated;
    ``deterministic`` puts the model in eval mode (no dropout, no prior mix)."""
    mcfg = model.config
    if not mcfg.variational:
        raise _not_ported("deterministic (variational=False) models")
    model.train(not deterministic)
    batch, blocked_in, blocked_out = materialize_batch(model, batch)
    fwd = _encode_and_sample(model, cfg, batch, generator, deterministic, blocked_in, blocked_out, draws)
    enc = fwd["enc"]
    # the voxel BCE sums ~262k log terms per sample: float32 whatever the model computes in
    pred = fwd["pred"].float()
    target = batch["target"].float()
    mean, log_var = enc.mean.float(), enc.log_var.float()

    metrics: Dict[str, torch.Tensor] = {}
    loss_shape = focal_binary_loss(pred, target, gamma=cfg.gamma, b_range=cfg.b_range).mean()
    metrics["loss_shape"] = loss_shape
    total = loss_shape

    if mcfg.prior_category is not None:
        mc, lvc = (t.float() for t in fwd["prior_cat"])
        kl = gaussian_kl(mean, log_var, mc, lvc).mean()
        reg = prior_repulsion(mc, lvc, cfg.reg_margin_scale_category * mc.shape[-1]).mean()
        metrics["loss_kl"] = kl
        metrics["loss_reg"] = reg
        total = total + cfg.kl_weight * kl + cfg.reg_weight * reg
    else:
        kl = standard_gaussian_kl(mean, log_var).mean()
        metrics["loss_kl"] = kl
        total = total + cfg.kl_weight * kl

    if cfg.l2_weight:  # skipped at weight 0: a reduction over every kernel otherwise
        total = total + l2_penalty(dict(model.named_parameters()), cfg.l2_weight)

    with torch.no_grad():
        tp, fp, fn = voxel_tp_fp_fn(target, pred)
        metrics["precision"] = (tp / (tp + fp + 1e-10)).mean()
        metrics["recall"] = (tp / (tp + fn + 1e-10)).mean()
    metrics["loss_total"] = total
    return total, {k: v.detach() for k, v in metrics.items()}


def apply_gradients_if_finite(state: TrainState, grads: Dict[str, torch.Tensor],
                              metrics: Dict[str, torch.Tensor]) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """Overflow-safe update: zero the WHOLE gradient when any leaf is
    non-finite, then apply as usual, so the parameters and the Adam moments
    stay finite (the poisoned step still advances the count and decays the
    moments). ``metrics['grads_finite']`` records it. No host sync: the flag
    stays on the device and gates every leaf there."""
    flag = grads_finite_flag(grads)
    metrics["grads_finite"] = flag
    poisoned = flag <= 0
    for g in grads.values():
        g.masked_fill_(poisoned, 0.0)  # in place: the gradients are this step's own
    return state.apply_gradients(grads), metrics


StepFn = Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]


def make_train_step(model: MultiModalVAE, cfg: LossConfig = LossConfig()) -> StepFn:
    """Build ``step(state, batch, generator=None, draws=None) -> (state, metrics)``.
    ``state`` is updated in place; ``metrics`` are scalars on the device."""

    def step(state: TrainState, batch: Batch, generator: Optional[torch.Generator] = None,
             draws: Optional[Draws] = None):
        total, metrics = compute_losses(model, cfg, batch, generator, deterministic=False, draws=draws)
        names, params = zip(*model.named_parameters())
        grads = dict(zip(names, torch.autograd.grad(total, params)))
        return apply_gradients_if_finite(state, grads, metrics)

    return step


def make_eval_step(model: MultiModalVAE, cfg: LossConfig = LossConfig()):
    """Build ``step(batch, generator=None, draws=None) -> metrics``: the losses
    and P/R at a posterior sample, no dropout, no prior mix, no gradient."""

    def step(batch: Batch, generator: Optional[torch.Generator] = None, draws: Optional[Draws] = None):
        with torch.no_grad():
            _, metrics = compute_losses(model, cfg, batch, generator, deterministic=True, draws=draws)
        return metrics

    return step
