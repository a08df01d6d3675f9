"""Loss assembly and the train and eval steps of the MultiModalVAE family.

Counterpart of ``anytime3d_tpu/train/step.py``. One config-driven loss:
focal BCE on the voxels, KL of the posterior to the class prior (or to
N(0, I)), the prior-repulsion regulariser, an optional kernel L2, and voxel
precision and recall, all in float32 whatever the model computes in.

Random draws: where the JAX step splits a PRNG key, this step draws from an
explicit ``torch.Generator`` on the model's device, or takes the draws
themselves in ``draws``, one name per JAX key, so a test can hand both
packages the same numbers: ``eps_cat`` and ``eps_inst`` (the posterior
samples of the category and instance blocks; a one-block latent draws from
``eps_inst``, as the JAX step does), ``eps_prior_cat`` and ``eps_prior_inst``
(the prior samples of the mix), ``coin`` and ``take_prior`` (the mix's coin
and element mask), ``drop_rate`` and ``drop_keep`` (the `_dr` variants'
dropout rate, U(0, 0.95), and keep mask, drawn after the mix).

Parallel runs (``parallel.make_mesh``; one process a device). Over "data"
each rank holds its equal shard of the global batch, and with a ``mesh``
the steps compute the single-device step on the global batch: every draw is
made for the global batch from the ranks' common generator and sliced by
the data rank (``ops.sampling.batch_shard``), each batch mean is the rank's
share of the global one (``parallel.global_mean``), the prior repulsion
runs this rank's rows against the means of every rank (gathered with their
gradients), the metrics are summed over the ranks, and the gradients are
all-reduced in float32 before the finite check, so every rank takes the
same update. Over "model" (tensor parallelism, a model sharded by
``parallel.tensor.parallelize``) the ranks of one data index hold the same
rows and draw alike; the sharded layers gather their outputs, so the loss
and the replicated gradients are the same on each, and the gradients are
all-reduced over "data" only (the sharded leaves as slices); the finite
flag and the kernel L2 are taken over "model" too. ``make_train_step_dp``
is the explicit data-parallel step instead: each rank differentiates the
mean loss of its own shard with draws of its own, and the gradients are
all-reduced over "data" in a lower precision (bfloat16 by default), upcast
to float32 and then averaged.

Spans (``utils/profiling.py``): ``step.forward`` (``compute_losses`` in
``loss_and_grads``), ``step.backward`` (``torch.autograd.grad``, and under
a mesh the gradients' all-reduce), ``step.update``
(``apply_gradients_if_finite``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from anytime3d_tpu_torch.data.packing import unpack_voxels, unpack_voxels_blocked
from anytime3d_tpu_torch.models.mmvae import MultiModalVAE
from anytime3d_tpu_torch.nn.blocks import space_to_depth3d
from anytime3d_tpu_torch.ops.losses import focal_binary_loss, gaussian_kl, prior_repulsion, standard_gaussian_kl
from anytime3d_tpu_torch.ops.metrics import voxel_tp_fp_fn
from anytime3d_tpu_torch.ops.sampling import batch_shard, fold_in, reparameterize, uniform
from anytime3d_tpu_torch.parallel.mesh import (
    all_gather_rows,
    all_reduce_grads,
    data_rank_and_size,
    global_mean,
    rank_share,
    reduce_metrics,
)
from anytime3d_tpu_torch.train.state import TrainState, grads_finite_flag, l2_penalty
from anytime3d_tpu_torch.utils.profiling import span

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


def materialize_batch(model: MultiModalVAE, batch: Batch) -> Tuple[Dict[str, torch.Tensor], bool, bool]:
    """Unpack or re-lay a batch on the device; returns ``(batch, blocked_in,
    blocked_out)`` with ``input`` and ``target`` set.

    A uint8 ``input`` (images) becomes float32 / 255. The voxel target is
    ``target``, ``target_packed`` or ``target_packed_blocked`` (image -> shape
    models), or else the voxel input (voxel -> voxel models ship one copy for
    both roles). When the model supports blocked IO, a voxel input comes in
    the space-to-depth(4) coarse layout: ``input_packed_blocked`` batches
    (bits pre-ordered on the host by ``pack_voxels_blocked``) unpack straight
    into it; ``input_packed`` and dense ``input`` batches pay one relayout.
    ``blocked_out`` concerns the decoder alone: whenever its tail is blocked,
    the target comes in the coarse layout too (``target_packed_blocked``
    unpacks straight into it), image models included. The losses and
    TP/FP/FN are sums of elementwise terms, so the layout changes no metric."""
    if "input" in batch and batch["input"].dtype == torch.uint8:
        batch = dict(batch, input=batch["input"].float() / 255.0)
    block, dec_block = model.blocked_io_block, model.decoder_block
    grid = model.config.decoder.output_shape

    tgt, tgt_blocked = batch.get("target"), False
    if "target_packed_blocked" in batch:
        if dec_block is None:
            raise ValueError("target_packed_blocked requires a blocked-tail decoder")
        tgt, tgt_blocked = unpack_voxels_blocked(batch["target_packed_blocked"], grid, dec_block), True
    elif "target_packed" in batch:
        tgt = unpack_voxels(batch["target_packed"], grid)
    out = {k: v for k, v in batch.items() if k not in ("target", "target_packed", "target_packed_blocked")}

    blocked_in = False
    if "input_packed_blocked" in out:
        if block is None:
            raise ValueError("input_packed_blocked requires a blocked-IO model "
                             "(blocked-head encoder + blocked-tail decoder)")
        out["input"] = unpack_voxels_blocked(out.pop("input_packed_blocked"), grid, block)
        blocked_in = True
        if tgt is None:
            tgt, tgt_blocked = out["input"], True
    elif "input_packed" in out:
        vox = unpack_voxels(out.pop("input_packed"), grid)
        if block is not None:
            vox = space_to_depth3d(vox, block)
        out["input"] = vox
        blocked_in = block is not None
        if tgt is None:
            tgt, tgt_blocked = vox, blocked_in
    elif block is not None:
        shared = tgt is None or tgt is batch.get("input")
        out["input"] = space_to_depth3d(out["input"], block)
        blocked_in = True
        if shared:
            tgt, tgt_blocked = out["input"], True

    blocked_out = dec_block is not None and tgt is not None
    if tgt is not None:
        if blocked_out and not tgt_blocked:
            tgt = space_to_depth3d(tgt, dec_block)
        out["target"] = tgt
    return out, blocked_in, blocked_out


def _encode_and_sample(model: MultiModalVAE, cfg: LossConfig, batch: Batch, generator: Optional[torch.Generator],
                       deterministic: bool, blocked: bool, blocked_out: bool, draws: Optional[Draws]) -> Dict:
    """Shared forward: priors -> posterior -> z draw -> prior mixing -> decoder."""
    mcfg = model.config
    draws = draws or {}
    x = batch["input"]
    if cfg.input_remap:
        x = 2.0 * x - 1.0
    out: Dict = {}
    enc = model.encode(x, blocked_input=blocked)
    out["enc"] = enc

    prior_cat = prior_inst = None
    if mcfg.prior_category is not None:
        prior_cat = model.priors_category(batch["category_onehot"], generator)
        out["prior_cat"] = prior_cat
    if mcfg.prior_inst is not None:
        inst_in = batch["inst_onehot"]
        if mcfg.category_dim > 0:  # the dual latent: the instance prior sees both one-hots
            inst_in = torch.cat([batch["category_onehot"], inst_in], dim=-1)
        prior_inst = model.priors_inst(inst_in, generator)
        out["prior_inst"] = prior_inst

    if not mcfg.variational:  # an AE: z is the encoder's output
        z = enc.mean
    elif enc.mean_category is not None and mcfg.z_inst_dim > 0:  # one draw a block
        z = torch.cat([reparameterize(enc.mean_category, enc.log_var_category, generator, draws.get("eps_cat")),
                       reparameterize(enc.mean_inst, enc.log_var_inst, generator, draws.get("eps_inst"))], dim=-1)
    else:
        z = reparameterize(enc.mean, enc.log_var, generator, draws.get("eps_inst"))

    # decoder-input prior mixing on the prior sample of every block, before any latent dropout
    if not deterministic and cfg.mix_coin_prob > 0.0 and (prior_cat is not None or prior_inst is not None):
        parts = []
        if prior_cat is not None:
            parts.append(reparameterize(prior_cat[0], prior_cat[1], generator, draws.get("eps_prior_cat")))
        if prior_inst is not None:
            parts.append(reparameterize(prior_inst[0], prior_inst[1], generator, draws.get("eps_prior_inst")))
        z_prior = torch.cat(parts, dim=-1)
        coin, take = draws.get("coin"), draws.get("take_prior")
        if coin is None:
            coin = uniform((), generator, z.device) < cfg.mix_coin_prob
        if take is None:
            take = uniform(z.shape, generator, z.device) < cfg.mix_element_prob
        z = torch.where(coin.bool() & take.bool(), z_prior, z)

    # the `_dr` variants: dropout on the (mixed) z at a rate drawn from U(0, 0.95) each step; in float32,
    # as the JAX step's float32 rate promotes a bfloat16 z
    if mcfg.latent_dropout and not deterministic:
        rate, keep = draws.get("drop_rate"), draws.get("drop_keep")
        if rate is None:
            rate = uniform((), generator, z.device) * 0.95
        if keep is None:
            keep = uniform(z.shape, generator, z.device) < 1.0 - rate
        z = torch.where(keep.bool(), z.float() / (1.0 - rate.float()), 0.0)

    out["z"] = z
    out["pred"] = model.decode(z, blocked_output=blocked_out)
    return out


def sharded_draws(mesh):
    """The context in which a rank of ``mesh`` draws its rows of the global batch's draws (none without a mesh)."""
    if mesh is None:
        return contextlib.nullcontext()
    return batch_shard(*data_rank_and_size(mesh))


def compute_losses(model: MultiModalVAE, cfg: LossConfig, batch: Batch,
                   generator: Optional[torch.Generator] = None, deterministic: bool = False,
                   draws: Optional[Draws] = None, mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns ``(total_loss, metrics)``. Batch keys: ``input`` (a dense
    (B, D, H, W, 1) grid, or (B, H, W, 3) images, float or uint8),
    ``input_packed`` or ``input_packed_blocked`` (bit-packed uint8,
    ``data/packing.py``), a voxel target for image models (``target``,
    ``target_packed`` or ``target_packed_blocked``), and ``category_onehot``
    / ``inst_onehot`` for the prior variants. The model's parameters are the
    ones differentiated; ``deterministic`` puts the model in eval mode (no
    dropout, no prior mix). With a ``mesh``, ``batch`` and ``draws`` are this
    rank's rows, and the loss is its share of the global batch's (see the
    module's doc)."""
    mcfg = model.config
    model.train(not deterministic)
    batch, blocked_in, blocked_out = materialize_batch(model, batch)
    with sharded_draws(mesh):
        fwd = _encode_and_sample(model, cfg, batch, generator, deterministic, blocked_in, blocked_out, draws)
    enc = fwd["enc"]
    # the voxel BCE sums ~262k log terms per sample: float32 whatever the model computes in
    pred = fwd["pred"].float()
    target = batch["target"].float()

    metrics: Dict[str, torch.Tensor] = {}
    loss_shape = global_mean(focal_binary_loss(pred, target, gamma=cfg.gamma, b_range=cfg.b_range), mesh)
    metrics["loss_shape"] = loss_shape
    total = loss_shape

    priors = mcfg.prior_category is not None or mcfg.prior_inst is not None
    if mcfg.variational:  # KL to the label priors, or to N(0, I) without them; an AE has none
        if priors:
            kl = 0.0
            if mcfg.prior_category is not None:  # on the category block, or on the one block there is
                mc, lvc = (t.float() for t in fwd["prior_cat"])
                mean = enc.mean_category if enc.mean_category is not None else enc.mean_inst
                log_var = enc.log_var_category if enc.log_var_category is not None else enc.log_var_inst
                kl = kl + global_mean(gaussian_kl(mean.float(), log_var.float(), mc, lvc), mesh)
            if mcfg.prior_inst is not None:
                mi, lvi = (t.float() for t in fwd["prior_inst"])
                kl = kl + global_mean(gaussian_kl(enc.mean_inst.float(), enc.log_var_inst.float(), mi, lvi), mesh)
        else:
            kl = global_mean(standard_gaussian_kl(enc.mean.float(), enc.log_var.float()), mesh)
        metrics["loss_kl"] = kl
        total = total + cfg.kl_weight * kl

    if priors:  # prior repulsion; between same-class pairs only for the dual latent's instance prior
        reg = 0.0
        if mcfg.prior_category is not None:
            mc, lvc = (t.float() for t in fwd["prior_cat"])
            reg = reg + global_mean(prior_repulsion(mc, lvc, cfg.reg_margin_scale_category * mc.shape[-1],
                                                    z_mean_cols=all_gather_rows(mc, mesh, grad=True)), mesh)
        if mcfg.prior_inst is not None:
            mi, lvi = (t.float() for t in fwd["prior_inst"])
            gate = batch["category_onehot"] if mcfg.category_dim > 0 else None
            reg = reg + global_mean(prior_repulsion(
                mi, lvi, cfg.reg_margin_scale_inst * mi.shape[-1], class_onehot=gate,
                z_mean_cols=all_gather_rows(mi, mesh, grad=True),
                class_onehot_cols=None if gate is None else all_gather_rows(gate, mesh)), mesh)
        metrics["loss_reg"] = reg
        total = total + cfg.reg_weight * reg

    if cfg.l2_weight:  # skipped at weight 0: a reduction over every kernel otherwise
        total = total + rank_share(l2_penalty(dict(model.named_parameters()), cfg.l2_weight), mesh)

    with torch.no_grad():
        tp, fp, fn = voxel_tp_fp_fn(target, pred)
        metrics["precision"] = global_mean(tp / (tp + fp + 1e-10), mesh)
        metrics["recall"] = global_mean(tp / (tp + fn + 1e-10), mesh)
    metrics["loss_total"] = total
    return total, reduce_metrics({k: v.detach() for k, v in metrics.items()}, mesh)


def apply_gradients_if_finite(state: TrainState, grads: Dict[str, torch.Tensor],
                              metrics: Dict[str, torch.Tensor],
                              mesh=None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """Overflow-safe update: zero the WHOLE gradient when any leaf is
    non-finite (on any model rank of ``mesh``), then apply as usual, so the
    parameters and the Adam moments stay finite (the poisoned step still
    advances the count and decays the moments). ``metrics['grads_finite']``
    records it. No host sync: the flag stays on the device and gates every
    leaf there."""
    with span("step.update"):
        flag = grads_finite_flag(grads, mesh)
        metrics["grads_finite"] = flag
        poisoned = flag <= 0
        for g in grads.values():
            g.masked_fill_(poisoned, 0.0)  # in place: the gradients are this step's own
        return state.apply_gradients(grads), metrics


StepFn = Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]


def loss_and_grads(model: MultiModalVAE, cfg: LossConfig, batch: Batch,
                   generator: Optional[torch.Generator] = None, draws: Optional[Draws] = None,
                   mesh=None) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(gradients by parameter name, metrics) of the train loss; with a
    ``mesh``, the global batch's, the gradients all-reduced over "data" in
    float32."""
    with span("step.forward"):
        total, metrics = compute_losses(model, cfg, batch, generator, deterministic=False, draws=draws, mesh=mesh)
    with span("step.backward"):
        names, params = zip(*model.named_parameters())
        grads = dict(zip(names, torch.autograd.grad(total, params)))
        if mesh is not None:
            grads = all_reduce_grads(grads, mesh)
    return grads, metrics


def make_train_step(model: MultiModalVAE, cfg: LossConfig = LossConfig(), mesh=None) -> StepFn:
    """Build ``step(state, batch, generator=None, draws=None) -> (state, metrics)``.
    ``state`` is updated in place; ``metrics`` are scalars on the device.
    With a ``mesh`` (``parallel.make_mesh``), ``batch`` and ``draws`` are this
    rank's rows of the global batch, and the step is the single-device step
    on that batch; a mesh with a "model" axis takes a model sharded over it
    (``parallel.tensor.parallelize``; see the module's doc)."""

    def step(state: TrainState, batch: Batch, generator: Optional[torch.Generator] = None,
             draws: Optional[Draws] = None):
        grads, metrics = loss_and_grads(model, cfg, batch, generator, draws, mesh)
        return apply_gradients_if_finite(state, grads, metrics, mesh)

    return step


def make_train_step_dp(model: MultiModalVAE, cfg: LossConfig = LossConfig(), mesh=None,
                       grad_psum_dtype: Optional[torch.dtype] = torch.bfloat16) -> StepFn:
    """The explicit data-parallel step over ``mesh``'s "data" ranks, each
    with its own shard of the batch: each rank takes the gradient of its
    shard's mean loss (the prior repulsion within the shard) under draws of
    its own (``ops.sampling.fold_in`` of the generator by the rank, or the
    given ``draws``), casts it to ``grad_psum_dtype`` (None: float32), and one
    all-reduce sums the ranks' gradients; the sum is upcast to float32 and
    only then divided by the number of ranks. Metrics are averaged in
    float32. Then the guarded Adam update, the same on every rank. The
    "model" axis of ``mesh`` works as in :func:`make_train_step`: the ranks
    of one data index share the shard and its draws.
    ``step(state, batch, generator=None, draws=None) -> (state, metrics)``."""
    if mesh is None:
        raise ValueError("make_train_step_dp needs a mesh")
    rank, _ = data_rank_and_size(mesh)
    dtype = grad_psum_dtype or torch.float32

    def step(state: TrainState, batch: Batch, generator: Optional[torch.Generator] = None,
             draws: Optional[Draws] = None):
        own = fold_in(generator, rank) if generator is not None and draws is None else None
        grads, metrics = loss_and_grads(model, cfg, batch, own, draws)
        grads = all_reduce_grads(grads, mesh, dtype=dtype, average=True)
        return apply_gradients_if_finite(state, grads, reduce_metrics(metrics, mesh, average=True), mesh)

    return step


def make_eval_step(model: MultiModalVAE, cfg: LossConfig = LossConfig(), mesh=None):
    """Build ``step(batch, generator=None, draws=None) -> metrics``: the losses
    and P/R at a posterior sample, no dropout, no prior mix, no gradient;
    with a ``mesh``, of the global batch whose rows ``batch`` holds."""

    def step(batch: Batch, generator: Optional[torch.Generator] = None, draws: Optional[Draws] = None):
        with torch.no_grad():
            _, metrics = compute_losses(model, cfg, batch, generator, deterministic=True, draws=draws, mesh=mesh)
        return metrics

    return step
