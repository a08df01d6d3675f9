"""The plain reference of a train step: the losses of the configuration file
with the given draws, the gradient, the finite check and Adam, in float32.

The losses, all reduced per sample and then averaged over the batch: the
focal BCE on the voxels (gamma weighting the occupied ones, predictions
clipped to [1e-7, 1 - 1e-7]); the closed-form KL of each posterior block to
its prior; the prior repulsion (the variance-normalised L1 distance of every
ordered pair of prior means hinged at scale * z, the diagonal included; the
instance prior's between same-class pairs only); the kernel L2 over the
weights of more than one axis. The whole gradient is zeroed where any entry
is not finite; Adam is ``torch.optim.Adam``'s update (b1 0.9, b2 0.999, eps
1e-8 added to the root of the bias-corrected second moment).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from perfbench.reference import model as ref


def _reparam(mean, log_var, eps):
    return mean + torch.exp(0.5 * log_var) * eps


def _kl(m, lv, mt, lvt):
    return (0.5 * (lvt - lv) + (torch.exp(lv) + (m - mt) ** 2) / (2.0 * torch.exp(lvt)) - 0.5).sum(-1)


def _repulsion(mean, log_var, margin, onehot=None):
    d = ((mean[:, None, :] - mean[None, :, :]).abs() / torch.exp(0.5 * log_var[:, None, :])).sum(-1) - margin
    pen = torch.where(d > 0.0, torch.zeros_like(d), d * d)
    if onehot is not None:
        pen = pen * ((onehot[:, None, :] - onehot[None, :, :]).abs().sum(-1) <= 0.0).float()
    return pen.sum(-1)


def focal(pred: torch.Tensor, target: torch.Tensor, gamma: float) -> torch.Tensor:
    n = pred.shape[0]
    p = pred.reshape(n, -1).clamp(1e-7, 1.0 - 1e-7)
    y = target.reshape(n, -1)
    return -(gamma * y * torch.log(p) + (1.0 - gamma) * (1.0 - y) * torch.log(1.0 - p)).sum(-1)


def loss(P: ref.Params, cfg: dict, batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor],
         keeps: Dict[str, list], precision: str = "f32") -> torch.Tensor:
    """The total train loss of one batch: ``vox`` (B, 1, D, H, W) the voxel
    target (and the input of a voxel model), ``images`` (B, H, W, 3) of an
    image model, ``category_onehot`` and ``inst_onehot``."""
    m, lc = cfg["model"], cfg["loss"]
    if m["encoder"] == "voxel":
        out = ref.encode_voxels(P, m, batch["vox"], precision)
    else:
        out = ref.encode_images(P, m, batch["images"], precision)
    mc, lvc, mi, lvi = ref.split_posterior(m, out)
    onehot_c = batch.get("category_onehot")
    pc = pi = None
    if m.get("prior_category"):
        pc = ref.prior(P, m, "prior_category", onehot_c, keeps.get("prior_category"), precision)
    if m.get("prior_inst"):
        inst_in = batch["inst_onehot"]
        if m["category_dim"] > 0:
            inst_in = torch.cat([onehot_c, inst_in], dim=-1)
        pi = ref.prior(P, m, "prior_inst", inst_in, keeps.get("prior_inst"), precision)

    if mi is not None:
        z = torch.cat([_reparam(mc, lvc, draws["eps_cat"]), _reparam(mi, lvi, draws["eps_inst"])], dim=-1)
    else:
        z = _reparam(mc, lvc, draws["eps_inst"])
    if lc["mix_coin_prob"] > 0.0 and (pc is not None or pi is not None):
        parts = []
        if pc is not None:
            parts.append(_reparam(pc[0], pc[1], draws["eps_prior_cat"]))
        if pi is not None:
            parts.append(_reparam(pi[0], pi[1], draws["eps_prior_inst"]))
        z = torch.where(draws["coin"].bool() & draws["take_prior"].bool(), torch.cat(parts, -1), z)

    pred = torch.sigmoid(ref.decode_logits(P, m, z, precision))
    target = ref.space_to_depth(batch["vox"].float(), 4)
    total = focal(pred, target, lc["gamma"]).mean()
    if pc is not None or pi is not None:
        kl = 0.0
        if pc is not None:
            kl = kl + _kl(mc, lvc, pc[0], pc[1]).mean()
        if pi is not None:
            kl = kl + _kl(mi, lvi, pi[0], pi[1]).mean()
        total = total + lc["kl_weight"] * kl
        reg = 0.0
        if pc is not None:
            reg = reg + _repulsion(pc[0], pc[1], lc["reg_margin_scale_category"] * pc[0].shape[-1]).mean()
        if pi is not None:
            gate = onehot_c if m["category_dim"] > 0 else None
            reg = reg + _repulsion(pi[0], pi[1], lc["reg_margin_scale_inst"] * pi[0].shape[-1], gate).mean()
        total = total + lc["reg_weight"] * reg
    if lc["l2_weight"]:
        total = total + lc["l2_weight"] * sum((w * w).sum() for n, w in P.items()
                                              if n.endswith(".weight") and w.dim() > 1)
    return total


class Adam:
    """``torch.optim.Adam``'s update over a dict of float32 leaves."""

    def __init__(self, params: ref.Params, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: ref.Params, grads: ref.Params) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1**self.t, 1.0 - self.b2**self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.addcdiv_(self.m[k], (self.v[k] / c2).sqrt_().add_(self.eps), value=-self.lr / c1)


def run_steps(P0: ref.Params, cfg: dict, batches: List[Dict[str, torch.Tensor]], draws: List[dict],
              keeps: List[dict], lr: float, precision: str = "f32", skip_rows: Optional[int] = None) -> dict:
    """``len(batches)`` guarded Adam steps from ``P0`` (not modified):
    ``losses`` (float per step), ``grad_norms`` (name -> norm of the first
    step's gradient after the finite check) and ``change_norms`` (name -> norm
    of the parameters' change after the last step). ``skip_rows`` keeps the
    first rows of each batch and of its draws alone (a planted fault)."""
    params = {k: v.detach().clone().float() for k, v in P0.items()}
    opt = Adam(params, lr)
    losses, grad_norms = [], {}
    for i, (batch, dr, kp) in enumerate(zip(batches, draws, keeps)):
        if skip_rows is not None:
            batch = {k: v[:skip_rows] for k, v in batch.items()}
            dr = {k: (v[:skip_rows] if v.dim() else v) for k, v in dr.items()}
            kp = {k: [t[:skip_rows] for t in v] for k, v in kp.items()}
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        total = loss(leaves, cfg, batch, dr, kp, precision)
        names = list(leaves)
        grads = dict(zip(names, torch.autograd.grad(total, [leaves[n] for n in names])))
        for v in leaves.values():
            v.requires_grad_(False)
        if not all(bool(torch.isfinite(g).all()) for g in grads.values()):
            grads = {k: torch.zeros_like(g) for k, g in grads.items()}
        losses.append(float(total.detach()))
        if i == 0:
            grad_norms = {k: float(g.norm()) for k, g in grads.items()}
        opt.step(params, grads)
        del total, grads
    change = {k: float((params[k] - P0[k].float()).norm()) for k in params}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
