"""The comparison that decides ``correct``: the numbers compared, each
beside its limit, from what the program produced and what the plain
reference computes.

A train cell compares the first steps that set-up drove through the
window's own call: each step's loss, the norm of the first gradient as the
optimizer got it (worked out from Adam's first moment after one step) and
the norm of the parameters' change after the steps, both by the worst leaf:
the gap between the program's norm and the reference's, over the
reference's norm of that leaf or of the median leaf, whichever is larger.
Leaves whose reference gradient is under a thousandth of the median leaf's
move under Adam by round-off alone and are left out of the change.

A serve cell judges each sampled request by what it says: the served
category against the reference's nearest prior over the observed dims (the
gap of its distance over the best, relative to the median class distance,
so that a near tie is no fault), the served latent against the reference's
latent corrected with the served category, and the served voxel bits
against the reference's decode of that latent (the widest reference logit,
relative to the request's root mean square logit, among the voxels whose
bit differs).
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch


def leaf_gaps(prog: Mapping[str, float], ref: Mapping[str, float], keep=None) -> Dict[str, float]:
    """name -> |prog - ref| over the larger of the leaf's reference norm and the median leaf's."""
    median = statistics.median(ref.values())
    return {n: abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30) for n in ref if keep is None or n in keep}


def moving_leaves(ref: dict) -> set:
    """The leaves whose reference gradient is at least a thousandth of the median leaf's."""
    grad_median = statistics.median(ref["grad_norms"].values())
    return {n for n, g in ref["grad_norms"].items() if g >= 1e-3 * grad_median}


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: ``losses`` (a list), ``grad_norms`` and
    ``change_norms`` (name -> float) -> the numbers a train cell may
    compare: the worst step's loss gap, the worst leaf's gradient and change
    gaps, and the median leaf's (for a cell whose worst leaf is one whose
    gradient is a sum that cancels, see ``PERF.md``)."""
    losses = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["losses"], ref["losses"]))
    grads = leaf_gaps(prog["grad_norms"], ref["grad_norms"])
    change = leaf_gaps(prog["change_norms"], ref["change_norms"], moving_leaves(ref))
    return {
        "loss_gap": losses,
        "grad_gap": max(grads.values()),
        "change_gap": max(change.values(), default=0.0),
        "grad_gap_median": statistics.median(grads.values()),
        "change_gap_median": statistics.median(change.values()) if change else 0.0,
    }


def prior_distances(z: torch.Tensor, means: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, K) squared distances over the observed dims."""
    return (mask[:, None, :] * (z[:, None, :] - means[None, :, :]) ** 2).sum(-1)


def category_gaps(z_ref: torch.Tensor, means_ref: torch.Tensor, mask: torch.Tensor,
                  category: torch.Tensor) -> torch.Tensor:
    """(B,) gap of the served category's distance over the nearest one, relative to the median distance."""
    d = prior_distances(z_ref, means_ref, mask)
    served = d.gather(1, category.view(-1, 1)).squeeze(1)
    return (served - d.min(dim=1).values) / d.median(dim=1).values.clamp(min=1e-30)


def latent_gaps(z_served: torch.Tensor, z_expected: torch.Tensor) -> torch.Tensor:
    """(B,) widest gap of a served latent dim, relative to the root mean square of the expected latent."""
    rms = z_expected.pow(2).mean(dim=1).sqrt().clamp(min=1e-30)
    return (z_served - z_expected).abs().amax(dim=1) / rms


def voxel_gaps(bits_served: torch.Tensor, logits_ref: torch.Tensor) -> torch.Tensor:
    """(B,) widest |reference logit| among the voxels whose served bit differs
    from the reference's (0 where none does), relative to the request's root
    mean square logit. ``bits_served`` and ``logits_ref`` are (B, N) in the
    same voxel order."""
    wrong = bits_served.bool() != (logits_ref > 0)
    rms = logits_ref.pow(2).mean(dim=1).sqrt().clamp(min=1e-30)
    return torch.where(wrong, logits_ref.abs(), torch.zeros_like(logits_ref)).amax(dim=1) / rms


def unpack_bits(packed: np.ndarray) -> torch.Tensor:
    """(B, N/8) uint8, MSB first -> (B, N) uint8 bits."""
    return torch.as_tensor(np.unpackbits(packed, axis=1))


def verdict(numbers: Mapping[str, float], limits: Mapping[str, float]) -> Tuple[bool, List[list]]:
    """(correct, [[name, value, limit], ...]) over the cell's limits: correct
    where each limited number was read, is finite and is at or under its
    limit. The cell's file names what it compares; a number it does not
    limit is not compared. No limits at all is not correct."""
    rows, ok = [], bool(limits)
    for name, limit in limits.items():
        value = float(numbers.get(name, float("nan")))
        ok &= bool(np.isfinite(value) and value <= limit)
        rows.append([name, value, float(limit)])
    return ok, rows

