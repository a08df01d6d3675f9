"""Reconstruction dumps for offline PR-curve analysis.

Counterpart of ``anytime3d_tpu/evaluation/dump.py``: one ``.npz`` a missing
rate with the ground truth, the uncorrected and corrected decodes, the
observation mask and the nearest-prior class, for the reference's
threshold-sweep notebooks (``evaluation.pr_curve`` computes the same curve
on the device).
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from anytime3d_tpu_torch.anytime.engine import category_prior_means, classify_by_prior, correct_latent
from anytime3d_tpu_torch.data.prefetch import to_device
from anytime3d_tpu_torch.models.mmvae import MultiModalVAE
from anytime3d_tpu_torch.nn.blocks import depth_to_space3d
from anytime3d_tpu_torch.ops.sampling import mask_latent, reparameterize
from anytime3d_tpu_torch.train.step import materialize_batch


def _host(t: torch.Tensor) -> np.ndarray:
    """Float tensors as float32 numpy (numpy has no bfloat16)."""
    return (t.float() if t.is_floating_point() else t).cpu().numpy()


def dump_reconstructions(model: MultiModalVAE, batch: Mapping, out_dir: str,
                         rates: Sequence[float] = (0.3, 0.5, 0.7, 0.9),
                         prior_means: Optional[torch.Tensor] = None, seed: int = 0, tag: str = "model",
                         draws: Optional[Mapping[float, Mapping[str, torch.Tensor]]] = None) -> Dict[str, str]:
    """Decode ``batch`` at each missing rate, uncorrected and corrected, and
    save ``<out_dir>/<tag>_rate<r>.npz`` with keys ``gt``, ``pred``, ``mask``,
    ``rate`` and, where there are prior means, ``pred_corrected`` and
    ``pred_class`` (int32). Grids are saved dense, (B, D, H, W, C) float32,
    whatever layout the model computes in. Returns {str(rate): path}.

    Each rate draws from a generator seeded ``seed + int(rate*1000)`` on the
    model's device, in the order ``eps`` (posterior sample; none for an AE
    model, which takes its mean), ``keep``
    (observation mask) and ``eps_corr`` (correction), unless ``draws[rate]``
    gives them."""
    os.makedirs(out_dir, exist_ok=True)
    device = next(model.parameters()).device
    block = model.decoder_block  # the coarse layout of the decoder's output and of the target beside it
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            b, blocked_in, blocked_out = materialize_batch(model, to_device(batch, device))
            enc = model.encode(b["input"], blocked_input=blocked_in)
            mean = enc.mean_category if enc.mean_category is not None else enc.mean_inst
            log_var = enc.log_var_category if enc.log_var_category is not None else enc.log_var_inst
            if prior_means is None and model.config.prior_category is not None:
                prior_means = category_prior_means(model, mean.dtype)

            def decode(z: torch.Tensor) -> np.ndarray:
                pred = model.decode(z, blocked_output=blocked_out)
                return _host(depth_to_space3d(pred, block) if blocked_out else pred)

            gt = _host(depth_to_space3d(b["target"], block) if blocked_out else b["target"])
            paths = {}
            for rate in rates:
                d = (draws or {}).get(rate, {})
                gen = torch.Generator(device=device).manual_seed(seed + int(rate * 1000))
                # an AE model (no log-var) decodes its mean
                z = mean if log_var is None else reparameterize(mean, log_var, gen, d.get("eps"))
                fill = prior_means.mean(dim=0) if prior_means is not None else 0.0
                z_masked, mask = mask_latent(z, rate, fill, gen, d.get("keep"))
                out = {"gt": gt, "pred": decode(z_masked), "mask": _host(mask), "rate": rate}
                if prior_means is not None:
                    z_corr = correct_latent(z_masked, mask, prior_means, generator=gen, eps=d.get("eps_corr"))
                    out["pred_corrected"] = decode(z_corr)
                    out["pred_class"] = _host(classify_by_prior(z_masked, prior_means)).astype(np.int32)
                path = os.path.join(out_dir, f"{tag}_rate{rate:.1f}.npz")
                np.savez_compressed(path, **out)
                paths[str(rate)] = path
            return paths
    finally:
        model.train(was_training)
