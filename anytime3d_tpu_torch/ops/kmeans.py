"""K-means over (sin, cos) Euler-angle vectors with a cosine-style distance:
the orientation anchor bins of the multi-object head.

Counterpart of ``anytime3d_tpu/ops/kmeans.py``. The fit runs on the device
of the data, its iterations one loop of tensor operations with no read back
to the host; the samples that seed it are drawn with NumPy, as the JAX
function draws them. The per-cluster sums are built with ``index_add_`` in
float64 (no TF32 on any device; on the card the atomic adds' order moves
them by far less than a float32 rounding), then rounded to float32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def sincos_distance(x: torch.Tensor, centres: torch.Tensor) -> torch.Tensor:
    """(N, K) distances ``sum_a (1 - (sin sin_c + cos cos_c))^2`` of points
    ``x`` (N, 2A) = [sin_0..sin_{A-1}, cos_0..cos_{A-1}] to ``centres`` (K,
    2A): per angle ``(1 - cos(theta - theta_c))^2``, zero iff they coincide."""
    a = x.shape[-1] // 2
    agree = x[:, None, :a] * centres[None, :, :a] + x[:, None, a:] * centres[None, :, a:]
    return torch.square(1.0 - agree).sum(dim=-1)


def _fit(x: torch.Tensor, centres: torch.Tensor, iters: int):
    """``iters`` Lloyd steps from ``centres``: assign each point to its
    nearest centre (the first of a tie), move each centre to its points'
    mean, keep a centre that has none. Returns (centres, assignments,
    distances)."""
    k = centres.shape[0]
    # each row's count rides as a last column of ones (bincount would read the
    # largest index back to the host on the card)
    x64 = torch.cat([x.double(), torch.ones_like(x[:, :1], dtype=torch.float64)], dim=1)
    for _ in range(iters):
        assign = torch.argmin(sincos_distance(x, centres), dim=-1)
        sums = torch.zeros(k, x64.shape[1], dtype=torch.float64, device=x.device).index_add_(0, assign, x64)
        counts = sums[:, -1:].float()
        new = sums[:, :-1].float() / torch.clamp(counts, min=1.0)
        centres = torch.where(counts > 0, new, centres)
    d = sincos_distance(x, centres)
    assign = torch.argmin(d, dim=-1)
    return centres, assign, torch.gather(d, 1, assign[:, None])[:, 0]


def kmeans_sincos(x, k: int, max_iter: int = 100, nsample: int = 0, seed: int = 0,
                  device: Optional[torch.device] = None):
    """Two-pass fit: 10 iterations on a subsample (``nsample`` points, by
    default ``max(2 sqrt(N), 10 k)``) from ``k`` points drawn as the first
    centres, then ``max_iter`` on all the data. ``x`` (N, 2A), NumPy or a
    tensor; the fit runs on ``device``, by default the tensor's (the CPU for
    NumPy). Returns (centres, assignments, distances) as NumPy arrays."""
    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else torch.device("cpu")
    xs = np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x, dtype=np.float32)
    n = xs.shape[0]
    if nsample == 0:
        nsample = int(max(2 * np.sqrt(n), 10 * k))
    nsample = min(nsample, n)
    rng = np.random.default_rng(seed)
    sample = xs[rng.choice(n, size=nsample, replace=False)]
    init = xs[rng.choice(n, size=k, replace=False)]
    seeded, _, _ = _fit(torch.from_numpy(sample).to(device), torch.from_numpy(init).to(device), 10)
    centres, assign, dist = _fit(torch.from_numpy(xs).to(device), seeded, max_iter)
    return centres.cpu().numpy(), assign.cpu().numpy(), dist.cpu().numpy()
