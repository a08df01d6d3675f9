"""Sparse feature front end: Harris corners, patch descriptors, NCC matching.

Counterpart of ``anytime3d_tpu/geometry/features.py``. Every output has a
fixed capacity (``max_keypoints`` slots and a validity mask), so nothing
depends on the data's shape: detection is shifted sums and elementwise
math, the descriptors one indexed gather, and matching one dense
``desc_a @ desc_b.T`` correlation.

Ties are broken as the JAX functions break them. The top K corners come
from a stable descending sort, so among equal scores (the many -inf slots
of a frame with fewer corners than K among them) the lower pixel index
comes first, as in ``jax.lax.top_k``; ``torch.topk`` promises no order for
ties. ``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does.
For ties to stay ties, every pixel's response must be summed in the same
order: the SAME convolutions are sums of shifted copies of the frame, term
by term, in float32 elementwise products and additions. ``F.conv2d`` sums
in an order that varies along a row (on the CPU), which broke the equal
responses of a checkerboard's corners into distinct ones and reordered
them; the elementwise sums also give the card the CPU's bits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["harris_response", "detect_keypoints", "extract_descriptors", "match_descriptors", "Keypoints",
           "Matches"]


class Keypoints(NamedTuple):
    """A fixed-capacity keypoint set of one frame."""

    rowcol: torch.Tensor  # (K, 2) int32 (row, col); 0 where invalid
    score: torch.Tensor  # (K,) response; -inf where invalid
    valid: torch.Tensor  # (K,) bool


class Matches(NamedTuple):
    """A fixed-capacity set of correspondences between two frames."""

    index_a: torch.Tensor  # (K,) int32 index into frame A's keypoints
    index_b: torch.Tensor  # (K,) int32 index into frame B's keypoints
    score: torch.Tensor  # (K,) NCC in [-1, 1]; 0 where invalid
    valid: torch.Tensor  # (K,) bool


def _to_gray(image: torch.Tensor) -> torch.Tensor:
    if image.dim() == 3:
        image = image.mean(dim=-1)
    return image.float()


def _conv2(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """SAME cross-correlation of one (H, W) channel with a float32 kernel:
    the sum over the kernel's nonzero taps, in row-major order, of the
    zero-padded frame shifted by the tap times its weight. A k-wide kernel
    pads (k-1)//2 below and k//2 above, as XLA's SAME does."""
    kh, kw = kernel.shape
    h, w = img.shape
    x = F.pad(img, ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
    acc = None
    for i in range(kh):
        for j in range(kw):
            if kernel[i, j] != 0:
                term = x[i:i + h, j:j + w] * float(kernel[i, j])
                acc = term if acc is None else acc + term
    return acc


def harris_response(image: torch.Tensor, k: float = 0.04, window: int = 5) -> torch.Tensor:
    """The Harris response map: Sobel gradients, the structure tensor
    box-filtered over ``window``, det(M) - k trace(M)^2."""
    img = _to_gray(image)
    sobel = np.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], np.float32)
    ix = _conv2(img, sobel)
    iy = _conv2(img, sobel.T)
    box = np.ones((window, window), np.float32) / np.float32(window * window)
    sxx, syy, sxy = _conv2(ix * ix, box), _conv2(iy * iy, box), _conv2(ix * iy, box)
    tr = sxx + syy
    return (sxx * syy - sxy * sxy) - k * tr * tr


def detect_keypoints(image: torch.Tensor, max_keypoints: int = 256, nms_radius: int = 4, threshold: float = 1e-6,
                     border: int = 8) -> Keypoints:
    """The top ``max_keypoints`` Harris corners after radius NMS: a pixel
    survives where it equals the maximum of its (2r+1)^2 window (``-inf``
    beyond the frame), exceeds ``threshold`` and lies ``border`` pixels
    inside the frame."""
    resp = harris_response(image)
    h, w = resp.shape
    win = 2 * nms_radius + 1
    local_max = F.max_pool2d(resp[None, None], win, stride=1, padding=nms_radius)[0, 0]
    rows = torch.arange(h, device=resp.device)[:, None]
    cols = torch.arange(w, device=resp.device)[None, :]
    inside = (rows >= border) & (rows < h - border) & (cols >= border) & (cols < w - border)
    keep = (resp >= local_max) & (resp > threshold) & inside
    masked = torch.where(keep, resp, torch.full_like(resp, float("-inf")))
    score, flat_idx = torch.sort(masked.reshape(-1), descending=True, stable=True)
    score, flat_idx = score[:max_keypoints], flat_idx[:max_keypoints]
    valid = torch.isfinite(score)
    rc = torch.stack([flat_idx // w, flat_idx % w], dim=-1).to(torch.int32)
    rc = torch.where(valid[:, None], rc, torch.zeros_like(rc))
    return Keypoints(rowcol=rc, score=score, valid=valid)


def extract_descriptors(image: torch.Tensor, keypoints: Keypoints, patch: int = 8) -> torch.Tensor:
    """(K, patch * patch) descriptors: the ``patch`` x ``patch`` window about
    each keypoint (clamped into the frame), zero-meaned and L2-normalised, so
    that a dot product of two is the NCC of their patches; zero where invalid.
    One indexed gather takes every patch."""
    img = _to_gray(image)
    h, w = img.shape
    half = patch // 2
    rc = keypoints.rowcol.long()
    r0 = torch.clamp(rc[:, 0] - half, 0, h - patch)
    c0 = torch.clamp(rc[:, 1] - half, 0, w - patch)
    offs = torch.arange(patch, device=img.device)
    d = img[(r0[:, None] + offs)[:, :, None], (c0[:, None] + offs)[:, None, :]].reshape(rc.shape[0], -1)
    d = d - d.mean(dim=-1, keepdim=True)
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-6)
    return torch.where(keypoints.valid[:, None], d, torch.zeros_like(d))


def match_descriptors(desc_a: torch.Tensor, desc_b: torch.Tensor, valid_a: torch.Tensor, valid_b: torch.Tensor,
                      min_score: float = 0.7, ratio: float = 0.95) -> Matches:
    """Mutual nearest neighbours by NCC with Lowe's ratio test, one slot per
    keypoint of frame A."""
    neg = float("-inf")
    corr = desc_a @ desc_b.T
    corr = torch.where(valid_a[:, None] & valid_b[None, :], corr, torch.full_like(corr, neg))
    best_score, best_b = corr.max(dim=1).values, torch.argmax(corr, dim=1)
    row_idx = torch.arange(desc_a.shape[0], device=corr.device)
    second = corr.index_put((row_idx, best_b), torch.tensor(neg, device=corr.device)).max(dim=1).values
    mutual = torch.argmax(corr, dim=0)[best_b] == row_idx
    # the ratio in distance: |a - b|^2 = 2 - 2 ncc for unit vectors
    d1 = torch.sqrt(torch.clamp(2.0 - 2.0 * best_score, min=0.0))
    d2 = torch.sqrt(torch.clamp(2.0 - 2.0 * second, min=0.0))
    valid = mutual & (best_score >= min_score) & (d1 <= ratio * torch.clamp(d2, min=1e-6)) & valid_a
    return Matches(index_a=row_idx.to(torch.int32), index_b=best_b.to(torch.int32),
                   score=torch.where(valid, best_score, torch.zeros_like(best_score)), valid=valid)
