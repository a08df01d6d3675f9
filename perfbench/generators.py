"""Seeded inputs of the benchmark: procedural shapes with labels, their
renders, the requests of the serve cells and the random draws of a step.

The shapes are the benchmark's own copy of the port's procedural generator
(``SyntheticVoxelLoader``: eight shape families, class half-extents from a
stream of their own, an instance scale, a per-sample jitter and one of four
yaw turns; ``SyntheticImageObjectLoader``'s render: the shape turned about
the vertical axis, shaded along its own +x and max-projected), computed in
bulk with torch on the device that the benchmark runs on, so that set-up makes
512 grids of 64^3 in milliseconds. The same seed gives the same arrays on
every machine that runs the same torch build; the shapes' statistics, not
their bits, are what the port's generator fixes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

SEED_MOD = 2**63 - 1  # torch.Generator seeds are below 2**64; numpy takes any


def rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for ``stream`` of ``seed`` (any whole number)."""
    return np.random.default_rng([int(seed) % SEED_MOD, stream])


def torch_generator(seed: int, stream: int, device) -> torch.Generator:
    """A torch generator on ``device`` for ``stream`` of ``seed``."""
    mixed = int(rng(seed, stream).integers(0, 2**62))
    return torch.Generator(device=device).manual_seed(mixed)


@dataclasses.dataclass
class ShapeSet:
    """``num`` seeded shapes: ``voxels`` (num, dim, dim, dim) bool on the host,
    ``labels`` and ``insts`` (num,) ints, ``azimuths`` (num,) radians."""

    voxels: np.ndarray
    labels: np.ndarray
    insts: np.ndarray
    azimuths: np.ndarray
    num_classes: int
    num_inst: int


def make_shapes(num: int, dim: int, num_classes: int, num_inst: int, seed: int, device,
                inst_spread: float = 0.15) -> ShapeSet:
    """The procedural shapes (see the module's doc), made on ``device`` in
    chunks and returned on the host."""
    r = rng(seed, 1)
    labels = r.integers(0, num_classes, num)
    insts = r.integers(0, num_inst, num)
    class_params = np.random.default_rng(12345).uniform(0.18, 0.42, size=(num_classes, 3))
    inst_scale = np.random.default_rng(54321).uniform(1.0 - inst_spread, 1.0 + inst_spread,
                                                      size=(num_classes, num_inst, 3))
    jitter = r.uniform(0.95, 1.05, size=(num, 3))
    params = (class_params[labels] * inst_scale[labels, insts] * jitter).astype(np.float32)
    rots = r.integers(0, 4, num)
    azimuths = r.uniform(-np.pi, np.pi, num)

    coords = (torch.arange(dim, device=device, dtype=torch.float32) + 0.5) / dim - 0.5
    x, y, z = torch.meshgrid(coords, coords, coords, indexing="ij")
    out = np.empty((num, dim, dim, dim), bool)
    chunk = max(1, (1 << 25) // dim**3)
    p_all = torch.as_tensor(params, device=device)
    for lo in range(0, num, chunk):
        hi = min(num, lo + chunk)
        a, b, c = (p_all[lo:hi, k].view(-1, 1, 1, 1) for k in range(3))
        fam = torch.as_tensor(labels[lo:hi] % 8, device=device).view(-1, 1, 1, 1)
        occ = torch.zeros((hi - lo, dim, dim, dim), dtype=torch.bool, device=device)
        ax, ay, az = x.abs(), y.abs(), z.abs()
        shapes = [
            (x / a) ** 2 + (y / b) ** 2 + (z / c) ** 2 <= 1.0,  # ellipsoid
            (ax <= a) & (ay <= b) & (az <= c),  # box
            ((x / a) ** 2 + (z / c) ** 2 <= 1.0) & (ay <= b),  # elliptic cylinder along y
            ((ax <= a) & (ay <= b) & (az <= c)) & ~((ax <= 0.6 * a) & (ay <= 0.6 * b) & (az <= 0.6 * c)),
            ((ax <= a) & (ay <= 0.35 * b) & (az <= 0.35 * c)) | ((ax <= 0.35 * a) & (ay <= b) & (az <= 0.35 * c))
            | ((ax <= 0.35 * a) & (ay <= 0.35 * b) & (az <= c)),  # three-axis cross of slabs
        ]
        t = ((b - y) / (2.0 * b)).clamp(0.0, 1.0)
        shapes.append((ax <= a * t) & (az <= c * t) & (ay <= b))  # wedge tapering upward in y
        ring = torch.sqrt(x**2 + z**2) - a
        shapes.append(ring**2 + (y / b.clamp(min=1e-3) * 0.4 * a) ** 2 <= (0.4 * a) ** 2)  # torus about y
        rad = 0.5 * (a + c) * 0.6
        seg = torch.maximum(torch.minimum(y, b - rad), -b + rad)
        shapes.append(x**2 + (y - seg) ** 2 + z**2 <= rad**2)  # capsule along y
        for f, s in enumerate(shapes):
            occ |= (fam == f) & s
        turns = torch.as_tensor(rots[lo:hi], device=device)
        for k in (1, 2, 3):
            sel = (turns == k).nonzero().flatten()
            if len(sel):
                occ[sel] = torch.rot90(occ[sel], k=k, dims=(1, 3))
        out[lo:hi] = occ.cpu().numpy()
    return ShapeSet(out, labels, insts, azimuths, num_classes, num_inst)


def render(shapes: ShapeSet, size: int, device) -> np.ndarray:
    """(num, size, size) uint8 renders of every shape: turned about the
    vertical axis by its azimuth (nearest neighbour), shaded from 0.35 to 1.0
    along its own +x, max-projected, resized by nearest neighbour."""
    n, d = shapes.voxels.shape[:2]
    idx = torch.arange(d, device=device, dtype=torch.float32) - d / 2 + 0.5
    gx, gz = torch.meshgrid(idx, idx, indexing="ij")
    out = np.empty((n, size, size), np.uint8)
    pick = (torch.arange(size, device=device) * d // size).long()
    for lo in range(0, n, 64):
        hi = min(n, lo + 64)
        az = torch.as_tensor(shapes.azimuths[lo:hi], device=device, dtype=torch.float32).view(-1, 1, 1)
        cos, sin = az.cos(), az.sin()
        sx = (cos * gx - sin * gz + d / 2 - 0.5).round().clamp(0, d - 1).long()
        sz = (sin * gx + cos * gz + d / 2 - 0.5).round().clamp(0, d - 1).long()
        vox = torch.as_tensor(shapes.voxels[lo:hi], device=device).float()
        b = torch.arange(hi - lo, device=device).view(-1, 1, 1)
        rot = vox[b, sx, :, sz]  # (n, x_out, z_out, y)
        shade = 0.35 + 0.65 * sx.float() / max(d - 1, 1)
        img = (rot * shade[..., None]).amax(dim=2).transpose(1, 2)  # (n, y, x_out)
        img = img[:, pick][:, :, pick]
        out[lo:hi] = (img * 255).to(torch.uint8).cpu().numpy()
    return out


class ShapeLoader:
    """The port's loader interface over a :class:`ShapeSet`, drawn in seeded
    shuffled epochs: ``getNextBatch(B)`` gives the ModelNet-style dict
    (``input_images``, ``class_list``, ``inst_list``), or with image renders
    (``renders``: size -> (num, size, size) uint8) ``getNextBatch(B,
    imageSize=(cols, rows))`` the Pascal-style 6-tuple. ``served`` records
    the rows of every batch, in the order the batches were made."""

    def __init__(self, shapes: ShapeSet, seed: int, renders: Optional[Dict[int, np.ndarray]] = None):
        self.shapes = shapes
        self.renders = renders
        self.dataLength = len(shapes.labels)
        self.epoch = 0
        self.batchStart = 0
        self._rng = rng(seed, 2)
        self._idx = self._rng.permutation(self.dataLength)
        self._eye_c = np.eye(shapes.num_classes, dtype=np.float32)
        self._eye_i = np.eye(shapes.num_inst, dtype=np.float32)
        self.served: List[np.ndarray] = []

    def _next_rows(self, b: int) -> np.ndarray:
        if self.batchStart + b > self.dataLength:
            self.epoch += 1
            self._rng.shuffle(self._idx)
            self.batchStart = 0
        sel = self._idx[self.batchStart:self.batchStart + b].copy()
        self.batchStart += b
        self.served.append(sel)
        return sel

    def getNextBatch(self, batchSize: int = 32, imageSize: Optional[Tuple[int, int]] = None):
        sel = self._next_rows(batchSize)
        vox = self.shapes.voxels[sel].astype(np.float32)[..., None]
        cls = self._eye_c[self.shapes.labels[sel]]
        inst = self._eye_i[self.shapes.insts[sel]]
        if imageSize is None:
            return {"input_images": vox, "class_list": cls, "inst_list": inst}
        cols, rows = imageSize
        if cols != rows or self.renders is None or cols not in self.renders:
            raise ValueError(f"no renders at {imageSize}")
        images = image_of(self.renders, sel, cols)
        az = self.shapes.azimuths[sel]
        euler = np.stack([az, np.zeros_like(az), np.zeros_like(az)], axis=-1)
        return inst, cls, np.sin(euler), np.cos(euler), images, vox


def image_of(renders: Dict[int, np.ndarray], rows: np.ndarray, size: int) -> np.ndarray:
    """(B, size, size, 3) float32 images in [0, 1] of ``rows`` of the renders at ``size``."""
    img = renders[size][rows].astype(np.float32) / 255.0
    return np.repeat(img[..., None], 3, axis=-1)


def missing_masks(num: int, dim: int, rates: Sequence[float], seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """``num`` latent masks of width ``dim`` (1.0 observed) and their rates:
    each mask's rate is drawn from ``rates`` and exactly ``round(rate *
    dim)`` of its dims, chosen at random, are missing."""
    r = rng(seed, 3)
    which = r.integers(0, len(rates), num)
    masks = np.ones((num, dim), np.float32)
    for i in range(num):
        k = int(round(rates[which[i]] * dim))
        masks[i, r.permutation(dim)[:k]] = 0.0
    return masks, np.asarray(rates, np.float64)[which]


def step_draws(cfg: dict, batch: int, seed: int, step: int, device) -> Dict[str, torch.Tensor]:
    """The random draws of train step ``step`` (``train/step.py``'s names),
    made on ``device`` from the seed: the posterior noise, the prior samples'
    noise, the mix's coin and element mask. ``dropout_seed`` seeds the
    generator the prior nets' dropout draws from (not a draw of ``draws``:
    the step takes it as its generator)."""
    model, loss = cfg["model"], cfg["loss"]
    g = torch_generator(seed, 1000 + step, device)
    zc, zi = model["z_category_dim"], model["z_inst_dim"]
    out: Dict[str, torch.Tensor] = {}
    if zc and zi:
        out["eps_cat"] = torch.randn((batch, zc), generator=g, device=device)
        out["eps_inst"] = torch.randn((batch, zi), generator=g, device=device)
    else:
        out["eps_inst"] = torch.randn((batch, zc + zi), generator=g, device=device)
    if model.get("prior_category"):
        out["eps_prior_cat"] = torch.randn((batch, model["prior_category"]["unit_nums"][-1]), generator=g,
                                           device=device)
    if model.get("prior_inst"):
        out["eps_prior_inst"] = torch.randn((batch, model["prior_inst"]["unit_nums"][-1]), generator=g,
                                            device=device)
    out["coin"] = torch.rand((), generator=g, device=device) < loss["mix_coin_prob"]
    out["take_prior"] = torch.rand((batch, zc + zi), generator=g, device=device) < loss["mix_element_prob"]
    return out


def dropout_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s dropout generator."""
    return int(rng(seed, 2000 + step).integers(0, 2**62))


def weights(spec: Dict[str, Tuple[Tuple[int, ...], str, int]], seed: int, device) -> Dict[str, torch.Tensor]:
    """Seeded float32 weights for ``spec`` (name -> (shape, kind, fan_in)):
    kernels ('kernel') normal with variance 1/fan_in, cut at two standard
    deviations, from one draw on ``device``; norm scales ('ones') 1, biases
    ('zeros') 0, as the port's initialiser leaves them."""
    g = torch_generator(seed, 4, device)
    kernels = [(n, s, f) for n, (s, k, f) in spec.items() if k == "kernel"]
    total = sum(math.prod(s) for _, s, _ in kernels)
    flat = torch.randn(total, generator=g, device=device).clamp_(-2.0, 2.0)
    out, off = {}, 0
    for name, shape, fan_in in kernels:
        n = math.prod(shape)
        out[name] = flat[off:off + n].view(shape).mul(1.0 / (0.8796256610342398 * math.sqrt(fan_in)))
        off += n
    for name, (shape, kind, _) in spec.items():
        if kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
    return {n: out[n] for n in spec}
