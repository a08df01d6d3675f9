"""Host loaders of voxel batches: the pre-voxelized ModelNet shards, and
procedural shapes for tests, smoke runs and dataset-free training.

Counterpart of ``anytime3d_tpu/data/modelnet.py``, NumPy only.
``ModelNetLoader`` reads the shard triples ``{i}Full.npy`` / ``{i}Class.npy``
/ ``{i}Inst.npy`` under ``32to64_4rot_64sqr/{train,test}`` and gives, at the
same seed, the same batches as the JAX loader; with ``partial_num=None`` it
reads the shard indices present on disk, whether or not they are contiguous.
``SyntheticVoxelLoader`` gives the same batches as the JAX package's at the
same seed, and ``SyntheticImageObjectLoader`` renders them to images in the
Pascal loader's tuple form, the same arrays as the JAX loader's;
``SyntheticMultiObjectLoader`` pastes several renders into one scene with its
grid targets, the same batches as the JAX loader's. With
``structural_inst=True`` the voxel and image loaders draw the part-based
instance shapes of ``data/instances.py`` (voxelized natively; the loader
raises where the native voxelizer cannot be built), the same grids as the JAX
package's native ones.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np


def _shard_indices(base: str) -> List[int]:
    """The indices ``i`` of the ``{i}Full.npy`` shards under ``base``, sorted."""
    found = sorted(int(m.group(1)) for name in (os.listdir(base) if os.path.isdir(base) else ())
                   if (m := re.fullmatch(r"(\d+)Full\.npy", name)))
    if not found:
        raise FileNotFoundError(f"no *Full.npy shards under {base}")
    return found


class ModelNetLoader:
    """Pre-voxelized ModelNet shards, copied whole into host memory, drawn in
    seeded shuffled epochs.

    ``getNextBatch(batchSize)`` -> ``input_images`` (B, 64, 64, 64, 1),
    ``class_list`` (B, 40) and ``inst_list`` one-hots, all float32; ``epoch``,
    ``batchStart`` and ``dataLength`` for progress. ``partial_num``: the
    number of train shards to read, indices 0.. (the reference's 30; the test
    split has 5); None reads every shard present. ``process_index`` of
    ``process_count`` reads every ``process_count``-th of those shards from
    its own, and shuffles with ``seed + process_index``: a host's part of the
    data for a loader a host."""

    def __init__(self, data_path: str, train_or_test: str = "train", partial_num: Optional[int] = 30,
                 process_index: int = 0, process_count: int = 1, seed: int = 0):
        self.epoch = 0
        self.batchStart = 0
        self._rng = np.random.default_rng(seed + process_index)
        split = "train" if train_or_test == "train" else "test"
        base = os.path.join(data_path, "32to64_4rot_64sqr", split)
        if partial_num is None:
            indices = _shard_indices(base)
        else:
            indices = list(range(partial_num if split == "train" else 5))
        parts: Dict[str, list] = {"Full": [], "Class": [], "Inst": []}
        for i in indices[process_index::process_count]:
            for kind, arrays in parts.items():
                path = os.path.join(base, f"{i}{kind}.npy")
                if not os.path.exists(path):
                    raise FileNotFoundError(f"shard {i} under {base} has no {i}{kind}.npy")
                arrays.append(np.load(path, mmap_mode="r"))
        self._vox, self._cls, self._inst = (np.concatenate(parts[k], axis=0) for k in ("Full", "Class", "Inst"))
        self.dataLength = len(self._vox)
        self._idx = np.arange(self.dataLength)
        self._shuffle()

    def _shuffle(self):
        self._rng.shuffle(self._idx)
        self.batchStart = 0

    def getNextBatch(self, batchSize: int = 32) -> Dict[str, np.ndarray]:
        if self.batchStart + batchSize > self.dataLength:
            self.epoch += 1
            self._shuffle()
        sel = self._idx[self.batchStart : self.batchStart + batchSize]
        self.batchStart += batchSize
        vox = np.ascontiguousarray(self._vox[sel]).astype(np.float32)
        if vox.ndim == 4:
            vox = vox[..., None]
        return {
            "input_images": vox,
            "class_list": np.ascontiguousarray(self._cls[sel]).astype(np.float32),
            "inst_list": np.ascontiguousarray(self._inst[sel]).astype(np.float32),
        }


def _jitter_zoom(grid: np.ndarray, factors) -> np.ndarray:
    """Anisotropic nearest-neighbour rescale of a cubic grid about its center
    by ``factors`` (one an axis, each about 1): the per-sample jitter of the
    structural instance shapes."""
    d = grid.shape[0]
    c = (d - 1) / 2.0
    idx = [np.clip(np.round((np.arange(d) - c) / f + c), 0, d - 1).astype(int)
           for f in np.asarray(factors, np.float64)]
    return grid[np.ix_(idx[0], idx[1], idx[2])]


class SyntheticVoxelLoader:
    """Procedural shapes behind the ModelNet loader's interface:
    ``getNextBatch(batchSize)`` -> ``input_images`` (B, dim, dim, dim, 1),
    ``class_list`` (B, num_classes) and ``inst_list`` (B, num_inst) one-hots,
    all float32; ``epoch``, ``batchStart`` and ``dataLength`` for progress.

    Class-informative by construction: each class owns one of 8 shape families
    and class-specific half-extents; each instance scales those by a fixed
    factor within ``1 +- inst_spread``; each sample adds a small jitter and
    one of 4 yaw rotations. All voxels are generated at construction.

    ``structural_inst=True`` takes each sample's base shape from
    ``data/instances.py::instance_grid`` (class, instance): instances then
    differ in structure (leg count, shade, wings...), not only in scale;
    each sample rescales it by its jitter over the mean of its three
    extents, then turns it. Those grids are voxelized natively: construction
    raises RuntimeError where the native voxelizer cannot be built."""

    def __init__(self, num_samples: int = 512, dim: int = 64, num_classes: int = 40, num_inst: int = 10,
                 seed: int = 0, inst_spread: float = 0.15, structural_inst: bool = False):
        self.epoch = 0
        self.batchStart = 0
        self.dataLength = num_samples
        self._dim = dim
        self._num_classes = num_classes
        self._num_inst = num_inst
        self._structural = structural_inst
        rng = np.random.default_rng(seed)
        self._labels = rng.integers(0, num_classes, num_samples)
        self._insts = rng.integers(0, num_inst, num_samples)
        # class and instance extents come from streams of their own, shared
        # by every loader whatever its seed
        class_params = np.random.default_rng(12345).uniform(0.18, 0.42, size=(num_classes, 3))
        inst_scale = np.random.default_rng(54321).uniform(
            1.0 - inst_spread, 1.0 + inst_spread, size=(num_classes, num_inst, 3)
        )
        jitter = rng.uniform(0.95, 1.05, size=(num_samples, 3))
        self._params = (
            class_params[self._labels] * inst_scale[self._labels, self._insts] * jitter
        ).astype(np.float32)
        self._rots = rng.integers(0, 4, num_samples)
        self._idx = np.arange(num_samples)
        self._rng = rng
        coords = (np.arange(dim) + 0.5) / dim - 0.5
        self._grid = np.stack(np.meshgrid(coords, coords, coords, indexing="ij"), -1)
        self._cache = np.stack([self._generate(i) for i in range(num_samples)]).astype(bool)

    def _generate(self, i: int) -> np.ndarray:
        """Occupancy of sample i: family = class % 8 (or the structural
        instance shape), rotated by the sample's yaw quarter-turns."""
        if self._structural:
            from anytime3d_tpu_torch.data.instances import instance_grid

            base = instance_grid(int(self._labels[i]), int(self._insts[i]), self._dim)
            occ = _jitter_zoom(base, self._params[i] / self._params[i].mean())
            k = int(self._rots[i])
            if k:
                occ = np.rot90(occ, k=k, axes=(0, 2)).copy()
            return occ.astype(np.float32)
        a, b, c = self._params[i]
        g = self._grid
        x, y, z = g[..., 0], g[..., 1], g[..., 2]
        family = int(self._labels[i]) % 8
        if family == 0:  # ellipsoid
            occ = (x / a) ** 2 + (y / b) ** 2 + (z / c) ** 2 <= 1.0
        elif family == 1:  # box
            occ = (np.abs(x) <= a) & (np.abs(y) <= b) & (np.abs(z) <= c)
        elif family == 2:  # elliptic cylinder along y
            occ = ((x / a) ** 2 + (z / c) ** 2 <= 1.0) & (np.abs(y) <= b)
        elif family == 3:  # hollow box
            outer = (np.abs(x) <= a) & (np.abs(y) <= b) & (np.abs(z) <= c)
            inner = (np.abs(x) <= 0.6 * a) & (np.abs(y) <= 0.6 * b) & (np.abs(z) <= 0.6 * c)
            occ = outer & ~inner
        elif family == 4:  # three-axis cross of slabs
            t = 0.35
            sx = (np.abs(x) <= a) & (np.abs(y) <= t * b) & (np.abs(z) <= t * c)
            sy = (np.abs(x) <= t * a) & (np.abs(y) <= b) & (np.abs(z) <= t * c)
            sz = (np.abs(x) <= t * a) & (np.abs(y) <= t * b) & (np.abs(z) <= c)
            occ = sx | sy | sz
        elif family == 5:  # wedge tapering upward in y
            t = np.clip((b - y) / (2.0 * b), 0.0, 1.0)
            occ = (np.abs(x) <= a * t) & (np.abs(z) <= c * t) & (np.abs(y) <= b)
        elif family == 6:  # torus about y
            ring = np.sqrt(x**2 + z**2) - a
            occ = ring**2 + (y / max(b, 1e-3) * 0.4 * a) ** 2 <= (0.4 * a) ** 2
        else:  # capsule along y
            r = 0.5 * (a + c) * 0.6
            seg = np.clip(y, -b + r, b - r)
            occ = x**2 + (y - seg) ** 2 + z**2 <= r**2
        occ = occ.astype(np.float32)
        k = int(self._rots[i])
        if k:
            occ = np.rot90(occ, k=k, axes=(0, 2)).copy()
        return occ

    def getNextBatch(self, batchSize: int = 32) -> Dict[str, np.ndarray]:
        if self.batchStart + batchSize > self.dataLength:
            self.epoch += 1
            self._rng.shuffle(self._idx)
            self.batchStart = 0
        sel = self._idx[self.batchStart : self.batchStart + batchSize]
        self.batchStart += batchSize
        vox = self._cache[sel].astype(np.float32)[..., None]
        cls = np.eye(self._num_classes, dtype=np.float32)[self._labels[sel]]
        inst = np.eye(self._num_inst, dtype=np.float32)[self._insts[sel]]
        return {"input_images": vox, "class_list": cls, "inst_list": inst}


class SyntheticImageObjectLoader(SyntheticVoxelLoader):
    """The procedural shapes behind the Pascal single-object loader's
    interface: ``getNextBatch(batchSizeof3DShape, imageSize=(cols, rows))``
    -> the tuple ``(inst, cls, sin, cos, images, voxels)``: one-hots (B,
    num_inst) and (B, num_classes), the sine and cosine of the (azimuth, 0, 0)
    Euler angles (B, 3), images (B, rows, cols, 3) float32 in [0, 1] and
    voxels (B, dim, dim, dim, 1) float32. ``dataStart`` tracks progress as the
    Pascal loader's does.

    Each sample has a fixed azimuth; its image is the shape turned about the
    vertical axis (nearest neighbour), shaded brighter along its own +x axis
    (0.35 -> 1.0, so that the image shows which way it faces) and max-projected.
    Renders are kept as uint8 by (sample, image size), so after one epoch at a
    size a batch renders nothing."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.dataStart = 0
        self._azimuths = np.random.default_rng(kwargs.get("seed", 0) + 1).uniform(-np.pi, np.pi, self.dataLength)
        self._render_cache: Dict[Tuple[int, Tuple[int, int]], np.ndarray] = {}

    def _render(self, vox: np.ndarray, azimuth: float, image_size) -> np.ndarray:
        """(rows, cols, 3) float32 render of one (dim, dim, dim) grid; ``image_size`` is (cols, rows)."""
        d = vox.shape[0]
        c, s = np.cos(azimuth), np.sin(azimuth)
        idx = np.arange(d) - d / 2 + 0.5
        gx, gz = np.meshgrid(idx, idx, indexing="ij")
        sx = np.clip(np.round(c * gx - s * gz + d / 2 - 0.5), 0, d - 1).astype(int)
        sz = np.clip(np.round(s * gx + c * gz + d / 2 - 0.5), 0, d - 1).astype(int)
        rot = vox[sx, :, sz]  # (x_out, z_out, y): the index arrays' dims come first
        w = (0.35 + 0.65 * sx / max(d - 1, 1)).astype(np.float32)
        rot = rot * w[:, :, None]
        img = rot.max(axis=2).T.astype(np.float32)  # (rows=y, cols=x)
        out_c, out_r = image_size
        ys = (np.arange(out_r) * d // out_r).astype(int)
        xs = (np.arange(out_c) * d // out_c).astype(int)
        img = img[ys][:, xs]
        return np.stack([img] * 3, axis=-1)

    def _render_cached(self, i: int, vox: np.ndarray, azimuth: float, image_size) -> np.ndarray:
        mono = self._render_cache.get((i, image_size))
        if mono is None:
            mono = (self._render(vox, azimuth, image_size)[..., 0] * 255).astype(np.uint8)
            self._render_cache[(i, image_size)] = mono
        img = mono.astype(np.float32) / 255.0
        return np.stack([img] * 3, axis=-1)

    def getNextBatch(self, batchSizeof3DShape: int = 32, imageSize=(64, 64)):
        if self.batchStart + batchSizeof3DShape > self.dataLength:
            self.epoch += 1
            self._rng.shuffle(self._idx)
            self.batchStart = 0
        sel = self._idx[self.batchStart : self.batchStart + batchSizeof3DShape]
        self.batchStart += batchSizeof3DShape
        self.dataStart = self.batchStart
        vox = self._cache[sel].astype(np.float32)
        az = self._azimuths[sel]
        images = np.stack([self._render_cached(int(i), v, a, tuple(imageSize)) for i, v, a in zip(sel, vox, az)])
        euler = np.stack([az, np.zeros_like(az), np.zeros_like(az)], axis=-1)
        cls = np.eye(self._num_classes, dtype=np.float32)[self._labels[sel]]
        inst = np.eye(self._num_inst, dtype=np.float32)[self._insts[sel]]
        return inst, cls, np.sin(euler), np.cos(euler), images, vox[..., None]


def _extents(vox: np.ndarray) -> np.ndarray:
    """(3,) float32: the occupied span of a (d, d, d) grid along each axis, in
    voxels (max index - min index + 1), 1 along an axis with nothing occupied."""
    occ = vox > 0.5
    ext = []
    for axis in range(3):
        hit = np.nonzero(occ.any(axis=tuple(a for a in range(3) if a != axis)))[0]
        ext.append(hit[-1] - hit[0] + 1 if len(hit) else 1)
    return np.array(ext, np.float32)


class SyntheticMultiObjectLoader(SyntheticVoxelLoader):
    """Synthetic scenes behind the multi-object Pascal loader's interface:
    ``getNextBatch(B) -> (images, grid_targets, voxel_lists)``: images (B,
    rows, cols, 3) float32, the stacked ``build_grid_targets`` dicts and each
    image's list of (n, dim, dim, dim, 1) voxels. Each image holds 1 to
    ``max_objects`` procedural shapes, rendered at random azimuths, sizes and
    places and max-pasted; each object's metric (w, h, l) is its occupied
    extent at a nominal 4 m scale. The same batches as the JAX loader's at the
    same seed."""

    def __init__(self, num_samples: int = 512, dim: int = 32, num_classes: int = 8, num_inst: int = 10,
                 image_size=(128, 96), grid_size=(4, 3), predictors_per_cell: int = 5, max_objects: int = 3,
                 seed: int = 0):
        super().__init__(num_samples, dim, num_classes, num_inst, seed)
        self.dataStart = 0
        self._image_size = image_size
        self._grid_size = grid_size
        self._p = predictors_per_cell
        self._max_obj = max_objects

    def getNextBatch(self, batchSize: int = 8):
        from anytime3d_tpu_torch.data.pascal3d import build_grid_targets

        out_c, out_r = self._image_size
        images, targets_list, voxel_lists = [], [], []
        for _ in range(batchSize):
            if self.batchStart >= self.dataLength:
                self.epoch += 1
                self._rng.shuffle(self._idx)
                self.batchStart = 0
            img = np.zeros((out_r, out_c, 3), np.float32)
            objs, voxels = [], []
            for _k in range(int(self._rng.integers(1, self._max_obj + 1))):
                i = self._idx[self.batchStart % self.dataLength]
                self.batchStart += 1
                vox = self._cache[i].astype(np.float32)
                az = float(self._rng.uniform(-np.pi, np.pi))
                h = int(self._rng.integers(out_r // 4, out_r // 2 + 1))
                w = int(self._rng.integers(out_c // 4, out_c // 2 + 1))
                r0 = int(self._rng.integers(0, out_r - h + 1))
                c0 = int(self._rng.integers(0, out_c - w + 1))
                region = img[r0 : r0 + h, c0 : c0 + w]
                np.maximum(region, SyntheticImageObjectLoader._render(self, vox, az, (w, h)), out=region)
                ext = _extents(vox) / vox.shape[0]
                objs.append({
                    "bbox": np.array([c0 / out_c, r0 / out_r, (c0 + w) / out_c, (r0 + h) / out_r], np.float32),
                    "euler_rad": (az, 0.0, 0.0),
                    "inst_onehot": np.eye(self._num_inst, dtype=np.float32)[self._insts[i]],
                    "voxel_index": len(voxels),
                    "bbox3d_whl": np.array([ext[2], ext[1], ext[0]], np.float32) * 4.0,
                })
                voxels.append(vox[..., None])
            images.append(img)
            targets_list.append(build_grid_targets(objs, self._grid_size, self._p))
            voxel_lists.append(np.stack(voxels))
        self.dataStart = self.batchStart
        targets = {k: np.stack([t[k] for t in targets_list]) for k in targets_list[0]}
        return np.stack(images), targets, voxel_lists
