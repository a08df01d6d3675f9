"""KITTI per-object loader: car crops of KITTI frames with a CAD instance
label, orientation and the instance's 64^3 voxels.

Counterpart of ``anytime3d_tpu/data/kitti.py`` (whose interface the JAX
package reconstructed from the reference's call sites): frames are read by
``cv2.imread`` (BGR, as the JAX loader reads them) and warped by
``data/augment.py``. At the same seed it gives the JAX loader's records,
labels, voxels and images. Layout (KITTI object detection):

  <root>/training/image_2/<frame>.png
  <root>/training/label_2/<frame>.txt   # type trunc occl alpha x0 y0 x1 y1 h w l x y z ry

and ``cad_path``, a directory of 10 car voxel models (.npy, 64^3; Pascal3D's
``CAD/car`` works). KITTI has no CAD annotation: each box takes the CAD
whose voxel extent's (w/l, h/l) aspect is nearest its own.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as np

from anytime3d_tpu_torch.data.augment import image_random_augmentation
from anytime3d_tpu_torch.data.imread import imread_color


class KittiSingleObjectLoader:
    """``getNextBatch(batchSizeof3DShape, imageSize=(cols, rows))`` ->
    ``(inst_onehot, sin_euler, cos_euler, images, voxels)``, the reference's
    5-tuple: images (B, rows, cols, 3) in [0, 1], BGR. The last
    ``val_fraction`` of the sorted frames (at least one) is the val split;
    boxes of ``classes`` at least ``min_height_px`` tall are the records."""

    def __init__(self, kitti_path: str, cad_path: str, trainOrVal: str = "train", val_fraction: float = 0.1,
                 min_height_px: float = 25.0, classes: Tuple[str, ...] = ("Car",), seed: int = 0, workers: int = 8):
        self.epoch = 0
        self.dataStart = 0
        self._root = kitti_path
        self._rng = np.random.default_rng(seed)
        self._split = trainOrVal
        self._classes = classes
        self._min_h = min_height_px
        files = sorted(f for f in os.listdir(cad_path) if f.endswith(".npy"))[:10]
        self.cad_shapes = np.stack([
            (np.load(os.path.join(cad_path, f)).reshape(64, 64, 64, 1) > 0).astype(np.float32) for f in files])
        self._cad_aspects = self._compute_cad_aspects()
        self._records = self._build_records(val_fraction)
        self.dataLength = len(self._records)
        self._order = np.arange(self.dataLength)
        self._rng.shuffle(self._order)
        self._pool = ThreadPoolExecutor(max_workers=workers)

    def _compute_cad_aspects(self) -> np.ndarray:
        """(10, 2) (w/l, h/l) of each CAD's occupied voxel extent."""
        aspects = []
        for vox in self.cad_shapes:
            occ = np.nonzero(vox[..., 0] > 0.5)
            d, h, w = np.array([o.max() - o.min() + 1 for o in occ], np.float32)
            aspects.append([w / max(d, 1.0), h / max(d, 1.0)])
        return np.array(aspects, np.float32)

    def _build_records(self, val_fraction: float) -> List[dict]:
        label_dir = os.path.join(self._root, "training", "label_2")
        image_dir = os.path.join(self._root, "training", "image_2")
        frames = sorted(f[:-4] for f in os.listdir(label_dir) if f.endswith(".txt"))
        n_val = max(1, int(len(frames) * val_fraction))
        frames = frames[:-n_val] if self._split == "train" else frames[-n_val:]
        records = []
        for frame in frames:
            with open(os.path.join(label_dir, frame + ".txt")) as fh:
                for line in fh:
                    p = line.strip().split(" ")
                    if p[0] not in self._classes:
                        continue
                    x0, y0, x1, y1 = map(float, p[4:8])
                    if y1 - y0 < self._min_h:
                        continue
                    h, w, l = map(float, p[8:11])
                    records.append({
                        "image": os.path.join(image_dir, frame + ".png"),
                        "bbox": (x0, y0, x1, y1),
                        "hwl": (h, w, l),
                        # the observation angle as azimuth; no elevation or in-plane labels
                        "euler": (float(p[3]), 0.0, 0.0),
                        "inst": self._match_instance(h, w, l),
                    })
        return records

    def _match_instance(self, h: float, w: float, l: float) -> int:
        """The CAD nearest the box's (w/l, h/l): the 10-way instance label."""
        q = np.array([w / max(l, 1e-3), h / max(l, 1e-3)], np.float32)
        return int(np.argmin(np.sum((self._cad_aspects - q) ** 2, axis=-1)))

    def _load_one(self, rec: dict, image_size, seed: int):
        rng = np.random.default_rng(seed)
        img = imread_color(rec["image"])
        if img is None:
            return None
        rows, cols = img.shape[:2]
        x0, y0, x1, y1 = rec["bbox"]
        w, h = x1 - x0, y1 - y0
        train = self._split == "train"
        border = rng.random() * 0.2 if train else 0.1
        x0, y0 = max(0, x0 - w * border), max(0, y0 - h * border)
        x1, y1 = min(cols, x1 + w * border), min(rows, y1 + h * border)
        crop = img[int(y0):int(y1), int(x0):int(x1)]
        if crop.size == 0:
            return None
        azimuth, elevation, inplane = rec["euler"]
        if train and rng.random() > 0.5:
            crop = crop[:, ::-1]
            azimuth = -azimuth
        out_c, out_r = image_size
        crop, _ = image_random_augmentation(rng, np.ascontiguousarray(crop), (out_c, out_r), augmentation=train,
                                            add_noise=train, pad_to_aspect=False)
        inst_vec = np.zeros(10, np.float32)
        inst_vec[rec["inst"]] = 1.0
        return crop / 255.0, self.cad_shapes[rec["inst"]], inst_vec, np.array([azimuth, elevation, inplane],
                                                                               np.float32)

    def getNextBatch(self, batchSizeof3DShape=32, imageSize=(64, 64)):
        picked = []
        while len(picked) < batchSizeof3DShape:
            if self.dataStart >= self.dataLength:
                self.epoch += 1
                self.dataStart = 0
                self._rng.shuffle(self._order)
            picked.append(self._records[self._order[self.dataStart]])
            self.dataStart += 1
        seeds = self._rng.integers(0, 2**31 - 1, len(picked))
        results = [r for r in self._pool.map(lambda ps: self._load_one(ps[0], imageSize, ps[1]), zip(picked, seeds))
                   if r is not None]
        images = np.stack([r[0] for r in results]).astype(np.float32)
        voxels = np.stack([r[1] for r in results]).astype(np.float32)
        inst = np.stack([r[2] for r in results])
        euler = np.stack([r[3] for r in results])
        return inst, np.sin(euler), np.cos(euler), images, voxels

    def close(self) -> None:
        """Stop the loader's thread pool."""
        self._pool.shutdown(wait=True)
