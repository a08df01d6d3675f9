"""ImageNet-style classification loader for backbone pretraining.

Counterpart of ``anytime3d_tpu/data/imagenet.py``: a directory of one
subdirectory a class (sorted names give the class index), its image files
(``_IMG_EXTS``) read by ``cv2.imread`` (BGR) and warped with the
photometric jitter by ``data/augment.py``. At the same seed it gives the
JAX loader's labels and images.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np

from anytime3d_tpu_torch.data.augment import image_random_augmentation
from anytime3d_tpu_torch.data.imread import imread_color

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


class ImagenetLoader:
    """``getNextBatch(batchSize, imageSize=(cols, rows))`` -> ``(images (B,
    rows, cols, 3) in [0, 1], labels (B, class_num) one-hot)``, in seeded
    shuffled epochs; an image that cannot be read is left out of its batch."""

    def __init__(self, data_path: str, seed: int = 0, workers: int = 8):
        self.epoch = 0
        self.dataStart = 0
        self._rng = np.random.default_rng(seed)
        classes = sorted(d for d in os.listdir(data_path) if os.path.isdir(os.path.join(data_path, d)))
        self.class_index = {c: i for i, c in enumerate(classes)}
        self.class_num = len(classes)
        self._records = []
        for c in classes:
            croot = os.path.join(data_path, c)
            for f in os.listdir(croot):
                if f.lower().endswith(_IMG_EXTS):
                    self._records.append((os.path.join(croot, f), self.class_index[c]))
        self.dataLength = len(self._records)
        self._order = np.arange(self.dataLength)
        self._rng.shuffle(self._order)
        self._pool = ThreadPoolExecutor(max_workers=workers)

    def _load_one(self, path: str, image_size: Tuple[int, int], seed: int):
        rng = np.random.default_rng(seed)
        img = imread_color(path)
        if img is None:
            return None
        out_c, out_r = image_size
        img, _ = image_random_augmentation(rng, img, (out_c, out_r), augmentation=True, add_noise=True)
        return img / 255.0

    def getNextBatch(self, batchSize=64, imageSize=(224, 224)):
        picked = []
        while len(picked) < batchSize:
            if self.dataStart >= self.dataLength:
                self.epoch += 1
                self.dataStart = 0
                self._rng.shuffle(self._order)
            picked.append(self._records[self._order[self.dataStart]])
            self.dataStart += 1
        seeds = self._rng.integers(0, 2**31 - 1, len(picked))
        loaded = list(self._pool.map(lambda ps: self._load_one(ps[0][0], imageSize, ps[1]), zip(picked, seeds)))
        images, labels = [], []
        for (_path, label), img in zip(picked, loaded):
            if img is not None:
                images.append(img)
                labels.append(label)
        onehot = np.eye(self.class_num, dtype=np.float32)[np.array(labels)]
        return np.stack(images).astype(np.float32), onehot

    def close(self) -> None:
        """Stop the loader's thread pool."""
        self._pool.shutdown(wait=True)
