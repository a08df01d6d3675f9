"""Pascal3D+ loaders: per-object crops (single object) and YOLO-grid batches
of whole images (multi object), and their grid targets.

Counterpart of ``anytime3d_tpu/data/pascal3d.py``: images are read by
``cv2.imread`` (BGR, as the JAX loaders read them) and warped by
``data/augment.py``. At the same seed the loaders give the JAX loaders'
records, labels, voxels, grid targets and images. On-disk layout:

  Image_sets/<dataset>/<class>_<split>.txt       datapoint lists
  training_data/{imagenet,pascal}/<datapoint>/<obj_i>/objInfo.txt
      "class imgPath cadPath colMin rowMin colMax rowMax azimuth elevation inPlaneRot"
  CAD/<class>/<k>.npy                            64^3 voxel models

The record index is built once; the datapoints keep ``os.listdir``'s order,
as the JAX loader keeps it. Images are decoded and augmented on a thread
pool, each with a seed drawn before the map; a record whose image cannot be
read is counted in ``bad_records``.
"""

from __future__ import annotations

import dataclasses
import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from anytime3d_tpu_torch.data.augment import image_random_augmentation, remap_bbox
from anytime3d_tpu_torch.data.imread import imread_color


def natural_keys(text: str):
    """Sort key of ``text`` with its digit runs compared as numbers."""
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", text)]


@dataclasses.dataclass
class ObjRecord:
    class_name: str
    image_path: str
    cad_index: int  # 1-based, as in objInfo.txt
    bbox: Tuple[float, float, float, float]  # colMin, rowMin, colMax, rowMax
    euler_rad: Tuple[float, float, float]  # azimuth, elevation, in-plane


class _PascalBase:
    """The class index (the CAD directories), the CAD voxels and the flat
    record index of one split."""

    def __init__(self, data_path: str, train_or_val: str = "train", seed: int = 0):
        self._root = data_path
        self._split = train_or_val
        self._rng = np.random.default_rng(seed)
        self.epoch = 0
        self.dataStart = 0
        self.bad_records = 0
        self._build_class_index()
        self._load_cad_shapes()
        self._build_records()
        self._order = np.arange(len(self._records))
        self._rng.shuffle(self._order)
        self.dataLength = len(self._records)

    def _build_class_index(self):
        cad_root = os.path.join(self._root, "CAD")
        classes = sorted([d for d in os.listdir(cad_root) if os.path.isdir(os.path.join(cad_root, d))],
                         key=natural_keys)
        self.class_index = {c: i for i, c in enumerate(classes)}
        self.class_num = len(classes)

    def _load_cad_shapes(self):
        self.cad_shapes: Dict[str, np.ndarray] = {}
        cad_root = os.path.join(self._root, "CAD")
        for class_name in self.class_index:
            files = sorted([f for f in os.listdir(os.path.join(cad_root, class_name)) if f.endswith(".npy")],
                           key=natural_keys)
            self.cad_shapes[class_name] = np.array(
                [(np.load(os.path.join(cad_root, class_name, f)).reshape(64, 64, 64, 1) > 0).astype(np.float32)
                 for f in files])

    def _datapoints(self) -> List[str]:
        """The datapoint directories of the split: every one an
        ``Image_sets`` list of the split names (a Pascal list's only where
        its last column is 1), in ``os.listdir`` order."""
        keep = set()
        sets_root = os.path.join(self._root, "Image_sets")
        for dataset in os.listdir(sets_root):
            dpath = os.path.join(sets_root, dataset)
            if not os.path.isdir(dpath):
                continue
            for txt in os.listdir(dpath):
                if txt.split(".")[0].split("_")[-1] != self._split:
                    continue
                with open(os.path.join(dpath, txt)) as fh:
                    for line in fh:
                        parts = line.strip().split(" ")
                        if not parts[0]:
                            continue
                        if dataset != "pascal" or (len(parts) > 1 and int(parts[-1]) == 1):
                            keep.add(parts[0])
        points = []
        train_root = os.path.join(self._root, "training_data")
        for dataset in ("imagenet", "pascal"):
            droot = os.path.join(train_root, dataset)
            if not os.path.isdir(droot):
                continue
            for dp in os.listdir(droot):
                full = os.path.join(droot, dp)
                if dp in keep and os.path.isdir(full):
                    points.append(full)
        return points

    def _build_records(self):
        self._records: List[ObjRecord] = []
        self._by_image: Dict[str, List[ObjRecord]] = {}
        for dp in self._datapoints():
            for obj in sorted(os.listdir(dp)):
                obj_dir = os.path.join(dp, obj)
                info = os.path.join(obj_dir, "objInfo.txt")
                if not os.path.isdir(obj_dir) or not os.path.isfile(info):
                    continue
                try:
                    with open(info) as fh:
                        parts = fh.readline().strip().split(" ")
                    cls, img_path, cad_path = parts[0], parts[1], parts[2]
                    if cls not in self.cad_shapes:
                        continue
                    col0, row0, col1, row1 = map(float, parts[3:7])
                    a, e, i = (float(v) / 180.0 * np.pi for v in parts[7:10])
                    rec = ObjRecord(class_name=cls, image_path=os.path.join(self._root, img_path),
                                    cad_index=int(cad_path.split("/")[-1]), bbox=(col0, row0, col1, row1),
                                    euler_rad=(a, e, i))
                    self._records.append(rec)
                    self._by_image.setdefault(rec.image_path, []).append(rec)
                except (ValueError, IndexError, OSError):
                    self.bad_records += 1
        self.images = list(self._by_image)

    def close(self) -> None:
        """Stop the loader's thread pool."""
        self._pool.shutdown(wait=True)


def orientation_anchors(records, k: int = 30, max_iter: int = 1000, seed: int = 0, device=None) -> np.ndarray:
    """(k, 6) orientation anchor bins: ``kmeans_sincos`` over the (sin, cos)
    Euler triples of ``records``, on ``device`` (the CPU by default)."""
    from anytime3d_tpu_torch.ops.kmeans import kmeans_sincos

    euler = np.array([r.euler_rad for r in records], np.float32)
    x = np.concatenate([np.sin(euler), np.cos(euler)], axis=-1)
    centres, _, _ = kmeans_sincos(x, k=k, max_iter=max_iter, seed=seed, device=device)
    return centres


class Pascal3DSingleObjectLoader(_PascalBase):
    """Per-object crop batches. ``getNextBatch(batchSizeof3DShape,
    imageSize=(cols, rows), augmentation)`` -> ``(inst_onehot, class_onehot,
    sin_euler, cos_euler, images, voxels)``: images (B, rows, cols, 3) in
    [0, 1], BGR; voxels (B, 64, 64, 64, 1). ``augmentation`` defaults to
    the train split's: a random border, flips (the azimuth negated on a
    horizontal one), the warp and the photometric jitter."""

    def __init__(self, data_path, train_or_val="train", seed: int = 0, workers: int = 8):
        super().__init__(data_path, train_or_val, seed)
        self._pool = ThreadPoolExecutor(max_workers=workers)

    def _load_one(self, rec: ObjRecord, image_size, augmentation: bool, seed: int):
        rng = np.random.default_rng(seed)
        img = imread_color(rec.image_path)
        if img is None:
            return None
        rows, cols = img.shape[:2]
        c0, r0, c1, r1 = rec.bbox
        w, h = c1 - c0, r1 - r0
        border = rng.random() * 0.2 if augmentation else 0.1
        c0, r0 = max(0, c0 - w * border), max(0, r0 - h * border)
        c1, r1 = min(cols, c1 + w * border), min(rows, r1 + h * border)
        crop = img[int(r0):int(r1), int(c0):int(c1)]
        if crop.size == 0:
            return None
        azimuth, elevation, inplane = rec.euler_rad
        if augmentation and rng.random() > 0.5:
            crop = crop[:, ::-1]
            azimuth = -azimuth
            if rng.random() > 0.5:
                crop = crop[::-1, :]
        out_r, out_c = image_size
        crop, _ = image_random_augmentation(rng, np.ascontiguousarray(crop), (out_c, out_r),
                                            augmentation=augmentation, add_noise=augmentation,
                                            pad_to_aspect=False)
        cls_vec = np.zeros(self.class_num, np.float32)
        cls_vec[self.class_index[rec.class_name]] = 1.0
        inst_vec = np.zeros(10, np.float32)
        inst_vec[(rec.cad_index - 1) % 10] = 1.0
        voxel = self.cad_shapes[rec.class_name][rec.cad_index - 1]
        return crop / 255.0, voxel, cls_vec, inst_vec, np.array([azimuth, elevation, inplane], np.float32)

    def getNextBatch(self, batchSizeof3DShape=32, imageSize=(64, 64), augmentation=None):
        if augmentation is None:
            augmentation = self._split == "train"
        picked = []
        while len(picked) < batchSizeof3DShape:
            if self.dataStart >= self.dataLength:
                self.epoch += 1
                self.dataStart = 0
                self._rng.shuffle(self._order)
            picked.append(self._records[self._order[self.dataStart]])
            self.dataStart += 1
        seeds = self._rng.integers(0, 2**31 - 1, len(picked))
        results = list(self._pool.map(lambda rs: self._load_one(rs[0], imageSize, augmentation, rs[1]),
                                      zip(picked, seeds)))
        results = [r for r in results if r is not None]
        self.bad_records += len(picked) - len(results)
        images = np.stack([r[0] for r in results]).astype(np.float32)
        voxels = np.stack([r[1] for r in results]).astype(np.float32)
        cls = np.stack([r[2] for r in results])
        inst = np.stack([r[3] for r in results])
        euler = np.stack([r[4] for r in results])
        return inst, cls, np.sin(euler), np.cos(euler), images, voxels


def build_grid_targets(objects: Sequence[dict], grid_size: Tuple[int, int],
                       predictors_per_cell: int) -> Dict[str, np.ndarray]:
    """YOLO grid tensors of one image from its object dicts.

    Each object: ``bbox`` (x0, y0, x1, y1) normalized, ``euler_rad`` (3,),
    ``inst_onehot`` (I,), ``voxel_index`` int, and optionally ``bbox3d_whl``
    (3,). ``grid_size`` is (cols, rows). An object lands in the cell holding
    its center, in the first free predictor slot; an object whose center is
    off the image, or whose cell is full, is dropped. Returns ``objness``
    (gr, gc, P, 1), ``bbox`` (gr, gc, P, 4) as (h, w, x, y) with (x, y)
    relative to the cell, ``sin``/``cos`` (gr, gc, P, 3), ``inst`` (gr, gc,
    P, I), ``voxel_slot`` (gr, gc, P) int32 into the image's voxel list (-1:
    empty), and ``bbox3d`` (gr, gc, P, 3) when every object has a size."""
    gc_n, gr_n = grid_size
    p = predictors_per_cell
    inst_dim = len(objects[0]["inst_onehot"]) if objects else 1
    objness = np.zeros((gr_n, gc_n, p, 1), np.float32)
    bbox = np.zeros((gr_n, gc_n, p, 4), np.float32)
    sin_t = np.zeros((gr_n, gc_n, p, 3), np.float32)
    cos_t = np.zeros((gr_n, gc_n, p, 3), np.float32)
    inst_t = np.zeros((gr_n, gc_n, p, inst_dim), np.float32)
    slot_t = np.full((gr_n, gc_n, p), -1, np.int32)
    with_b3 = bool(objects) and all("bbox3d_whl" in o for o in objects)
    b3_t = np.zeros((gr_n, gc_n, p, 3), np.float32)
    for obj in objects:
        x0, y0, x1, y1 = obj["bbox"]
        cx, cy = (x0 + x1) / 2.0, (y0 + y1) / 2.0
        if not (0.0 <= cx < 1.0 and 0.0 <= cy < 1.0):
            continue
        gc_i, gr_i = int(cx * gc_n), int(cy * gr_n)
        free = np.nonzero(objness[gr_i, gc_i, :, 0] == 0)[0]
        if len(free) == 0:
            continue
        slot = free[0]
        objness[gr_i, gc_i, slot, 0] = 1.0
        bbox[gr_i, gc_i, slot] = [y1 - y0, x1 - x0, cx * gc_n - gc_i, cy * gr_n - gr_i]
        euler = np.asarray(obj["euler_rad"], np.float32)
        sin_t[gr_i, gc_i, slot] = np.sin(euler)
        cos_t[gr_i, gc_i, slot] = np.cos(euler)
        inst_t[gr_i, gc_i, slot] = obj["inst_onehot"]
        slot_t[gr_i, gc_i, slot] = obj["voxel_index"]
        if with_b3:
            b3_t[gr_i, gc_i, slot] = obj["bbox3d_whl"]
    out = {"objness": objness, "bbox": bbox, "sin": sin_t, "cos": cos_t, "inst": inst_t, "voxel_slot": slot_t}
    if with_b3:
        out["bbox3d"] = b3_t
    return out


class Pascal3DMultiObjectLoader(_PascalBase):
    """Whole-image YOLO-grid batches of the images holding a
    ``class_filter`` object (cars by default). ``getNextBatch(batchSize)``
    -> ``(images (B, rows, cols, 3) in [0, 1] BGR, targets, voxel_lists)``:
    ``build_grid_targets`` of each image's objects of the class, boxes
    remapped through the warp, and each image's stacked voxels."""

    def __init__(self, data_path, train_or_val="train", image_size=(640, 480), grid_size=(20, 15),
                 predictors_per_cell=5, class_filter: Optional[str] = "car", seed: int = 0, workers: int = 8):
        super().__init__(data_path, train_or_val, seed)
        self._image_size = image_size
        self._grid_size = grid_size
        self._p = predictors_per_cell
        if class_filter is not None:
            self.images = [im for im in self.images if any(r.class_name == class_filter for r in self._by_image[im])]
        self._class_filter = class_filter
        self._img_order = np.arange(len(self.images))
        self._rng.shuffle(self._img_order)
        self.dataLength = len(self.images)
        self._pool = ThreadPoolExecutor(max_workers=workers)

    def _load_image(self, image_path: str, seed: int):
        rng = np.random.default_rng(seed)
        img = imread_color(image_path)
        if img is None:
            return None
        rows, cols = img.shape[:2]
        out_c, out_r = self._image_size
        train = self._split == "train"
        img_out, params = image_random_augmentation(rng, img, (out_c, out_r), augmentation=train, add_noise=train)
        objs, voxels = [], []
        for rec in self._by_image[image_path]:
            if self._class_filter and rec.class_name != self._class_filter:
                continue
            c0, r0, c1, r1 = rec.bbox
            frac = remap_bbox(np.array([c0 / cols, r0 / rows, c1 / cols, r1 / rows], np.float32), params)
            inst_vec = np.zeros(10, np.float32)
            inst_vec[(rec.cad_index - 1) % 10] = 1.0
            objs.append({"bbox": frac, "euler_rad": rec.euler_rad, "inst_onehot": inst_vec,
                         "voxel_index": len(voxels)})
            voxels.append(self.cad_shapes[rec.class_name][rec.cad_index - 1])
        if not objs:
            return None
        return img_out / 255.0, build_grid_targets(objs, self._grid_size, self._p), voxels

    def getNextBatch(self, batchSize=8):
        picked = []
        while len(picked) < batchSize:
            if self.dataStart >= self.dataLength:
                self.epoch += 1
                self.dataStart = 0
                self._rng.shuffle(self._img_order)
            picked.append(self.images[self._img_order[self.dataStart]])
            self.dataStart += 1
        seeds = self._rng.integers(0, 2**31 - 1, len(picked))
        results = [r for r in self._pool.map(lambda ps: self._load_image(ps[0], ps[1]), zip(picked, seeds))
                   if r is not None]
        images = np.stack([r[0] for r in results]).astype(np.float32)
        targets = {k: np.stack([r[1][k] for r in results]) for k in results[0][1]}
        return images, targets, [np.stack(r[2]) for r in results]
