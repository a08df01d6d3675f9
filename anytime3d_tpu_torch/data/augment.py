"""Image augmentation with explicit NumPy random draws: the geometric warp
(pad to the output aspect, random scale and translation, resize) and the
photometric jitter.

Counterpart of ``anytime3d_tpu/data/augment.py``. The warp is the native
fused bilinear gather (``csrc/augment.cpp``, the port's copy of the JAX
package's ``native/augment.cpp``, built with ``g++`` by
``kernels/build.py::build_host`` on first use); where it cannot be built,
its NumPy twin ``_augment_one_numpy``, the same gather in float64
coordinates (within 1e-2 of the native one on the 0..255 scale).
``image_random_augmentation.native_calls`` / ``.numpy_calls`` count the
images each path warped.

``photometric_augment`` is the JAX function with ``cv2`` present: it blurs
and shifts hue and saturation with ``cv2`` (imported on the first call), so
on one machine the two packages give the same bits. Where ``cv2`` does not
import it raises, where the JAX function would leave those two steps out.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from anytime3d_tpu_torch.kernels import build

_SRC = Path(__file__).resolve().parent / "csrc" / "augment.cpp"
_lock = threading.Lock()  # guards the build, the load and the counts
_native: dict = {}  # "lib" once loaded, or "error" once the build has failed

# ------------------------------------------------------------ photometric


def photometric_augment(rng: np.random.Generator, image: np.ndarray) -> np.ndarray:
    """Random photometric jitter: brightness, contrast, blur, invert, additive
    noise and a hue/saturation shift, each with its probability, on a uint8
    or float [0, 255] image; float32 in [0, 255] back. The draws and the
    arithmetic are the JAX function's with ``cv2`` present. The hue shift
    converts with ``COLOR_RGB2HSV`` whatever the channel order: on the BGR
    crops of the loaders the hue is mirrored, and the shift, drawn from the
    symmetric U(-20, 20), has the same distribution."""
    import cv2

    img = image.astype(np.float32)
    if rng.random() < 0.5:  # brightness
        img = img + rng.uniform(-25, 25)
    if rng.random() < 0.5:  # contrast
        img = (img - 127.5) * rng.uniform(0.7, 1.3) + 127.5
    if rng.random() < 0.2:  # blur
        k = int(rng.integers(1, 3)) * 2 + 1
        img = cv2.GaussianBlur(img, (k, k), 0)
    if rng.random() < 0.1:  # invert
        img = 255.0 - img
    if rng.random() < 0.3:  # gaussian noise (float64 from here)
        img = img + rng.normal(0, 8, img.shape)
    if rng.random() < 0.5 and img.ndim == 3 and img.shape[2] == 3:
        # one shift added to H (wrapping in [0, 180)) and S
        shift = float(rng.uniform(-20, 20))
        hsv = cv2.cvtColor(np.clip(img, 0, 255).astype(np.uint8), cv2.COLOR_RGB2HSV).astype(np.float32)
        hsv[..., 0] = np.mod(hsv[..., 0] + shift * 180.0 / 255.0, 180.0)
        hsv[..., 1] = np.clip(hsv[..., 1] + shift, 0.0, 255.0)
        img = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.float32)


def noisy(rng: np.random.Generator, noise_type: str, image: np.ndarray) -> np.ndarray:
    """Parametric noise on a float [0, 255] image: 'gauss' | 's&p' |
    'poisson' | 'speckle'."""
    img = image.astype(np.float32)
    if noise_type == "gauss":
        return img + rng.normal(0.0, 10.0, img.shape)
    if noise_type == "s&p":
        amount, s_vs_p = 0.004, 0.5
        out = img.copy()
        n_salt = int(np.ceil(amount * img.size * s_vs_p))
        n_pepper = int(np.ceil(amount * img.size * (1.0 - s_vs_p)))
        out[tuple(rng.integers(0, d, n_salt) for d in img.shape)] = 255.0
        out[tuple(rng.integers(0, d, n_pepper) for d in img.shape)] = 0.0
        return out
    if noise_type == "poisson":
        vals = 2 ** np.ceil(np.log2(len(np.unique(img.astype(np.uint8)))))
        return rng.poisson(np.clip(img, 0, None) / 255.0 * vals) / vals * 255.0
    if noise_type == "speckle":
        return img + img * rng.normal(0.0, 0.1, img.shape)
    raise ValueError(f"unknown noise type {noise_type!r}")


# ------------------------------------------------------------ the warp


def _to_rgb3(image: np.ndarray) -> np.ndarray:
    """Exactly 3 channels, contiguous float32: (H, W) and (H, W, 1) are
    repeated, RGBA drops alpha, anything else raises (the native engine
    writes 3 floats a pixel)."""
    im = np.asarray(image, np.float32)
    if im.ndim == 2:
        im = np.stack([im] * 3, axis=-1)
    elif im.ndim == 3 and im.shape[2] == 1:
        im = np.repeat(im, 3, axis=2)
    elif im.ndim == 3 and im.shape[2] == 4:
        im = im[:, :, :3]
    if im.ndim != 3 or im.shape[2] != 3:
        raise ValueError(f"augment expects (H,W), (H,W,1), (H,W,3) or (H,W,4) images; got {image.shape}")
    return np.ascontiguousarray(im)


def native_augment() -> ctypes.CDLL:
    """The augment engine's library, built with ``g++`` on first use; raises
    RuntimeError where it cannot be built (and again on every later call)."""
    with _lock:
        if "lib" not in _native and "error" not in _native:
            try:
                lib = ctypes.CDLL(str(build.build_host(_SRC)))
            except (RuntimeError, OSError) as e:
                _native["error"] = RuntimeError(f"native augment engine unavailable: {e}")
            else:
                p = ctypes.c_void_p
                lib.augment_batch.argtypes = [p, p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, p, p,
                                              ctypes.c_int32, p, p, ctypes.c_int32, ctypes.c_int32]
                lib.augment_batch.restype = ctypes.c_int32
                _native["lib"] = lib
    if "error" in _native:
        raise _native["error"]
    return _native["lib"]


def augment_native_available() -> bool:
    """True where the native engine builds and loads."""
    try:
        native_augment()
    except RuntimeError:
        return False
    return True


def _library() -> Optional[ctypes.CDLL]:
    try:
        return native_augment()
    except RuntimeError:
        return None


def _count(fn, path: str, n: int) -> None:
    with _lock:
        setattr(fn, path, getattr(fn, path) + n)


def _augment_one_numpy(image: np.ndarray, out_r: int, out_c: int, scale: float, tx: float, ty: float,
                       flip: bool = False, pad_to_aspect: bool = True):
    """NumPy twin of ``csrc/augment.cpp::run_job``: the same fused
    inverse-map bilinear gather (pad to aspect, affine about the padded
    center, resize; one resampling, zero border), sample coordinates in
    float64. ``(out (out_r, out_c, 3) float32, params)``."""
    im = _to_rgb3(image)
    rows, cols, _ = im.shape
    # the content centered in the output's aspect, the padded size rounded
    # half up (floor(x + 0.5)): the rule csrc/augment.cpp shares
    pad_l = pad_t = 0
    padded_r, padded_c = rows, cols
    if pad_to_aspect:
        target_ar, ar = out_c / out_r, cols / rows
        if ar < target_ar:
            padded_c = int(np.floor(rows * target_ar + 0.5))
            pad_l = (padded_c - cols) // 2
        elif ar > target_ar:
            padded_r = int(np.floor(cols / target_ar + 0.5))
            pad_t = (padded_r - rows) // 2
    off_x = (1.0 - scale) * padded_c * 0.5 + tx * padded_c
    off_y = (1.0 - scale) * padded_r * 0.5 + ty * padded_r
    xp = (np.arange(out_c, dtype=np.float64) + 0.5) * (padded_c / out_c) - 0.5
    yp = (np.arange(out_r, dtype=np.float64) + 0.5) * (padded_r / out_r) - 0.5
    x_orig = (xp - off_x) / scale - pad_l
    y_orig = (yp - off_y) / scale - pad_t
    if flip:
        x_orig = (cols - 1) - x_orig
    xg, yg = np.meshgrid(x_orig, y_orig)
    x0 = np.floor(xg).astype(np.int64)
    y0 = np.floor(yg).astype(np.int64)
    wx = (xg - x0).astype(np.float32)[..., None]
    wy = (yg - y0).astype(np.float32)[..., None]

    def gather(yi, xi):
        ok = (yi >= 0) & (yi < rows) & (xi >= 0) & (xi < cols)
        v = im[np.clip(yi, 0, rows - 1), np.clip(xi, 0, cols - 1)]
        return np.where(ok[..., None], v, 0.0)

    out = (gather(y0, x0) * (1 - wx) * (1 - wy) + gather(y0, x0 + 1) * wx * (1 - wy)
           + gather(y0 + 1, x0) * (1 - wx) * wy + gather(y0 + 1, x0 + 1) * wx * wy).astype(np.float32)
    params = (scale, tx, ty, pad_l / padded_c, pad_t / padded_r, cols / padded_c, rows / padded_r)
    return out, params


def _native_batch(lib: ctypes.CDLL, images: Sequence[np.ndarray], out_r: int, out_c: int, st: np.ndarray,
                  flips: np.ndarray, pad_to_aspect: bool, n_threads: int) -> Tuple[np.ndarray, np.ndarray]:
    """One ``augment_batch`` call: (n, out_r, out_c, 3) float32 and (n, 7) params."""
    held: List[np.ndarray] = [_to_rgb3(im) for im in images]  # alive for the call
    n = len(held)
    shapes = np.array([im.shape for im in held], np.int32)
    ptrs = (ctypes.c_void_p * n)(*(im.ctypes.data for im in held))
    st = np.ascontiguousarray(st, np.float32)
    flips = np.ascontiguousarray(flips, np.uint8)
    out = np.empty((n, out_r, out_c, 3), np.float32)
    params = np.empty((n, 7), np.float32)
    rc = lib.augment_batch(ptrs, shapes.ctypes.data, n, out_r, out_c, st.ctypes.data, flips.ctypes.data,
                           1 if pad_to_aspect else 0, out.ctypes.data, params.ctypes.data, 3, n_threads)
    if rc != 0:
        raise RuntimeError(f"augment_batch native call failed (code {rc})")
    return out, params


def _augment_one_native(lib: ctypes.CDLL, image: np.ndarray, out_r: int, out_c: int, scale: float, tx: float,
                        ty: float, flip: bool = False, pad_to_aspect: bool = True):
    """One image through ``csrc/augment.cpp`` on the caller's thread (the
    loaders fan out over a thread pool, and ctypes releases the GIL for the
    call). ``(out (out_r, out_c, 3) float32, params)``."""
    out, params = _native_batch(lib, [image], out_r, out_c, np.array([[scale, tx, ty]], np.float32),
                                np.array([1 if flip else 0], np.uint8), pad_to_aspect, 1)
    return out[0], tuple(float(v) for v in params[0])


def image_random_augmentation(rng: np.random.Generator, image: np.ndarray, image_size: Tuple[int, int],
                              augmentation: bool = True, add_noise: bool = False,
                              scale_range: Tuple[float, float] = (0.8, 1.2), translate_frac: float = 0.2,
                              pad_to_aspect: bool = True):
    """Geometric and optional photometric augmentation of one image to
    ``image_size`` = (cols, rows). Returns ``(image_out float32, params)``,
    ``params`` = (scale, tx_frac, ty_frac, pad_left_frac, pad_top_frac,
    content_w_frac, content_h_frac), what ``remap_bbox`` reads. The affine
    draws come first, then ``photometric_augment``'s."""
    out_c, out_r = image_size
    img = _to_rgb3(image)
    if augmentation:
        scale = float(rng.uniform(*scale_range))
        tx = float(rng.uniform(-translate_frac, translate_frac))
        ty = float(rng.uniform(-translate_frac, translate_frac))
    else:
        scale, tx, ty = 1.0, 0.0, 0.0
    lib = _library()
    if lib is not None:
        out, params = _augment_one_native(lib, img, out_r, out_c, scale, tx, ty, pad_to_aspect=pad_to_aspect)
        _count(image_random_augmentation, "native_calls", 1)
    else:
        out, params = _augment_one_numpy(img, out_r, out_c, scale, tx, ty, pad_to_aspect=pad_to_aspect)
        _count(image_random_augmentation, "numpy_calls", 1)
    if add_noise:
        out = photometric_augment(rng, out)
    return out.astype(np.float32), params


image_random_augmentation.native_calls = 0
image_random_augmentation.numpy_calls = 0


def remap_bbox(bbox_frac: np.ndarray, params) -> np.ndarray:
    """[x0, y0, x1, y1] fractions of the original image through the
    transform of ``image_random_augmentation``'s ``params``, as fractions of
    the output image."""
    scale, tx, ty, pad_l, pad_t, w_frac, h_frac = params
    b = np.asarray(bbox_frac, np.float32).copy()
    b[..., [0, 2]] = pad_l + b[..., [0, 2]] * w_frac
    b[..., [1, 3]] = pad_t + b[..., [1, 3]] * h_frac
    b[..., [0, 2]] = (b[..., [0, 2]] - 0.5) * scale + 0.5 + tx
    b[..., [1, 3]] = (b[..., [1, 3]] - 0.5) * scale + 0.5 + ty
    return b


def augment_batch(rng: np.random.Generator, images: Sequence[np.ndarray], image_size: Tuple[int, int],
                  augmentation: bool = True, scale_range: Tuple[float, float] = (0.8, 1.2),
                  translate_frac: float = 0.2, pad_to_aspect: bool = True, flip_prob: float = 0.0,
                  n_threads: int = 0):
    """The warp of ``image_random_augmentation`` for a batch in one native
    call, fanned over ``n_threads`` threads (0: one a core; the batch does
    not depend on it). One (scale, tx, ty) draw a row, then the flips.
    Returns ``(batch (n, rows, cols, 3) float32, params, flipped)``; the
    flip mirrors the original image (callers negate the azimuth). Without
    the native engine, the NumPy twin image by image."""
    n = len(images)
    out_c, out_r = image_size
    if augmentation:
        st = rng.uniform([scale_range[0], -translate_frac, -translate_frac],
                         [scale_range[1], translate_frac, translate_frac], (n, 3)).astype(np.float32)
    else:
        st = np.tile(np.array([1.0, 0.0, 0.0], np.float32), (n, 1))
    flips = (rng.random(n) < flip_prob).astype(np.uint8) if flip_prob > 0 else np.zeros(n, np.uint8)
    lib = _library()
    if lib is None:
        out = np.empty((n, out_r, out_c, 3), np.float32)
        params = []
        for i, img in enumerate(images):
            out[i], p = _augment_one_numpy(img, out_r, out_c, *(float(v) for v in st[i]), flip=bool(flips[i]),
                                           pad_to_aspect=pad_to_aspect)
            params.append(p)
        _count(image_random_augmentation, "numpy_calls", n)
        return out, params, flips.astype(bool)
    out, params = _native_batch(lib, images, out_r, out_c, st, flips, pad_to_aspect, n_threads)
    _count(image_random_augmentation, "native_calls", n)
    return out, [tuple(float(v) for v in p) for p in params], flips.astype(bool)


def random_flip_horizontal(rng: np.random.Generator, image: np.ndarray, prob: float = 0.5) -> tuple[np.ndarray, bool]:
    """Horizontal flip with probability ``prob``; callers negate the azimuth
    when flipped."""
    if rng.random() < prob:
        return image[:, ::-1].copy(), True
    return image, False
