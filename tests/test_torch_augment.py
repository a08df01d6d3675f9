"""PyTorch port, image reading and the augmentation against ``cv2`` and the
JAX package on the CPU.

``data/imread.py::imread_color`` is held to ``cv2.imread(path,
IMREAD_COLOR)`` on every fixture PNG and to the digests that
``chip_smoke.py`` checks the card's host against, and this ``cv2``'s
jitter calls to the digests it records (``CV2_DIGESTS``);
``photometric_augment``, ``noisy``, ``_to_rgb3``, ``remap_bbox``,
``random_flip_horizontal`` bit-equal to the JAX functions on the same draws;
the native warp bit-equal to the JAX package's native build, its NumPy twin
equal to JAX's.

The JAX side's native engine is the untouched ``native/augment.cpp``, built
here with ``g++`` and the Makefile's flags into a temporary directory and
loaded through ``ANYTIME3D_AUGMENT_LIB`` (its ``_AUG_LIB`` /
``_AUG_LIB_TRIED`` reset for the module's tests, then restored). The tests
that build skip without ``g++``.
"""

import hashlib
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")  # the port reads and jitters with cv2, as the JAX package does

from anytime3d_tpu.data import augment as jax_augment  # noqa: E402
from anytime3d_tpu_torch.data import augment  # noqa: E402
from anytime3d_tpu_torch.data.imread import imread_color  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (the digests the card's phase checks)

FIXTURE_PNGS = sorted(chip_smoke.FIXTURE_PNG_SHA256)


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package on its own native engine, built from ``native/augment.cpp``."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the native augment engine")
    lib = tmp_path_factory.mktemp("jax_native") / "libaugment.so"
    subprocess.run(["g++", "-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-shared", "-o", str(lib),
                    os.path.join(REPO, "native", "augment.cpp"), "-lpthread"], check=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ANYTIME3D_AUGMENT_LIB", str(lib))
        mp.setattr(jax_augment, "_AUG_LIB", None)
        mp.setattr(jax_augment, "_AUG_LIB_TRIED", False)
        assert jax_augment.augment_native_available()
        yield jax_augment


@pytest.fixture(scope="module")
def port_native():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the native augment engine")
    assert augment.augment_native_available()
    return augment


# ---------------------------------------------------------------- reading


@pytest.mark.parametrize("rel", FIXTURE_PNGS)
def test_imread_fixtures_equal_cv2_and_the_recorded_digests(rel):
    path = os.path.join(REPO, rel)
    got, want = imread_color(path), cv2.imread(path, cv2.IMREAD_COLOR)
    assert got.dtype == np.uint8 and got.shape == want.shape and np.array_equal(got, want)
    assert hashlib.sha256(want.tobytes()).hexdigest() == chip_smoke.FIXTURE_PNG_SHA256[rel]


def test_imread_refusals(tmp_path, monkeypatch):
    """A missing or damaged file reads as None, as in cv2; a JPEG reads as
    cv2 reads it; without cv2, a read raises rather than return None."""
    assert imread_color(tmp_path / "missing.png") is None
    good = open(os.path.join(REPO, FIXTURE_PNGS[0]), "rb").read()
    for name, data in (("crc", good[:-5] + b"x" + good[-4:]), ("cut", good[:40]), ("garbage", b"\x00" * 64)):
        (tmp_path / f"{name}.png").write_bytes(data)
        assert imread_color(tmp_path / f"{name}.png") is None
    jpg = str(tmp_path / "a.jpg")
    cv2.imwrite(jpg, np.random.default_rng(3).integers(0, 256, (20, 30, 3)).astype(np.uint8))
    assert np.array_equal(imread_color(jpg), cv2.imread(jpg, cv2.IMREAD_COLOR))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        imread_color(jpg)


def test_recorded_cv2_digests_are_this_cv2s():
    """The jitter's cv2 calls give here the digests ``chip_smoke.py``
    records for this cv2 version, which the card's host is compared with."""
    recorded = dict(chip_smoke.CV2_DIGESTS)
    assert recorded.pop("version") != cv2.__version__ or chip_smoke.cv2_digests() == recorded


# ---------------------------------------------------------------- the functions, against JAX's


def branches(seed, shape):
    """The branches of ``photometric_augment`` that the draws of ``seed`` take
    (the blur with its kernel size), the draws replayed in its order."""
    rng, taken = np.random.default_rng(seed), set()
    if rng.random() < 0.5:
        taken.add("brightness")
        rng.uniform(-25, 25)
    if rng.random() < 0.5:
        taken.add("contrast")
        rng.uniform(0.7, 1.3)
    if rng.random() < 0.2:
        taken.add(f"blur{int(rng.integers(1, 3)) * 2 + 1}")
    if rng.random() < 0.1:
        taken.add("invert")
    if rng.random() < 0.3:
        taken.add("noise")
        rng.normal(0, 8, shape)
    if rng.random() < 0.5:
        taken.add("hsv")
    return taken


@pytest.mark.parametrize("shape", [(48, 52, 3), (5, 33, 3), (3, 70, 3), (9, 1, 3)])
def test_photometric_augment_equals_jax(shape):
    """200 seeded draws (every branch fires), on rows of whole and partial
    32-pixel blocks: within 1.0 (an LSB of the HSV round trip) and bit-equal
    on every draw, those that take the HSV branch among them."""
    fired = set()
    for seed in range(200):
        img = np.random.default_rng(1000 + seed).uniform(0, 255, shape).astype(np.float32)
        got = augment.photometric_augment(np.random.default_rng(seed), img)
        want = jax_augment.photometric_augment(np.random.default_rng(seed), img)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1.0)
        assert np.array_equal(got, want), seed
        fired.update(branches(seed, img.shape))
    assert fired == {"brightness", "contrast", "blur3", "blur5", "invert", "noise", "hsv"}
    grey = np.random.default_rng(3).uniform(0, 255, (20, 24)).astype(np.float32)
    for seed in range(20):  # no HSV branch on one channel
        assert np.array_equal(augment.photometric_augment(np.random.default_rng(seed), grey),
                              jax_augment.photometric_augment(np.random.default_rng(seed), grey))


def test_photometric_augment_needs_cv2(monkeypatch):
    """Without cv2 the jitter raises, where the JAX function would leave out
    the blur and the HSV shift."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        augment.photometric_augment(np.random.default_rng(0), np.zeros((4, 4, 3), np.float32))


@pytest.mark.parametrize("noise", ["gauss", "s&p", "poisson", "speckle"])
def test_noisy_equals_jax(noise):
    img = np.random.default_rng(4).uniform(0, 255, (30, 40, 3)).astype(np.float32)
    got = augment.noisy(np.random.default_rng(5), noise, img)
    want = jax_augment.noisy(np.random.default_rng(5), noise, img)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError, match="unknown noise"):
        augment.noisy(np.random.default_rng(0), "salt", img)


@pytest.mark.parametrize("shape", [(6, 7), (6, 7, 1), (6, 7, 3), (6, 7, 4), (6, 7, 5), (6,)])
def test_to_rgb3_equals_jax(shape):
    img = np.random.default_rng(6).uniform(0, 255, shape)
    if len(shape) == 3 and shape[2] == 5 or len(shape) == 1:
        with pytest.raises(ValueError, match="augment expects"):
            augment._to_rgb3(img)
        return
    got, want = augment._to_rgb3(img), jax_augment._to_rgb3(img)
    assert got.dtype == np.float32 and got.flags.c_contiguous and np.array_equal(got, want)


def test_remap_bbox_and_flip_equal_jax():
    rng = np.random.default_rng(7)
    boxes = rng.uniform(0, 1, (5, 4)).astype(np.float32)
    for _ in range(5):
        params = tuple(rng.uniform(0.1, 1.2, 7))
        assert np.array_equal(augment.remap_bbox(boxes, params), jax_augment.remap_bbox(boxes, params))
    img = rng.uniform(0, 255, (8, 9, 3)).astype(np.float32)
    for seed in range(8):
        (a, fa), (b, fb) = (m.random_flip_horizontal(np.random.default_rng(seed), img) for m in (augment, jax_augment))
        assert fa == fb and np.array_equal(a, b)


def hetero_images(seed, n=6):
    rng = np.random.default_rng(seed)
    shapes = [(int(rng.integers(20, 70)), int(rng.integers(20, 70))) for _ in range(n)]
    out = [rng.uniform(0, 255, (r, c, 3)).astype(np.float32) for r, c in shapes]
    out[1] = out[1][..., 0]  # a grey image
    out[2] = np.concatenate([out[2], np.full(out[2].shape[:2] + (1,), 9.0, np.float32)], -1)  # RGBA
    return out


@pytest.mark.parametrize("pad", [True, False])
@pytest.mark.parametrize("flip_prob", [0.0, 0.5])
def test_augment_batch_native_equals_jax_native(jax_native, port_native, pad, flip_prob):
    imgs = hetero_images(8)
    before = augment.image_random_augmentation.native_calls
    got = augment.augment_batch(np.random.default_rng(9), imgs, (40, 32), pad_to_aspect=pad, flip_prob=flip_prob)
    want = jax_native.augment_batch(np.random.default_rng(9), imgs, (40, 32), pad_to_aspect=pad, flip_prob=flip_prob)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1] and np.array_equal(got[2], want[2])
    assert augment.image_random_augmentation.native_calls == before + len(imgs)
    # augmentation off: the identity affine, still bit-equal
    got = augment.augment_batch(np.random.default_rng(9), imgs, (24, 24), augmentation=False)
    want = jax_native.augment_batch(np.random.default_rng(9), imgs, (24, 24), augmentation=False)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]


@pytest.mark.parametrize("add_noise", [False, True])
@pytest.mark.parametrize("pad", [True, False])
def test_image_random_augmentation_native_equals_jax_native(jax_native, port_native, add_noise, pad):
    """A VOC-sized and a KITTI-sized frame and a small crop, 8 seeds each,
    warp and jitter: bit-equal images and params."""
    for shape in ((375, 500, 3), (375, 1242, 3), (41, 29, 3)):
        img = np.random.default_rng(shape[1]).integers(0, 256, shape).astype(np.uint8)
        for seed in range(8):
            got = augment.image_random_augmentation(np.random.default_rng(seed), img, (64, 48),
                                                    add_noise=add_noise, pad_to_aspect=pad)
            want = jax_native.image_random_augmentation(np.random.default_rng(seed), img, (64, 48),
                                                        add_noise=add_noise, pad_to_aspect=pad)
            assert np.array_equal(got[0], want[0]) and got[1] == want[1], (shape, seed)


def test_numpy_twin_equals_jax_numpy_and_native(port_native):
    """The port's ``_augment_one_numpy`` equals JAX's bit for bit, and stays
    within 1e-2 of the native engine (float64 against float32 sample
    coordinates), as JAX's oracle test holds it."""
    for i, img in enumerate(hetero_images(10)):
        args = (32, 40, 0.8 + 0.05 * i, 0.1 - 0.03 * i, -0.05 + 0.02 * i)
        for flip in (False, True):
            got = augment._augment_one_numpy(img, *args, flip=flip)
            want = jax_augment._augment_one_numpy(img, *args, flip=flip)
            assert np.array_equal(got[0], want[0]) and got[1] == want[1]
            native, params = augment._augment_one_native(augment.native_augment(), img, *args, flip=flip)
            np.testing.assert_allclose(native, got[0], rtol=0, atol=1e-2)
            np.testing.assert_allclose(params, got[1], rtol=1e-6, atol=1e-7)


def test_without_the_engine_the_numpy_twin_warps(monkeypatch):
    """Where ``g++`` cannot build the engine, both entry points take the
    NumPy twin, and count it."""
    monkeypatch.setattr(augment, "_native", {"error": RuntimeError("native augment engine unavailable: test")})
    assert not augment.augment_native_available()
    imgs = hetero_images(11, n=3)
    before = augment.image_random_augmentation.numpy_calls
    out, params, flips = augment.augment_batch(np.random.default_rng(12), imgs, (30, 20), flip_prob=0.5)
    st = np.random.default_rng(12).uniform([0.8, -0.2, -0.2], [1.2, 0.2, 0.2], (3, 3)).astype(np.float32)
    for i, img in enumerate(imgs):
        ref, ref_params = jax_augment._augment_one_numpy(img, 20, 30, *(float(v) for v in st[i]), flip=bool(flips[i]))
        assert np.array_equal(out[i], ref) and params[i] == ref_params
    got, _ = augment.image_random_augmentation(np.random.default_rng(13), imgs[0], (30, 20))
    rng = np.random.default_rng(13)
    s, tx, ty = rng.uniform(0.8, 1.2), rng.uniform(-0.2, 0.2), rng.uniform(-0.2, 0.2)
    assert np.array_equal(got, jax_augment._augment_one_numpy(imgs[0], 20, 30, s, tx, ty)[0])
    assert augment.image_random_augmentation.numpy_calls == before + 4


def test_thread_count_does_not_change_the_batch(port_native):
    imgs = hetero_images(14, n=16)
    one = augment.augment_batch(np.random.default_rng(15), imgs, (48, 48), flip_prob=0.5, n_threads=1)
    many = augment.augment_batch(np.random.default_rng(15), imgs, (48, 48), flip_prob=0.5, n_threads=8)
    auto = augment.augment_batch(np.random.default_rng(15), imgs, (48, 48), flip_prob=0.5)
    for other in (many, auto):
        assert np.array_equal(one[0], other[0]) and one[1] == other[1] and np.array_equal(one[2], other[2])
