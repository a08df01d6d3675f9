"""PyTorch port, the real-image data path against the JAX package on the CPU:
``ops/kmeans.py`` and ``orientation_anchors``; the Pascal3D single- and
multi-object loaders on ``tests/fixtures/pascal3d``, the KITTI loader on
``tests/fixtures/kitti`` and the ImageNet loader on a temporary tree of the
fixture PNGs, at the same seed as the JAX loaders, train and val split;
the ImageNet and the Pascal3D single-object loaders also on JPEG copies
of the fixtures; ``cli/train.py``'s ``build_batch_fn`` on the loaders' 5-
and 6-tuples; and
the CLIs on the fixtures (``cli.train`` for ``pascal_nolbo``, whose
``category_dim`` the 2-class fixture resizes, and ``kitti_inst_only`` with
``--cad-path``; ``cli.train_detector --data``, ``cli.pretrain --data``,
``cli.evaluate``), each at B=2 for 2 steps, with the models' 64^3 decoders
narrowed.

The JAX loaders warp with the JAX package's native engine (the untouched
``native/augment.cpp``, built here with the Makefile's flags into a
temporary directory, loaded through ``ANYTIME3D_AUGMENT_LIB``), the port's
with its own copy of the engine; both read and jitter with ``cv2``, so the
images are bit-equal in both splits. The tests that build skip without
``g++``.
"""

import dataclasses
import math
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")  # both packages read the images with cv2

from anytime3d_tpu.cli import train as jax_cli_train
from anytime3d_tpu.data import augment as jax_augment
from anytime3d_tpu.data import imagenet as jax_imagenet
from anytime3d_tpu.data import kitti as jax_kitti
from anytime3d_tpu.data import pascal3d as jax_pascal3d
from anytime3d_tpu.models import configs as jax_configs
from anytime3d_tpu.ops import kmeans as jax_kmeans
from anytime3d_tpu_torch.cli import evaluate as cli_evaluate
from anytime3d_tpu_torch.cli import pretrain as cli_pretrain
from anytime3d_tpu_torch.cli import train as cli_train
from anytime3d_tpu_torch.cli import train_detector as cli_detector
from anytime3d_tpu_torch.data import ImagenetLoader, KittiSingleObjectLoader, Pascal3DMultiObjectLoader
from anytime3d_tpu_torch.data import Pascal3DSingleObjectLoader, augment
from anytime3d_tpu_torch.data.pascal3d import ObjRecord, orientation_anchors
from anytime3d_tpu_torch.models import configs
from anytime3d_tpu_torch.ops import kmeans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PASCAL = os.path.join(REPO, "tests", "fixtures", "pascal3d")
KITTI = os.path.join(REPO, "tests", "fixtures", "kitti")
CAD = os.path.join(KITTI, "cad")
SIZE = 32  # the crops' side
BATCHES = 3


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
        assert jax_augment.augment_native_available() and augment.augment_native_available()
        yield


def make_imagenet_tree(root, ext):
    """An ImageNet-layout tree of the fixture PNGs, written as ``ext`` files:
    three classes, a damaged PNG the loaders leave out, and a file that is
    not an image."""
    pngs = sorted(os.path.join(d, f) for d, _, fs in os.walk(os.path.join(REPO, "tests", "fixtures")) for f in fs
                  if f.endswith(".png"))
    for i, src in enumerate(pngs):
        cls = root / f"n0{i % 3}"
        cls.mkdir(exist_ok=True)
        if ext == "png":
            shutil.copy(src, cls / f"img{i}.png")
        else:
            assert cv2.imwrite(str(cls / f"img{i}.{ext}"), cv2.imread(src, cv2.IMREAD_COLOR))
    (root / "n00" / "bad.png").write_bytes(b"\x89PNG\r\n\x1a\n" + b"\x00" * 30)
    (root / "n01" / "notes.txt").write_text("not an image")
    return str(root)


@pytest.fixture(scope="module")
def imagenet_tree(tmp_path_factory):
    return make_imagenet_tree(tmp_path_factory.mktemp("imagenet"), "png")


def assert_images(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32 and np.array_equal(got, want)


# ---------------------------------------------------------------- kmeans


def euler_points(n, seed):
    rng = np.random.default_rng(seed)
    e = (rng.uniform(-np.pi, np.pi, (n, 3)) * np.array([1.0, 0.3, 0.2])).astype(np.float32)
    return np.concatenate([np.sin(e), np.cos(e)], axis=-1)


@pytest.mark.parametrize("n,k,iters", [(40, 5, 50), (600, 30, 300)])
def test_kmeans_sincos_equals_jax(n, k, iters):
    """Assignments equal, centres and distances within 1e-5 (float32 sums in
    another order)."""
    x = euler_points(n, seed=n)
    got = kmeans.kmeans_sincos(x, k, iters, seed=3)
    want = jax_kmeans.kmeans_sincos(x, k, iters, seed=3)
    assert np.array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-5)
    d = kmeans.sincos_distance(torch.from_numpy(x), torch.from_numpy(got[0])).numpy()
    np.testing.assert_allclose(d, np.asarray(jax_kmeans.sincos_distance(x, got[0])), rtol=0, atol=1e-6)


def test_kmeans_keeps_an_empty_clusters_centre():
    """A centre far from every point keeps its place; ties go to the first centre."""
    x = torch.tensor([[0.0, 0.0, 0.0, 1.0, 1.0, 1.0]] * 4)
    far = torch.tensor([[1.0, 1.0, 1.0, -1.0, -1.0, -1.0]])
    centres, assign, _ = kmeans._fit(x, torch.cat([x[:1], x[:1], far]), 5)
    assert assign.tolist() == [0, 0, 0, 0] and torch.equal(centres[2], far[0])


def test_orientation_anchors_equal_jax():
    rng = np.random.default_rng(4)
    records = [ObjRecord("car", "x.png", 1, (0, 0, 1, 1), tuple(rng.uniform(-1.5, 1.5, 3))) for _ in range(400)]
    jax_records = [jax_pascal3d.ObjRecord(**dataclasses.asdict(r)) for r in records]
    got = orientation_anchors(records, k=30, max_iter=200, seed=1)
    want = jax_pascal3d.orientation_anchors(jax_records, k=30, max_iter=200, seed=1)
    assert got.shape == (30, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    loader = Pascal3DSingleObjectLoader(PASCAL, "train", workers=1)
    fixture = orientation_anchors(loader._records, k=2, max_iter=20)
    np.testing.assert_allclose(fixture, jax_pascal3d.orientation_anchors(loader._records, k=2, max_iter=20),
                               rtol=0, atol=1e-5)


# ---------------------------------------------------------------- the loaders


@pytest.mark.parametrize("split", ["train", "val"])
def test_pascal_single_object_loader_equals_jax(jax_native, split):
    got = Pascal3DSingleObjectLoader(PASCAL, split, seed=5, workers=2)
    want = jax_pascal3d.Pascal3DSingleObjectLoader(PASCAL, split, seed=5, workers=2)
    assert got.class_index == want.class_index == {"car": 0, "chair": 1}
    assert [dataclasses.astuple(r) for r in got._records] == [dataclasses.astuple(r) for r in want._records]
    for _ in range(BATCHES):
        a, b = got.getNextBatch(5, imageSize=(SIZE, SIZE)), want.getNextBatch(5, imageSize=(SIZE, SIZE))
        for name, x, y in zip(("inst", "cls", "sin", "cos", "images", "voxels"), a, b):
            if name == "images":
                assert_images(x, y)
            else:
                assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert (got.bad_records, got.epoch, got.dataStart) == (want.bad_records, want.epoch, want.dataStart)
    got.close()


@pytest.fixture
def pascal_jpeg(tmp_path):
    """The Pascal3D fixture with its images as JPEG files, as the real set keeps them."""
    root = tmp_path / "p"
    shutil.copytree(PASCAL, root)
    for png in (root / "Images").glob("*.png"):
        assert cv2.imwrite(str(png.with_suffix(".jpg")), cv2.imread(str(png), cv2.IMREAD_COLOR))
        png.unlink()
    for info in root.glob("training_data/*/*/*/objInfo.txt"):
        info.write_text(info.read_text().replace(".png", ".jpg"))
    return str(root)


def test_pascal_single_object_loader_on_jpeg_equals_jax(jax_native, pascal_jpeg):
    """The train split's crops and labels bit-equal to JAX's, every image read."""
    got = Pascal3DSingleObjectLoader(pascal_jpeg, "train", seed=10, workers=2)
    want = jax_pascal3d.Pascal3DSingleObjectLoader(pascal_jpeg, "train", seed=10, workers=2)
    for _ in range(BATCHES):
        a, b = got.getNextBatch(4, imageSize=(SIZE, SIZE)), want.getNextBatch(4, imageSize=(SIZE, SIZE))
        assert len(a[4]) == 4
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    assert got.bad_records == want.bad_records == 0
    got.close()


def test_pascal_multi_object_loader_on_jpeg_equals_jax(jax_native, pascal_jpeg):
    """The train split's frames and grid targets bit-equal to JAX's, every image read."""
    kw = dict(image_size=(48, 40), grid_size=(4, 3), seed=11, workers=2)
    got = Pascal3DMultiObjectLoader(pascal_jpeg, "train", **kw)
    want = jax_pascal3d.Pascal3DMultiObjectLoader(pascal_jpeg, "train", **kw)
    for _ in range(BATCHES):
        (ia, ta, _), (ib, tb, _) = got.getNextBatch(2), want.getNextBatch(2)
        assert_images(ia, ib)
        assert sorted(ta) == sorted(tb) and all(np.array_equal(ta[k], tb[k]) for k in ta)
    assert got.bad_records == want.bad_records == 0
    got.close()


@pytest.mark.parametrize("split", ["train", "val"])
def test_pascal_multi_object_loader_equals_jax(jax_native, split):
    kw = dict(image_size=(48, 40), grid_size=(4, 3), seed=6, workers=2)
    got = Pascal3DMultiObjectLoader(PASCAL, split, **kw)
    want = jax_pascal3d.Pascal3DMultiObjectLoader(PASCAL, split, **kw)
    assert got.images == want.images and got.dataLength == want.dataLength
    for _ in range(BATCHES):
        (ia, ta, va), (ib, tb, vb) = got.getNextBatch(3), want.getNextBatch(3)
        assert_images(ia, ib)
        assert sorted(ta) == sorted(tb) and all(ta[k].dtype == tb[k].dtype and np.array_equal(ta[k], tb[k])
                                                for k in ta)
        assert len(va) == len(vb) and all(np.array_equal(x, y) for x, y in zip(va, vb))
    assert (got.bad_records, got.epoch) == (want.bad_records, want.epoch)
    got.close()


@pytest.mark.parametrize("split", ["train", "val"])
def test_kitti_loader_equals_jax(jax_native, split):
    got = KittiSingleObjectLoader(KITTI, CAD, split, seed=7, workers=2)
    want = jax_kitti.KittiSingleObjectLoader(KITTI, CAD, split, seed=7, workers=2)
    assert got._records == want._records and np.array_equal(got._cad_aspects, want._cad_aspects)
    for _ in range(BATCHES):
        a, b = got.getNextBatch(4, imageSize=(SIZE, SIZE)), want.getNextBatch(4, imageSize=(SIZE, SIZE))
        assert len(a) == 5
        for name, x, y in zip(("inst", "sin", "cos", "images", "voxels"), a, b):
            if name == "images":
                assert_images(x, y)
            else:
                assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert got.epoch == want.epoch
    got.close()


@pytest.mark.parametrize("ext", ["png", "jpg", "bmp"])
def test_imagenet_loader_equals_jax(jax_native, tmp_path, ext):
    """The train loader is the only one (always augmented): images and
    labels bit-equal, the damaged PNG left out of its batch by both."""
    tree = make_imagenet_tree(tmp_path, ext)
    got, want = ImagenetLoader(tree, seed=8, workers=2), jax_imagenet.ImagenetLoader(tree, seed=8)
    assert got.class_index == want.class_index and got._records == want._records and got.dataLength == 6
    sizes = []
    for _ in range(BATCHES):
        (ia, la), (ib, lb) = got.getNextBatch(4, imageSize=(SIZE, SIZE)), want.getNextBatch(4, imageSize=(SIZE, SIZE))
        assert_images(ia, ib)
        assert la.dtype == lb.dtype and np.array_equal(la, lb)
        sizes.append(len(la))
    assert min(sizes) == 3 and got.epoch == want.epoch
    got.close()


def test_loader_without_its_image_counts_a_bad_record(tmp_path):
    """An object whose image is missing is counted in ``bad_records`` and
    left out of the batch, as the JAX loader does."""
    shutil.copytree(PASCAL, tmp_path / "p")
    os.remove(tmp_path / "p" / "Images" / "chair_c.png")
    got = Pascal3DSingleObjectLoader(str(tmp_path / "p"), "train", seed=9, workers=1)
    want = jax_pascal3d.Pascal3DSingleObjectLoader(str(tmp_path / "p"), "train", seed=9, workers=1)
    a, b = got.getNextBatch(6, imageSize=(SIZE, SIZE), augmentation=False), want.getNextBatch(
        6, imageSize=(SIZE, SIZE), augmentation=False)
    assert got.bad_records == want.bad_records == 2 and len(a[0]) == len(b[0]) == 4
    assert np.array_equal(a[4], b[4])


@pytest.mark.parametrize("kind", ["pascal", "kitti"])
def test_build_batch_fn_on_the_loader_tuples_equals_jax(jax_native, kind):
    """The 6-tuple (Pascal: category and instance one-hots) and the 5-tuple
    (KITTI: no class) through ``build_batch_fn`` of both packages, the val
    split (no augmentation): the same keys and arrays."""
    name = "pascal_nolbo" if kind == "pascal" else "kitti_inst_only"
    if kind == "pascal":
        pair = (Pascal3DSingleObjectLoader(PASCAL, "val", workers=1),
                jax_pascal3d.Pascal3DSingleObjectLoader(PASCAL, "val", workers=1))
        overrides = {"category_dim": 2}
    else:
        pair = (KittiSingleObjectLoader(KITTI, CAD, "val", workers=1),
                jax_kitti.KittiSingleObjectLoader(KITTI, CAD, "val", workers=1))
        overrides = {}
    got = cli_train.build_batch_fn(pair[0], configs.REGISTRY[name](**overrides), 3, image_size=(SIZE, SIZE))(0)
    want = jax_cli_train.build_batch_fn(pair[1], jax_configs.REGISTRY[name](**overrides), 3, (SIZE, SIZE))(0)
    assert sorted(got) == sorted(want)
    assert set(got) == ({"input", "target", "category_onehot", "inst_onehot"} if kind == "pascal"
                        else {"input", "target", "inst_onehot"})
    for k in got:
        assert np.array_equal(got[k], np.asarray(want[k])), k


# ---------------------------------------------------------------- the CLIs


def narrow(cfg):
    """A config's 64^3 decoder at narrow widths (the CPU steps in seconds)."""
    return dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, filter_nums=(32, 16, 16, 8, 1)))


@pytest.fixture
def narrow_image_configs(monkeypatch):
    """The image configs on Darknet53Tiny (a seeded Darknet19 takes seconds
    to initialise on the CPU) with narrow decoders; ``category_dim`` still
    reaches the factory."""
    for name in ("pascal_nolbo", "kitti_inst_only"):
        factory = configs.REGISTRY[name]
        monkeypatch.setitem(configs.REGISTRY, name,
                            lambda _f=factory, **kw: narrow(_f(backbone="darknet53tiny", **kw)))


def check_trained(trainer, steps):
    assert trainer.state.step == steps and len(trainer.history) == steps
    assert all(math.isfinite(v) for row in trainer.history + trainer.eval_history for v in row.values())


def test_cli_train_pascal_resizes_to_the_fixtures_classes(narrow_image_configs, capsys):
    trainer = cli_train.main(["--config", "pascal_nolbo", "--data", PASCAL, "--device", "cpu", "--steps", "2",
                              "--batch-size", "2", "--image-size", str(SIZE), "--eval-every", "2"])
    check_trained(trainer, 2)
    assert trainer.model.config.category_dim == 2 and len(trainer.eval_history) == 1
    assert "dataset defines 2 classes (config default 12)" in capsys.readouterr().out
    batch = trainer.batch_fn(0)
    assert batch["category_onehot"].shape == (2, 2) and batch["input"].shape == (2, SIZE, SIZE, 3)


def test_cli_train_kitti_with_cad_path(narrow_image_configs, tmp_path):
    argv = ["--config", "kitti_inst_only", "--data", KITTI, "--device", "cpu", "--steps", "2", "--batch-size", "2",
            "--image-size", str(SIZE), "--eval-every", "2"]
    with pytest.raises(SystemExit, match="--cad-path"):
        cli_train.main(argv)
    trainer = cli_train.main(argv + ["--cad-path", CAD, "--save-path", str(tmp_path / "ckpt")])
    check_trained(trainer, 2)
    assert set(trainer.batch_fn(0)) == {"input", "target", "inst_onehot"}
    # the checkpoint's reconstructions of the KITTI val crops (no class prior, so no sweep, as in the JAX command)
    paths = cli_evaluate.main(["--config", "kitti_inst_only", "--data", KITTI, "--cad-path", CAD, "--ckpt",
                               str(tmp_path / "ckpt"), "--device", "cpu", "--batch-size", "2", "--rates", "0.5",
                               "--image-size", str(SIZE), "--dump", str(tmp_path / "dump")])
    assert paths and all(os.path.exists(p) for p in paths.values())


def test_cli_evaluate_on_the_pascal_fixture(narrow_image_configs, capsys):
    table, curve = cli_evaluate.main(["--config", "pascal_nolbo", "--data", PASCAL, "--device", "cpu",
                                      "--batch-size", "2", "--batches", "1", "--rates", "0.5",
                                      "--image-size", str(SIZE)])
    assert set(table) == {0.5} and all(math.isfinite(v) for v in table[0.5].values())
    out = capsys.readouterr().out
    assert "dataset defines 2 classes" in out and "best decode threshold" in out


def test_cli_train_detector_on_the_pascal_fixture(capsys):
    argv = ["--data", PASCAL, "--image-size", "64", "64", "--grid-size", "2", "2", "--steps", "2", "--batch-size",
            "2", "--max-detections", "4", "--device", "cpu"]
    with pytest.raises(SystemExit, match="--voxel-dim 64"):
        cli_detector.main(argv)
    trainer, det = cli_detector.main(argv + ["--voxel-dim", "64"])
    check_trained(trainer, 2)
    assert {"det_precision", "det_recall", "map50", "ori_mae_rad"} <= set(det)
    assert "detection eval:" in capsys.readouterr().out


def test_cli_pretrain_on_an_imagenet_tree(imagenet_tree):
    trainer = cli_pretrain.main(["--data", imagenet_tree, "--backbone", "darknet53tiny", "--device", "cpu",
                                 "--steps", "2", "--batch-size", "2", "--image-size", str(SIZE), "--eval-every", "2"])
    check_trained(trainer, 2)
    assert trainer.model.config.num_classes == 3 and len(trainer.eval_history) == 1
    batch = trainer.batch_fn(0)
    assert batch["images"].shape == (2, SIZE, SIZE, 3) and batch["labels"].shape == (2, 3)


def test_the_data_parallel_paths_still_raise():
    """What the data-parallel paths refuse: the dataset's 64^3 CAD voxels
    against the default ``--voxel-dim`` under ``--mesh`` as without it,
    before any rank joins; a "model" mesh axis larger than the run (2 in a
    run of one rank, an in-process gloo group, left as it was found); and
    the explicit data-parallel step without a mesh."""
    import torch.distributed as dist

    from anytime3d_tpu_torch.parallel import make_mesh
    from anytime3d_tpu_torch.parallel import mesh as mesh_module
    from anytime3d_tpu_torch.train.step import make_train_step_dp

    with pytest.raises(SystemExit, match="--voxel-dim 64"):
        cli_detector.build_trainer(cli_detector.parse_args(["--data", PASCAL, "--mesh", "--device", "cpu"]))
    try:
        with pytest.raises(ValueError, match="x2 != 1 ranks"):
            make_mesh(model=2, device="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        mesh_module._mesh.cache_clear()
    with pytest.raises(ValueError, match="needs a mesh"):
        make_train_step_dp(None)
