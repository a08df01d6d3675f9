"""PyTorch port, the voxelizer and the structural instance shapes against the
JAX package on the CPU: the native grids (a cube, a tetrahedron, every part
mesh of ``instance_parts`` for 8 classes x 4 instances; solid and surface),
the NumPy path, the thread count, host NMS, OFF loading, ``cli.voxelize``;
then ``instance_grid``, the distinctness of a class's instances, and the
structural voxel and image loaders.

The JAX side's native library is the untouched ``native/voxelizer.cpp``,
built here with ``g++`` and the Makefile's flags into a temporary directory
and loaded through ``ANYTIME3D_VOXELIZER_LIB`` (its ``_LIB`` / ``_LIB_TRIED``
and its instance cache reset for the module's tests, then restored). The
port builds its own copy (``anytime3d_tpu_torch/data/csrc/voxelizer.cpp``).
Every grid comparison is exact: both are occupancy grids from the same
arithmetic. The tests that build skip without ``g++``.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest

from anytime3d_tpu.data import instances as jax_instances
from anytime3d_tpu.data import modelnet as jax_modelnet
from anytime3d_tpu.data import voxelize as jax_voxelize
from anytime3d_tpu_torch.cli import voxelize as cli_voxelize
from anytime3d_tpu_torch.data import instances, modelnet, voxelize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 32
CLASSES, INSTS = 8, 4

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++ to build the native voxelizer")


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package on its own native library, built from ``native/voxelizer.cpp``."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the native voxelizer")
    lib = tmp_path_factory.mktemp("jax_native") / "libvoxelizer.so"
    subprocess.run(["g++", "-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-shared", "-o", str(lib),
                    os.path.join(REPO, "native", "voxelizer.cpp"), "-lpthread"], check=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ANYTIME3D_VOXELIZER_LIB", str(lib))
        mp.setattr(jax_voxelize, "_LIB", None)
        mp.setattr(jax_voxelize, "_LIB_TRIED", False)
        # grids another test cached on the NumPy path must not be read back here
        mp.setattr(jax_instances, "_BANK", jax_instances.InstanceShapeBank())
        assert jax_voxelize.native_available()
        yield jax_voxelize


def cube_mesh():
    v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]],
                 np.float32)
    f = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4], [1, 2, 6], [1, 6, 5],
                  [2, 3, 7], [2, 7, 6], [3, 0, 4], [3, 4, 7]], np.int32)
    return v, f


def tetra_mesh():
    v = np.array([[0.1, 0.0, 0.2], [1.0, 0.3, 0.0], [0.4, 1.1, 0.3], [0.5, 0.4, 0.9]], np.float32)
    f = np.array([[0, 2, 1], [0, 1, 3], [1, 2, 3], [0, 3, 2]], np.int32)
    return v, f


def part_meshes(cls):
    return [mesh for inst in range(INSTS) for _, mesh in instances.instance_parts(cls, inst)]


# ---------------------------------------------------------------- the voxelizer


@pytest.mark.parametrize("solid", [True, False], ids=["solid", "surface"])
@pytest.mark.parametrize("mesh", ["cube", "tetra"])
def test_native_grid_equals_jax_native(jax_native, mesh, solid):
    v, f = {"cube": cube_mesh, "tetra": tetra_mesh}[mesh]()
    got = voxelize.voxelize(v, f, dim=DIM, solid=solid, native=True)
    want = jax_native.voxelize(v, f, dim=DIM, solid=solid)
    assert got.dtype == np.float32 and got.shape == (DIM,) * 3
    assert 0 < got.sum() < DIM**3
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("solid", [True, False], ids=["solid", "surface"])
@pytest.mark.parametrize("cls", range(CLASSES))
def test_part_meshes_equal_jax_native(jax_native, cls, solid):
    """Every part mesh of the class's first 4 instances, each normalized into the cube on its own."""
    for v, f in part_meshes(cls):
        np.testing.assert_array_equal(voxelize.voxelize(v, f, dim=DIM, solid=solid, native=True),
                                      jax_native.voxelize(v, f, dim=DIM, solid=solid))


@needs_gxx
def test_instance_parts_equal_jax():
    """The part lists themselves: the same operations, vertices and triangles."""
    for cls in range(CLASSES):
        for inst in range(INSTS):
            ours, theirs = instances.instance_parts(cls, inst), jax_instances.instance_parts(cls, inst)
            assert [op for op, _ in ours] == [op for op, _ in theirs]
            for (_, (v, f)), (_, (jv, jf)) in zip(ours, theirs):
                np.testing.assert_array_equal(v, jv)
                np.testing.assert_array_equal(f, jf)


def test_numpy_path_equals_jax_numpy():
    """``_voxelize_numpy`` against JAX's on the cube, the tetrahedron and a
    chair's parts, solid and surface."""
    meshes = [cube_mesh(), tetra_mesh(), *[m for _, m in instances.instance_parts(1, 0)]]
    for v, f in meshes:
        v, jv = voxelize.normalize_mesh(v, DIM), jax_voxelize.normalize_mesh(v, DIM)
        np.testing.assert_array_equal(v, jv)
        for solid in (True, False):
            np.testing.assert_array_equal(voxelize._voxelize_numpy(v, f, DIM, solid),
                                          jax_voxelize._voxelize_numpy(v, f, DIM, solid))


@needs_gxx
def test_thread_count_does_not_change_the_grid():
    for v, f in [cube_mesh(), *part_meshes(3)]:
        for solid in (True, False):
            np.testing.assert_array_equal(voxelize.voxelize(v, f, dim=DIM, solid=solid, threads=1, native=True),
                                          voxelize.voxelize(v, f, dim=DIM, solid=solid, native=True))


@needs_gxx
def test_paths_are_counted_and_native_none_takes_native():
    v, f = cube_mesh()
    before = (voxelize.voxelize.native_calls, voxelize.voxelize.numpy_calls)
    native = voxelize.voxelize(v, f, dim=16)
    numpy_grid = voxelize.voxelize(v, f, dim=16, native=False)
    assert (voxelize.voxelize.native_calls, voxelize.voxelize.numpy_calls) == (before[0] + 1, before[1] + 1)
    assert voxelize.native_available()
    # a cube's parity fill agrees; the native surface pass adds the boundary voxels
    assert (numpy_grid <= native).all()


def test_refused_native_library(monkeypatch):
    """``native=True`` raises, None falls back to NumPy (counted), and
    ``instance_grid`` raises rather than fall back."""
    monkeypatch.setattr(voxelize, "_native", {"error": RuntimeError("native voxelizer unavailable: no g++")})
    monkeypatch.setattr(instances, "_BANK", instances.InstanceShapeBank())
    v, f = cube_mesh()
    with pytest.raises(RuntimeError, match="native voxelizer unavailable"):
        voxelize.voxelize(v, f, dim=8, native=True)
    assert not voxelize.native_available()
    before = voxelize.voxelize.numpy_calls
    np.testing.assert_array_equal(voxelize.voxelize(v, f, dim=8), voxelize._voxelize_numpy(
        voxelize.normalize_mesh(v, 8), f, 8, True))
    assert voxelize.voxelize.numpy_calls == before + 1
    with pytest.raises(RuntimeError, match="native voxelizer unavailable"):
        instances.instance_grid(0, 0, 8)
    with pytest.raises(RuntimeError, match="native voxelizer unavailable"):
        modelnet.SyntheticVoxelLoader(num_samples=2, dim=8, num_classes=2, num_inst=2, structural_inst=True)


@pytest.mark.parametrize("tied", [False, True], ids=["random", "tied"])
def test_nms_native_matches_jax(jax_native, tied):
    """Native against native, and the NumPy side (``ops.nms.nms_indices``)
    against JAX's fallback: random boxes, and tied scores on overlapping boxes."""
    rng = np.random.default_rng(3 + tied)
    xy = rng.uniform(0, 80, size=(40, 2))
    wh = rng.uniform(5, 40, size=(40, 2))
    scores = np.round(rng.uniform(size=(40, 1)), 1) if tied else rng.uniform(size=(40, 1))
    boxes = np.concatenate([xy, xy + wh, scores], axis=1).astype(np.float32)
    got = voxelize.nms_native(boxes, 0.3)
    np.testing.assert_array_equal(got, jax_native.nms_native(boxes, 0.3))
    assert 0 < got.sum() < len(boxes)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(voxelize, "_native", {"error": RuntimeError("native voxelizer unavailable: no g++")})
        mp.setattr(jax_native, "_LIB", None)
        mp.setattr(jax_native, "_LIB_TRIED", True)
        np.testing.assert_array_equal(voxelize.nms_native(boxes, 0.3), jax_native.nms_native(boxes, 0.3))


def write_quad_cube(path, inline_counts: bool):
    v, _ = cube_mesh()
    quads = [[0, 3, 2, 1], [4, 5, 6, 7], [0, 1, 5, 4], [1, 2, 6, 5], [2, 3, 7, 6], [3, 0, 4, 7]]
    head = "OFF8 6 0\n" if inline_counts else "OFF\n8 6 0\n"
    lines = [" ".join(f"{x:.6f}" for x in row) for row in v * 2.0 - 0.5]
    lines += ["4 " + " ".join(map(str, q)) for q in quads]
    path.write_text(head + "\n".join(lines) + "\n")


@pytest.mark.parametrize("inline_counts", [False, True], ids=["counts_line", "counts_inline"])
def test_load_off_reads_quads(tmp_path, inline_counts):
    path = tmp_path / "cube.off"
    write_quad_cube(path, inline_counts)
    verts, tris = voxelize.load_off(str(path))
    jv, jt = jax_voxelize.load_off(str(path))
    assert verts.shape == (8, 3) and tris.shape == (12, 3) and tris.dtype == np.int32
    np.testing.assert_array_equal(verts, jv)
    np.testing.assert_array_equal(tris, jt)


@needs_gxx
def test_cli_voxelize_writes_the_grids(tmp_path, capsys):
    for cls in ("chair", "table"):
        (tmp_path / "meshes" / cls).mkdir(parents=True)
        write_quad_cube(tmp_path / "meshes" / cls / "a.off", inline_counts=False)
    (tmp_path / "meshes" / "chair" / "notes.txt").write_text("not a mesh")
    n = cli_voxelize.main(["--mesh-root", str(tmp_path / "meshes"), "--out-root", str(tmp_path / "out"),
                           "--dim", "16", "--surface-only", "--threads", "2"])
    assert n == 2
    assert "voxelizer: native" in capsys.readouterr().out
    verts, tris = voxelize.load_off(str(tmp_path / "meshes" / "chair" / "a.off"))
    want = voxelize.voxelize(verts, tris, dim=16, solid=False, native=True).astype(np.uint8)
    for cls in ("chair", "table"):
        got = np.load(tmp_path / "out" / cls / "a.npy")
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- structural shapes


def _iou(a, b):
    a, b = a > 0.5, b > 0.5
    return (a & b).sum() / max((a | b).sum(), 1)


def test_instance_grids_equal_jax_native(jax_native):
    for cls in range(CLASSES):
        for inst in range(INSTS):
            got = instances.instance_grid(cls, inst, DIM)
            assert got.dtype == np.float32 and got.shape == (DIM,) * 3
            np.testing.assert_array_equal(got, jax_instances.instance_grid(cls, inst, DIM))


@needs_gxx
def test_instances_structurally_distinct():
    """The JAX package's own bound on the native grids: every instance
    non-empty and within half the cube, and any two of a class's first 4
    instances at IoU under 0.9."""
    for cls in range(CLASSES):
        grids = [instances.instance_grid(cls, i, DIM) for i in range(INSTS)]
        for g in grids:
            assert 0.005 < g.mean() < 0.5, (cls, g.mean())
        ious = [_iou(grids[i], grids[j]) for i in range(INSTS) for j in range(i + 1, INSTS)]
        assert max(ious) < 0.9, (cls, ious)


def test_jitter_zoom_matches_jax():
    rng = np.random.default_rng(0)
    grid = (rng.uniform(size=(DIM,) * 3) > 0.5).astype(np.float32)
    for factors in ([1.0, 1.0, 1.0], [0.93, 1.04, 1.08], [1.1, 0.9, 1.0]):
        np.testing.assert_array_equal(modelnet._jitter_zoom(grid, factors), jax_modelnet._jitter_zoom(grid, factors))


@pytest.mark.parametrize("image", [False, True], ids=["voxel", "image"])
def test_structural_loaders_equal_jax(jax_native, image):
    """Two batches of 12 (the second past an epoch's end, reshuffled), voxels
    or the image tuple at 40x48, at the same seed."""
    kw = dict(num_samples=16, dim=DIM, num_classes=CLASSES, num_inst=INSTS, seed=3, structural_inst=True)
    if image:
        ours, theirs = modelnet.SyntheticImageObjectLoader(**kw), jax_modelnet.SyntheticImageObjectLoader(**kw)
    else:
        ours, theirs = modelnet.SyntheticVoxelLoader(**kw), jax_modelnet.SyntheticVoxelLoader(**kw)
    for _ in range(2):
        if image:
            got, want = ours.getNextBatch(12, imageSize=(48, 40)), theirs.getNextBatch(12, imageSize=(48, 40))
        else:
            got, want = ours.getNextBatch(12), theirs.getNextBatch(12)
            got, want = [got[k] for k in sorted(want)], [want[k] for k in sorted(want)]
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert ours.epoch == theirs.epoch == 1
    assert (ours._cache.reshape(16, -1).mean(axis=1) > 0.003).all()


@needs_gxx
def test_instance_grids_digest():
    """The digest the card test (``tests/test_torch_cuda.py``) holds the card
    host's native build to is that of these grids."""
    from tests.test_torch_cuda import INSTANCE_GRIDS_SHA256, instance_grids_digest

    assert instance_grids_digest() == INSTANCE_GRIDS_SHA256
