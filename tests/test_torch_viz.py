"""PyTorch port, drawing (``evaluation/viz.py``) against the JAX package.

Both packages draw with ``cv2.rectangle`` and ``cv2.line``, so the frames
must be equal bit for bit: on a scene from the port's
``models/pipeline.py::scene_reconstruction`` (the tiny detector of
``tests/test_torch_detector.py``, every detection kept), handed to JAX's
``draw_scene`` as numpy and to the port's as tensors; on single boxes; and
on ``chip_smoke.viz_scene``, whose sha256 (``chip_smoke.VIZ_SHA256``) phase
17 of ``chip_smoke.py`` holds the card host's drawing to. The in-place quirk
is pinned: ``draw_bbox2d`` and ``draw_bbox3d`` draw into the caller's array
when it is already C-contiguous, and into a copy otherwise.
"""

import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
from anytime3d_tpu.evaluation import viz as jax_viz
from anytime3d_tpu_torch.evaluation import viz
from anytime3d_tpu_torch.models.pipeline import scene_reconstruction
from tests.test_torch_detector import KITTI_COLS_ROWS, build, frames, tiny_configs

cv2 = pytest.importorskip("cv2")

CORNERS = np.array([[20, 20], [20, 40], [40, 20], [40, 40], [25, 25], [25, 45], [45, 25], [45, 45]])


def test_draw_boxes_bit_equal_to_jax():
    """JAX's own case (``tests/test_evaluation_extras.py::test_draw_boxes``)
    and a box with float pixels partly off the frame."""
    for box in ([10, 10, 60, 60], [-5.7, 30.2, 120.9, 99.5]):
        img = np.zeros((100, 100, 3), np.uint8)
        got, want = viz.draw_bbox2d(img.copy(), box), jax_viz.draw_bbox2d(img.copy(), box)
        assert got.sum() > 0
        np.testing.assert_array_equal(got, want)
    for corners in (CORNERS, CORNERS.astype(np.float32) * 1.7 - 10.3):
        img = np.zeros((100, 100, 3), np.uint8)
        got, want = viz.draw_bbox3d(img.copy(), corners), jax_viz.draw_bbox3d(img.copy(), corners)
        assert got.sum() > 0
        np.testing.assert_array_equal(got, want)


def test_draws_into_a_contiguous_array_and_copies_another():
    """Kept quirk (ROADMAP §C): a C-contiguous uint8 frame is drawn on and
    returned as it is; a strided view is copied and left as it was; JAX's
    functions do the same."""
    for mod in (viz, jax_viz):
        img = np.zeros((64, 64, 3), np.uint8)
        out = mod.draw_bbox2d(img, [4, 4, 40, 40])
        assert out is img and img.sum() > 0
        out3 = mod.draw_bbox3d(img, CORNERS // 2)
        assert out3 is img
        base = np.zeros((64, 128, 3), np.uint8)
        view = base[:, ::2]
        out = mod.draw_bbox2d(view, [4, 4, 40, 40])
        assert out is not view and out.sum() > 0 and base.sum() == 0
        out3 = mod.draw_bbox3d(view, CORNERS // 2)
        assert out3 is not view and base.sum() == 0


def test_draw_scene_of_the_ports_scene_reconstruction_matches_jax():
    """Every detection NMS keeps (``obj_thresh`` 0) draws its 2-D box, the
    empty slots nothing; none lifts on these 64x64 frames under the KITTI
    camera, so the 3-D boxes are ``viz_scene``'s to cover. The port's scene as
    tensors, JAX's draw on the same scene as numpy arrays; the image as a
    tensor and as an array."""
    jax_cfg, cfg = tiny_configs()
    _, _, model = build(jax_cfg, cfg, seed=3)
    x = frames(10)
    scene = scene_reconstruction(model, torch.from_numpy(x), KITTI_COLS_ROWS, 0.0, 0.5, sample_shapes=False)
    assert 0 < int(scene["valid_det"].sum()) < len(scene["valid_det"]), scene["valid_det"]
    got = viz.draw_scene(torch.from_numpy(x[0]), scene)
    want = jax_viz.draw_scene(x[0], {k: v.numpy() for k, v in scene.items()})
    assert got.dtype == np.uint8 and got.shape == x[0].shape
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, (x[0] * 255).astype(np.uint8))
    # without valid_det the 2-D boxes follow valid, in both packages
    lifted = {k: v.numpy() for k, v in scene.items() if k != "valid_det"}
    np.testing.assert_array_equal(viz.draw_scene(x[0], lifted), jax_viz.draw_scene(x[0], lifted))


def test_viz_scene_digest_is_pinned():
    """The frame phase 17 of ``chip_smoke.py`` draws on the card's host:
    both packages give the bytes whose sha256 it checks."""
    image, scene = chip_smoke.viz_scene()
    got = viz.draw_scene(image, scene)
    np.testing.assert_array_equal(got, jax_viz.draw_scene(image, scene))
    assert hashlib.sha256(got.tobytes()).hexdigest() == chip_smoke.VIZ_SHA256
    drawn = np.any(got != (image * 255).astype(np.uint8), axis=-1)
    assert drawn[: 60].any() and not drawn[70:, 40:70].any()  # slot 2 was dropped: its box is not drawn
