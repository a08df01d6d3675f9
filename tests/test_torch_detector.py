"""PyTorch port, the multi-object detector-reconstructor, against the JAX
package on the CPU: ``Head2D``'s map and average heads, the pixel-shuffle
decoder, NMS, the grid decode (``encode_grid``, ``detect`` with tied scores,
``reconstruct``), the geometry, the scene pass, the exported per-frame
program, and one detection at full width.

Weights come from a flax tree drawn in numpy through
``convert.params_from_flax``; inputs from numpy seeds; JAX's random draws are
made from its keys and handed to the port. The JAX side runs under
``jax.jit``. Comparisons are float32; each tolerance is stated where it is
set: 1e-5 relative unless it says why not.
"""

import dataclasses
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anytime3d_tpu import geometry as jax_geometry
from anytime3d_tpu.models import detector as jax_detector
from anytime3d_tpu.models.pipeline import scene_reconstruction as jax_scene_reconstruction
from anytime3d_tpu.nn import autoencoder3d as jax_ae
from anytime3d_tpu.nn import darknet as jax_darknet
from anytime3d_tpu.serving import export as jax_export
from anytime3d_tpu_torch import geometry
from anytime3d_tpu_torch.convert import params_from_flax
from anytime3d_tpu_torch.models import detector
from anytime3d_tpu_torch.models.pipeline import scene_reconstruction
from anytime3d_tpu_torch.nn import autoencoder3d as ae
from anytime3d_tpu_torch.nn import darknet
from anytime3d_tpu_torch.ops import nms
from anytime3d_tpu_torch.serving.export import export_detector, load_infer, make_detector_fn

jax_nms = importlib.import_module("anytime3d_tpu.ops.nms")  # the package re-exports the function under the same name

RTOL = dict(rtol=1e-5, atol=1e-6)  # f32 on both sides: summation order only
NET_TOL = dict(rtol=1e-4, atol=1e-5)  # through a backbone and head of ~10 layers in another summation order
GRAD_REL = 1e-4  # each gradient leaf against JAX's, relative to that leaf's largest entry
FRAME = 64  # the tiny model's frames: a 2x2 grid (stride 32)
KITTI_COLS_ROWS = (1242, 375)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)  # the suite runs several workers per machine


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def random_tree(init, rng, noise=0.05):
    """A flax param tree of the shapes ``init(key)`` makes, drawn in numpy:
    kernels normal with variance 1/fan_in; norm scales 1 and biases 0, moved
    by ``noise`` times a normal so that nothing is special."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))["params"]

    def leaf(path, s):
        if path[-1].key == "kernel":
            return rng.standard_normal(s.shape, np.float32) / np.float32(math.sqrt(math.prod(s.shape[:-1])))
        base = np.ones(s.shape, np.float32) if path[-1].key == "scale" else np.zeros(s.shape, np.float32)
        return base + np.float32(noise) * rng.standard_normal(s.shape, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def tiny_configs(max_detections=8):
    """``tests/test_detector.py::tiny_detector`` (Darknet53Tiny, a 32-wide head,
    3 predictors, z = 4, the pixel-shuffle decoder to 16^3) as (jax, port)."""
    out = []
    for det_mod, ae_mod in ((jax_detector, jax_ae), (detector, ae)):
        out.append(det_mod.DetectorConfig(
            predictor_num=3, z_inst_dim=4, predict_log_var=True, backbone="darknet53tiny",
            head_filter_nums=(32,), head_filter_sizes=(3,),
            decoder=ae_mod.Decoder3DConfig(input_dim=4, output_shape=(16, 16, 16, 1), filter_nums=(16, 8, 1),
                                           filter_sizes=(3, 3, 3), strides=(1, 2, 2)),
            max_detections=max_detections, shape_samples=4))
    return out


def build(jax_cfg, cfg, seed=0, frame=FRAME, edit=None):
    """(flax module, tree, port model) on one random tree; ``edit(tree)`` may
    change the tree first."""
    jax_model = jax_detector.DetectorReconstructor(jax_cfg)
    init = lambda k: jax_model.init(k, jnp.zeros((1, frame, frame, 3)),  # noqa: E731
                                    method=jax_detector.DetectorReconstructor.initialize)
    tree = random_tree(init, np.random.default_rng(seed))
    if edit is not None:
        edit(tree)
    with torch.device("meta"):  # no init draws: at full width they take seconds
        model = detector.DetectorReconstructor(cfg)
    state = params_from_flax(tree)
    assert state.keys() == model.state_dict().keys()
    model.load_state_dict(state, assign=True)
    return jax_model, tree, model


@pytest.fixture(scope="module")
def tiny():
    jax_cfg, cfg = tiny_configs()
    return build(jax_cfg, cfg)


def frames(seed, n=1, rows=FRAME, cols=FRAME):
    return np.random.default_rng(seed).uniform(size=(n, rows, cols, 3)).astype(np.float32)


def jax_apply(jax_model, method, *static):
    """``jax.jit`` of ``jax_model.apply(params, *args, *static, method=method)``."""
    return jax.jit(lambda p, *a: jax_model.apply({"params": p}, *a, *static, method=method))


def assert_fields_close(got, want, tol=NET_TOL):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].detach().numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, err_msg=k, **tol)


# ---------------------------------------------------------------- blocks


@pytest.mark.parametrize("pooling", [None, "average", "max"])
def test_head2d_matches_flax(pooling):
    """The map head (the detector's), the average head and the max head: the
    output and the gradients w.r.t. the input and every kernel."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 4, 16)).astype(np.float32)
    mod = jax_darknet.Head2D(output_dim=10, filter_nums=(8,), filter_sizes=(3,), last_pooling=pooling)
    tree = random_tree(lambda k: mod.init(k, jnp.asarray(x)), rng)
    y_ref, vjp = jax.vjp(lambda p, xx: mod.apply({"params": p}, xx), tree, jnp.asarray(x))
    g = rng.normal(size=y_ref.shape).astype(np.float32)
    dp, dx = vjp(jnp.asarray(g))
    head = darknet.Head2D(16, 10, (8,), (3,), last_pooling=pooling)
    head.load_state_dict(params_from_flax(tree))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = head(xt)
    gx, gk0, gk1 = torch.autograd.grad(y, [xt, head.convblock2d_0.conv_0.weight, head.conv_0.weight],
                                       torch.from_numpy(g))
    assert y.shape == y_ref.shape
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), **NET_TOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(dx), **NET_TOL)
    np.testing.assert_allclose(gk0.numpy(), np.asarray(dp["ConvBlock2D_0"]["Conv_0"]["kernel"]).transpose(3, 2, 0, 1),
                               **NET_TOL)
    np.testing.assert_allclose(gk1.numpy(), np.asarray(dp["Conv_0"]["kernel"]).transpose(3, 2, 0, 1), **NET_TOL)


def decoder_configs(name):
    """(jax, port) pixel-shuffle decoders: the tiny detector's (16^3, k=3:
    the final conv is ceil(3/2) = 2 wide), one whose final conv is ceil(5/2)
    = 3 wide (a plain ``Conv3d``, no ``conv_k2``) and the CLI's at 32^3."""
    out = []
    for mod in (jax_ae, ae):
        if name in ("tiny16", "final_k3"):
            k = 3 if name == "tiny16" else 5
            out.append(mod.Decoder3DConfig(input_dim=4, output_shape=(16, 16, 16, 1), filter_nums=(16, 8, 1),
                                           filter_sizes=(3, 3, k), strides=(1, 2, 2)))
        else:
            out.append(mod.Decoder3DConfig(input_dim=16, output_shape=(32, 32, 32, 1), filter_nums=(128, 64, 32, 1),
                                           filter_sizes=(4, 4, 4, 4), strides=(1, 2, 2, 2)))
    return out


@pytest.mark.parametrize("name", ["tiny16", "final_k3", "cli32"])
def test_pixel_shuffle_decoder_matches_flax(name):
    """The non-blocked decoder: dense, transposed convs, the phase conv
    (k=2: ``conv_k2``; k=3: ``Conv3d``), depth-to-space(2), sigmoid. The
    output and the gradients w.r.t. the latent and every leaf, flax names
    mapped (a 2x2x2 ``Conv_0`` stays (2, 2, 2, C, N), a 3x3x3 one goes
    DHWIO -> OIDHW)."""
    jax_cfg, cfg = decoder_configs(name)
    rng = np.random.default_rng(3)
    z = rng.normal(size=(3, cfg.input_dim)).astype(np.float32)
    mod = jax_ae.Decoder3D(jax_cfg)
    tree = random_tree(lambda k: mod.init(k, jnp.asarray(z)), rng)
    y_ref, vjp = jax.vjp(jax.jit(lambda p, zz: mod.apply({"params": p}, zz)), tree, jnp.asarray(z))
    g = rng.normal(size=y_ref.shape).astype(np.float32)
    dp, dz = vjp(jnp.asarray(g))
    dec = ae.Decoder3D(cfg)
    assert isinstance(dec.conv_0, ae.Conv3d if name == "final_k3" else ae.ConvK2) and not dec.blocked
    state = params_from_flax(tree)
    assert state.keys() == dec.state_dict().keys()
    kernel = np.asarray(tree["Conv_0"]["kernel"])
    want = kernel if name != "final_k3" else kernel.transpose(4, 3, 0, 1, 2)
    np.testing.assert_array_equal(state["conv_0.weight"].numpy(), want)
    dec.load_state_dict(state)
    zt = torch.from_numpy(z).requires_grad_(True)
    y = dec(zt)
    names, params = zip(*dec.named_parameters())
    grads = torch.autograd.grad(y, [zt, *params], torch.from_numpy(g))
    assert y.shape == y_ref.shape == (3, *cfg.output_shape)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), **NET_TOL)
    want = params_from_flax(np_tree(dp))
    want["z"] = torch.from_numpy(np.array(dz))
    for n, gr in zip(("z", *names), grads):  # sums over every voxel: relative to the leaf's largest entry
        w = want[n].numpy()
        assert float(np.abs(gr.numpy() - w).max()) <= GRAD_REL * float(np.abs(w).max()), n
    with pytest.raises(ValueError, match="blocked_output"):
        dec(zt, blocked_output=True)


@pytest.mark.parametrize("change", [{"final_mode": "transpose"}, {"strides": (1, 2, 1)}, {"mid_equiv": True},
                                    {"tail_init_match_transpose": True}])
def test_other_decoder_layouts_still_raise(change):
    """The tiny decoder (16^3, k=3) in the other layouts of the JAX package:
    a transposed-conv final stage (``'transpose'``, and any last stride 1),
    ``mid_equiv`` (no k=4 s=2 stage here: the classic blocks stay) and
    ``tail_init_match_transpose`` (no blocked tail here: the pixel shuffle
    stays). flax's names, the output and the gradients w.r.t. the latent and
    every leaf."""
    jax_cfg, cfg = (dataclasses.replace(c, **change) for c in decoder_configs("tiny16"))
    rng = np.random.default_rng(4)
    z = rng.normal(size=(3, cfg.input_dim)).astype(np.float32)
    mod = jax_ae.Decoder3D(jax_cfg)
    tree = random_tree(lambda k: mod.init(k, jnp.asarray(z)), rng)
    y_ref, vjp = jax.vjp(jax.jit(lambda p, zz: mod.apply({"params": p}, zz)), tree, jnp.asarray(z))
    g = rng.normal(size=y_ref.shape).astype(np.float32)
    dp, dz = vjp(jnp.asarray(g))
    dec = ae.Decoder3D(cfg)
    transposed = cfg.final_mode == "transpose" or cfg.strides[-1] == 1
    assert hasattr(dec, "convtranspose_0") == transposed and hasattr(dec, "conv_0") == (not transposed)
    state = params_from_flax(tree)
    assert state.keys() == dec.state_dict().keys()
    dec.load_state_dict(state)
    zt = torch.from_numpy(z).requires_grad_(True)
    y = dec(zt)
    names, params = zip(*dec.named_parameters())
    grads = torch.autograd.grad(y, [zt, *params], torch.from_numpy(g))
    assert y.shape == y_ref.shape
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), **NET_TOL)
    want = params_from_flax(np_tree(dp))
    want["z"] = torch.from_numpy(np.array(dz))
    for n, gr in zip(("z", *names), grads):  # relative to the leaf's largest entry
        w = want[n].numpy()
        assert float(np.abs(gr.numpy() - w).max()) <= GRAD_REL * float(np.abs(w).max()), n


# ---------------------------------------------------------------- NMS


def nms_case(case):
    """(boxes (N, 5), valid or None) of a named case."""
    rng = np.random.default_rng(len(case))
    n = 12
    x0, y0 = rng.uniform(0, 0.6, n), rng.uniform(0, 0.6, n)
    boxes = np.stack([x0, y0, x0 + rng.uniform(0.1, 0.4, n), y0 + rng.uniform(0.1, 0.4, n),
                      rng.uniform(size=n)], -1).astype(np.float32)
    valid = None
    if case == "ties":  # equal scores: the slot order decides who suppresses whom
        boxes[:, 4] = np.round(boxes[:, 4] * 3) / 3
    elif case == "invalid":
        valid = rng.uniform(size=n) < 0.6
    elif case == "full_suppression":  # one box repeated: only the first of the top scores survives
        boxes[:, :4] = boxes[0, :4]
        boxes[:, 4] = 0.5
    elif case == "negative_extents":  # inverted boxes: negative areas, as the reference computes them
        boxes[::2, [0, 2]] = boxes[::2, [2, 0]]
    return boxes, valid


@pytest.mark.parametrize("case", ["random", "ties", "invalid", "full_suppression", "negative_extents"])
def test_nms_matches_jax(case):
    boxes, valid = nms_case(case)
    iou = nms.box_iou_matrix(torch.from_numpy(boxes)).numpy()
    np.testing.assert_allclose(iou, np.asarray(jax.jit(jax_nms.box_iou_matrix)(boxes)), **RTOL)
    for thresh in (0.1, 0.5):
        want = np.asarray(jax_nms.nms(jnp.asarray(boxes), thresh, None if valid is None else jnp.asarray(valid)))
        got = nms.nms(torch.from_numpy(boxes), thresh, None if valid is None else torch.from_numpy(valid)).numpy()
        np.testing.assert_array_equal(got, want)
        if case == "full_suppression":
            assert got.sum() == 1 and got[0]
    assert nms.nms_indices(boxes, 0.3) == jax_nms.nms_indices(boxes, 0.3)
    assert nms.nms_indices(boxes[:0]) == jax_nms.nms_indices(boxes[:0]) == []


# ---------------------------------------------------------------- the grid decode


def test_encode_grid_matches_jax(tiny):
    jax_model, tree, model = tiny
    x = frames(0, n=2)
    want = jax_apply(jax_model, jax_detector.DetectorReconstructor.encode_grid)(tree, x)
    with torch.no_grad():
        got = model.encode_grid(torch.from_numpy(x))
    assert got["objness"].shape == (2, 2, 2, 3, 1) and got["z_mean"].shape == (2, 2, 2, 3, 4)
    assert_fields_close(got, want)
    # the flax names the converter maps: the bare 1x1 head conv (HWIO -> OIHW) and the decoder's
    state = params_from_flax(tree)
    np.testing.assert_array_equal(state["head.conv_0.weight"].numpy(),
                                  np.asarray(tree["head"]["Conv_0"]["kernel"]).transpose(3, 2, 0, 1))
    assert {"decoder.denseblock_0.dense_0.weight", "decoder.deconvblock3d_1.convtranspose_0.weight",
            "decoder.conv_0.weight", "head.convblock2d_0.conv_0.weight"} <= set(state)


def tie_objness(tree, predictors=3, channels=None):
    """Zero the head's objectness columns: every predictor of every cell scores 0.5."""
    k = tree["head"]["Conv_0"]["kernel"]
    per = channels or k.shape[-1] // predictors
    k[..., ::per] = 0.0


@pytest.mark.parametrize("top_1", [True, False], ids=["top1", "all_predictors"])
@pytest.mark.parametrize("case", ["random", "all_tied"])
def test_detect_matches_jax(case, top_1):
    """Equal ``valid`` masks, the same slots (every field equal within
    tolerance, slot by slot) and boxes within 1e-5. ``all_tied``: every
    objectness is 0.5, so the per-cell winner, the top-K and NMS all break
    ties, by the lower index as JAX does."""
    jax_cfg, cfg = tiny_configs()
    jax_model, tree, model = build(jax_cfg, cfg, seed=1, edit=tie_objness if case == "all_tied" else None)
    x = frames(1)
    thresh = 0.3 if case == "all_tied" else 0.45
    want = jax_apply(jax_model, jax_detector.DetectorReconstructor.detect, thresh, 0.4, top_1)(tree, x)
    with torch.no_grad():
        got = model.detect(torch.from_numpy(x), thresh, 0.4, top_1)
    if case == "all_tied":
        scores = np.asarray(want["bbox2d"])[:, 4]
        assert (scores == 0.5).sum() == (8 if not top_1 else 4)
        assert 0 < np.asarray(want["valid"]).sum() < np.asarray(want["valid"]).size  # NMS removed some
    assert_fields_close(got, want)


@pytest.mark.parametrize("sample", [False, True])
def test_reconstruct_matches_jax(tiny, sample):
    """K latents decoded: the posterior mean, or the mean of S samples repeated
    object by object (the draws made from the JAX key, injected)."""
    jax_model, tree, model = tiny
    rng = np.random.default_rng(4)
    zm, zlv = (rng.normal(size=(5, 4)).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(7)
    want = jax_apply(jax_model, jax_detector.DetectorReconstructor.reconstruct, sample)(tree, key, zm, zlv)
    eps = np.array(jax.random.normal(key, (5 * 4, 4), jnp.float32))
    with torch.no_grad():
        got = model.reconstruct(torch.from_numpy(zm), torch.from_numpy(zlv), sample, eps=torch.from_numpy(eps))
    assert got.shape == (5, 16, 16, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **NET_TOL)


# ---------------------------------------------------------------- geometry


def detections(seed, k=6, border=False):
    """Normalized boxes, (w, h, l), and the sin/cos of (azimuth, elevation, in-plane)."""
    rng = np.random.default_rng(seed)
    x0, y0 = rng.uniform(0.12, 0.5, k), rng.uniform(0.12, 0.5, k)
    boxes = np.stack([x0, y0, x0 + rng.uniform(0.1, 0.35, k), y0 + rng.uniform(0.1, 0.35, k),
                      rng.uniform(size=k)], -1).astype(np.float32)
    if border:
        boxes[0, 0] = 0.02  # hugs the left border: not lifted
    whl = rng.uniform(1.0, 4.0, (k, 3)).astype(np.float32)
    ang = (rng.uniform(-np.pi, np.pi, (k, 3)) * np.array([1.0, 0.2, 0.2])).astype(np.float32)
    return boxes, whl, np.sin(ang), np.cos(ang)


def t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_projection_functions_match_jax():
    rng = np.random.default_rng(5)
    px = rng.uniform([0, 0], KITTI_COLS_ROWS, (7, 2)).astype(np.float32)
    ray = np.asarray(jax_geometry.get_ray(jax_geometry.KITTI_PROJ_INV, jnp.asarray(px)))
    np.testing.assert_allclose(geometry.get_ray(geometry.KITTI_PROJ_INV, *t(px)).numpy(), ray, **RTOL)
    np.testing.assert_allclose(geometry.ray_rotation(*t(ray)).numpy(),
                               np.asarray(jax_geometry.ray_rotation(jnp.asarray(ray))), **RTOL)
    _, whl, s, c = detections(5, k=7)
    np.testing.assert_allclose(geometry.euler_to_rotation(*t(s, c)).numpy(),
                               np.asarray(jax_geometry.euler_to_rotation(jnp.asarray(s), jnp.asarray(c))), **RTOL)
    r_want = np.asarray(jax_geometry.compose_object_rotation(jnp.asarray(s), jnp.asarray(c), jnp.asarray(px)))
    r = geometry.compose_object_rotation(*t(s, c, px))
    np.testing.assert_allclose(r.numpy(), r_want, **RTOL)
    pts = rng.normal(size=(7, 3)).astype(np.float32) + np.float32([0, 0, 12])
    np.testing.assert_allclose(geometry.project_points(geometry.KITTI_PROJ, *t(pts)).numpy(),
                               np.asarray(jax_geometry.project_points(jax_geometry.KITTI_PROJ, jnp.asarray(pts))),
                               rtol=1e-5, atol=1e-3)  # pixels, in the hundreds
    corners = geometry.project_bbox3d_corners(geometry.KITTI_PROJ, *t(r_want, pts, whl))
    want = jax_geometry.project_bbox3d_corners(jax_geometry.KITTI_PROJ, jnp.asarray(r_want), jnp.asarray(pts),
                                               jnp.asarray(whl))
    assert corners.shape == (7, 8, 2)
    np.testing.assert_allclose(corners.numpy(), np.asarray(want), rtol=1e-5, atol=1e-3)


def test_recover_translation_matches_jax():
    """Six boxes, the last one running off the bottom of the frame and turned
    upside down, so that no hypothesis is valid (the IoU is -1 and the
    translation 0 on both sides). The null vector's sign differs between the
    two SVDs at will; the result must not."""
    boxes, whl, s, c = detections(6)
    px = boxes[:, :4] * np.float32([1242, 375, 1242, 375])
    px[5], whl[5] = [19.833162, 291.98721, 392.23331, 403.00928], [5.091628, 3.8535621, 2.6400697]
    ang = np.float32([0.36765215, -3.0261974, -0.44991532])
    s[5], c[5] = np.sin(ang), np.cos(ang)
    centers = np.stack([(px[:, 0] + px[:, 2]) / 2, (px[:, 1] + px[:, 3]) / 2], -1)
    r = np.asarray(jax_geometry.compose_object_rotation(jnp.asarray(s), jnp.asarray(c), jnp.asarray(centers)))
    t_want, iou_want = jax.jit(jax.vmap(jax_geometry.recover_translation, in_axes=(0, 0, 0, None)))(
        px, whl, r, jax_geometry.KITTI_PROJ)
    t_got, iou_got = geometry.recover_translation(*t(px, whl, r))
    assert float(iou_want[5]) < 0 and float(iou_got[5]) < 0 and not t_got[5].any()
    assert (np.asarray(iou_want[:5]) > 0).all()
    np.testing.assert_allclose(iou_got.numpy(), np.asarray(iou_want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_got.numpy(), np.asarray(t_want), rtol=1e-5, atol=1e-4)  # metres, up to ~40
    t1, iou1 = geometry.recover_translation(*t(px[0], whl[0], r[0]))  # one object, unbatched
    np.testing.assert_allclose(t1.numpy(), t_got[0].numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("occupied", ["shape", "empty"])
def test_rescale_transform_points_matches_jax(occupied):
    rng = np.random.default_rng(8)
    vox = np.zeros((16, 16, 16), np.float32)
    if occupied == "shape":
        vox[3:11, 5:9, 2:14] = rng.uniform(0.4, 1.0, (8, 4, 12))
    whl = np.float32([1.6, 1.5, 4.0])
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.asarray(jax_geometry.euler_to_rotation(jnp.sin(jnp.float32([0.3, 0.1, -0.2])),
                                                             jnp.cos(jnp.float32([0.3, 0.1, -0.2]))))
    pose[:3, 3] = [1.0, -0.5, 12.0]
    pts_want, mask_want = jax.jit(jax_geometry.rescale_transform_points)(vox, whl, pose)
    pts, mask = geometry.rescale_transform_points(*t(vox, whl, pose))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_want))
    np.testing.assert_allclose(pts.numpy(), np.asarray(pts_want), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(geometry.voxel_grid_points(5).numpy(), np.asarray(jax_geometry.voxel_grid_points(5)))


def test_lift_detections_matches_jax():
    boxes, whl, s, c = detections(9, border=True)
    valid = np.array([True, True, True, False, True, True])
    want = jax.jit(lambda b, w, s_, c_, v: jax_geometry.lift_detections(b, w, s_, c_, image_size=KITTI_COLS_ROWS,
                                                                         valid=v))(boxes, whl, s, c, valid)
    got = geometry.lift_detections(*t(boxes, whl, s, c), image_size=KITTI_COLS_ROWS, valid=torch.from_numpy(valid))
    assert not bool(got["valid"][0]) and not bool(got["valid"][3])
    for k in want:
        w = np.asarray(want[k])
        if w.dtype == bool:
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
        else:  # pixels in the hundreds, metres up to ~40
            np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-5, atol=1e-3, err_msg=k)


# ---------------------------------------------------------------- the scene pass and serving


@pytest.mark.parametrize("sample", [False, True])
def test_scene_reconstruction_matches_jax(tiny, sample):
    jax_model, tree, model = tiny
    x = frames(10)
    key = jax.random.PRNGKey(3)
    want = jax.jit(lambda p, im, k: jax_scene_reconstruction(jax_model, p, im, k, KITTI_COLS_ROWS, 0.0, 0.5,
                                                             sample_shapes=sample))(tree, x, key)
    eps = np.array(jax.random.normal(key, (8 * 4, 4), jnp.float32))
    got = scene_reconstruction(model, torch.from_numpy(x), KITTI_COLS_ROWS, 0.0, 0.5, sample_shapes=sample,
                               eps=torch.from_numpy(eps))
    assert got["shapes"].shape == (8, 16, 16, 16) and got["pose"].shape == (8, 4, 4)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        if w.dtype == bool:
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
        elif k in ("pose", "bbox3d_corners_px"):
            # metres and pixels from the fields' 1e-5 differences: the null vector of a near-singular 4x4
            # system amplifies them ~10x, and a corner near the camera plane again
            np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-3, atol=1e-2, err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), w, err_msg=k, **NET_TOL)


def test_export_detector_matches_eager_and_jax(tiny):
    """The exported per-frame program (detect + the posterior-mean decode of
    the K slots), loaded by ``load_infer`` as ``fn(images)``, against the eager
    program and against JAX's artifact of the same tree; batches other than 1
    are refused."""
    jax_model, tree, model = tiny
    x = frames(11)
    fn = load_infer(export_detector(model, (1, FRAME, FRAME, 3), obj_thresh=0.4, iou_thresh=0.5))
    assert fn.input_shape == (1, FRAME, FRAME, 3) and fn.mask_shape is None
    got = fn(torch.from_numpy(x))
    eager = make_detector_fn(model, 0.4, 0.5)(torch.from_numpy(x))
    assert set(got) == set(eager) == {"bbox2d", "valid", "bbox3d", "z_mean", "z_log_var", "ori_sin", "ori_cos",
                                      "rad_log_var", "vox"}
    for k in eager:
        torch.testing.assert_close(got[k], eager[k], rtol=0, atol=1e-6)  # the same ops on the same weights
    jax_fn = jax_export.load_infer(jax_export.export_detector(jax_model, tree, (1, FRAME, FRAME, 3), 0.4, 0.5))
    assert_fields_close(got, jax_fn(jnp.asarray(x)))
    with pytest.raises(ValueError, match="per-frame"):
        export_detector(model, (2, FRAME, FRAME, 3))


def test_full_width_detect_matches_jax():
    """The default ``DetectorConfig`` (Darknet19, four 1024-wide head layers, 5
    predictors of 49 channels, 245 a cell; max_detections 32) on one 64x64
    frame: the parameter names both ways, equal ``valid`` masks and slots."""
    jax_cfg = jax_detector.DetectorConfig(max_detections=32)
    cfg = detector.DetectorConfig(max_detections=32)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_cfg)
    assert cfg.head_output_dim == 5 * 49
    jax_model, tree, model = build(jax_cfg, cfg, seed=12)
    x = frames(12)
    want = jax_apply(jax_model, jax_detector.DetectorReconstructor.detect, 0.3, 0.5)(tree, x)
    with torch.no_grad():
        got = model.detect(torch.from_numpy(x), 0.3, 0.5)
    assert got["bbox2d"].shape == (20, 5)  # min(K, 2 * 2 * 5)
    # ~25 layers at full width; GroupNorm keeps every map O(1): 1e-4 of the value
    assert_fields_close(got, want, tol=dict(rtol=1e-4, atol=1e-4))
