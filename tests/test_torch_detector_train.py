"""PyTorch port, training and evaluating the detector, against the JAX package
on the CPU: the grid targets, the synthetic multi-object loader, collation,
every loss term and gradient leaf of ``detector_losses`` (with and without
the 3-D sizes and the instance priors, packed voxels, uint8 images, tied
top-K cells), the Adam step and its zeroed update, ``evaluate_detector``
and the AP integrator, the trainer's ``step_fn`` with checkpoints and a NaN
restart, and ``cli.train_detector`` on the CPU.

The tiny detector of ``tests/test_torch_detector.py`` on one flax tree drawn
in numpy; the shape decode's draws are made from the JAX key and injected.
Comparisons are float32; each tolerance is stated where it is set.
"""

import copy
import dataclasses
import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from anytime3d_tpu.data import collate as jax_collate
from anytime3d_tpu.data import pascal3d as jax_pascal3d
from anytime3d_tpu.data.modelnet import SyntheticMultiObjectLoader as JaxMultiObjectLoader
from anytime3d_tpu.data.packing import pack_voxels
from anytime3d_tpu.evaluation import detection as jax_detection
from anytime3d_tpu.train import detector_step as jax_detector_step
from anytime3d_tpu.train import step as jax_step
from anytime3d_tpu.train.state import TrainState as JaxTrainState
from anytime3d_tpu_torch.cli import train_detector as cli
from anytime3d_tpu_torch.convert import params_from_flax
from anytime3d_tpu_torch.data.collate import collate_multiobject
from anytime3d_tpu_torch.data.modelnet import SyntheticMultiObjectLoader
from anytime3d_tpu_torch.data.pascal3d import build_grid_targets
from anytime3d_tpu_torch.evaluation import detection
from anytime3d_tpu_torch.train import checkpoint
from anytime3d_tpu_torch.train.detector_step import DetectorLossConfig, detector_losses, make_detector_train_step
from anytime3d_tpu_torch.train.state import create_train_state
from anytime3d_tpu_torch.train.trainer import Trainer, TrainerConfig
from tests.test_torch_detector import build, frames, tiny_configs

B, GH, GW, P, Z, DIM, SLOTS = 2, 2, 2, 3, 4, 16, 3
LOSS_RTOL = 1e-4  # loss terms: sums over the grid and 4096-voxel decodes in another order
GRAD_REL = 1e-4  # each gradient leaf against JAX's float64 one, relative to that leaf's largest entry
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)  # the suite runs several workers per machine


@pytest.fixture(scope="module")
def tiny():
    jax_cfg, cfg = tiny_configs()
    return build(jax_cfg, cfg, seed=20)


def scene_objects(rng, n, inst=5, with_b3=True):
    """``n`` object dicts as the loaders make them, boxes inside the frame."""
    objs = []
    for i in range(n):
        x0, y0 = rng.uniform(0.0, 0.6, 2)
        o = {"bbox": np.float32([x0, y0, x0 + rng.uniform(0.1, 0.4), y0 + rng.uniform(0.1, 0.4)]),
             "euler_rad": tuple(rng.uniform(-np.pi, np.pi, 3)), "inst_onehot": np.eye(inst, dtype=np.float32)[i % inst],
             "voxel_index": i}
        if with_b3:
            o["bbox3d_whl"] = rng.uniform(0.5, 4.0, 3).astype(np.float32)
        objs.append(o)
    return objs


def make_batch(seed, counts=(3, 1), form="dense"):
    """A collated batch of ``len(counts)`` 64x64 frames with that many objects
    each. ``form``: "dense" (float images and voxels), "packed" (uint8 images,
    bit-packed voxels), "full" (dense plus instance-prior means)."""
    rng = np.random.default_rng(seed)
    targets, vlists = [], []
    for n in counts:
        targets.append(build_grid_targets(scene_objects(rng, n), (GW, GH), P))
        vlists.append((rng.uniform(size=(n, DIM, DIM, DIM, 1)) > 0.7).astype(np.float32))
    stacked = {k: np.stack([t_[k] for t_ in targets]) for k in targets[0]}
    u8 = rng.integers(0, 256, (len(counts), 64, 64, 3)).astype(np.uint8)
    b = collate_multiobject(u8.astype(np.float32) / 255.0, stacked, vlists, max_slots=SLOTS)
    if form == "packed":
        vox = b.pop("voxels")
        b["voxels_packed"] = pack_voxels(vox.reshape(-1, DIM**3)).reshape(vox.shape[0], SLOTS, -1)
        b["images"] = u8
    if form == "full":
        b["z_prior_mean"] = rng.normal(size=(len(counts), GH, GW, P, Z)).astype(np.float32)
    return b


def without_b3(b):
    return {k: v for k, v in b.items() if k != "bbox3d"}


def port_batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def jax_eps(key, k):
    return torch.from_numpy(np.array(jax.random.normal(key, (B, k, Z), jnp.float32)))


# ---------------------------------------------------------------- data


def test_build_grid_targets_matches_jax():
    """With and without 3-D sizes; an object off the frame and a full cell
    (four centres in one cell of 3 predictors) are dropped the same way."""
    rng = np.random.default_rng(1)
    objs = scene_objects(rng, 6)
    objs[1]["bbox"] = np.float32([0.9, 0.2, 1.3, 0.4])  # centre off the frame
    for o in objs[2:6]:
        o["bbox"] = np.float32([0.05, 0.05, 0.2, 0.2])  # one cell, four objects
    for case in (objs, [{k: v for k, v in o.items() if k != "bbox3d_whl"} for o in objs], []):
        got, want = build_grid_targets(case, (5, 3), P), jax_pascal3d.build_grid_targets(case, (5, 3), P)
        assert got.keys() == want.keys() and ("bbox3d" in got) == (case is objs)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert build_grid_targets(objs, (5, 3), P)["objness"][0, 0].sum() == P


def test_synthetic_multi_object_loader_is_bit_equal_to_jax():
    """Non-square frames (40 x 24) on a 5 x 3 grid, 4 objects at most, over an
    epoch boundary."""
    kw = dict(num_samples=24, dim=16, image_size=(40, 24), grid_size=(5, 3), max_objects=4, seed=3)
    ours, theirs = SyntheticMultiObjectLoader(**kw), JaxMultiObjectLoader(**kw)
    for _ in range(5):
        (ia, ta, va), (ib, tb, vb) = ours.getNextBatch(4), theirs.getNextBatch(4)
        assert ia.shape == (4, 24, 40, 3) and ia.dtype == ib.dtype
        np.testing.assert_array_equal(ia, ib)
        assert ta.keys() == tb.keys()
        for k in tb:
            assert ta[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)
        assert len(va) == len(vb) and all(np.array_equal(a, b) for a, b in zip(va, vb))
    assert ours.epoch == theirs.epoch > 0 and ours.dataStart == theirs.dataStart


def test_collate_multiobject_matches_jax():
    """Slot overflow: the third object of a 2-slot budget loses its shape target."""
    loader = SyntheticMultiObjectLoader(num_samples=16, dim=8, image_size=(32, 32), grid_size=(2, 2), max_objects=3,
                                        seed=5)
    images, targets, vlists = loader.getNextBatch(6)
    got = collate_multiobject(images, targets, vlists, max_slots=2)
    want = jax_collate.collate_multiobject(images, targets, vlists, max_slots=2)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["voxel_slot"] == -1).sum() > (targets["voxel_slot"] == -1).sum()  # an overflow was clamped


# ---------------------------------------------------------------- losses and the step


def f32_draws_reparameterize(key, mean, log_var):
    """``ops.sampling.reparameterize`` with its draws made in float32 (as the
    port's injected ones are) and cast to ``mean``'s dtype."""
    return mean + jnp.exp(0.5 * log_var) * jax.random.normal(key, mean.shape, jnp.float32).astype(mean.dtype)


def jax_loss_and_grads64(jax_model, cfg, tree, batch, key):
    """JAX's own (total, metrics, gradients) in float64: the model, tree and
    float batch cast up, the shape decode's draws ``f32_draws_reparameterize``'s.
    The reference for every term and leaf: XLA's CPU float32 backward strays
    1.5-4.5% from it on the first two backbone blocks' weight gradients of
    these trees (sums of ~10^4 products x * g in which GroupNorm's backward
    makes g zero-mean over each group while x carries the image's offset, so
    they cancel to a small part of their terms); the port keeps ~2e-5."""
    with jax.enable_x64(True), mock.patch.object(jax_detector_step, "reparameterize", f32_draws_reparameterize):
        model64 = jax_model.clone(dtype=jnp.float64)
        tree64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)
        b64 = {k: jnp.asarray(v, jnp.float64 if np.asarray(v).dtype == np.float32 else None) for k, v in batch.items()}
        (total, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p: jax_detector_step.detector_losses(model64, cfg, p, b64, key), has_aux=True))(tree64)
        assert jax.tree.leaves(grads)[0].dtype == jnp.float64
        return float(total), {k: float(v) for k, v in metrics.items()}, params_from_flax(jax.tree.map(np.asarray, grads))


def port_grads(model, loss_cfg, batch, eps):
    """(total, metrics, names, grads) of the port's losses on ``model``, in the
    model's parameter dtype (float batches cast to it)."""
    dtype = next(model.parameters()).dtype
    b = {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in port_batch(batch).items()}
    total, metrics = detector_losses(model, loss_cfg, b, draws={"eps_z": eps.to(dtype)})
    names, params = zip(*model.named_parameters())
    return total, metrics, names, torch.autograd.grad(total, params, allow_unused=True, materialize_grads=True)


def assert_grads_match(names, grads, want64):
    """Each leaf within ``GRAD_REL`` of JAX's float64 gradient of the same
    function, relative to the leaf's largest entry."""
    for name, g in zip(names, grads):
        g, e = g.numpy(), want64[name].numpy()
        top = float(np.abs(e).max()) + 1e-12
        assert float(np.abs(g - e).max()) <= GRAD_REL * top, (name, float(np.abs(g - e).max()), top)


def test_float64_reference_draws_are_jaxs():
    """In float32 the float64 reference's reparameterize is the package's, bit
    for bit, and its draws are the ones injected into the port."""
    from anytime3d_tpu.ops.sampling import reparameterize

    key = jax.random.PRNGKey(4)
    rng = np.random.default_rng(0)
    mean, log_var = (jnp.asarray(rng.normal(size=(B, 4, Z)).astype(np.float32)) for _ in range(2))
    want = np.asarray(reparameterize(key, mean, log_var))
    np.testing.assert_array_equal(np.asarray(f32_draws_reparameterize(key, mean, log_var)), want)
    got = mean + jnp.exp(0.5 * log_var) * jnp.asarray(jax_eps(key, 4).numpy())
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("case", ["full", "packed_no_bbox3d", "tied_topk", "no_shape"])
def test_detector_losses_match_jax(tiny, case):
    """Every loss term, P/R and every gradient leaf. ``full``: float images
    and voxels, the 3-D sizes and instance-prior means. ``tied_topk``: image 0
    holds three objects and image 1 one, the decode budget is 2, so the top-K
    of the 0/1 target mask breaks ties among the ones (image 0) and among the
    zeros (image 1), by the lower index. ``packed_no_bbox3d``: uint8 images
    and bit-packed voxels, unpacked on the device, and no 3-D sizes. ``no_shape``: no decode, so no
    term reaches the decoder's norms (their gradients are zeros, as JAX's).
    The port runs in float32, JAX in float64 (``jax_loss_and_grads64``)."""
    jax_model, tree, model = tiny
    form = {"packed_no_bbox3d": "packed", "full": "full"}.get(case, "dense")
    batch = make_batch(30, form=form)
    if case == "packed_no_bbox3d":
        batch = without_b3(batch)
    k = {"tied_topk": 2, "no_shape": 0}.get(case, 4)
    loss_cfg = DetectorLossConfig(shape_decode_per_image=k)
    jax_cfg = jax_detector_step.DetectorLossConfig(shape_decode_per_image=k)
    assert dataclasses.asdict(loss_cfg) == dataclasses.asdict(jax_cfg)
    key = jax.random.PRNGKey(4)
    total_want, metrics_want, grads_want = jax_loss_and_grads64(jax_model, jax_cfg, tree, batch, key)
    total, metrics, names, grads = port_grads(model, loss_cfg, batch, jax_eps(key, k))
    assert set(metrics) == set(metrics_want)
    assert ("loss_bbox3d" in metrics) == (case != "packed_no_bbox3d") and ("loss_kl" in metrics) == (case == "full")
    assert ("loss_shape" in metrics) == (k > 0)
    for name, want in metrics_want.items():
        assert math.isclose(float(metrics[name]), want, rel_tol=LOSS_RTOL, abs_tol=1e-6), (name, metrics[name], want)
    assert math.isclose(float(total.detach()), total_want, rel_tol=LOSS_RTOL)
    assert_grads_match(names, grads, grads_want)
    if case == "no_shape":
        assert not any(g.any() for n, g in zip(names, grads) if n.startswith("decoder.") and g.dim() == 1)


def flax_layout(tree, by_name):
    """Port tensors keyed by ``state_dict`` name, laid out as the flax tree
    ``tree``: the inverse of ``convert.params_from_flax``."""
    def leaf(path, a):
        keys = [p.key for p in path]
        kind, name = keys[-2].rsplit("_", 1)[0], keys[-1]
        v = by_name[".".join(k.lower() for k in keys[:-1]) + (".bias" if name == "bias" else ".weight")].numpy()
        if name != "kernel":
            return v
        if kind == "Dense":
            return v.T
        if kind == "ConvTranspose":
            return v.transpose(2, 3, 4, 0, 1)[::-1, ::-1, ::-1]
        if v.ndim == 4:
            return v.transpose(2, 3, 1, 0)
        return v if a.shape[:3] == (2, 2, 2) else v.transpose(2, 3, 4, 1, 0)

    return jax.tree_util.tree_map_with_path(lambda path, a: np.ascontiguousarray(leaf(path, a)), tree)


def jax_state(jax_model, tree):
    params = jax.tree.map(jnp.asarray, tree)
    tx = optax.adam(LR)
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                         apply_fn=jax_model.apply, tx=tx)


def test_train_step_matches_jax_and_zeroes_a_non_finite_update(tiny):
    """Three guarded Adam steps through ``make_detector_train_step``: a frame
    holding a NaN (the gradient is zeroed whole: from a fresh state the step
    changes no parameter, the count advances), a clean batch, the NaN frame
    again (zeroed, so only the moments move the parameters). After each, the
    parameters equal those of JAX's ``apply_gradients_if_finite`` (optax's
    Adam) given the same gradients, within an ulp or two (the gradients'
    own parity is ``test_detector_losses_match_jax``'s)."""
    jax_model, tree, shared = tiny
    model = copy.deepcopy(shared)  # a copy of its own: this test steps it
    clean = make_batch(31)
    poisoned = dict(clean, images=clean["images"].copy())
    poisoned["images"][1, 5, 5, 0] = np.nan
    key = jax.random.PRNGKey(5)
    eps = jax_eps(key, 4)
    state = create_train_state(model, learning_rate=LR)
    step = make_detector_train_step(model)
    jax_apply = jax.jit(jax_step.apply_gradients_if_finite)
    state_jax = jax_state(jax_model, tree)
    fresh = {n: p.detach().clone() for n, p in model.named_parameters()}
    for i, (batch, finite) in enumerate(((poisoned, False), (clean, True), (poisoned, False))):
        _, _, names, grads = port_grads(model, DetectorLossConfig(), batch, eps)
        by_name = dict(zip(names, grads))
        grad_tree = flax_layout(tree, by_name)
        for k, v in params_from_flax(grad_tree).items():  # the layout round trip is exact
            torch.testing.assert_close(v, by_name[k], rtol=0, atol=0, equal_nan=True)
        state_jax, m_jax = jax_apply(state_jax, grad_tree, {})
        state, metrics = step(state, port_batch(batch), draws={"eps_z": eps})
        assert state.step == i + 1 and float(metrics["grads_finite"]) == float(m_jax["grads_finite"]) == finite
        assert math.isfinite(float(metrics["loss_total"])) == finite
        want = params_from_flax(jax.tree.map(np.asarray, state_jax.params))
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-6, atol=1e-7, err_msg=name)
        if i == 0:
            assert all(torch.equal(p.detach(), fresh[n]) for n, p in model.named_parameters())


# ---------------------------------------------------------------- evaluation


@pytest.mark.parametrize("dets,gt,want", [
    ([(0.9, True), (0.8, True), (0.7, True)], 3, 1.0),  # perfect
    ([(0.9, False), (0.8, False)], 2, 0.0),  # all false positives
    ([], 5, 0.0),  # no detections
    ([(0.9, True)], 0, 0.0),  # no ground truth
    ([(0.9, True), (0.8, False), (0.7, True)], 2, 5.0 / 6.0),  # TP FP TP: 1 * 1/2 + 2/3 * 1/2
    ([(0.7, True), (0.9, True), (0.8, False)], 2, 5.0 / 6.0),  # the same, inserted out of score order
], ids=["perfect", "all_fp", "no_detections", "no_gt", "mixed", "score_order"])
def test_average_precision_hand_computed(dets, gt, want):
    got = detection.average_precision(dets, gt_count=gt)
    assert abs(got - want) < 1e-9 and got == jax_detection.average_precision(dets, gt_count=gt)


def test_evaluate_detector_matches_jax(tiny):
    """Ground truth laid where the model detects (two of its boxes per frame,
    and one box elsewhere), so the set has true positives, false positives and
    misses; every metric and every diagnostic record equal to JAX's."""
    jax_model, tree, model = tiny
    images = frames(40, n=2)
    rng = np.random.default_rng(40)
    targets, vlists = [], []
    for i in range(2):
        with torch.no_grad():
            det = model.detect(torch.from_numpy(images[i:i + 1]), 0.3, 0.5)
        boxes = det["bbox2d"][det["valid"]].numpy()[:2, :4].clip(0.0, 0.99)
        objs = scene_objects(rng, len(boxes) + 1)
        for o, bx in zip(objs, boxes):
            o["bbox"] = bx
        targets.append(build_grid_targets(objs, (GW, GH), P))
        vlists.append(np.zeros((len(objs), DIM, DIM, DIM, 1), np.float32))
    batch = collate_multiobject(images, {k: np.stack([t_[k] for t_ in targets]) for k in targets[0]}, vlists, SLOTS)
    got = detection.evaluate_detector(model, lambda _i: batch, num_batches=1, obj_thresh=0.3, collect_diagnostics=True)
    want = jax_detection.evaluate_detector(jax_model, tree, lambda _i: batch, num_batches=1, obj_thresh=0.3,
                                           collect_diagnostics=True)
    assert got["num_tp"] > 0 and got["num_fn"] > 0
    assert got.keys() == want.keys()
    for k in ("num_tp", "num_fp", "num_fn", "det_precision", "det_recall", "fn_records", "tp_records"):
        assert got[k] == want[k], k
    for k in ("map50", "ori_mae_rad"):  # from the detections' scores and angles: f32 through the network
        assert math.isclose(got[k], want[k], rel_tol=1e-4, abs_tol=1e-6), k
    boxes, idx = detection.grid_targets_to_boxes(batch["objness"][0], batch["bbox"][0])
    want_boxes, want_idx = jax_detection.grid_targets_to_boxes(batch["objness"][0], batch["bbox"][0])
    np.testing.assert_array_equal(boxes, want_boxes)
    np.testing.assert_array_equal(idx, want_idx)


# ---------------------------------------------------------------- the loop and the CLI


def test_trainer_step_fn_checkpoints_and_restarts_after_nan(tiny, tmp_path):
    """The trainer with the detector's ``step_fn`` and no ``eval_fn`` (so no
    eval): 6 steps, a checkpoint every 2; step 3's batch is poisoned once, so
    the run restores the checkpoint of step 2 (saved after step 1) and goes on;
    the last checkpoint equals the final state bit for bit."""
    model = copy.deepcopy(tiny[2])
    calls = []

    def batch_fn(it):
        calls.append(it)
        b = make_batch(50 + it)
        if it == 3 and calls.count(3) == 1:
            b["images"] = b["images"] * np.nan
        return b

    path = str(tmp_path / "ckpt")
    trainer = Trainer(model, create_train_state(model, LR), batch_fn, eval_batch_fn=batch_fn,
                      config=TrainerConfig(total_steps=6, save_every=2, save_path=path, max_nan_restarts=1,
                                           eval_every=1, prefetch_depth=0),
                      step_fn=make_detector_train_step(model, DetectorLossConfig(shape_decode_per_image=2)))
    assert trainer.eval_fn is None
    final = trainer.run()
    assert not trainer.aborted_nan and final.step == 6 and not trainer.eval_history
    assert sum(not math.isfinite(h["loss_total"]) for h in trainer.history) == 1
    assert calls == [0, 1, 2, 3, 2, 3, 4, 5]
    assert all(h["grads_finite"] == 1.0 for h in trainer.history if math.isfinite(h["loss_total"]))
    restored = checkpoint.restore_params(path, model.state_dict())
    assert all(torch.equal(restored[k], v) for k, v in model.state_dict().items())


def test_cli_train_detector_main_on_the_cpu(capsys):
    """``main`` for 2 steps at a tiny size (64x64 frames, a 2x2 grid, 16^3
    shapes; the model is the CLI's: Darknet19 and the 1024-wide head), then
    the 2-batch detection eval; a path that holds no Pascal3D tree raises;
    ``--mesh`` parses (its runs, over 2 ranks, are in
    ``tests/test_torch_parallel.py``)."""
    trainer, det = cli.main(["--image-size", "64", "64", "--grid-size", "2", "2", "--voxel-dim", "16", "--steps", "2",
                             "--batch-size", "2", "--device", "cpu"])
    assert trainer.state.step == 2 and len(trainer.history) == 2
    assert all(math.isfinite(v) for row in trainer.history for v in row.values())
    assert {"det_precision", "det_recall", "map50", "ori_mae_rad"} <= set(det)
    assert "detection eval:" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError, match="/nowhere"):
        cli.build_trainer(cli.parse_args(["--data", "/nowhere", "--device", "cpu"]))
    assert cli.parse_args(["--mesh", "--device", "cpu"]).mesh
    dense = cli.build_batch_fn(SyntheticMultiObjectLoader(num_samples=8, dim=16, image_size=(32, 32),
                                                          grid_size=(2, 2)), 2, 4)(0)
    packed = cli.transfer_forms(dense)
    assert packed["images"].dtype == np.uint8 and packed["voxels_packed"].shape == (2, 4, 16**3 // 8)
    shipped = trainer.batch_fn(0)
    assert shipped["images"].dtype == np.uint8 and "voxels_packed" in shipped and "voxels" not in shipped
    args = cli.parse_args(["--max-objects", "6", "--max-detections", "32", "--device", "cpu"])
    assert (args.max_objects, args.max_detections) == (6, 32)
