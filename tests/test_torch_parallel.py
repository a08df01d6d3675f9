"""PyTorch port, data parallelism over 2 ranks against the JAX package, on
the CPU.

One module-scoped launch of 2 processes (``tests/_torch_parallel_child.py``,
joined by gloo on a free localhost port through ``COORDINATOR_ADDRESS``,
``NUM_PROCESSES`` and ``PROCESS_ID``, as ``parallel/multihost.py`` reads
them) runs every data-parallel path of the port; the children import no JAX
and write npz files. While they run, this process computes the JAX side on
the same weights (converted with ``convert.params_from_flax``), batches and
draws, then compares:

- the 2-rank ``--mesh`` step of the voxel model (with the prior repulsion
  across ranks), the classifier and the detector (with ``n_obj`` and the
  decode count across ranks) against JAX's single-device step on the whole
  batch, to the existing step tests' tolerances: the voxel and classifier
  steps against JAX's ``make_train_step`` / ``make_classifier_train_step``
  (a stand-in optax transform records the gradients they apply), the
  detector against JAX's float64 losses and gradients, as
  ``test_torch_detector_train.py`` holds it;
- the 2-rank ``make_train_step_dp`` against JAX's on a 2-device slice of the
  CPU mesh, each shard's draws (``fold_in(key, shard)``) injected. JAX's
  step applies N times the mean gradient (under jax 0.9 ``shard_map``
  already sums the gradient of a replicated parameter over the shards, and
  the step's own psum sums again before dividing by N; ROADMAP §C), so the
  port's mean is held to JAX's gradient halved, entry by entry within one
  bfloat16 rounding at the leaf's scale;
- ``fuse_sequence_sharded`` and ``observe_stream(mesh=)`` against JAX's, and
  the ragged stream's refusal;
- ``ba_step_sharded`` against JAX's ``ba_step`` and ``ba_step_sharded`` in
  float64 (in float32 the reduced system, whose scale is free, is too
  ill-conditioned to compare two libraries' solves: JAX's own float32 step
  is 10% of the step off its float64 one), and in float32 against the port's
  own ``ba_step`` at the JAX test's tolerance;
- ``cli.train``, ``cli.pretrain`` and ``cli.train_detector`` with ``--mesh``:
  both ranks end bit-equal, and rank 0's checkpoint restores on both;
- ``ModelNetLoader``'s process sharding against JAX's, and the mesh's
  refusal of a shape that is not the world's (the "model" axis itself, tensor
  parallelism, is ``tests/test_torch_tensor_parallel.py``'s).
"""

import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from anytime3d_tpu.anytime import engine as jax_engine
from anytime3d_tpu.data.modelnet import ModelNetLoader as JaxModelNetLoader
from anytime3d_tpu.geometry import ba as jax_ba
from anytime3d_tpu.models import configs as jax_configs
from anytime3d_tpu.parallel import make_mesh as jax_make_mesh
from anytime3d_tpu.train import classifier_step as jax_classifier_step
from anytime3d_tpu.train import detector_step as jax_detector_step
from anytime3d_tpu.train import step as jax_step
from anytime3d_tpu.train.state import TrainState as JaxTrainState
from anytime3d_tpu_torch.convert import params_from_flax
from anytime3d_tpu_torch.data.modelnet import ModelNetLoader
from anytime3d_tpu_torch.geometry.ba import BAProblem, ba_step
from anytime3d_tpu_torch.parallel import make_mesh
from tests import test_torch_detector_train as det_tests
from tests import test_torch_pretrain as pre_tests
from tests import test_torch_train as train_tests
from tests.test_ba import make_problem
from tests.test_torch_detector import build, tiny_configs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "modelnet")
GRAD_REL = 1e-4  # a gradient leaf's error, relative to its largest entry (the step tests' tolerance)
LOSS_RTOL = 1e-4
BF16_ULP = 2.0 ** -7  # one bfloat16 rounding, relative


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _capture():
    """An optax transform that applies nothing and keeps the gradients it is given as its state."""
    return optax.GradientTransformation(init=lambda p: jax.tree.map(jnp.zeros_like, p),
                                        update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _captured(step, jax_model, tree, batch, *key):
    """(gradients in the port's layout, metrics) of one JAX step from ``tree``."""
    tx = _capture()
    params = jax.tree.map(jnp.asarray, tree)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                          apply_fn=jax_model.apply, tx=tx)
    new, metrics = step(state, jax.tree.map(jnp.asarray, batch), *key)
    return params_from_flax(jax.tree.map(np.asarray, new.opt_state)), {k: float(v) for k, v in metrics.items()}


def _voxel_draws(key, cfg, b):
    """``test_torch_train.jax_draws`` at batch ``b``."""
    ks = jax.random.split(key, 7)
    k_coin, k_elem = jax.random.split(ks[4])
    z = train_tests.Z
    return {"eps_inst": np.asarray(jax.random.normal(ks[1], (b, z), jnp.float32)),
            "eps_prior_cat": np.asarray(jax.random.normal(ks[2], (b, z), jnp.float32)),
            "coin": np.asarray(jax.random.bernoulli(k_coin, cfg.mix_coin_prob, ())),
            "take_prior": np.asarray(jax.random.bernoulli(k_elem, cfg.mix_element_prob, (b, z)))}


def _inputs():
    """(what the children read, what the JAX side needs)."""
    jax_cfg, cfg = train_tests.small_configs()
    from anytime3d_tpu.models.mmvae import MultiModalVAE as JaxVAE

    jax_vae = JaxVAE(jax_cfg)
    rng = np.random.default_rng(0)
    tree = pre_tests.random_tree(lambda k: jax_vae.init({"params": k, "dropout": k},
                                                        jnp.zeros((1,) + (train_tests.DIM,) * 3 + (1,)),
                                                        method=JaxVAE.initialize), rng)
    b = train_tests.B
    vox = (rng.uniform(size=(b,) + (train_tests.DIM,) * 3 + (1,)) > 0.7).astype(np.float32)
    onehot = np.eye(train_tests.CAT, dtype=np.float32)[rng.integers(0, train_tests.CAT, b)]
    loss_cfg = jax_configs.loss_config("modelnet_nolbo")
    key = train_tests.key_with_coin(loss_cfg, True)
    dp_key = jax.random.PRNGKey(11)
    voxel = {"config": cfg, "params": params_from_flax(tree), "batch": {"input": vox, "category_onehot": onehot},
             "draws": _voxel_draws(key, loss_cfg, b),
             "dp_draws": [_voxel_draws(jax.random.fold_in(dp_key, i), loss_cfg, b // 2) for i in range(2)]}

    jax_cls, cls_tree, cls_model = pre_tests.classifiers("darknet53tiny", pre_tests.K, pre_tests.SIZE, 0)
    crng = np.random.default_rng(1)
    cls_batch = {"images": crng.uniform(size=(pre_tests.B, pre_tests.SIZE, pre_tests.SIZE, 3)).astype(np.float32),
                 "labels": np.eye(pre_tests.K, dtype=np.float32)[crng.integers(0, pre_tests.K, pre_tests.B)]}
    classifier = {"config": cls_model.config, "params": cls_model.state_dict(), "batch": cls_batch}

    jax_det_cfg, det_cfg = tiny_configs()
    jax_det, det_tree, det_model = build(jax_det_cfg, det_cfg, seed=20)
    det_batch = det_tests.make_batch(30, form="full")
    det_key = jax.random.PRNGKey(4)
    detector = {"config": det_cfg, "params": det_model.state_dict(), "batch": det_batch,
                "eps_z": det_tests.jax_eps(det_key, 4).numpy()}

    frng = np.random.default_rng(2)
    t, d = 8, 5
    fuse = {"means": frng.normal(size=(t, d)).astype(np.float32),
            "log_vars": frng.normal(scale=0.5, size=(t, d)).astype(np.float32),
            "masks": (frng.uniform(size=(t, d)) > 0.4).astype(np.float32),
            "prior_info": frng.normal(size=d).astype(np.float32),
            "prior_precision": frng.uniform(0.5, 2.0, size=d).astype(np.float32)}

    problem, *_ = make_problem(p=3, l=32)
    ba = {f.name: np.asarray(getattr(problem, f.name)) for f in dataclasses.fields(problem)}

    children = {"voxel": voxel, "classifier": classifier, "detector": detector, "fuse": fuse, "ba": ba}
    jax_side = {"voxel": (jax_vae, tree, key, dp_key), "classifier": (jax_cls, cls_tree),
                "detector": (jax_det, det_tree, det_key)}
    return children, jax_side


def _jax_references(children, jax_side):
    refs = {}
    jax_vae, tree, key, dp_key = jax_side["voxel"]
    v = children["voxel"]
    loss_cfg = jax_configs.loss_config("modelnet_nolbo")
    batch = dict(v["batch"], target=v["batch"]["input"])
    refs["voxel"] = _captured(jax_step.make_train_step(jax_vae, loss_cfg, donate=False), jax_vae, tree, batch, key)
    mesh = jax_make_mesh(data=2, model=1, devices=jax.devices()[:2])
    refs["dp"] = _captured(jax_step.make_train_step_dp(jax_vae, loss_cfg, mesh, grad_psum_dtype=jnp.bfloat16,
                                                       donate=False), jax_vae, tree, batch, dp_key)

    jax_cls, cls_tree = jax_side["classifier"]
    refs["classifier"] = _captured(jax_classifier_step.make_classifier_train_step(
        jax_cls, jax_classifier_step.ClassifierLossConfig(), donate=False), jax_cls, cls_tree,
        children["classifier"]["batch"])

    jax_det, det_tree, det_key = jax_side["detector"]
    total, metrics, grads = det_tests.jax_loss_and_grads64(jax_det, jax_detector_step.DetectorLossConfig(), det_tree,
                                                           children["detector"]["batch"], det_key)
    refs["detector"] = (grads, metrics)

    f = {k: jnp.asarray(x) for k, x in children["fuse"].items()}
    prior = jax_engine.GaussianBelief(info=f["prior_info"], precision=f["prior_precision"])
    fused = jax.jit(lambda *a: jax_engine.fuse_sequence_sharded(mesh, *a, prior=prior))(f["means"], f["log_vars"],
                                                                                       f["masks"])
    refs["fuse"] = {"info": np.asarray(fused.info), "precision": np.asarray(fused.precision)}
    with pytest.raises(ValueError):
        jax_engine.fuse_sequence_sharded(mesh, f["means"][:5], f["log_vars"][:5], f["masks"][:5])

    with jax.enable_x64(True):
        p64 = jax_ba.BAProblem(**{k: jnp.asarray(x, jnp.float64) for k, x in children["ba"].items()})
        refs["ba64_step"] = jax.jit(lambda p: jax_ba.ba_step(p, damping=1e-3))(p64)
        refs["ba64_sharded"] = jax.jit(lambda p: jax_ba.ba_step_sharded(p, mesh, damping=1e-3))(p64)
        refs["ba64_step"], refs["ba64_sharded"] = (
            {"poses": np.asarray(p.poses), "points": np.asarray(p.points), "mse": float(m)}
            for p, m in (refs["ba64_step"], refs["ba64_sharded"]))
    return refs


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(rank 0's npz, rank 1's npz, the JAX references, the children's inputs)."""
    workdir = str(tmp_path_factory.mktemp("parallel"))
    children, jax_side = _inputs()
    torch.save(children, os.path.join(workdir, "inputs.pt"))
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, COORDINATOR_ADDRESS=f"localhost:{port}", NUM_PROCESSES="2", PROCESS_ID=str(rank),
                   PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen([sys.executable, "-m", "tests._torch_parallel_child", workdir], cwd=ROOT, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    try:
        refs = _jax_references(children, jax_side)  # while the ranks run
        logs = [p.communicate(timeout=600)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    outs = [dict(np.load(os.path.join(workdir, f"rank{r}.npz"))) for r in range(2)]
    return outs[0], outs[1], refs, children


def _grads(out, tag):
    prefix = f"{tag}/grad/"
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}


def _metrics(out, tag):
    prefix = f"{tag}/metric/"
    return {k[len(prefix):]: float(v) for k, v in out.items() if k.startswith(prefix)}


def _assert_grads_close(got, want, rel=GRAD_REL):
    assert got.keys() == {k for k in want}, set(got) ^ set(want)
    for name, g in got.items():
        w = np.asarray(want[name], np.float64)
        top = float(np.abs(w).max()) + 1e-12
        err = float(np.abs(g - w).max())
        assert err <= rel * top, (name, err, top)


def test_both_ranks_joined_and_apply_the_same_update(pair):
    """Rank 0 and rank 1 of 2: after each all-reduced step both hold the same
    gradients, metrics and (after a real Adam step) parameters, bit for bit."""
    r0, r1, _, _ = pair
    assert (int(r0["rank"]), int(r1["rank"]), int(r0["size"]), int(r1["size"])) == (0, 1, 2, 2)
    for tag in ("voxel", "dp", "classifier", "detector"):
        g0, g1 = _grads(r0, tag), _grads(r1, tag)
        assert g0.keys() == g1.keys() and g0
        assert all(np.array_equal(g0[k], g1[k]) for k in g0), tag
        assert _metrics(r0, tag) == _metrics(r1, tag), tag
        assert str(r0[f"{tag}/digest"]) == str(r1[f"{tag}/digest"]), tag


def test_mesh_step_of_the_voxel_model_is_jaxs_global_step(pair):
    """Every loss term (the prior repulsion runs over the pairs that cross the
    ranks) and every gradient leaf against JAX's ``make_train_step`` on the
    whole batch of 4, the mix forced on."""
    r0, _, refs, _ = pair
    want_grads, want_metrics = refs["voxel"]
    got = _metrics(r0, "voxel")
    for k in train_tests.LOSS_KEYS + ("grads_finite",):
        np.testing.assert_allclose(got[k], want_metrics[k], rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    assert want_metrics["loss_reg"] > 0
    _assert_grads_close(_grads(r0, "voxel"), {k: v.numpy() for k, v in want_grads.items()})


def test_mesh_step_of_the_classifier_is_jaxs_global_step(pair):
    r0, _, refs, _ = pair
    want_grads, want_metrics = refs["classifier"]
    got = _metrics(r0, "classifier")
    for k in pre_tests.METRIC_KEYS:
        np.testing.assert_allclose(got[k], want_metrics[k], rtol=LOSS_RTOL, err_msg=k)
    assert got["top1"] == want_metrics["top1"] and got["top5"] == want_metrics["top5"]
    _assert_grads_close(_grads(r0, "classifier"), {k: v.numpy() for k, v in want_grads.items()})


def test_mesh_step_of_the_detector_is_jaxs_global_step(pair):
    """Image 0 holds 3 objects and image 1 one, one image a rank: ``n_obj``,
    the grid's size and the decode count are the batch's. Every term and leaf
    against JAX's float64 run on the whole batch."""
    r0, _, refs, _ = pair
    want_grads, want_metrics = refs["detector"]
    got = _metrics(r0, "detector")
    assert set(want_metrics) <= set(got)
    for k, w in want_metrics.items():
        np.testing.assert_allclose(got[k], w, rtol=det_tests.LOSS_RTOL, atol=1e-6, err_msg=k)
    _assert_grads_close(_grads(r0, "detector"), {k: v.numpy() for k, v in want_grads.items()},
                        rel=det_tests.GRAD_REL)


def test_explicit_dp_step_is_jaxs_on_two_devices(pair):
    """``make_train_step_dp`` (bfloat16 all-reduce) against JAX's over
    ``jax.devices()[:2]``, each shard's draws JAX's ``fold_in(key, shard)``
    ones; JAX's gradient halved (see the module's doc). The port rounds each
    shard's gradient to bfloat16 and sums in bfloat16, JAX rounds their float32
    sum once, so an entry may be a bfloat16 rounding apart at the leaf's
    scale; twice the port's entries are bfloat16 values. The metrics are
    float32 means."""
    r0, _, refs, _ = pair
    want_grads, want_metrics = refs["dp"]
    got = _metrics(r0, "dp")
    for k in train_tests.LOSS_KEYS + ("grads_finite",):
        np.testing.assert_allclose(got[k], want_metrics[k], rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    grads = _grads(r0, "dp")
    assert grads.keys() == want_grads.keys()
    for name, g in grads.items():
        w = want_grads[name].numpy() / 2
        top = float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= BF16_ULP * top, (name, float(np.abs(g - w).max()), top)
        # a sum of 2 bfloat16 values halved: representable in bfloat16 up to the halving
        assert np.array_equal(torch.from_numpy(g * 2).bfloat16().float().numpy(), g * 2), name


def test_fuse_sequence_sharded_and_observe_stream_are_jaxs(pair):
    """8 observations over 2 ranks from a prior, against JAX's sharded fusion
    on 2 devices; ``observe_stream(mesh=)`` is the same call; a stream of 5
    raises on both sides."""
    r0, r1, refs, _ = pair
    for out in (r0, r1):
        for part in ("info", "precision"):
            np.testing.assert_allclose(out[f"fuse/{part}"], refs["fuse"][part], rtol=1e-6, atol=1e-7)
            np.testing.assert_array_equal(out[f"observe/{part}"], out[f"fuse/{part}"])
        assert int(out["fuse/ragged_raised"]) == 1


def test_ba_step_sharded_is_jaxs(pair):
    r0, r1, refs, children = pair
    for out in (r0, r1):
        for want in (refs["ba64_step"], refs["ba64_sharded"]):
            np.testing.assert_allclose(out["ba64/poses"], want["poses"], rtol=1e-9, atol=1e-9)
            np.testing.assert_allclose(out["ba64/points"], want["points"], rtol=1e-9, atol=1e-9)
            np.testing.assert_allclose(float(out["ba64/mse"]), want["mse"], rtol=1e-9)
    single, mse = ba_step(BAProblem(**{k: torch.from_numpy(x) for k, x in children["ba"].items()}), damping=1e-3)
    np.testing.assert_allclose(float(r0["ba32/mse"]), float(mse), rtol=1e-5)
    np.testing.assert_allclose(r0["ba32/poses"], single.poses.numpy(), rtol=5e-3, atol=2e-3)
    np.testing.assert_allclose(r0["ba32/points"], single.points.numpy(), rtol=5e-3, atol=2e-3)


@pytest.mark.parametrize("tag", ["cli_train", "cli_pretrain", "cli_detector"])
def test_cli_mesh_runs_end_equal_and_restore_rank0s_checkpoint(pair, tag):
    """``main --mesh`` for 2 steps on each rank (``cli.train`` packed, with
    an eval and its anytime metrics): the ranks log the same loss and end
    with the same parameters, which rank 0's checkpoint holds, restored on
    both ranks."""
    r0, r1, _, _ = pair
    assert float(r0[f"{tag}/loss"]) == float(r1[f"{tag}/loss"]) and np.isfinite(float(r0[f"{tag}/loss"]))
    assert str(r0[f"{tag}/digest"]) == str(r1[f"{tag}/digest"])
    for out in (r0, r1):
        assert str(out[f"{tag}/restored"]) == str(out[f"{tag}/digest"])
        assert int(out[f"{tag}/step"]) == 2


def test_modelnet_loader_process_sharding_matches_jax():
    """Rank 1 of 2 reads every other shard of the fixture's train split and
    shuffles with seed + 1, as JAX's loader does: the same batches, over an
    epoch boundary."""
    ours = ModelNetLoader(FIXTURES, "train", partial_num=None, process_index=1, process_count=2, seed=3)
    theirs = JaxModelNetLoader(FIXTURES, "train", partial_num=None, process_index=1, process_count=2, seed=3)
    assert ours.dataLength == theirs.dataLength < ModelNetLoader(FIXTURES, "train", partial_num=None).dataLength
    for _ in range(4):
        a, b = ours.getNextBatch(2), theirs.getNextBatch(2)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert ours.epoch == theirs.epoch > 0


def test_make_mesh_refuses_a_mesh_that_is_not_the_world():
    """In a run of one rank (an in-process gloo group, left as it was found),
    a mesh of 2 ranks, over "data" or over "model", is refused."""
    import torch.distributed as dist

    from anytime3d_tpu_torch.parallel import mesh as mesh_module

    try:
        for data, model in ((2, 1), (1, 2)):
            with pytest.raises(ValueError, match=f"mesh {data}x{model} != 1 ranks"):
                make_mesh(data=data, model=model, device="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        mesh_module._mesh.cache_clear()
