"""PyTorch port, classifier pretraining against the JAX package on the CPU:
``softmax_cross_entropy`` and ``topk_accuracy`` (tied logits among them),
the classifier (``darknet53tiny`` at 64x64 with 4 classes, the JAX test's
size: logits, ``classifier_losses``, every gradient leaf, the guarded Adam
step; ``darknet19`` logits at 32x32) on weights converted from the flax tree,
then ``cli.pretrain`` on the CPU and the graft of its backbone into a
``pascal_nolbo``-shaped model.

Weights are drawn in numpy in the flax tree's shapes (kernels with variance
1/fan_in, norms and biases moved off ones and zeros), inputs from numpy
seeds; the JAX side runs under ``jax.jit``. Tolerances are those
``tests/test_torch_image.py`` holds Darknet19 to: logits 1e-4 of their
largest entry (~20 layers of float32 summed in another order), losses rtol
1e-4, each gradient leaf 1e-4 of its largest entry, the Adam update atol
1e-7 or one float32 ulp; accuracies exactly.
"""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from anytime3d_tpu.models.classifier import Classifier as JaxClassifier
from anytime3d_tpu.models.classifier import ClassifierConfig as JaxClassifierConfig
from anytime3d_tpu.ops import losses as jax_losses
from anytime3d_tpu.ops import metrics as jax_metrics
from anytime3d_tpu.train import classifier_step as jax_classifier_step
from anytime3d_tpu.train.state import TrainState as JaxTrainState
from anytime3d_tpu.train.step import apply_gradients_if_finite as jax_apply_gradients_if_finite
from anytime3d_tpu_torch.cli import pretrain as cli_pretrain
from anytime3d_tpu_torch.convert import params_from_flax
from anytime3d_tpu_torch.models import configs
from anytime3d_tpu_torch.models.classifier import Classifier, ClassifierConfig
from anytime3d_tpu_torch.models.mmvae import MultiModalVAE
from anytime3d_tpu_torch.ops.losses import softmax_cross_entropy
from anytime3d_tpu_torch.ops.metrics import topk_accuracy
from anytime3d_tpu_torch.train.checkpoint import CHECKPOINT_FILE, graft_submodule
from anytime3d_tpu_torch.train.classifier_step import (
    ClassifierLossConfig,
    classifier_losses,
    make_classifier_train_step,
)
from anytime3d_tpu_torch.train.state import create_train_state

B, K, SIZE = 8, 4, 64
LOGIT_REL, LOSS_RTOL, GRAD_REL = 1e-4, 1e-4, 1e-4
METRIC_KEYS = ("loss_ce", "loss_total", "top1", "top5")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)  # the suite runs several workers per machine


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def random_tree(init, rng, noise=0.05):
    """A flax param tree of the shapes ``init(key)`` makes, drawn in numpy."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))["params"]

    def leaf(path, s):
        if path[-1].key == "kernel":
            return rng.standard_normal(s.shape, np.float32) / np.float32(math.sqrt(math.prod(s.shape[:-1])))
        base = np.ones(s.shape, np.float32) if path[-1].key == "scale" else np.zeros(s.shape, np.float32)
        return base + np.float32(noise) * rng.standard_normal(s.shape, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


# ---------------------------------------------------------------- the ops


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_softmax_cross_entropy_matches_jax(smoothing):
    """Large and tied logits, smoothed targets; bfloat16 logits are computed in float32."""
    rng = np.random.default_rng(0)
    logits = rng.normal(scale=20.0, size=(16, 10)).astype(np.float32)
    logits[3] = 7.0  # all tied
    onehot = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 16)]
    onehot = onehot * (1.0 - smoothing) + smoothing / 10
    want = np.asarray(jax_losses.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(onehot)))
    got = softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(onehot))
    assert got.dtype == torch.float32 and got.shape == (16,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    low = torch.from_numpy(logits).bfloat16()
    got16 = softmax_cross_entropy(low, torch.from_numpy(onehot))
    assert got16.dtype == torch.float32
    np.testing.assert_allclose(got16.numpy(), np.asarray(jax_losses.softmax_cross_entropy(
        jnp.asarray(low.float().numpy()), jnp.asarray(onehot))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 5])
def test_topk_accuracy_breaks_ties_as_jax(k):
    """Integer logits with many ties: the lower index ranks first, so a label
    just past the k-th tied entry is a miss in both packages."""
    rng = np.random.default_rng(k)
    logits = rng.integers(0, 3, size=(64, 8)).astype(np.float32)
    logits[:8] = 1.0  # whole rows tied
    onehot = np.eye(8, dtype=np.float32)[rng.integers(0, 8, 64)]
    want = float(jax_metrics.topk_accuracy(jnp.asarray(logits), jnp.asarray(onehot), k=k))
    got = topk_accuracy(torch.from_numpy(logits), torch.from_numpy(onehot), k=k)
    assert got.dtype == torch.float32
    assert float(got) == want
    assert 0.0 < want < 1.0
    tied = torch.from_numpy(logits[:8])
    hits = topk_accuracy(tied, torch.from_numpy(np.eye(8, dtype=np.float32)), k=k)
    assert float(hits) == k / 8  # labels 0..k-1 of the tied rows are the hits


# ---------------------------------------------------------------- the classifier


def classifiers(backbone, num_classes, size, seed):
    jax_model = JaxClassifier(JaxClassifierConfig(num_classes=num_classes, backbone=backbone))
    tree = random_tree(lambda k: jax_model.init(k, jnp.zeros((1, size, size, 3))), np.random.default_rng(seed))
    model = Classifier(ClassifierConfig(num_classes=num_classes, backbone=backbone))
    state = params_from_flax(tree)
    assert state.keys() == model.state_dict().keys()
    model.load_state_dict(state)
    return jax_model, tree, model


@pytest.fixture(scope="module")
def tiny():
    """darknet53tiny at 64x64, 4 classes, and a batch of 8."""
    jax_model, tree, model = classifiers("darknet53tiny", K, SIZE, 0)
    rng = np.random.default_rng(1)
    batch = {"images": rng.uniform(size=(B, SIZE, SIZE, 3)).astype(np.float32),
             "labels": np.eye(K, dtype=np.float32)[rng.integers(0, K, B)]}
    return jax_model, tree, model, batch


def t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def assert_logits_close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_REL * float(np.abs(want).max()))


@pytest.mark.parametrize("backbone", ["darknet19", "darknet53", "darknet53tiny"])
def test_converter_maps_every_classifier_leaf(backbone):
    """The flax tree of each backbone's classifier (``backbone/...``,
    ``head/...``) maps onto the port's state dict name for name and shape
    for shape, the ``backbone.`` prefix an image model's own."""
    jax_model = JaxClassifier(JaxClassifierConfig(num_classes=7, backbone=backbone))
    shapes = jax.eval_shape(lambda k: jax_model.init(k, jnp.zeros((1, 32, 32, 3))), jax.random.PRNGKey(0))
    state = params_from_flax(jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes["params"]))
    with torch.device("meta"):
        model = Classifier(ClassifierConfig(num_classes=7, backbone=backbone))
        image = MultiModalVAE(configs.pascal_nolbo(backbone=backbone))
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in state.items()} == want
    assert {k: v for k, v in want.items() if k.startswith("backbone.")} == {
        k: tuple(v.shape) for k, v in image.state_dict().items() if k.startswith("backbone.")}


@pytest.mark.parametrize("backbone,num_classes,size", [("darknet53tiny", K, SIZE), ("darknet19", 10, 32)])
def test_classifier_logits_match_jax(backbone, num_classes, size):
    jax_model, tree, model = classifiers(backbone, num_classes, size, 2)
    x = np.random.default_rng(3).uniform(size=(2, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, xx: jax_model.apply({"params": p}, xx))(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (2, num_classes)
    assert_logits_close(got.numpy(), want)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_classifier_losses_match_jax(tiny, smoothing):
    jax_model, tree, model, batch = tiny
    cfg = ClassifierLossConfig(label_smoothing=smoothing)
    jax_cfg = jax_classifier_step.ClassifierLossConfig(label_smoothing=smoothing)
    want = _np_tree(jax.jit(lambda p, b: jax_classifier_step.classifier_losses(jax_model, jax_cfg, p, b)[1])(
        tree, jax.tree.map(jnp.asarray, batch)))
    total, got = classifier_losses(model, cfg, t(batch))
    assert total.requires_grad and set(got) == set(METRIC_KEYS)
    for k in METRIC_KEYS:
        if k.startswith("top"):
            assert float(got[k]) == float(want[k]), k
        else:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, err_msg=k)


def test_classifier_loss_config_mirrors_jax():
    assert dataclasses.asdict(ClassifierLossConfig()) == dataclasses.asdict(jax_classifier_step.ClassifierLossConfig())
    assert dataclasses.asdict(ClassifierConfig()) == dataclasses.asdict(JaxClassifierConfig())


def jax_grads(jax_model, tree, batch):
    cfg = jax_classifier_step.ClassifierLossConfig()
    fn = jax.jit(jax.grad(lambda p, b: jax_classifier_step.classifier_losses(jax_model, cfg, p, b)[0]))
    return _np_tree(fn(tree, jax.tree.map(jnp.asarray, batch)))


def test_classifier_gradients_match_jax(tiny):
    """Every leaf's gradient against ``jax.grad``, to GRAD_REL of the leaf's largest entry."""
    jax_model, tree, model, batch = tiny
    ref = params_from_flax(jax_grads(jax_model, tree, batch))
    total, _ = classifier_losses(model, ClassifierLossConfig(), t(batch))
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(total, params)))
    assert grads.keys() == ref.keys()
    for name, g in grads.items():
        scale = float(ref[name].abs().max())
        assert scale > 0, name
        err = float((g - ref[name]).abs().max())
        assert err <= GRAD_REL * scale, (name, err, scale)


def test_classifier_adam_step_matches_jax(tiny):
    """One step of ``make_classifier_train_step``: its metrics against
    JAX's, and its update against JAX's guarded Adam step
    (``apply_gradients_if_finite``) fed the port's own gradients (the first
    Adam step is lr * g / (|g| + 1e-8), which turns a rounding difference in
    a gradient near zero into a full step)."""
    jax_model, tree, _, batch = tiny
    _, _, model = classifiers("darknet53tiny", K, SIZE, 0)
    total, _ = classifier_losses(model, ClassifierLossConfig(), t(batch))
    names, params = zip(*model.named_parameters())
    grads = {n: g.numpy() for n, g in zip(names, torch.autograd.grad(total, params))}
    state = create_train_state(model, learning_rate=1e-4)
    state, metrics = make_classifier_train_step(model)(state, t(batch))
    assert state.step == 1 and float(metrics["grads_finite"]) == 1.0
    # the port's gradients back in the flax tree's layout, by the converter's own map
    flat = {}
    jax.tree_util.tree_map_with_path(lambda p, a: flat.setdefault(tuple(k.key for k in p), a), tree)
    by_port_name = {}
    for path in flat:
        name = next(iter(params_from_flax(_nest(path, np.zeros(flat[path].shape, np.float32)))))
        by_port_name[path] = name
    g_tree = _unflatten({path: _to_flax_layout(grads[by_port_name[path]], flat[path].shape)
                         for path in flat})
    tx = optax.adam(1e-4)
    jax_state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jax.tree.map(jnp.asarray, tree),
                              opt_state=tx.init(jax.tree.map(jnp.asarray, tree)), apply_fn=jax_model.apply, tx=tx)
    new, jax_metrics_ = jax_apply_gradients_if_finite(jax_state, jax.tree.map(jnp.asarray, g_tree), {})
    assert float(jax_metrics_["grads_finite"]) == 1.0
    ref = params_from_flax(_np_tree(new.params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=1.2e-7, atol=1e-7, err_msg=name)
    jax_m = _np_tree(jax.jit(lambda p, b: jax_classifier_step.classifier_losses(
        jax_model, jax_classifier_step.ClassifierLossConfig(), p, b)[1])(tree, jax.tree.map(jnp.asarray, batch)))
    np.testing.assert_allclose(float(metrics["loss_total"]), float(jax_m["loss_total"]), rtol=LOSS_RTOL)


def _nest(path, leaf):
    node = leaf
    for key in reversed(path):
        node = {key: node}
    return node


def _unflatten(flat):
    tree = {}
    for path, leaf in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def _to_flax_layout(g, shape):
    """Invert ``convert._leaf`` for the classifier's leaves: OIHW -> HWIO, else as is."""
    return g.transpose(2, 3, 1, 0) if g.ndim == 4 else g.reshape(shape)


# ---------------------------------------------------------------- the CLI and the graft


def test_cli_pretrain_runs_on_the_cpu_and_grafts(tmp_path, capsys):
    """``cli.pretrain.main`` at darknet19, 32x32, B=4, 2 steps with an eval:
    finite metrics and a checkpoint whose ``backbone`` grafts into a
    ``pascal_nolbo``-shaped model (the 32^3 decoder of the image tests)
    bit for bit, every other parameter untouched."""
    save = tmp_path / "ckpt"
    trainer = cli_pretrain.main(["--data", "synthetic", "--device", "cpu", "--steps", "2", "--image-size", "32",
                                 "--batch-size", "4", "--eval-every", "2", "--save-path", str(save)])
    out = capsys.readouterr().out
    assert "done; final metrics" in out and "eval_top1" in out
    assert trainer.state.step == 2 and len(trainer.history) == 2 and len(trainer.eval_history) == 1
    assert all(math.isfinite(v) for row in trainer.history for v in row.values())
    assert set(METRIC_KEYS) | {"grads_finite"} <= set(trainer.history[-1])
    assert os.path.exists(save / CHECKPOINT_FILE)

    base = configs.pascal_nolbo()
    cfg = dataclasses.replace(base, decoder=dataclasses.replace(base.decoder, output_shape=(32, 32, 32, 1),
                                                                filter_nums=(32, 16, 16, 8, 1)))
    vae = MultiModalVAE(cfg, generator=torch.Generator().manual_seed(3))
    before = {k: v.clone() for k, v in vae.state_dict().items()}
    graft_submodule(create_train_state(vae), str(save), "backbone")
    donor = trainer.model.state_dict()
    after = vae.state_dict()
    grafted = [k for k in after if k.startswith("backbone.")]
    assert len(grafted) == len([k for k in donor if k.startswith("backbone.")]) > 0
    for k, v in after.items():
        want = donor[k] if k.startswith("backbone.") else before[k]
        assert torch.equal(v, want), k


def test_cli_pretrain_refusals():
    with pytest.raises(FileNotFoundError, match="/data/imagenet"):
        cli_pretrain.main(["--data", "/data/imagenet", "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="/data/imagenet"):  # --mesh joins the ranks after the loaders
        cli_pretrain.main(["--data", "/data/imagenet", "--mesh", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA is not available"):
            cli_pretrain.main(["--steps", "1"])
