"""PyTorch port, the image family: ``pascal_nolbo`` (Darknet backbone ->
dual category + instance latent -> voxel decoder) against the JAX package on
the CPU.

The blocks (``ConvBlock2D``, ``maxpool2d``, ``Head2D``), the three backbones,
the converter's 2-D names and layout, then a model shaped like
``pascal_nolbo`` (full-width Darknet19, z = 8 + 8, 12 classes and 10
instances, the blocked decoder cut to 32^3 with narrow filters): its losses,
gradients and Adam steps, the batch forms, bfloat16, the all-black image, the
kernel L2; the synthetic image loader, the multi-scale schedule and the batch
function; the anytime protocol with the instance accuracy, the evaluation
protocols, serving, export and the CLIs.

Weights come from the flax tree through ``convert.params_from_flax``, inputs
from numpy seeds; JAX's random draws are made here from its keys exactly as
the JAX functions make them and handed to the port. The prior nets' dropout
is set to 0 where a train step is compared (its flax mask cannot be handed
over). The JAX side runs under ``jax.jit`` (op-by-op it compiles every
primitive shape anew and takes minutes). All comparisons are float32 unless
a test says otherwise; each tolerance is stated where it is set.
"""

import base64
import dataclasses
import http.client
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from anytime3d_tpu.anytime import engine as jax_engine
from anytime3d_tpu.cli import train as jax_cli_train
from anytime3d_tpu.data.modelnet import SyntheticImageObjectLoader as JaxImageLoader
from anytime3d_tpu.evaluation import protocols as jax_protocols
from anytime3d_tpu.models import configs as jax_configs
from anytime3d_tpu.models.mmvae import MultiModalVAE as JaxVAE
from anytime3d_tpu.nn import blocks as jax_blocks
from anytime3d_tpu.nn import darknet as jax_darknet
from anytime3d_tpu.serving.export import make_infer_fn as jax_make_infer_fn
from anytime3d_tpu.train import step as jax_step
from anytime3d_tpu.train.state import grads_finite_flag as jax_grads_finite_flag
from anytime3d_tpu.train.state import l2_penalty as jax_l2_penalty
from anytime3d_tpu.train.trainer import multi_scale_schedule as jax_multi_scale_schedule
from anytime3d_tpu_torch.anytime import engine
from anytime3d_tpu_torch.cli import evaluate as cli_evaluate
from anytime3d_tpu_torch.cli import export as cli_export
from anytime3d_tpu_torch.cli import serve as serve_cli
from anytime3d_tpu_torch.cli import train as cli_train
from anytime3d_tpu_torch.convert import load_flax_npz, params_from_flax
from anytime3d_tpu_torch.data.modelnet import SyntheticImageObjectLoader
from anytime3d_tpu_torch.data.packing import pack_voxels, pack_voxels_blocked
from anytime3d_tpu_torch.evaluation import protocols
from anytime3d_tpu_torch.models import configs
from anytime3d_tpu_torch.models.mmvae import MultiModalVAE
from anytime3d_tpu_torch.nn import blocks, darknet
from anytime3d_tpu_torch.serving.export import load_infer, make_infer_fn
from anytime3d_tpu_torch.train import step as port_step
from anytime3d_tpu_torch.train import trainer as trainer_mod
from anytime3d_tpu_torch.train.state import create_train_state, l2_penalty

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, ZC, ZI, CAT, INST, DIM = 4, 8, 8, 12, 10, 32
ROWS, COLS = 48, 64  # non-square; the backbone's maps go 48 -> 24 -> 12 -> 6 -> 3 -> 2 (an odd pool)
LOSS_KEYS = ("loss_shape", "loss_kl", "loss_reg", "precision", "recall", "loss_total")
TOL = dict(rtol=1e-4, atol=1e-5)  # the blocks, f32 both sides: summation order only
LOSS_RTOL = 1e-4  # loss terms: sums of 32768 voxel terms a sample, and the l2 over 31M squares, in another order
PR_ATOL = 5e-4  # P and R count voxels against 0.5: one within rounding of it moves them by ~1e-4
GRAD_REL = 1e-4  # each gradient leaf against JAX's, relative to that leaf's largest entry
Z_TOL = dict(rtol=1e-4, atol=1e-4)  # latents through ~20 layers of f32
PRED_ATOL = 1e-5  # decoded probabilities


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)  # the suite runs several workers per machine


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def random_tree(init, rng, noise=0.05):
    """A flax param tree of the shapes ``init(key)`` makes, drawn in numpy (a
    jitted flax init of 30M parameters takes seconds): kernels normal with
    variance 1/fan_in, as flax's lecun init; norm scales 1 and biases 0, each
    moved by ``noise`` times a normal so that nothing is special."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))["params"]

    def leaf(path, s):
        if path[-1].key == "kernel":
            return rng.standard_normal(s.shape, np.float32) / np.float32(math.sqrt(math.prod(s.shape[:-1])))
        base = np.ones(s.shape, np.float32) if path[-1].key == "scale" else np.zeros(s.shape, np.float32)
        return base + np.float32(noise) * rng.standard_normal(s.shape, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


# ---------------------------------------------------------------- blocks


def _grads_of(fn, params, x, g):
    """torch: output and the gradients of <fn(x), g> w.r.t. x and ``params``."""
    x = x.clone().requires_grad_(True)
    y = fn(x)
    grads = torch.autograd.grad(y, [x, *params], torch.from_numpy(g))
    return y.detach(), grads


@pytest.mark.parametrize("size", [8, 7], ids=["even", "odd"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3])
def test_conv_block_2d_matches_flax(k, stride, size):
    """Conv (SAME) + GroupNorm + ELU: the output and the gradients w.r.t. the
    input, the kernel and the norm's scale, at even and odd maps."""
    rng = np.random.default_rng(k * 10 + stride + size)
    x = rng.normal(size=(2, size, size + 2, 6)).astype(np.float32)
    mod = jax_blocks.ConvBlock2D(16, k, strides=stride)
    tree = _np_tree(mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    tree = jax.tree.map(lambda a: (a + rng.normal(scale=0.05, size=a.shape)).astype(np.float32), tree)
    y_ref, vjp = jax.vjp(lambda p, xx: mod.apply({"params": p}, xx), tree, jnp.asarray(x))
    g = rng.normal(size=y_ref.shape).astype(np.float32)
    dp, dx = vjp(jnp.asarray(g))
    port = blocks.ConvBlock2D(6, 16, k, stride)
    port.load_state_dict(params_from_flax(tree))
    y, (gx, gk, gs) = _grads_of(port, [port.conv_0.weight, port.groupnorm_0.weight], torch.from_numpy(x), g)
    assert y.shape == y_ref.shape == (2, -(-size // stride), -(-(size + 2) // stride), 16)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(dx), **TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(dp["Conv_0"]["kernel"]).transpose(3, 2, 0, 1), **TOL)
    np.testing.assert_allclose(gs.numpy(), np.asarray(dp["GroupNorm_0"]["scale"]), **TOL)


def _tied(rng, shape, block):
    """Values constant over ``block`` x ``block`` patches: every aligned pool window ties."""
    b, h, w, c = shape
    coarse = rng.normal(size=(b, -(-h // block), -(-w // block), c)).astype(np.float32)
    return np.repeat(np.repeat(coarse, block, axis=1), block, axis=2)[:, :h, :w]


@pytest.mark.parametrize("case", ["random_even", "random_odd", "tied", "tied_odd", "tied_stride1", "negative_odd"])
def test_maxpool2d_matches_flax(case):
    """Forward and gradient exactly equal to flax's ``max_pool`` (SAME):
    on tied windows each window's gradient must go to the element XLA picks
    (the first in row-major order), at a stride-1 pool and at odd maps,
    whose overhang is padded with -inf (an all-negative map, as after ELU,
    shows a zero pad at once)."""
    rng = np.random.default_rng(len(case))
    shape = (2, 7, 9, 3) if "odd" in case else (2, 8, 6, 3)
    if case.startswith("tied"):
        x = _tied(rng, shape, 2)
    else:
        x = rng.normal(size=shape).astype(np.float32)
        if case == "negative_odd":
            x = -np.abs(x) - 0.5
    stride = 1 if case == "tied_stride1" else 2
    y_ref, vjp = jax.vjp(lambda xx: jax_blocks.maxpool2d(xx, stride=stride), jnp.asarray(x))
    g = rng.normal(size=y_ref.shape).astype(np.float32)
    (dx,) = vjp(jnp.asarray(g))
    y, (gx,) = _grads_of(lambda xx: blocks.maxpool2d(xx, stride=stride), [], torch.from_numpy(x), g)
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_ref))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(dx))
    if case.startswith("tied"):  # the gradient lands on one element of a tie, not spread over it
        assert (np.asarray(dx) != 0).sum() <= y_ref.size


def test_head2d_splits_the_gradient_of_tied_maxima_as_jax():
    """The head's global max over H and W on a map that is the same at every
    position: every position ties, and the gradient is split evenly among
    them, as ``jnp.max``'s is."""
    rng = np.random.default_rng(1)
    x = np.broadcast_to(rng.normal(size=(2, 1, 1, 32)), (2, 3, 4, 32)).astype(np.float32).copy()
    mod = jax_darknet.Head2D(output_dim=6, filter_nums=(), filter_sizes=())
    tree = _np_tree(mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    y_ref, vjp = jax.vjp(lambda p, xx: mod.apply({"params": p}, xx), tree, jnp.asarray(x))
    g = rng.normal(size=y_ref.shape).astype(np.float32)
    dp, dx = vjp(jnp.asarray(g))
    head = darknet.Head2D(32, 6, (), ())
    head.load_state_dict(params_from_flax(tree))
    y, (gx, gk) = _grads_of(head, [head.conv_0.weight], torch.from_numpy(x), g)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(dx), **TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(dp["Conv_0"]["kernel"]).transpose(3, 2, 0, 1), **TOL)
    assert np.ptp(gx.numpy(), axis=(1, 2)).max() < 1e-6  # split evenly over the 12 positions


@pytest.mark.parametrize("name", ["darknet19", "darknet53", "darknet53tiny"])
def test_backbone_matches_flax(name):
    """Each backbone at full channel width on a 32x32 image, B=1: every map
    it returns, on the same random weights (norms off ones and zeros)."""
    rng = np.random.default_rng(7)
    x = rng.uniform(size=(1, 32, 32, 3)).astype(np.float32)
    mod = jax_darknet.BACKBONES[name]()
    tree = random_tree(lambda k: mod.init(k, jnp.zeros((1, 32, 32, 3))), rng)
    ref = jax.jit(lambda p, xx: mod.apply({"params": p}, xx))(tree, jnp.asarray(x))
    port = darknet.BACKBONES[name]()
    state = params_from_flax(tree)
    assert state.keys() == port.state_dict().keys()
    port.load_state_dict(state)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    got, ref = (v if isinstance(v, tuple) else (v,) for v in (got, ref))
    assert len(got) == len(ref) == {"darknet19": 1, "darknet53": 3, "darknet53tiny": 2}[name]
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        # GroupNorm keeps every map O(1); 1e-4 of the largest entry covers ~50 layers of summation order
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4 * float(np.abs(b).max()))


def test_convert_2d_names_and_layout():
    """2-D kernels go HWIO -> OIHW by value (a 2x2 kernel over 2 input
    channels is no 3-D kernel) and ``_ResBlock_i`` becomes ``_resblock_i``. (That
    the names agree both ways with the port's modules is held for each
    backbone in ``test_backbone_matches_flax`` and for the whole model in
    ``test_pascal_nolbo_at_full_width``.)"""
    rng = np.random.default_rng(0)
    k = rng.normal(size=(2, 2, 2, 5)).astype(np.float32)
    out = params_from_flax({"backbone": {"_ResBlock_3": {"ConvBlock2D_1": {"Conv_0": {"kernel": k},
                                                                             "GroupNorm_0": {"scale": k[0, 0, 0]}}}},
                            "head": {"Conv_0": {"kernel": k}}})
    assert set(out) == {"backbone._resblock_3.convblock2d_1.conv_0.weight",
                        "backbone._resblock_3.convblock2d_1.groupnorm_0.weight", "head.conv_0.weight"}
    w = out["head.conv_0.weight"].numpy()
    assert w.shape == (5, 2, 2, 2)
    for o, i, h, ww in np.ndindex(w.shape):
        assert w[o, i, h, ww] == k[h, ww, i, o]


# ---------------------------------------------------------------- configs


@pytest.mark.parametrize("name", ["pascal_nolbo", "pascal_category"])
def test_image_configs_mirror_jax(name):
    """Field by field, with their loss configs, at their defaults and resized."""
    for kw in ({}, {"category_dim": 7}, {"backbone": "darknet53tiny"}):
        ours, theirs = configs.variant(name, **kw), jax_configs.variant(name, **kw)
        assert dataclasses.asdict(ours[0]) == dataclasses.asdict(theirs[0]), kw
        assert dataclasses.asdict(ours[1]) == dataclasses.asdict(theirs[1])


def test_pascal_nolbo_at_full_width():
    """31,398,832 parameters, named as the flax tree names them."""
    model = MultiModalVAE(configs.pascal_nolbo())
    assert sum(p.numel() for p in model.parameters()) == 31_398_832
    shapes = jax.eval_shape(lambda k: JaxVAE(jax_configs.pascal_nolbo()).init(
        {"params": k, "dropout": k}, jnp.zeros((1, 64, 64, 3)), method=JaxVAE.initialize), jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    assert params_from_flax(tree).keys() == model.state_dict().keys()


# ---------------------------------------------------------------- the image model


def image_configs(dropout_rate=0.0, backbone="darknet19"):
    """pascal_nolbo at full backbone width, decoder cut to 32^3, as (jax, port)."""
    out = []
    for mod in (jax_configs, configs):
        base = mod.pascal_nolbo(backbone=backbone)
        out.append(dataclasses.replace(
            base,
            decoder=dataclasses.replace(base.decoder, output_shape=(DIM,) * 3 + (1,), filter_nums=(32, 16, 16, 8, 1)),
            prior_category=dataclasses.replace(base.prior_category, dropout_rate=dropout_rate),
            prior_inst=dataclasses.replace(base.prior_inst, dropout_rate=dropout_rate),
        ))
    return out


def make_batch(seed, n=B, rows=ROWS, cols=COLS):
    """uint8 images and their float form (u / 255), dense voxels, one-hots;
    samples 0 and 1 share a class, so the class-gated instance repulsion has
    a pair to gate in."""
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, (n, rows, cols, 3)).astype(np.uint8)
    vox = (rng.uniform(size=(n, DIM, DIM, DIM, 1)) > 0.7).astype(np.float32)
    cls = rng.integers(0, CAT, n)
    cls[1] = cls[0]
    return {"u8": u8, "input": u8.astype(np.float32) / 255.0, "target": vox,
            "category_onehot": np.eye(CAT, dtype=np.float32)[cls],
            "inst_onehot": np.eye(INST, dtype=np.float32)[rng.integers(0, INST, n)]}


def dense(batch):
    return {k: v for k, v in batch.items() if k != "u8"}


def model_init(jax_model, rows=ROWS, cols=COLS):
    return lambda k: jax_model.init({"params": k, "dropout": k}, jnp.zeros((1, rows, cols, 3)),
                                    method=JaxVAE.initialize)


@pytest.fixture(scope="module")
def image_setup():
    """The flax model (dropout 0); a tree as flax initialises one (norm scales
    1, biases 0) and the same moved off ones and zeros; the port on the moved one."""
    jax_cfg, cfg = image_configs()
    jax_model = JaxVAE(jax_cfg)
    fresh = random_tree(model_init(jax_model), np.random.default_rng(0), noise=0.0)
    rng = np.random.default_rng(1)
    tree = jax.tree.map(lambda a: a + np.float32(0.05) * rng.standard_normal(a.shape, np.float32), fresh)
    model = MultiModalVAE(cfg)
    model.load_state_dict(params_from_flax(tree))
    return jax_model, fresh, tree, model, cfg


def jax_step_draws(key, loss_cfg, n=B):
    """The draws the JAX ``_encode_and_sample`` makes from ``key``, by the port's names."""
    ks = jax.random.split(key, 7)
    k_coin, k_elem = jax.random.split(ks[4])
    return _np_tree({
        "eps_cat": jax.random.normal(ks[0], (n, ZC)), "eps_inst": jax.random.normal(ks[1], (n, ZI)),
        "eps_prior_cat": jax.random.normal(ks[2], (n, ZC)), "eps_prior_inst": jax.random.normal(ks[3], (n, ZI)),
        "coin": jax.random.bernoulli(k_coin, loss_cfg.mix_coin_prob, ()),
        "take_prior": jax.random.bernoulli(k_elem, loss_cfg.mix_element_prob, (n, ZC + ZI)),
    })


def key_with_coin(loss_cfg, want):
    for seed in range(64):
        key = jax.random.PRNGKey(seed)
        if bool(jax_step_draws(key, loss_cfg)["coin"]) == want:
            return key
    raise AssertionError("no key found")


_JAX_LOSSES = {}


def jax_loss_and_grad(jax_model, key):
    """Jitted ``(params, batch) -> (loss_total, grads)`` of the JAX step at ``key``, compiled once."""
    return _JAX_LOSSES.setdefault((id(jax_model), "grad", int(jax.random.key_data(key)[-1])), jax.jit(
        jax.value_and_grad(lambda p, b: jax_step.compute_losses(
            jax_model, jax_configs.loss_config("pascal_nolbo"), p, b, key)[0])))


def jax_losses(jax_model, tree, batch, key, deterministic=False):
    fn = _JAX_LOSSES.setdefault((id(jax_model), deterministic), jax.jit(
        lambda p, b, k: jax_step.compute_losses(jax_model, jax_configs.loss_config("pascal_nolbo"), p, b, k,
                                                deterministic=deterministic)[1]))
    return _np_tree(fn(tree, jax.tree.map(jnp.asarray, batch), key))


def assert_metrics_close(port, ref, keys=LOSS_KEYS, rtol=LOSS_RTOL):
    for k in keys:
        got, want = float(port[k]), float(ref[k])
        if "acc" in k:
            assert got == want, k
        elif "precision" in k or "recall" in k:
            assert abs(got - want) <= PR_ATOL, (k, got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=rtol, err_msg=k)


@pytest.mark.parametrize("mode", ["deterministic", "mix_on", "mix_off"])
def test_image_losses_match_jax(image_setup, mode):
    """Every loss term and P/R of the dual-latent step (both blocks' KL, the
    class-gated instance repulsion, the mix on both blocks' prior sample,
    l2 5e-4), f32, to LOSS_RTOL."""
    jax_model, _, tree, model, _ = image_setup
    loss_cfg = configs.loss_config("pascal_nolbo")
    deterministic = mode == "deterministic"
    key = jax.random.PRNGKey(3) if deterministic else key_with_coin(loss_cfg, mode == "mix_on")
    batch = dense(make_batch(0))
    ref = jax_losses(jax_model, tree, batch, key, deterministic)
    draws = jax_step_draws(key, loss_cfg)
    total, metrics = port_step.compute_losses(model, loss_cfg, t({k: v for k, v in batch.items()}),
                                              deterministic=deterministic, draws=t(draws))
    assert total.requires_grad
    assert_metrics_close(metrics, ref)


def test_mixing_reaches_both_blocks(image_setup):
    """The mix takes the prior sample of both blocks: with the coin on and
    the element mask on the instance block alone, the loss still moves."""
    _, _, _, model, _ = image_setup
    loss_cfg = configs.loss_config("pascal_nolbo")
    draws = jax_step_draws(key_with_coin(loss_cfg, True), loss_cfg)
    batch = t(dense(make_batch(0)))
    only_inst = dict(draws, take_prior=np.concatenate([np.zeros((B, ZC), bool), np.ones((B, ZI), bool)], axis=1))
    off = dict(draws, coin=np.asarray(False))
    with torch.no_grad():
        a = port_step.compute_losses(model, loss_cfg, batch, draws=t(only_inst))[1]
        b = port_step.compute_losses(model, loss_cfg, batch, draws=t(off))[1]
    assert abs(float(a["loss_shape"]) - float(b["loss_shape"])) > 1e-3


def test_image_gradients_match_jax(image_setup):
    """Every leaf's gradient against ``jax.grad`` (jitted), carried into the
    port's layout by ``params_from_flax``: to GRAD_REL of the leaf's largest entry."""
    jax_model, _, tree, model, _ = image_setup
    loss_cfg = configs.loss_config("pascal_nolbo")
    key = key_with_coin(loss_cfg, True)
    batch = dense(make_batch(1))
    ref = params_from_flax(_np_tree(jax_loss_and_grad(jax_model, key)(tree, jax.tree.map(jnp.asarray, batch))[1]))
    total, _ = port_step.compute_losses(model, loss_cfg, t(batch), draws=t(jax_step_draws(key, loss_cfg)))
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(total, params)))
    assert grads.keys() == ref.keys()
    for name, g in grads.items():
        scale = float(ref[name].abs().max())
        assert scale > 0, name
        err = float((g - ref[name]).abs().max())
        assert err <= GRAD_REL * scale, (name, err, scale)


def test_image_adam_steps_match_optax(image_setup):
    """Adam over the image model's parameters: the same gradients through
    ``optax.adam(1e-4)`` and the port's optimizer for 3 steps, parameters to
    atol 1e-7 as ``test_torch_train.py`` holds the voxel model, or one float32
    ulp (rtol 1.2e-7) for the GroupNorm scales near 1, where 1e-7 is under
    an ulp."""
    _, _, tree, _, cfg = image_setup
    model = MultiModalVAE(cfg)
    model.load_state_dict(params_from_flax(tree))
    state = create_train_state(model, learning_rate=1e-4)
    tx = optax.adam(1e-4)
    params = jax.tree.map(jnp.asarray, tree)
    opt_state = tx.init(params)
    update = jax.jit(lambda g, s, p: (lambda u, s2: (optax.apply_updates(p, u), s2))(*tx.update(g, s, p)))
    rng = np.random.default_rng(5)
    for step in range(3):
        grads = jax.tree.map(lambda a: rng.standard_normal(a.shape, np.float32) * np.float32(10.0 ** rng.integers(-6, 1)),
                             tree)
        params, opt_state = update(jax.tree.map(jnp.asarray, grads), opt_state, params)
        state.apply_gradients(params_from_flax(grads))
        assert state.step == step + 1
    ref = params_from_flax(_np_tree(params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=1.2e-7, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("form", ["dense", "target_packed", "target_packed_blocked", "uint8"])
def test_image_batch_forms_give_the_same_metrics(image_setup, form):
    """Dense or packed targets (linear or blocked bit order) and uint8 or
    float images are one step: the same metrics, bit for bit, as the dense
    float batch; the target is materialised in the decoder's blocked layout
    and the image stays dense."""
    _, _, _, model, _ = image_setup
    loss_cfg = configs.loss_config("pascal_nolbo")
    draws = t(jax_step_draws(key_with_coin(loss_cfg, True), loss_cfg))
    raw = make_batch(2)
    base = {k: raw[k] for k in ("category_onehot", "inst_onehot")}
    forms = {
        "dense": {"input": raw["input"], "target": raw["target"]},
        "target_packed": {"input": raw["input"], "target_packed": pack_voxels(raw["target"])},
        "target_packed_blocked": {"input": raw["input"], "target_packed_blocked": pack_voxels_blocked(raw["target"], 4)},
        "uint8": {"input": raw["u8"], "target": raw["target"]},
    }
    got = {}
    for name in ("dense", form):
        batch = t({**base, **forms[name]})
        mat, blocked_in, blocked_out = port_step.materialize_batch(model, batch)
        assert not blocked_in and blocked_out
        assert mat["input"].shape == (B, ROWS, COLS, 3) and mat["input"].dtype == torch.float32
        assert mat["target"].shape == (B, 8, 8, 8, 64)
        with torch.no_grad():
            got[name] = port_step.compute_losses(model, loss_cfg, batch, draws=draws)[1]
    for k in LOSS_KEYS:
        assert float(got[form][k]) == float(got["dense"][k]), k


def test_voxel_inputs_do_not_fit_an_image_model(image_setup):
    """Packed voxel inputs need a blocked-IO (voxel) model: an image model refuses them."""
    *_, model, _ = image_setup
    assert model.blocked_io_block is None and model.decoder_block == 4
    with pytest.raises(ValueError, match="blocked-IO"):
        port_step.materialize_batch(model, {"input_packed_blocked": torch.zeros(1, 8, dtype=torch.uint8)})


def test_image_bf16_stays_close_to_f32(image_setup):
    """bf16 compute with f32 parameters: every loss within 5% of f32 (8 bits
    of mantissa through ~25 layers), finite f32 gradients, and a step that
    moves the f32 parameters."""
    _, _, tree, model, cfg = image_setup
    loss_cfg = configs.loss_config("pascal_nolbo")
    draws = t(jax_step_draws(key_with_coin(loss_cfg, True), loss_cfg))
    raw = make_batch(3)
    batch = t({"input": raw["u8"], "target_packed_blocked": pack_voxels_blocked(raw["target"], 4),
               "category_onehot": raw["category_onehot"], "inst_onehot": raw["inst_onehot"]})
    low = MultiModalVAE(cfg, dtype=torch.bfloat16)
    low.load_state_dict(params_from_flax(tree))
    with torch.no_grad():
        ref = port_step.compute_losses(model, loss_cfg, batch, draws=draws)[1]
    state = create_train_state(low)
    before = {n: p.detach().clone() for n, p in low.named_parameters()}
    state, metrics = port_step.make_train_step(low, loss_cfg)(state, batch, draws=draws)
    for k in ("loss_shape", "loss_kl", "loss_reg", "loss_total"):
        np.testing.assert_allclose(float(metrics[k]), float(ref[k]), rtol=0.05, err_msg=k)
    assert float(metrics["grads_finite"]) == 1.0 and state.step == 1
    assert all(p.dtype == torch.float32 and torch.isfinite(p).all() for p in low.parameters())
    assert any(not torch.equal(p, before[n]) for n, p in low.named_parameters())


def test_black_image_zeroes_the_step_as_jax_does(image_setup):
    """A fresh model (GroupNorm shifts at 0) fed all-black images: every
    GroupNorm group has zero variance, each backward through a norm scales by
    1/sqrt(1e-5), and over the 18 of them the gradient overflows while the
    loss stays finite. JAX's guard (``grads_finite_flag``, which its step
    applies) flags it; so must the port's step: the same flag, the same
    finite loss (LOSS_RTOL), and parameters unchanged (from a fresh Adam
    state a zeroed step moves nothing)."""
    jax_model, fresh, _, _, cfg = image_setup
    loss_cfg = configs.loss_config("pascal_nolbo")
    raw = make_batch(4)
    batch = dense(dict(raw, input=np.zeros_like(raw["input"])))
    key = key_with_coin(loss_cfg, True)
    jloss, jgrads = jax_loss_and_grad(jax_model, key)(jax.tree.map(jnp.asarray, fresh),
                                                      jax.tree.map(jnp.asarray, batch))
    assert float(jax_grads_finite_flag(jgrads)) == 0.0 and math.isfinite(float(jloss))

    model = MultiModalVAE(cfg)
    model.load_state_dict(params_from_flax(fresh))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, metrics = port_step.make_train_step(model, loss_cfg)(create_train_state(model), t(batch),
                                                                draws=t(jax_step_draws(key, loss_cfg)))
    assert float(metrics["grads_finite"]) == 0.0 and state.step == 1
    np.testing.assert_allclose(float(metrics["loss_total"]), float(jloss), rtol=LOSS_RTOL)
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]), n


def test_l2_penalty_takes_exactly_the_flax_kernels(image_setup):
    """``l2_penalty`` sums the ``.weight`` tensors of more than one axis: on
    the image model those are exactly the flax ``kernel`` leaves (the 2-D
    convs, the decoder's, both prior nets' dense kernels), no norm scale,
    and its value is JAX's (rtol 1e-5, a sum over 31M squares in another order)."""
    _, _, tree, model, _ = image_setup
    flat = {"/".join(k.key for k in path): leaf for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}
    kernel_names = set(params_from_flax(_nest({k: v for k, v in flat.items() if k.endswith("/kernel")})))
    chosen = {n for n, p in model.named_parameters() if n.endswith(".weight") and p.dim() > 1}
    assert chosen == kernel_names
    assert any(n.startswith("prior_inst.") for n in chosen) and any(n.startswith("backbone.") for n in chosen)
    ref = float(jax_l2_penalty(jax.tree.map(jnp.asarray, tree), 5e-4))
    np.testing.assert_allclose(float(l2_penalty(dict(model.named_parameters()), 5e-4).detach()), ref, rtol=1e-5)


def _nest(flat):
    tree = {}
    for key, value in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


# ---------------------------------------------------------------- loader, schedule, batch function


def test_synthetic_image_loader_matches_jax():
    """Every array of every batch equal to the JAX loader's, bit for bit, at a
    non-square size (cols 40, rows 24: images come out (B, 24, 40, 3)) and its
    transpose, across an epoch boundary and the render cache; the progress
    attributes too."""
    kw = dict(num_samples=11, dim=16, num_classes=5, num_inst=3, seed=2)
    ours, theirs = SyntheticImageObjectLoader(**kw), JaxImageLoader(**kw)
    for size in [(40, 24), (40, 24), (24, 40), (40, 24), (40, 24)]:
        a, b = ours.getNextBatch(4, imageSize=size), theirs.getNextBatch(4, imageSize=size)
        assert len(a) == len(b) == 6
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
        assert a[4].shape == (4, size[1], size[0], 3) and a[5].shape == (4, 16, 16, 16, 1)
        assert (ours.epoch, ours.batchStart, ours.dataStart) == (theirs.epoch, theirs.batchStart, theirs.dataStart)
    assert ours.epoch == 2 and ours._render_cache.keys() == theirs._render_cache.keys()
    assert a[4].std() > 0.05  # a render, not a blank


def test_multi_scale_schedule_matches_jax():
    sizes = [(32, 48, 4), (40, 40, 2), (64, 96, 8)]
    for seed in (0, 3):
        got = [trainer_mod.multi_scale_schedule(sizes, it, seed=seed) for it in range(40)]
        assert got == [tuple(jax_multi_scale_schedule(sizes, it, seed=seed)) for it in range(40)]
        assert all(got[i] == got[i - i % 3] for i in range(40))  # three steps an entry
        assert {got[9 * r + 3 * j] for r in range(4) for j in range(3)} == set(sizes)


@pytest.mark.parametrize("packed", [False, True])
def test_batch_fn_matches_jax_under_multi_scale(packed):
    """``build_batch_fn`` on the image loader under a multi-scale schedule of
    non-square sizes: the JAX function's arrays and keys (packed: the target
    in the blocked bit order), image shapes (batch, rows, cols, 3)."""
    jax_cfg, cfg = image_configs()
    kw = dict(num_samples=9, dim=DIM, num_classes=CAT, num_inst=INST, seed=4)
    sched = [(24, 40, 3), (16, 24, 2)]
    ours = cli_train.build_batch_fn(SyntheticImageObjectLoader(**kw), cfg, 3, packed=packed, multi_scale=sched)
    theirs = jax_cli_train.build_batch_fn(JaxImageLoader(**kw), jax_cfg, 3, multi_scale=sched, packed=packed)
    for it in range(7):
        a, b = ours(it), theirs(it)
        assert a.keys() == b.keys()
        assert ("target_packed_blocked" in a) == packed
        rows, cols, bs = trainer_mod.multi_scale_schedule(sched, it)
        assert a["input"].shape == (bs, rows, cols, 3)
        for k in a:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)


# ---------------------------------------------------------------- anytime, protocols


def anytime_draws(key, missing_prob, n=B):
    """The draws JAX ``anytime_eval`` makes from ``key`` (its traced rate in float32)."""
    k_cat, k_inst, k_mask, k_corr = jax.random.split(key, 4)
    d = {"eps_cat": jax.random.normal(k_cat, (n, ZC)), "eps_inst": jax.random.normal(k_inst, (n, ZI))}
    if missing_prob > 0:
        d["keep"] = jax.random.bernoulli(k_mask, 1.0 - jnp.float32(missing_prob), (n, ZC))
        d["eps_corr"] = jax.random.normal(k_corr, (n, ZC))
    return _np_tree(d)


@pytest.fixture(scope="module")
def eval_model(image_setup):
    """The port on the same weights with the prior nets' dropout at 0.2 and
    in train mode: ``anytime_eval`` must run the priors in eval mode itself."""
    *_, tree, _, _ = image_setup
    model = MultiModalVAE(image_configs(dropout_rate=0.2)[1])
    model.load_state_dict(params_from_flax(tree))
    return model.train()


@pytest.mark.parametrize("missing_prob", [0.0, 0.5])
def test_anytime_eval_dual_latent_matches_jax(image_setup, eval_model, missing_prob):
    """The category block sampled, masked and corrected, the instance block
    sampled and appended, ``acc_inst`` from the instance prior swept over
    every instance under each sample's category: every metric as JAX's
    (accuracies equal), the decodes (dense) to PRED_ATOL, on a
    packed-blocked target."""
    jax_model, _, tree, _, _ = image_setup
    raw = make_batch(5)
    key = jax.random.PRNGKey(3)
    ref = _np_tree(jax_engine.anytime_eval_jit(jax_model, tree, jax.tree.map(jnp.asarray, dense(raw)), key,
                                               missing_prob, return_pred=True))
    batch = t({"input": raw["u8"], "target_packed_blocked": pack_voxels_blocked(raw["target"], 4),
               "category_onehot": raw["category_onehot"], "inst_onehot": raw["inst_onehot"]})
    got = engine.anytime_eval(eval_model, batch, missing_prob=missing_prob, return_pred=True,
                              draws=t(anytime_draws(key, missing_prob)))
    want = {"acc_category", "acc_inst", "loss_shape", "precision", "recall", "pred"}
    if missing_prob:
        want |= {f"{k}_corrected" for k in want - {"acc_inst"}}
    assert set(got) == set(ref) == want
    assert_metrics_close(got, ref, keys=[k for k in want if not k.startswith("pred")])
    for k in [k for k in want if k.startswith("pred")]:
        assert got[k].shape == (B, DIM, DIM, DIM, 1)
        np.testing.assert_allclose(got[k].numpy(), ref[k], atol=PRED_ATOL, rtol=0, err_msg=k)
    assert eval_model.training


def test_instance_accuracy_reads_the_instance_prior(image_setup, eval_model):
    """``acc_inst`` moves with the instance labels (and not the category
    accuracy); the samples that hit are those nearest their own instance's prior mean."""
    raw = make_batch(6)
    batch = t(dense(raw))
    draws = t(anytime_draws(jax.random.PRNGKey(1), 0.0))
    a = engine.anytime_eval(eval_model, batch, draws=draws)
    nearest = [int(engine.anytime_eval(eval_model, dict(batch, inst_onehot=torch.eye(INST)[[i] * B]),
                                       draws=draws)["acc_inst"] * B) for i in range(INST)]
    assert sum(nearest) == B  # each sample is nearest to exactly one instance
    assert {float(a["acc_category"])} == {float(engine.anytime_eval(eval_model, dict(
        batch, inst_onehot=torch.eye(INST)[[0] * B]), draws=draws)["acc_category"])}


def with_jax_draws(monkeypatch, module):
    """Make ``module.anytime_eval`` take the JAX draws of ``PRNGKey(seed)``, ``seed`` its generator's."""
    real = module.anytime_eval

    def wrapped(model, batch, generator, missing_prob=0.0, **kw):
        n = next(iter(batch.values())).shape[0]
        draws = anytime_draws(jax.random.PRNGKey(generator.initial_seed()), missing_prob, n)
        return real(model, batch, generator, missing_prob=missing_prob, draws=t(draws), **kw)

    monkeypatch.setattr(module, "anytime_eval", wrapped)


def test_evaluate_epoch_and_sweep_on_image_batches(image_setup, eval_model, monkeypatch):
    """``evaluate_epoch`` and ``missing_rate_sweep`` over an image batch
    function (uint8 images, packed-blocked targets) against the JAX
    protocols over the dense batches, ``acc_inst`` carried in both."""
    jax_model, _, tree, _, _ = image_setup
    with_jax_draws(monkeypatch, protocols)
    raws = [make_batch(20 + b) for b in range(2)]

    def port_fn(b):
        r = raws[b]
        return {"input": r["u8"], "target_packed_blocked": pack_voxels_blocked(r["target"], 4),
                "category_onehot": r["category_onehot"], "inst_onehot": r["inst_onehot"]}

    def jax_fn(b):
        return dense(raws[b])

    ref = jax_protocols.evaluate_epoch(jax_model, tree, jax_fn, 2, missing_prob=0.5, seed=7)
    got = protocols.evaluate_epoch(eval_model, port_fn, 2, missing_prob=0.5, seed=7)
    assert set(got) == set(ref) and "acc_inst" in got
    assert_metrics_close(got, ref, keys=sorted(ref))
    ref = jax_protocols.missing_rate_sweep(jax_model, tree, jax_fn, (0.5,), num_batches=2, seed=1)
    got = protocols.missing_rate_sweep(eval_model, port_fn, (0.5,), num_batches=2, seed=1)
    assert set(got[0.5]) == set(ref[0.5])
    assert_metrics_close(got[0.5], ref[0.5], keys=sorted(ref[0.5]))


def test_trainer_eval_on_image_batches_matches_jax(image_setup, eval_model, monkeypatch):
    """``Trainer.evaluate(it)`` on an image batch: the losses, and the anytime
    metrics (``anytime_acc_inst`` among them) as JAX's ``anytime_eval`` at
    missing 0.5 with ``PRNGKey(it)``."""
    jax_model, _, tree, _, _ = image_setup
    with_jax_draws(monkeypatch, trainer_mod)
    raw = make_batch(5)
    batch = {"input": raw["u8"], "target": raw["target"], "category_onehot": raw["category_onehot"],
             "inst_onehot": raw["inst_onehot"]}
    tr = trainer_mod.Trainer(eval_model, create_train_state(eval_model), lambda it: batch,
                             configs.loss_config("pascal_nolbo"), lambda it: batch,
                             trainer_mod.TrainerConfig(total_steps=1, prefetch_depth=0))
    out = tr.evaluate(3)
    ref = _np_tree(jax_engine.anytime_eval_jit(jax_model, tree, jax.tree.map(jnp.asarray, dense(raw)),
                                               jax.random.PRNGKey(3), 0.5))
    got = {k[len("anytime_"):]: v for k, v in out.items() if k.startswith("anytime_")}
    assert set(got) == set(ref) and "acc_inst" in got and "eval_loss_total" in out
    assert_metrics_close(got, ref, keys=sorted(ref))


# ---------------------------------------------------------------- serving, export, CLIs


def _mask(n=B, seed=0):
    m = (np.random.default_rng(seed).uniform(size=(n, ZC)) < 0.5).astype(np.float32)
    m[0], m[1] = 1.0, 0.0
    return m


def test_image_infer_matches_jax(image_setup):
    """``make_infer_fn`` on float images against the JAX serving function:
    category equal, latents to Z_TOL; the port's ``pred`` is the JAX
    decoder's output for the same z, and its sigmoid the JAX ``pred`` (the
    JAX program applies a second sigmoid)."""
    jax_model, _, tree, model, _ = image_setup
    x, mask = make_batch(8)["input"], _mask()
    ref = _np_tree(jax.jit(jax_make_infer_fn(jax_model))(tree, jnp.asarray(x), jnp.asarray(mask)))
    out = {k: v.numpy() for k, v in make_infer_fn(model)(torch.from_numpy(x), torch.from_numpy(mask)).items()}
    assert set(out) == set(ref)
    np.testing.assert_array_equal(out["category"], ref["category"])
    np.testing.assert_allclose(out["z_mean"], ref["z_mean"], **Z_TOL)
    np.testing.assert_allclose(out["z_log_var"], ref["z_log_var"], **Z_TOL)
    assert out["z_mean"].shape == (B, ZC + ZI) and out["pred"].shape == (B, DIM, DIM, DIM, 1)
    decoded = np.asarray(jax.jit(lambda p, z: jax_model.apply({"params": p}, z, method=JaxVAE.decode))(
        tree, jnp.asarray(ref["z_mean"])))
    np.testing.assert_allclose(out["pred"], decoded, atol=PRED_ATOL, rtol=0)
    np.testing.assert_allclose(1 / (1 + np.exp(-out["pred"])), ref["pred"], atol=PRED_ATOL, rtol=0)


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/infer", json.dumps(body), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_image_program_exports_and_serves(image_setup, monkeypatch, tmp_path):
    """``cli.export --image-size`` (``export_infer``) writes the (B, S, S, 3)
    float program, which ``load_infer`` loads and which answers as the eager
    program does (atol 1e-6: the same ops); ``cli.serve --artifact`` serves
    it through the raw ``input`` path, one (S, S, 3) image a request;
    ``cli.serve --config`` refuses an image config."""
    from anytime3d_tpu_torch.train.checkpoint import save_params

    *_, model, cfg = image_setup
    monkeypatch.setitem(configs.REGISTRY, "pascal_nolbo", lambda: cfg)
    save_params(str(tmp_path / "ckpt"), model.state_dict())
    out = tmp_path / "image.pt2"
    cli_export.main(["--config", "pascal_nolbo", "--ckpt", str(tmp_path / "ckpt"), "--batch-size", "2",
                     "--image-size", "32", "--out", str(out), "--device", "cpu"])
    fn = load_infer(out.read_bytes())
    assert (fn.input_shape, fn.input_dtype, fn.mask_shape) == ((2, 32, 32, 3), torch.float32, (2, ZC))
    img, mask = make_batch(10, n=2, rows=32, cols=32)["input"], _mask(n=2)
    got, want = (f(torch.from_numpy(img), torch.from_numpy(mask)) for f in (fn, make_infer_fn(model)))
    assert torch.equal(got["category"], want["category"])
    for k in ("z_mean", "z_log_var", "pred"):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-6, err_msg=k)

    server, what = serve_cli.build_server(serve_cli.parse_args(["--artifact", str(out), "--device", "cpu",
                                                                "--mask-dim", str(ZC)]))
    assert "item (32, 32, 3) float" in what and "batch 2" in what
    try:
        port = server.serve(0, background=True)
        status, reply = _post(port, {"input": img[0].tolist(), "mask": mask[0].tolist()})
        assert status == 200, reply
    finally:
        server.close()
    # the batcher pads the request to the program's batch with zero images and full masks
    img[1], mask[1] = 0.0, 1.0
    ref = make_infer_fn(model)(torch.from_numpy(img), torch.from_numpy(mask))
    assert reply["category"] == int(ref["category"][0])
    np.testing.assert_allclose(reply["z_mean"], ref["z_mean"][0].numpy(), rtol=1e-5, atol=1e-5)
    pred = np.frombuffer(base64.b64decode(reply["pred_f32_b64"]), np.float32).reshape(DIM, DIM, DIM, 1)
    np.testing.assert_allclose(pred, ref["pred"][0].numpy(), rtol=0, atol=1e-6)
    with pytest.raises(SystemExit, match="voxel-encoder"):
        serve_cli.build_server(serve_cli.parse_args(["--config", "pascal_nolbo", "--device", "cpu"]))


def test_cli_train_runs_the_image_config_on_the_cpu(monkeypatch, tmp_path):
    """``cli.train.main`` with an image config: the synthetic image loaders,
    a multi-scale schedule, dense targets (``--packed`` is a voxel option),
    finite metrics on every step and an eval with the anytime metrics,
    ``anytime_acc_inst`` among them."""
    cfg = image_configs(dropout_rate=0.2)[1]
    monkeypatch.setitem(configs.REGISTRY, "pascal_nolbo", lambda: cfg)
    shapes = []
    real = cli_train.build_batch_fn

    def spy(*a, **kw):
        fn = real(*a, **kw)

        def batch_fn(it):
            b = fn(it)
            shapes.append((tuple(b["input"].shape), tuple(sorted(b))))
            return b

        return batch_fn

    monkeypatch.setattr(cli_train, "build_batch_fn", spy)
    trainer = cli_train.main(["--config", "pascal_nolbo", "--device", "cpu", "--steps", "3", "--batch-size", "2",
                              "--packed", "--image-size", "32", "--multi-scale", "32,48", "--eval-every", "3",
                              "--jsonl", str(tmp_path / "t.jsonl")])
    assert trainer.state.step == 3 and len(trainer.history) == 3 and len(trainer.eval_history) == 1
    assert all(math.isfinite(v) for row in trainer.history + trainer.eval_history for v in row.values())
    assert "anytime_acc_inst" in trainer.eval_history[0]
    keys = ("category_onehot", "input", "inst_onehot", "target")
    train_shapes = {s for s, k in shapes[:3]}
    assert all(k == keys for _, k in shapes) and train_shapes <= {(2, 32, 32, 3), (2, 48, 48, 3)}
    assert shapes[-1][0] == (2, 32, 32, 3)  # the eval batches at --image-size


@pytest.mark.parametrize("size", [None, 32])
def test_cli_evaluate_reads_images_of_image_size(monkeypatch, capsys, size):
    """``cli.evaluate.main`` on an image config evaluates renders of
    ``--image-size`` pixels square, 64 without the flag, as the JAX CLI does:
    every batch of the sweep and of the PR curve has that size."""
    cfg = image_configs()[1]
    monkeypatch.setitem(configs.REGISTRY, "pascal_nolbo", lambda: cfg)
    shapes = []
    real = cli_train.build_batch_fn

    def spy(*a, **kw):
        fn = real(*a, **kw)

        def batch_fn(it):
            b = fn(it)
            shapes.append(tuple(b["input"].shape))
            return b

        return batch_fn

    monkeypatch.setattr(cli_train, "build_batch_fn", spy)
    argv = ["--config", "pascal_nolbo", "--device", "cpu", "--batch-size", "2", "--batches", "1", "--rates", "0.5"]
    table, curve = cli_evaluate.main(argv + ([] if size is None else ["--image-size", str(size)]))
    side = 64 if size is None else size
    assert shapes and set(shapes) == {(2, side, side, 3)}
    assert all(np.isfinite(v) for v in table[0.5].values()) and np.isfinite(curve["iou"]).all()
    assert "best decode threshold" in capsys.readouterr().out


def test_orbax_to_npz_carries_an_image_checkpoint_into_the_port(tmp_path):
    """``tools/orbax_to_npz.py`` unchanged on a JAX image model's checkpoint
    (Darknet53Tiny: 2-D kernels under ``backbone`` and ``head``, the instance
    prior): the port on the ``.npz`` serves as the JAX model does."""
    from anytime3d_tpu.train import checkpoint as jax_checkpoint

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import orbax_to_npz

    jax_cfg, cfg = image_configs(backbone="darknet53tiny")
    jax_model = JaxVAE(jax_cfg)
    x, mask = make_batch(11, n=2, rows=32, cols=32)["input"], _mask(n=2)
    params = jax.tree.map(jnp.asarray, random_tree(model_init(jax_model, 32, 32), np.random.default_rng(3)))
    jax_checkpoint.save_params(str(tmp_path / "orbax"), params)
    out = str(tmp_path / "params.npz")
    flat = orbax_to_npz.main([str(tmp_path / "orbax"), out])
    assert "backbone/ConvBlock2D_6/Conv_0/kernel" in flat and "prior_inst/mean_tower/Dense_1/kernel" in flat
    model = MultiModalVAE(cfg)
    model.load_state_dict(load_flax_npz(out))
    ref = _np_tree(jax.jit(jax_make_infer_fn(jax_model))(params, jnp.asarray(x), jnp.asarray(mask)))
    got = {k: v.numpy() for k, v in make_infer_fn(model)(torch.from_numpy(x), torch.from_numpy(mask)).items()}
    np.testing.assert_array_equal(got["category"], ref["category"])
    np.testing.assert_allclose(got["z_mean"], ref["z_mean"], **Z_TOL)
    np.testing.assert_allclose(1 / (1 + np.exp(-got["pred"])), ref["pred"], atol=PRED_ATOL, rtol=0)
