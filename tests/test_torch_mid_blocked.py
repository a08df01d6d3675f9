"""PyTorch port, the layer features the earlier slices left out, against the
JAX package on the CPU: the ``mid_blocked`` encoder and decoder stages (every
composition ``tests/test_nn.py`` builds, their flax names, the strict load,
forward and every gradient leaf; the whole train step's losses and
gradients on a ``mid_blocked`` model), the learned log-var ``PriorNet`` with
JAX's dropout masks, ``create_train_state(flat_opt=True)`` against
``flat_adam`` and ``optax.adam``, and ``kernels/subpixel.py`` (mirroring
``tests/test_kernels.py``). The spans of ``utils/profiling.py`` are held
in ``tests/test_torch_tracing.py``.

Weights are flax trees drawn in numpy and converted with
``convert.params_from_flax``; inputs come from numpy seeds; the JAX side runs
under ``jax.jit`` where it has no random draws to record. Comparisons are
float32; each tolerance is stated where it is set.
"""

import copy
import dataclasses
import itertools
import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from anytime3d_tpu.kernels import subpixel as jax_subpixel
from anytime3d_tpu.models import configs as jax_configs
from anytime3d_tpu.models.mmvae import MultiModalVAE as JaxVAE
from anytime3d_tpu.nn import autoencoder3d as jax_ae
from anytime3d_tpu.nn import blocks as jax_blocks
from anytime3d_tpu.nn.priornet import PriorNet as JaxPriorNet
from anytime3d_tpu.nn.priornet import PriorNetConfig as JaxPriorNetConfig
from anytime3d_tpu.train import state as jax_state
from anytime3d_tpu.train import step as jax_step
from anytime3d_tpu_torch.convert import params_from_flax
from anytime3d_tpu_torch.kernels import subpixel
from anytime3d_tpu_torch.kernels.conv_k2 import conv_k2
from anytime3d_tpu_torch.models import configs
from anytime3d_tpu_torch.models.mmvae import MultiModalVAE
from anytime3d_tpu_torch.nn import autoencoder3d as ae
from anytime3d_tpu_torch.nn import blocks
from anytime3d_tpu_torch.nn import priornet
from anytime3d_tpu_torch.train import step as port_step
from anytime3d_tpu_torch.train.state import FlatAdam, create_train_state

TOL = dict(rtol=1e-4, atol=1e-5)  # f32 both sides, summation order only, through a few layers
GRAD_REL = 1e-4  # each gradient leaf against JAX's, relative to that leaf's largest entry
ADAM_ATOL = 1e-6  # parameters after 3 Adam steps of lr 1e-3: the updates' rounding
B, Z, CAT, DIM = 2, 8, 5, 32


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


def check_module(jax_mod, port_mod, x, seed=0, **kw):
    """Forward and the gradients of the input and of every leaf (through a
    random cotangent) of ``port_mod`` against ``jax_mod`` on one random tree;
    the converted tree must fill ``port_mod`` exactly (a strict load).
    Returns the port's output."""
    rng = np.random.default_rng(seed)
    tree = random_tree(lambda k: jax_mod.init(k, jnp.asarray(x), **kw), rng)
    fn = jax.jit(lambda p, xx: jax_mod.apply({"params": p}, xx, **kw))
    y_ref, vjp = jax.vjp(fn, tree, jnp.asarray(x))
    g = rng.standard_normal(y_ref.shape).astype(np.float32)
    dp, dx = vjp(jnp.asarray(g))
    port_mod.load_state_dict(params_from_flax(tree), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = port_mod(xt, **kw)
    names, params = zip(*port_mod.named_parameters())
    grads = torch.autograd.grad(y, [xt, *params], torch.from_numpy(g))
    assert y.shape == y_ref.shape and float(np.asarray(y_ref).std()) > 1e-3
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), **TOL)
    want = params_from_flax(np_tree(dp))
    want["x"] = torch.from_numpy(np.array(dx))
    for n, gr in zip(("x", *names), grads):  # sums over many voxels: relative to the leaf's largest entry
        w = want[n].numpy()
        assert float(np.abs(gr.numpy() - w).max()) <= GRAD_REL * float(np.abs(w).max()), n
    return y.detach()


# ---------------------------------------------------------------- mid_blocked encoder and decoder

def encoder_configs(**kw):
    """(jax, port) encoders of tests/test_nn.py::TestMidBlocked: 32^3 x 1 in."""
    return [mod.Encoder3DConfig(output_dim=16, filter_nums=(8, 16, 32), filter_sizes=(4, 4, 4, 4),
                                strides=(2, 2, 2, 1), mid_blocked=True, **kw) for mod in (jax_ae, ae)]


ENCODERS = {"classic": {}, "head_blocked": {"head_blocked": True}, "s2d2_stem": {"stem_space_to_depth": 2},
            "max_pool": {"final_pool": "max"}}


@pytest.mark.parametrize("layout", sorted(ENCODERS))
def test_mid_blocked_encoder_matches_flax(layout):
    """Every k=4 s=2 stage as space-to-depth(2) + a k=2 s=1 conv over 8x the
    channels (``conv_k2``): alone on the classic stem, beside the blocked head
    (the head's two k=2 convs, then one folded stage), on the s2d(2) stem
    (whose k=2 stem is no k=4 stage: the later two fold). Forward and every
    gradient leaf; each folded conv a ``ConvK2`` of 8 C inputs."""
    jax_cfg, cfg = encoder_configs(**ENCODERS[layout])
    enc = ae.Encoder3D(cfg, grid=(DIM,) * 3)
    assert enc.mid == {"classic": [True, True, True], "head_blocked": [False, False, True],
                       "s2d2_stem": [False, True, True], "max_pool": [True, True, True]}[layout]
    for i, (mid, (_, k, s)) in enumerate(zip(enc.mid, enc.stages)):
        assert isinstance(getattr(enc, f"convblock3d_{i}").conv_0, blocks.ConvK2) == (mid or (k, s) == (2, 1))
    x = (np.random.default_rng(len(layout)).uniform(size=(B, DIM, DIM, DIM, 1)) > 0.6).astype(np.float32)
    y = check_module(jax_ae.Encoder3D(jax_cfg), enc, x)
    assert y.shape == (B, 16)
    # the same parameter count as the classic stages (4^3 C N == 2^3 (8 C) N), as JAX's test holds
    plain = ae.Encoder3D(dataclasses.replace(cfg, mid_blocked=False))
    assert sum(p.numel() for p in enc.parameters()) == sum(p.numel() for p in plain.parameters())


def test_mid_blocked_encoder_leaves_a_1cubed_stage_classic():
    """A stage whose input grid is 1 on an axis stays the classic k=4 s=2
    conv, as flax decides from the traced shape: built for the grid (16^3, the
    fifth stage meets 1^3), it matches flax; built without it, it assumes a
    fold there and refuses that input."""
    jax_cfg, cfg = (mod.Encoder3DConfig(output_dim=6, filter_nums=(4, 8, 8, 8, 8), filter_sizes=(4,) * 6,
                                        strides=(2, 2, 2, 2, 2, 1), mid_blocked=True) for mod in (jax_ae, ae))
    enc = ae.Encoder3D(cfg, grid=(16, 16, 16))
    assert enc.mid == [True, True, True, True, False]
    x = (np.random.default_rng(9).uniform(size=(B, 16, 16, 16, 1)) > 0.5).astype(np.float32)
    check_module(jax_ae.Encoder3D(jax_cfg), enc, x)
    with pytest.raises(ValueError, match="grid"):
        ae.Encoder3D(cfg)(torch.from_numpy(x))


def decoder_configs(**kw):
    """(jax, port) decoders of tests/test_nn.py::TestMidBlocked: 32^3 x 1 out."""
    return [mod.Decoder3DConfig(input_dim=8, output_shape=(DIM, DIM, DIM, 1), filter_nums=(32, 16, 8, 1),
                                filter_sizes=(4, 4, 4, 4), strides=(1, 2, 2, 2), mid_blocked=True, **kw)
            for mod in (jax_ae, ae)]


DECODERS = {
    "pixel_shuffle": ({}, ["deconvblock3d_0", "conv_0", "groupnorm_0", "conv_1", "groupnorm_1", "conv_2"], False),
    "tail_blocked": ({"tail_blocked": True},
                     ["deconvblock3d_0", "conv_0", "groupnorm_0", "conv_1", "groupnorm_1", "conv_2"], True),
    "tail_phase_norm": ({"tail_blocked": True, "tail_phase_norm": True},
                        ["deconvblock3d_0", "conv_0", "groupnorm_0", "conv_1", "phasegroupnorm_0", "conv_2"], False),
    "transpose": ({"final_mode": "transpose"},
                  ["deconvblock3d_0", "conv_0", "groupnorm_0", "conv_1", "groupnorm_1", "convtranspose_0"], False),
    "transpose_equiv": ({"final_mode": "transpose_equiv"},
                        ["deconvblock3d_0", "conv_0", "groupnorm_0", "conv_1", "groupnorm_1",
                         "convtransposeequiv3d_0"], True),
    "mid_equiv": ({"final_mode": "transpose_equiv", "mid_equiv": True},
                  ["deconvblock3d_0", "conv_0", "groupnorm_0", "conv_1", "groupnorm_1", "convtransposeequiv3d_0"],
                  False),
}


@pytest.mark.parametrize("layout", sorted(DECODERS))
def test_mid_blocked_decoder_matches_flax(layout):
    """Every k=4 s=2 middle stage as a k=2 conv to 8 f phase channels
    (``conv_k2``), depth-to-space(2), GroupNorm(f) and the activation at the
    fine grid; with each final layout (pixel shuffle, blocked tail with its
    per-phase or fine-grid norm, transposed conv, its phase lowering;
    ``mid_equiv`` yields to ``mid_blocked`` as in flax): flax's names,
    numbered per class with the tail's, forward (``blocked_output`` where the
    layout has it) and every gradient leaf."""
    change, names, blocked = DECODERS[layout]
    jax_cfg, cfg = decoder_configs(**change)
    dec = ae.Decoder3D(cfg)
    assert [n for n, _ in dec.named_children()] == ["denseblock_0"] + names
    assert [n.lower() for n in jax_ae._decoder_stage_names(jax_cfg)] == [n for n in names if "norm" not in n]
    z = np.random.default_rng(len(layout)).normal(size=(B, 8)).astype(np.float32)
    y = check_module(jax_ae.Decoder3D(jax_cfg), dec, z, blocked_output=blocked)
    if blocked:
        np.testing.assert_allclose(y.numpy(), blocks.space_to_depth3d(dec(torch.from_numpy(z)).detach(), 4).numpy(),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("final_mode", ["pixel_shuffle", "transpose", "transpose_equiv"])
def test_mid_blocked_stage_names_and_strict_load_every_layout(final_mode):
    """tests/test_nn.py's layout grid (tail_blocked x mid_blocked x mid_equiv
    at each final mode, 16^3): the port's ``_decoder_stage_names`` equal
    JAX's, and flax's tree loads into the port's decoder strictly (no leaf
    left over or missing, every shape equal)."""
    for tail, midb, mide in itertools.product((False, True), repeat=3):
        kw = dict(input_dim=8, output_shape=(16, 16, 16, 1), filter_nums=(16, 8, 1), filter_sizes=(4, 4, 4),
                  strides=(1, 2, 2), final_mode=final_mode, tail_blocked=tail, mid_blocked=midb, mid_equiv=mide)
        jax_cfg, cfg = jax_ae.Decoder3DConfig(**kw), ae.Decoder3DConfig(**kw)
        assert ae._decoder_stage_names(cfg) == jax_ae._decoder_stage_names(jax_cfg)
        shapes = jax.eval_shape(lambda k: jax_ae.Decoder3D(jax_cfg).init(k, jnp.zeros((1, 8))),
                                jax.random.PRNGKey(0))["params"]
        tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
        ae.Decoder3D(cfg).load_state_dict(params_from_flax(tree), strict=True)


# ---------------------------------------------------------------- the slice: a mid_blocked model's train step

def small_configs():
    """modelnet_nolbo's layout (blocked head and tail) with mid_blocked on the
    encoder and decoder, at 32^3 with narrow filters: (jax, port)."""
    out = []
    for mod in (jax_configs, configs):
        base = mod.modelnet_nolbo(z_dim=Z, category_dim=CAT)
        out.append(dataclasses.replace(
            base,
            encoder3d=dataclasses.replace(base.encoder3d, filter_nums=(8, 16, 16, 32), mid_blocked=True),
            decoder=dataclasses.replace(base.decoder, output_shape=(DIM,) * 3 + (1,), filter_nums=(32, 16, 16, 8, 1),
                                        mid_blocked=True),
            prior_category=dataclasses.replace(base.prior_category, unit_nums=(16, Z), dropout_rate=0.0),
        ))
    return out


def jax_draws(key, cfg):
    """The draws ``_encode_and_sample`` makes from ``key``, as numpy arrays
    (as tests/test_torch_train.py reads them)."""
    ks = jax.random.split(key, 7)
    k_coin, k_elem = jax.random.split(ks[4])
    return {
        "eps_inst": np.asarray(jax.random.normal(ks[1], (B, Z), jnp.float32)),
        "eps_prior_cat": np.asarray(jax.random.normal(ks[2], (B, Z), jnp.float32)),
        "coin": np.asarray(jax.random.bernoulli(k_coin, cfg.mix_coin_prob, ())),
        "take_prior": np.asarray(jax.random.bernoulli(k_elem, cfg.mix_element_prob, (B, Z))),
    }


def test_mid_blocked_model_train_losses_and_gradients_match_jax():
    """``modelnet_nolbo``'s layout with ``mid_blocked`` on both sides (blocked
    head, folded stages at 8^3 and 4^3, the middle's k=2 conv and d2s, the blocked
    tail), the train step's losses with JAX's draws: every loss term and P/R
    to rtol 1e-4 (sums over 32768 voxels), every gradient leaf to 1e-4 of its
    largest entry; the model's voxel I/O stays blocked."""
    jax_cfg, cfg = small_configs()
    jax_model = JaxVAE(jax_cfg)
    rng = np.random.default_rng(0)
    tree = random_tree(lambda k: jax_model.init({"params": k, "dropout": k}, jnp.zeros((1, DIM, DIM, DIM, 1)),
                                                method=JaxVAE.initialize), rng)
    model = MultiModalVAE(cfg)
    model.load_state_dict(params_from_flax(tree), strict=True)
    assert model.blocked_io_block == 4 and model.encoder3d.mid == [False, False, True, True]
    vox = (rng.uniform(size=(B, DIM, DIM, DIM, 1)) > 0.7).astype(np.float32)
    onehot = np.eye(CAT, dtype=np.float32)[rng.integers(0, CAT, B)]
    loss_cfg = configs.loss_config("modelnet_nolbo")
    key = jax.random.PRNGKey(4)
    batch = {"input": jnp.asarray(vox), "target": jnp.asarray(vox), "category_onehot": jnp.asarray(onehot)}

    def loss_fn(params):
        return jax_step.compute_losses(jax_model, jax_configs.loss_config("modelnet_nolbo"), params, batch, key,
                                       deterministic=False)

    (_, ref), dp = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(tree)
    draws = {k: torch.from_numpy(np.array(v)) for k, v in jax_draws(key, loss_cfg).items()}
    total, metrics = port_step.compute_losses(
        model, loss_cfg, {"input": torch.from_numpy(vox), "category_onehot": torch.from_numpy(onehot)}, draws=draws)
    for k in ("loss_shape", "loss_kl", "loss_reg", "precision", "recall", "loss_total"):
        np.testing.assert_allclose(float(metrics[k]), float(ref[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    names, params = zip(*model.named_parameters())
    want = params_from_flax(np_tree(dp))
    for name, g in zip(names, torch.autograd.grad(total, params)):
        scale = float(want[name].abs().max())
        assert scale > 0 and float((g - want[name]).abs().max()) <= GRAD_REL * scale, name


# ---------------------------------------------------------------- the learned log-var PriorNet

@pytest.mark.parametrize("train", [False, True])
def test_priornet_log_var_tower_matches_flax(monkeypatch, train):
    """``const_log_var=None``: a second tower learns the log-variance
    (``log_var_tower``, flax's name). In train mode each tower's dropout masks
    are JAX's (recorded from flax's ``Dropout`` and handed to the port as its
    uniform draws, the mean tower's first): mean, log-var and every gradient
    leaf, f32."""
    cfg = priornet.PriorNetConfig(input_dim=5, unit_nums=(16, 12, 8), const_log_var=None, dropout_rate=0.3)
    flax_net = JaxPriorNet(JaxPriorNetConfig(**dataclasses.asdict(cfg)))
    onehot = np.eye(5, dtype=np.float32)[np.random.default_rng(6).integers(0, 5, 7)]
    tree = random_tree(lambda k: flax_net.init(k, jnp.asarray(onehot)), np.random.default_rng(7))
    masks = []
    bernoulli = jax.random.bernoulli

    def recorded(key, p=0.5, shape=None):
        mask = bernoulli(key, p, shape)
        masks.append(np.asarray(mask))
        return mask

    monkeypatch.setattr(jax.random, "bernoulli", recorded)

    def fwd(params):
        return flax_net.apply({"params": params}, jnp.asarray(onehot), not train,
                              rngs={"dropout": jax.random.PRNGKey(2)})

    (mean_ref, lv_ref), vjp = jax.vjp(fwd, tree)  # eager: the masks are arrays
    g_mean, g_lv = (np.random.default_rng(s).normal(size=mean_ref.shape).astype(np.float32) for s in (8, 9))
    (dp,) = vjp((jnp.asarray(g_mean), jnp.asarray(g_lv)))
    assert len(masks) == (4 if train else 0)
    draws = iter(masks)
    # the port keeps a unit where its draw is >= the rate: 1 for JAX's kept units, 0 for its dropped ones
    monkeypatch.setattr(priornet, "uniform", lambda shape, generator, device: torch.from_numpy(
        next(draws).astype(np.float32)))
    net = priornet.PriorNet(cfg)
    net.load_state_dict(params_from_flax(tree), strict=True)
    net.train(train)
    assert {n.split(".")[0] for n, _ in net.named_parameters()} == {"mean_tower", "log_var_tower"}
    mean, lv = net(torch.from_numpy(onehot), torch.Generator())
    np.testing.assert_allclose(mean.detach().numpy(), np.asarray(mean_ref), **TOL)
    np.testing.assert_allclose(lv.detach().numpy(), np.asarray(lv_ref), **TOL)
    assert not np.allclose(np.asarray(mean_ref), np.asarray(lv_ref))
    names, params = zip(*net.named_parameters())
    grads = torch.autograd.grad((mean, lv), params, (torch.from_numpy(g_mean), torch.from_numpy(g_lv)))
    want = params_from_flax(np_tree(dp))
    for n, g in zip(names, grads):
        assert float((g - want[n]).abs().max()) <= GRAD_REL * float(want[n].abs().max()), n


def test_model_with_learned_prior_log_var_converts_strictly():
    """A ``modelnet_nolbo`` whose class prior learns its log-variance: flax's
    tree (``prior_category/log_var_tower/...``) fills the port's model
    exactly, and its prior log-var is the tower's, not the constant."""
    jax_cfg, cfg = (dataclasses.replace(c, prior_category=dataclasses.replace(c.prior_category, const_log_var=None))
                    for c in small_configs())
    rng = np.random.default_rng(3)
    tree = random_tree(lambda k: JaxVAE(jax_cfg).init({"params": k, "dropout": k}, jnp.zeros((1, DIM, DIM, DIM, 1)),
                                                      method=JaxVAE.initialize), rng)
    assert "log_var_tower" in tree["prior_category"]
    model = MultiModalVAE(cfg).eval()
    model.load_state_dict(params_from_flax(tree), strict=True)
    onehot = np.eye(CAT, dtype=np.float32)
    mean_ref, lv_ref = JaxVAE(jax_cfg).apply({"params": tree}, jnp.asarray(onehot), method=JaxVAE.priors_category)
    mean, lv = model.priors_category(torch.from_numpy(onehot))
    np.testing.assert_allclose(mean.detach().numpy(), np.asarray(mean_ref), **TOL)
    np.testing.assert_allclose(lv.detach().numpy(), np.asarray(lv_ref), **TOL)
    assert float(lv.detach().abs().max()) > 1e-3


# ---------------------------------------------------------------- flat Adam

def _adam_tree():
    """A ragged flax tree (a prior net's Dense kernels, biases and norms)
    and its port module on the same values."""
    cfg = priornet.PriorNetConfig(input_dim=5, unit_nums=(16, 12, 8), const_log_var=None)
    flax_net = JaxPriorNet(JaxPriorNetConfig(**dataclasses.asdict(cfg)))
    tree = random_tree(lambda k: flax_net.init(k, jnp.zeros((1, 5))), np.random.default_rng(11))
    net = priornet.PriorNet(cfg)
    net.load_state_dict(params_from_flax(tree), strict=True)
    return tree, net


def test_flat_adam_matches_flat_adam_and_optax():
    """``create_train_state(flat_opt=True)`` over 3 steps of the guarded
    update (``apply_gradients_if_finite``), the second with a non-finite
    leaf (the whole step zeroed, the moments decayed): the parameters equal
    JAX's ``flat_adam`` and ``optax.adam`` under JAX's guarded update, and
    the port's per-leaf Adam, within 1e-6; every parameter a view into the
    one flat buffer."""
    tree, net = _adam_tree()
    flat_state = create_train_state(net, learning_rate=1e-3, flat_opt=True)
    opt = flat_state.optimizer
    assert isinstance(opt, FlatAdam) and opt.flat.numel() == sum(p.numel() for p in net.parameters())
    assert all(p.untyped_storage().data_ptr() == opt.flat.untyped_storage().data_ptr() for p in net.parameters())
    _, leaf_net = _adam_tree()
    leaf_state = create_train_state(leaf_net, learning_rate=1e-3)
    jax_states = [jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=jax.tree.map(jnp.asarray, tree),
                                       opt_state=tx.init(jax.tree.map(jnp.asarray, tree)), apply_fn=None, tx=tx)
                  for tx in (jax_state.flat_adam(1e-3), optax.adam(1e-3))]
    guarded = jax.jit(lambda s, g: jax_step.apply_gradients_if_finite(s, g, {})[0])
    rng = np.random.default_rng(12)
    for step in range(3):
        grads = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 10.0 ** rng.integers(-4, 1)).astype(np.float32),
                             tree)
        if step == 1:
            grads["mean_tower"]["Dense_0"]["kernel"][0, 0] = np.inf
        jax_states = [guarded(s, jax.tree.map(jnp.asarray, grads)) for s in jax_states]
        for state in (flat_state, leaf_state):
            metrics = port_step.apply_gradients_if_finite(state, params_from_flax(grads), {})[1]
            assert float(metrics["grads_finite"]) == float(step != 1)
    assert flat_state.step == 3 and opt.state[opt.flat]["step"] == 3
    for s in jax_states:
        want = params_from_flax(np_tree(s.params))
        for state in (flat_state, leaf_state):
            for name, p in state.model.named_parameters():
                assert float((p.detach() - want[name]).abs().max()) <= ADAM_ATOL, name
    assert all(p.untyped_storage().data_ptr() == opt.flat.untyped_storage().data_ptr() for p in net.parameters())


def test_flat_adam_state_round_trips():
    """The flat optimizer's ``state_dict`` loads into a fresh one (as a
    checkpoint restores it), which then takes the same next step."""
    tree, net = _adam_tree()
    a = create_train_state(net, learning_rate=1e-3, flat_opt=True)
    rng = np.random.default_rng(13)
    grads = [params_from_flax(jax.tree.map(lambda v: rng.normal(size=v.shape).astype(np.float32), tree))
             for _ in range(2)]
    a.apply_gradients(grads[0])
    _, net_b = _adam_tree()
    b = create_train_state(net_b, learning_rate=1e-3, flat_opt=True)
    net_b.load_state_dict(net.state_dict())
    b.optimizer.load_state_dict(copy.deepcopy(a.optimizer.state_dict()))  # a copy, as a checkpoint file holds
    a.apply_gradients(grads[1])
    b.apply_gradients(grads[1])
    assert all(torch.equal(x, y) for x, y in zip(net.parameters(), net_b.parameters()))


# ---------------------------------------------------------------- kernels/subpixel.py (tests/test_kernels.py)

def test_subpixel_equals_flax_conv_transpose():
    """``convtranspose_kernel_to_subpixel`` of a flax ``ConvTranspose`` kernel
    equals JAX's map bit for bit, and ``subpixel_deconv3d`` (``conv_k2`` over
    the input padded at the low end) equals the transposed conv and JAX's
    ``subpixel_deconv3d`` within 1e-5, at tests/test_kernels.py's sizes."""
    rng = np.random.default_rng(0)
    for shape, cout in (((2, 4, 4, 4, 3), 5), ((1, 2, 2, 2, 1), 1), ((1, 6, 6, 6, 4), 2), ((1, 3, 4, 5, 2), 3)):
        x = rng.normal(size=shape).astype(np.float32)
        ct = fnn.ConvTranspose(cout, (4, 4, 4), strides=(2, 2, 2), padding="SAME", use_bias=False)
        kernel = (rng.normal(size=(4, 4, 4, shape[-1], cout)) / math.sqrt(64 * shape[-1])).astype(np.float32)
        params = {"params": {"kernel": jnp.asarray(kernel)}}
        w_jax = np.asarray(jax_subpixel.convtranspose_kernel_to_subpixel(jnp.asarray(kernel)))
        w = subpixel.convtranspose_kernel_to_subpixel(torch.from_numpy(kernel.copy()))
        np.testing.assert_array_equal(w.numpy(), w_jax)
        before = conv_k2.launches
        y = subpixel.subpixel_deconv3d(torch.from_numpy(x), w).numpy()
        assert conv_k2.launches == before  # a CPU tensor: the plain version
        assert y.shape == (shape[0], *(2 * n for n in shape[1:4]), cout)
        np.testing.assert_allclose(y, np.asarray(jax.jit(ct.apply)(params, jnp.asarray(x))), rtol=0, atol=1e-5)
        y_jax = jax.jit(jax_subpixel.subpixel_deconv3d)(jnp.asarray(x), jnp.asarray(w_jax))
        np.testing.assert_allclose(y, np.asarray(y_jax), rtol=0, atol=1e-5)


def test_subpixel_module_matches_flax():
    """``SubpixelDeconv3D``: the transposed conv's parameter count, flax's
    fan-in init (variance 1 / (8 C_in) on the (2, 2, 2, C_in, 8 f) kernel), and
    on flax's tree its forward and every gradient, f32; equal to
    ``ConvTransposeEquiv3D`` on the same transposed-conv weight."""
    port = subpixel.SubpixelDeconv3D(16, 8, generator=torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in port.parameters()) == 4 * 4 * 4 * 16 * 8
    flax_w = np.asarray(jax_subpixel.SubpixelDeconv3D(features=8).init(jax.random.PRNGKey(0),
                                                                         jnp.ones((1, 4, 4, 4, 16)))["params"]["kernel"])
    for w in (port.weight.detach().numpy(), flax_w):
        assert abs(float(w.std()) * math.sqrt(8 * 16) - 1.0) < 0.05
    x = np.random.default_rng(2).normal(size=(2, 4, 4, 4, 3)).astype(np.float32)
    flax_mod = jax_subpixel.SubpixelDeconv3D(features=6)
    kernel = random_tree(lambda k: flax_mod.init(k, jnp.asarray(x)), np.random.default_rng(3))["kernel"]
    y_ref, vjp = jax.vjp(lambda w, v: flax_mod.apply({"params": {"kernel": w}}, v), jnp.asarray(kernel), jnp.asarray(x))
    g = np.random.default_rng(4).normal(size=y_ref.shape).astype(np.float32)
    dw_ref, dx_ref = vjp(jnp.asarray(g))
    port = subpixel.SubpixelDeconv3D(3, 6)
    port.weight.data.copy_(torch.from_numpy(kernel))  # flax's layout, as it lies
    xt = torch.from_numpy(x).requires_grad_(True)
    y = port(xt)
    dx, dw = torch.autograd.grad(y, (xt, port.weight), torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), **TOL)
    for got, want in ((dx, dx_ref), (dw, dw_ref)):
        want = np.asarray(want)
        assert float(np.abs(got.numpy() - want).max()) <= GRAD_REL * float(np.abs(want).max())
    equiv = blocks.ConvTransposeEquiv3D(3, 6, generator=torch.Generator().manual_seed(1))
    flax_kernel = equiv.weight.detach().flip(2, 3, 4).permute(2, 3, 4, 0, 1)  # flax's (4, 4, 4, C_in, C_out)
    port.weight.data.copy_(subpixel.convtranspose_kernel_to_subpixel(flax_kernel))
    with torch.no_grad():
        np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(), equiv(torch.from_numpy(x)).numpy(), **TOL)

