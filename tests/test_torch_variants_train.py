"""PyTorch port, training the model variants against the JAX package on the
CPU: for a tiny form of ``modelnet_vae``, ``modelnet_ae_dr``, ``ae3d``,
``modelnet_nolbo_acc`` (packed-blocked batches through the phase-equivalent
decoder), ``pascal_ae``, ``pascal_vae_dr`` and ``kitti_inst_only``, every
loss term and metric of ``compute_losses`` and every gradient leaf, from the
same weights (a flax tree drawn in numpy, converted with
``convert.params_from_flax``), the same batch and JAX's own random draws
handed to the port (the posterior and prior samples, the mix's coin and mask,
the `_dr` dropout's rate and mask); ``build_batch_fn`` against JAX's for
``modelnet_nolbo_acc``, ``pascal_nolbo_acc`` and ``kitti_inst_only``; and
``cli.train.main`` of a `_dr` name on the CPU.

The voxel models run at 32^3 with narrow filters, the image ones on
Darknet53Tiny at 64x64 with the same 32^3 decoder; the prior nets' dropout is
0 (its flax mask has no counterpart to inject). The JAX side runs under
``jax.jit``. Comparisons are float32; each tolerance is stated where it is
set.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anytime3d_tpu.cli import train as jax_cli_train
from anytime3d_tpu.data.modelnet import SyntheticImageObjectLoader as JaxImageLoader
from anytime3d_tpu.data.modelnet import SyntheticVoxelLoader as JaxVoxelLoader
from anytime3d_tpu.models import configs as jax_configs
from anytime3d_tpu.models.mmvae import MultiModalVAE as JaxVAE
from anytime3d_tpu.train import step as jax_step
from anytime3d_tpu_torch.cli import train as cli_train
from anytime3d_tpu_torch.convert import params_from_flax
from anytime3d_tpu_torch.data.modelnet import SyntheticImageObjectLoader, SyntheticVoxelLoader
from anytime3d_tpu_torch.data.packing import pack_voxels_blocked
from anytime3d_tpu_torch.models import configs
from anytime3d_tpu_torch.models.mmvae import MultiModalVAE
from anytime3d_tpu_torch.train import step as port_step

LOSS_RTOL = 1e-4  # loss terms: sums of 32768 voxel terms a sample (and the l2 over every kernel) in another order
PR_ATOL = 5e-4  # P and R count voxels against 0.5; one within rounding of it moves them
GRAD_REL = 1e-4  # each gradient leaf against JAX's, relative to that leaf's largest entry
B, DIM, CAT, INST, IMG = 4, 32, 5, 3, 64
NAMES = ["modelnet_vae", "modelnet_ae_dr", "ae3d", "modelnet_nolbo_acc", "pascal_ae", "pascal_vae_dr",
         "kitti_inst_only"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)  # the suite runs several workers per machine


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def tiny(mod, name):
    """``name``'s config in package ``mod``, cut: a 32^3 decoder and narrow
    voxel encoder, Darknet53Tiny for image encoders, 5 classes and 3
    instances, prior dropout 0."""
    cfg = mod.REGISTRY[name]()
    change = {"decoder": dataclasses.replace(cfg.decoder, output_shape=(DIM,) * 3 + (1,),
                                             filter_nums=(32, 16, 16, 8, 1))}
    if cfg.encoder == "voxel":
        change["encoder3d"] = dataclasses.replace(cfg.encoder3d, filter_nums=(8, 16, 16, 32))
    else:
        change["backbone"] = "darknet53tiny"
    if cfg.category_dim:
        change["category_dim"] = CAT
    if cfg.inst_dim:
        change["inst_dim"] = INST
    for prior in ("prior_category", "prior_inst"):
        p = getattr(cfg, prior)
        if p is not None:
            width = (CAT if cfg.category_dim else 0) + (INST if prior == "prior_inst" else 0)
            change[prior] = dataclasses.replace(p, input_dim=width, dropout_rate=0.0)
    return dataclasses.replace(cfg, **change)


def random_tree(init, rng, noise=0.05):
    """A flax param tree of the shapes ``init(key)`` makes, drawn in numpy:
    kernels normal with variance 1/fan_in; norm scales and biases moved off 1
    and 0 by ``noise`` times a normal."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))["params"]

    def leaf(path, s):
        if path[-1].key == "kernel":
            return rng.standard_normal(s.shape, np.float32) / np.float32(math.sqrt(math.prod(s.shape[:-1])))
        base = np.ones(s.shape, np.float32) if path[-1].key == "scale" else np.zeros(s.shape, np.float32)
        return base + np.float32(noise) * rng.standard_normal(s.shape, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def make_batch(cfg, seed):
    """A dense numpy batch for JAX: voxels (input = target) or uint8-range
    images and a voxel target; one-hots where the config reads them; samples
    0 and 1 share a class."""
    rng = np.random.default_rng(seed)
    vox = (rng.uniform(size=(B, DIM, DIM, DIM, 1)) > 0.7).astype(np.float32)
    if cfg.encoder == "voxel":
        batch = {"input": vox, "target": vox}
    else:
        batch = {"input": rng.integers(0, 256, (B, IMG, IMG, 3)).astype(np.float32) / 255.0, "target": vox}
    cls = rng.integers(0, CAT, B)
    cls[1] = cls[0]
    if cfg.prior_category is not None or cfg.category_dim:
        batch["category_onehot"] = np.eye(CAT, dtype=np.float32)[cls]
    if cfg.inst_dim:
        batch["inst_onehot"] = np.eye(INST, dtype=np.float32)[rng.integers(0, INST, B)]
    return batch


def jax_draws(key, cfg, loss_cfg):
    """The draws the JAX ``_encode_and_sample`` makes from ``key``, by the
    port's names (``jax/train/step.py``: one key split in 7, the mix's and the
    dropout's each split in 2)."""
    ks = jax.random.split(key, 7)
    zc, zi = cfg.z_category_dim, cfg.z_inst_dim
    d = {}
    if cfg.variational:
        if zc and zi:
            d["eps_cat"], d["eps_inst"] = jax.random.normal(ks[0], (B, zc)), jax.random.normal(ks[1], (B, zi))
        else:
            d["eps_inst"] = jax.random.normal(ks[1], (B, zc + zi))
    if loss_cfg.mix_coin_prob > 0 and (cfg.prior_category is not None or cfg.prior_inst is not None):
        if cfg.prior_category is not None:
            d["eps_prior_cat"] = jax.random.normal(ks[2], (B, cfg.prior_category.unit_nums[-1]))
        if cfg.prior_inst is not None:
            d["eps_prior_inst"] = jax.random.normal(ks[3], (B, cfg.prior_inst.unit_nums[-1]))
        k_coin, k_elem = jax.random.split(ks[4])
        d["coin"] = jax.random.bernoulli(k_coin, loss_cfg.mix_coin_prob, ())
        d["take_prior"] = jax.random.bernoulli(k_elem, loss_cfg.mix_element_prob, (B, zc + zi))
    if cfg.latent_dropout:
        k_rate, k_mask = jax.random.split(ks[5])
        d["drop_rate"] = jax.random.uniform(k_rate, (), minval=0.0, maxval=0.95)
        d["drop_keep"] = jax.random.bernoulli(k_mask, 1.0 - d["drop_rate"], (B, zc + zi))
    return np_tree(d)


def key_for(cfg, loss_cfg):
    """A key whose mix coin comes up (where there is a mix) and whose dropout drops something (`_dr`)."""
    for seed in range(64):
        key = jax.random.PRNGKey(seed)
        d = jax_draws(key, cfg, loss_cfg)
        if ("coin" not in d or bool(d["coin"])) and ("drop_keep" not in d or not d["drop_keep"].all()):
            return key, d
    raise AssertionError("no key found")


_SETUPS = {}


def setup(name):
    """(jax model, tree, port model, jax cfg, port cfg), built once a name."""
    if name not in _SETUPS:
        jax_cfg, cfg = tiny(jax_configs, name), tiny(configs, name)
        assert dataclasses.asdict(jax_cfg) == dataclasses.asdict(cfg)
        jax_model = JaxVAE(jax_cfg)
        x = jnp.zeros((1, IMG, IMG, 3)) if cfg.encoder == "image" else jnp.zeros((1, DIM, DIM, DIM, 1))
        tree = random_tree(lambda k: jax_model.init({"params": k, "dropout": k}, x, method=JaxVAE.initialize),
                           np.random.default_rng(len(name)))
        model = MultiModalVAE(cfg)
        model.load_state_dict(params_from_flax(tree))
        _SETUPS[name] = (jax_model, tree, model, jax_cfg, cfg)
    return _SETUPS[name]


def port_batch(name, batch):
    """The batch the port is handed: ``modelnet_nolbo_acc``'s packed in the
    blocked bit order (its encoder head and phase-equivalent decoder both
    take the coarse layout), the other voxel ones dense and shared (input
    only), the image ones with their dense target."""
    if name == "modelnet_nolbo_acc":
        return {"input_packed_blocked": pack_voxels_blocked(batch["input"], 4),
                **{k: v for k, v in batch.items() if k not in ("input", "target")}}
    if configs.REGISTRY[name]().encoder == "voxel":
        return {k: v for k, v in batch.items() if k != "target"}
    return batch


@pytest.mark.parametrize("name", NAMES)
def test_variant_losses_and_gradients_match_jax(name):
    """``compute_losses`` (train mode, JAX's draws) of each variant: every
    metric, and the gradient of the total w.r.t. every leaf; the latent
    draws each variant makes (none for an AE, the dropout's for `_dr`, the
    whole-vector prior swap for ``kitti_inst_only``); the blocked layout
    where the model has it."""
    jax_model, tree, model, jax_cfg, cfg = setup(name)
    loss_cfg, jax_loss_cfg = configs.loss_config(name), jax_configs.loss_config(name)
    key, draws = key_for(cfg, loss_cfg)
    batch = make_batch(cfg, 1)

    def jax_loss(p, b):
        return jax_step.compute_losses(jax_model, jax_loss_cfg, p, b, key)

    (_, ref), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(tree, jax.tree.map(jnp.asarray, batch))
    ref, want = np_tree(ref), params_from_flax(np_tree(jgrads))
    total, metrics = port_step.compute_losses(model, loss_cfg, t(port_batch(name, batch)), draws=t(draws))
    assert set(metrics) == set(ref)
    assert ("loss_kl" in metrics) == cfg.variational and ("loss_reg" in metrics) == (
        cfg.prior_category is not None or cfg.prior_inst is not None)
    for k in ref:
        if "precision" in k or "recall" in k:
            assert abs(float(metrics[k]) - float(ref[k])) <= PR_ATOL, k
        else:
            np.testing.assert_allclose(float(metrics[k]), float(ref[k]), rtol=LOSS_RTOL, err_msg=k)
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(total, params)))
    assert grads.keys() == want.keys()
    for n, g in grads.items():
        w = want[n].numpy()
        assert float(np.abs(g.numpy() - w).max()) <= GRAD_REL * float(np.abs(w).max()), n


def test_latent_dropout_takes_its_draws():
    """The `_dr` dropout on z: kept entries scaled by 1/(1 - rate), dropped
    ones 0, so the decoder input and the loss move with the mask; without
    injected draws it draws from the generator, reproducibly."""
    *_, model, _, cfg = setup("modelnet_ae_dr")
    loss_cfg = configs.loss_config("modelnet_ae_dr")
    batch = t(port_batch("modelnet_ae_dr", make_batch(cfg, 2)))
    keep = torch.ones(B, cfg.z_dim, dtype=torch.bool)
    with torch.no_grad():
        z = model.encode(batch["input"]).mean
        out = port_step._encode_and_sample(model, loss_cfg, batch, None, False, False, False,
                                           {"drop_rate": torch.tensor(0.5), "drop_keep": keep})
        np.testing.assert_allclose(out["z"].numpy(), (z / 0.5).numpy(), rtol=1e-6)
        keep[:, ::2] = False
        out = port_step._encode_and_sample(model, loss_cfg, batch, None, False, False, False,
                                           {"drop_rate": torch.tensor(0.5), "drop_keep": keep})
        assert not out["z"][:, ::2].any()
        a, b = (port_step.compute_losses(model, loss_cfg, batch, torch.Generator().manual_seed(3))[1]["loss_total"]
                for _ in range(2))
        assert float(a) == float(b)
        det = port_step.compute_losses(model, loss_cfg, batch, deterministic=True)[1]  # no dropout in eval
        np.testing.assert_allclose(float(det["loss_total"]), float(port_step.compute_losses(
            model, loss_cfg, batch, deterministic=True)[1]["loss_total"]), rtol=0)


@pytest.mark.parametrize("name,packed", [("modelnet_nolbo_acc", True), ("modelnet_nolbo_acc", False),
                                         ("pascal_nolbo_acc", True), ("kitti_inst_only", False),
                                         ("kitti_inst_only", True)])
def test_batch_fn_matches_jax(name, packed):
    """``build_batch_fn`` against JAX's on the same loaders: the same keys
    (``modelnet_nolbo_acc`` packed ships ``input_packed_blocked``, as its
    blocked head and phase-equivalent decoder read the coarse layout; image
    targets ``target_packed_blocked``; ``kitti_inst_only`` its instance
    one-hot and no category one) and the same arrays."""
    jax_cfg, cfg = tiny(jax_configs, name), tiny(configs, name)
    if cfg.encoder == "voxel":
        kw = dict(num_samples=6, dim=DIM, num_classes=CAT, seed=2)
        ours = cli_train.build_batch_fn(SyntheticVoxelLoader(**kw), cfg, 3, packed=packed)
        theirs = jax_cli_train.build_batch_fn(JaxVoxelLoader(**kw), jax_cfg, 3, packed=packed)
    else:
        kw = dict(num_samples=6, dim=DIM, num_classes=CAT, num_inst=INST, seed=2)
        ours = cli_train.build_batch_fn(SyntheticImageObjectLoader(**kw), cfg, 3, packed=packed, image_size=(32, 24))
        theirs = jax_cli_train.build_batch_fn(JaxImageLoader(**kw), jax_cfg, 3, image_size=(32, 24), packed=packed)
    for it in range(3):
        a, b = ours(it), theirs(it)
        # a dense voxel batch: the JAX one repeats the grid as "target", the port's input is both
        assert set(b) == set(a) | ({"target"} if cfg.encoder == "voxel" and not packed else set())
        for k in a:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)
    want = {"modelnet_nolbo_acc": {"input_packed_blocked", "category_onehot"} if packed
            else {"input", "category_onehot"},
            "pascal_nolbo_acc": {"input", "target_packed_blocked", "category_onehot", "inst_onehot"},
            "kitti_inst_only": {"input", "target_packed_blocked" if packed else "target", "inst_onehot"}}[name]
    assert set(a) == want


def test_cli_train_runs_a_dr_variant_on_the_cpu(monkeypatch):
    """``cli.train.main`` of ``modelnet_vae_dr`` (tiny) end to end: packed
    batches, bf16, finite losses with a KL and no prior terms, one eval."""
    cfg = tiny(configs, "modelnet_vae_dr")
    monkeypatch.setitem(configs.REGISTRY, "modelnet_vae_dr", lambda: cfg)
    trainer = cli_train.main(["--config", "modelnet_vae_dr", "--device", "cpu", "--steps", "4", "--batch-size", "2",
                              "--packed", "--bf16", "--eval-every", "2"])
    assert trainer.state.step == 4 and len(trainer.eval_history) == 2
    for row in trainer.history:
        assert {"loss_kl", "loss_shape", "loss_total"} <= set(row) and "loss_reg" not in row
        assert all(math.isfinite(v) for v in row.values()) and row["grads_finite"] == 1.0
    assert not any(k.startswith("anytime_") for row in trainer.eval_history for k in row)
