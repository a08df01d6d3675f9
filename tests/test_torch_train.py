"""PyTorch port, training: the losses, the gradients, the optimizer and the
whole train step against the JAX package, on the CPU, from the same weights
(converted with ``convert.params_from_flax``), the same batch (numpy, seeded)
and the same random draws.

JAX's PRNG streams cannot be reproduced in torch, so the draws are made here
exactly as ``anytime3d_tpu.train.step._encode_and_sample`` makes them from its
key and handed to the port as arrays. The prior net's dropout is set to rate
0 on both sides: its flax mask has no counterpart to inject.

The model is ``modelnet_nolbo``'s layout at 32^3 with narrow filters (at 16^3
the blocked decoder starts from a 1^3 grid and GroupNorm makes it constant).
Comparisons are float32 on both sides unless a test says otherwise.
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from anytime3d_tpu.data.packing import pack_voxels as jax_pack_voxels
from anytime3d_tpu.models import configs as jax_configs
from anytime3d_tpu.models.mmvae import MultiModalVAE as JaxVAE
from anytime3d_tpu.train import step as jax_step
from anytime3d_tpu_torch.cli import train as cli_train
from anytime3d_tpu_torch.convert import params_from_flax
from anytime3d_tpu_torch.data.packing import pack_voxels, pack_voxels_blocked
from anytime3d_tpu_torch.models import configs
from anytime3d_tpu_torch.models.mmvae import MultiModalVAE
from anytime3d_tpu_torch.train import step as port_step
from anytime3d_tpu_torch.train.state import create_train_state, grads_finite_flag, l2_penalty

B, Z, CAT, DIM = 4, 8, 5, 32
LOSS_KEYS = ("loss_shape", "loss_kl", "loss_reg", "precision", "recall", "loss_total")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)  # the suite runs several workers per machine


def small_configs(dropout_rate=0.0):
    out = []
    for mod in (jax_configs, configs):
        base = mod.modelnet_nolbo(z_dim=Z, category_dim=CAT)
        out.append(dataclasses.replace(
            base,
            encoder3d=dataclasses.replace(base.encoder3d, filter_nums=(8, 16, 16, 32)),
            decoder=dataclasses.replace(base.decoder, output_shape=(DIM,) * 3 + (1,), filter_nums=(32, 16, 16, 8, 1)),
            prior_category=dataclasses.replace(base.prior_category, unit_nums=(16, Z), dropout_rate=dropout_rate),
        ))
    return out


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    """The flax model and its params, the port on the same weights, one batch."""
    jax_cfg, cfg = small_configs()
    jax_model = JaxVAE(jax_cfg)
    tree = _np_tree(jax_model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                                   jnp.zeros((1, DIM, DIM, DIM, 1)), method=JaxVAE.initialize)["params"])
    rng = np.random.default_rng(0)
    # move the norms off ones/zeros so their gradients are not special
    tree = jax.tree.map(lambda a: (a + rng.normal(scale=0.05, size=a.shape)).astype(np.float32), tree)
    model = MultiModalVAE(cfg)
    model.load_state_dict(params_from_flax(tree))
    vox = (rng.uniform(size=(B, DIM, DIM, DIM, 1)) > 0.7).astype(np.float32)
    onehot = np.eye(CAT, dtype=np.float32)[rng.integers(0, CAT, B)]
    return jax_model, tree, model, cfg, vox, onehot


def jax_draws(key, cfg):
    """The draws ``_encode_and_sample`` makes from ``key``, as numpy arrays."""
    ks = jax.random.split(key, 7)
    k_coin, k_elem = jax.random.split(ks[4])
    return {
        "eps_inst": np.asarray(jax.random.normal(ks[1], (B, Z), jnp.float32)),
        "eps_prior_cat": np.asarray(jax.random.normal(ks[2], (B, Z), jnp.float32)),
        "coin": np.asarray(jax.random.bernoulli(k_coin, cfg.mix_coin_prob, ())),
        "take_prior": np.asarray(jax.random.bernoulli(k_elem, cfg.mix_element_prob, (B, Z))),
    }


def key_with_coin(cfg, want: bool):
    for seed in range(64):
        key = jax.random.PRNGKey(seed)
        if bool(jax_draws(key, cfg)["coin"]) == want:
            return key
    raise AssertionError("no key found")


def to_torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def assert_metrics_close(port_metrics, jax_metrics, rtol=1e-4):
    assert set(port_metrics) >= set(LOSS_KEYS)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(port_metrics[k]), float(jax_metrics[k]), rtol=rtol, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("mode", ["deterministic", "mix_on", "mix_off"])
def test_compute_losses_match_jax(setup, mode):
    """Every loss term and P/R, f32, rtol 1e-4 (summation order over 32768 voxels)."""
    jax_model, tree, model, _, vox, onehot = setup
    loss_cfg = configs.loss_config("modelnet_nolbo")
    jax_loss_cfg = jax_configs.loss_config("modelnet_nolbo")
    deterministic = mode == "deterministic"
    key = jax.random.PRNGKey(3) if deterministic else key_with_coin(loss_cfg, mode == "mix_on")
    batch = {"input": vox, "target": vox, "category_onehot": onehot}
    _, ref = jax_step.compute_losses(jax_model, jax_loss_cfg, tree, jax.tree.map(jnp.asarray, batch), key,
                                     deterministic=deterministic)
    draws = jax_draws(key, loss_cfg)
    if not deterministic:
        assert bool(draws["coin"]) == (mode == "mix_on") and draws["take_prior"].any()
    total, metrics = port_step.compute_losses(
        model, loss_cfg, to_torch({"input": vox, "category_onehot": onehot}),
        deterministic=deterministic, draws=to_torch(draws))
    assert total.requires_grad and not any(v.requires_grad for v in metrics.values())
    assert_metrics_close(metrics, ref)


def test_mixing_changes_the_loss(setup):
    """The forced-on and forced-off cases above are not the same computation."""
    _, _, model, _, vox, onehot = setup
    loss_cfg = configs.loss_config("modelnet_nolbo")
    draws = jax_draws(key_with_coin(loss_cfg, True), loss_cfg)
    batch = to_torch({"input": vox, "category_onehot": onehot})
    on = port_step.compute_losses(model, loss_cfg, batch, draws=to_torch(draws))[1]
    off = port_step.compute_losses(model, loss_cfg, batch, draws=to_torch({**draws, "coin": np.asarray(False)}))[1]
    assert abs(float(on["loss_shape"]) - float(off["loss_shape"])) > 1e-3
    assert float(on["loss_kl"]) == float(off["loss_kl"])


def _jax_grads(jax_model, tree, batch, key):
    loss_cfg = jax_configs.loss_config("modelnet_nolbo")

    def loss_fn(params):
        return jax_step.compute_losses(jax_model, loss_cfg, params, batch, key, deterministic=False)[0]

    return _np_tree(jax.grad(loss_fn)(tree))


def test_gradients_match_jax(setup):
    """Every leaf's gradient against ``jax.grad``, carried into the port's
    layout by ``params_from_flax``: to 1e-4 of the leaf's largest entry."""
    jax_model, tree, model, _, vox, onehot = setup
    loss_cfg = configs.loss_config("modelnet_nolbo")
    key = key_with_coin(loss_cfg, True)
    batch = {"input": jnp.asarray(vox), "target": jnp.asarray(vox), "category_onehot": jnp.asarray(onehot)}
    ref = params_from_flax(_jax_grads(jax_model, tree, batch, key))
    total, _ = port_step.compute_losses(model, loss_cfg, to_torch({"input": vox, "category_onehot": onehot}),
                                        draws=to_torch(jax_draws(key, loss_cfg)))
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(total, params)))
    assert grads.keys() == ref.keys()
    for name, g in grads.items():
        scale = float(ref[name].abs().max())
        assert scale > 0, name
        err = float((g - ref[name]).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)


def test_params_from_flax_only_permutes(setup):
    """Every transform of ``params_from_flax`` is a permutation or a flip, so
    it carries gradients as it carries weights: same leaves, same multiset of
    values in each."""
    _, tree, model, _, _, _ = setup
    flat = {"/".join(k.key for k in path): leaf for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}
    out = params_from_flax(tree)
    assert len(out) == len(flat) and out.keys() == model.state_dict().keys()
    by_size = sorted((np.sort(v.ravel()).tobytes() for v in flat.values()))
    assert by_size == sorted(np.sort(v.numpy().ravel()).tobytes() for v in out.values())


def test_adam_matches_optax(setup):
    """Adam alone: the same gradients through ``optax.adam(1e-4)`` and the
    port's optimizer for 3 steps, parameters to atol 1e-7. (Not compared after
    a step on computed gradients: the first Adam step is lr*g/(|g|+1e-8), so
    noise in a near-zero gradient moves a parameter by up to 1e-4.)"""
    _, tree, _, cfg, _, _ = setup
    model = MultiModalVAE(cfg)
    model.load_state_dict(params_from_flax(tree))
    state = create_train_state(model, learning_rate=1e-4)
    tx = optax.adam(1e-4)
    params, opt_state = jax.tree.map(jnp.asarray, tree), None
    opt_state = tx.init(params)
    rng = np.random.default_rng(5)
    for step in range(3):
        grads = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 10.0 ** rng.integers(-6, 1)).astype(np.float32), tree)
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads), opt_state, params)
        params = optax.apply_updates(params, updates)
        state.apply_gradients(params_from_flax(grads))
        assert state.step == step + 1
    ref = params_from_flax(_np_tree(params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=0, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_non_finite_leaf_zeroes_the_update(setup, bad):
    _, tree, _, cfg, _, _ = setup
    model = MultiModalVAE(cfg)
    model.load_state_dict(params_from_flax(tree))
    state = create_train_state(model)
    good = {n: torch.full_like(p, 0.5) for n, p in model.named_parameters()}
    state, metrics = port_step.apply_gradients_if_finite(state, {n: g.clone() for n, g in good.items()}, {})
    assert float(metrics["grads_finite"]) == 1.0 and state.step == 1
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    moments = {n: state.optimizer.state[p]["exp_avg"].clone() for n, p in model.named_parameters()}
    poisoned = {n: g.clone() for n, g in good.items()}
    poisoned["decoder.conv_1.weight"][0, 0, 0, 0, 0] = bad
    assert float(grads_finite_flag(poisoned)) == 0.0
    state, metrics = port_step.apply_gradients_if_finite(state, poisoned, {})
    assert float(metrics["grads_finite"]) == 0.0
    assert state.step == 2  # a zeroed step still advances the count
    for n, p in model.named_parameters():
        assert torch.isfinite(p).all(), n
        # the whole gradient was zeroed: the first moment only decays
        assert torch.allclose(state.optimizer.state[p]["exp_avg"], 0.9 * moments[n]), n
        # and the parameters move by the decayed momentum alone, less than a full step
        assert float((p.detach() - before[n]).abs().max()) <= 1e-4 + 1e-9, n


def test_batch_forms_give_the_same_loss(setup):
    """Packed-blocked, packed and dense batches are the same step (the layout
    permutes the terms of sums), and the packed bits are the JAX package's."""
    _, _, model, _, vox, onehot = setup
    loss_cfg = configs.loss_config("modelnet_nolbo")
    draws = to_torch(jax_draws(key_with_coin(loss_cfg, True), loss_cfg))
    cat = torch.from_numpy(onehot)
    forms = {
        "dense": {"input": torch.from_numpy(vox)},
        "packed": {"input_packed": torch.from_numpy(pack_voxels(vox))},
        "packed_blocked": {"input_packed_blocked": torch.from_numpy(pack_voxels_blocked(vox, 4))},
    }
    np.testing.assert_array_equal(pack_voxels(vox), jax_pack_voxels(vox))
    got = {}
    for name, batch in forms.items():
        mat, blocked_in, blocked_out = port_step.materialize_batch(model, batch)
        assert blocked_in and blocked_out and mat["input"].shape == (B, 8, 8, 8, 64)
        assert mat["target"] is mat["input"]
        with torch.no_grad():
            got[name] = port_step.compute_losses(model, loss_cfg, {**batch, "category_onehot": cat}, draws=draws)[1]
    for name in ("packed", "packed_blocked"):
        for k in LOSS_KEYS:
            assert float(got[name][k]) == float(got["dense"][k]), (name, k)


@pytest.mark.parametrize("n", [4, 5, 7])
def test_unported_batch_forms_raise(setup, n):
    """Image batches (explicit voxel targets, uint8 images, packed targets)
    are ported and held to the JAX package in ``test_torch_image.py``; of the
    loader tuples, the Pascal loader's 6 and the KITTI loader's 5 (no class:
    no ``category_onehot``) are read, and any other length raises."""
    class Loader:
        def getNextBatch(self, batch_size):
            return tuple(np.zeros((batch_size, 1), np.float32) for _ in range(n))

    if n == 5:
        assert set(cli_train.build_batch_fn(Loader(), setup[3], 2)(0)) == {"input", "target"}
        return
    with pytest.raises(ValueError, match="loader tuples of"):
        cli_train.build_batch_fn(Loader(), setup[3], 2)(0)


def test_bf16_compute_keeps_f32_params(setup):
    """bf16 compute dtype with f32 parameters: losses within 5% of f32 (8 bits
    of mantissa through ~20 layers), gradients f32 and finite, and the step
    updates the f32 parameters."""
    _, tree, model, cfg, vox, onehot = setup
    loss_cfg = configs.loss_config("modelnet_nolbo")
    draws = to_torch(jax_draws(key_with_coin(loss_cfg, True), loss_cfg))
    batch = to_torch({"input_packed_blocked": pack_voxels_blocked(vox, 4), "category_onehot": onehot})
    low = MultiModalVAE(cfg, dtype=torch.bfloat16)
    low.load_state_dict(params_from_flax(tree))
    assert all(p.dtype == torch.float32 for p in low.parameters())
    assert low.encode(torch.from_numpy(vox)).mean.dtype == torch.bfloat16
    with torch.no_grad():
        ref = port_step.compute_losses(model, loss_cfg, batch, draws=draws)[1]
    state = create_train_state(low)
    before = {n: p.detach().clone() for n, p in low.named_parameters()}
    total, metrics = port_step.compute_losses(low, loss_cfg, batch, draws=draws)
    assert total.dtype == torch.float32
    for k in ("loss_shape", "loss_kl", "loss_reg", "loss_total"):
        np.testing.assert_allclose(float(metrics[k]), float(ref[k]), rtol=0.05, err_msg=k)
    grads = torch.autograd.grad(total, list(low.parameters()))
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads)
    state, metrics = port_step.make_train_step(low, loss_cfg)(state, batch, draws=draws)
    assert float(metrics["grads_finite"]) == 1.0 and state.step == 1
    assert all(p.dtype == torch.float32 for p in low.parameters())
    assert any(not torch.equal(p, before[n]) for n, p in low.named_parameters())


def test_train_state_refuses_low_precision_params(setup):
    model = MultiModalVAE(setup[3]).to(torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        create_train_state(model)


def test_train_step_with_a_generator_is_seeded(setup):
    """Without injected draws the step draws from its generator: the same seed
    gives the same metrics, another seed others; eval is deterministic in
    its draws too and applies neither dropout nor the prior mix."""
    _, tree, _, _, vox, onehot = setup
    _, cfg = small_configs(dropout_rate=0.2)
    loss_cfg = configs.loss_config("modelnet_nolbo")
    batch = to_torch({"input_packed_blocked": pack_voxels_blocked(vox, 4), "category_onehot": onehot})
    runs = []
    for seed in (7, 7, 8):
        model = MultiModalVAE(cfg)
        model.load_state_dict(params_from_flax(tree))
        step = port_step.make_train_step(model, loss_cfg)
        _, metrics = step(create_train_state(model), batch, torch.Generator().manual_seed(seed))
        runs.append({k: float(v) for k, v in metrics.items()})
    assert runs[0] == runs[1] and runs[0]["loss_total"] != runs[2]["loss_total"]
    assert runs[0]["loss_reg"] != runs[2]["loss_reg"]  # the prior net's dropout draws from the generator
    evaluate = port_step.make_eval_step(model, loss_cfg)
    a = evaluate(batch, torch.Generator().manual_seed(1))
    b = evaluate(batch, torch.Generator().manual_seed(1))
    assert not model.training and all(float(a[k]) == float(b[k]) for k in a) and "grads_finite" not in a


def test_loss_config_mirrors_jax():
    ours, theirs = configs.variant("modelnet_nolbo"), jax_configs.variant("modelnet_nolbo")
    assert dataclasses.asdict(ours[0]) == dataclasses.asdict(theirs[0])
    assert dataclasses.asdict(ours[1]) == dataclasses.asdict(theirs[1])
    assert dataclasses.asdict(port_step.LossConfig()) == dataclasses.asdict(jax_step.LossConfig())
    assert dataclasses.asdict(configs.variant("modelnet_nolbo", category_dim=7)[0]) == dataclasses.asdict(
        jax_configs.variant("modelnet_nolbo", category_dim=7)[0])


def test_l2_penalty_matches_jax(setup):
    from anytime3d_tpu.train.state import l2_penalty as jax_l2

    _, tree, model, _, _, _ = setup
    ref = float(jax_l2(jax.tree.map(jnp.asarray, tree), 5e-4))
    np.testing.assert_allclose(float(l2_penalty(dict(model.named_parameters()), 5e-4).detach()), ref, rtol=1e-5)


def test_cli_train_runs_on_the_cpu(monkeypatch, tmp_path, capsys):
    """``cli.train.main`` end to end at the tiny config: finite metrics on
    every logged step, two evals, a JSONL line per step; the loaders are the
    CLI's own (1024 + 256 procedural shapes at the config's 32^3)."""
    _, tiny = small_configs(dropout_rate=0.2)
    monkeypatch.setitem(configs.REGISTRY, "modelnet_nolbo", lambda: tiny)
    jsonl = tmp_path / "train.jsonl"
    trainer = cli_train.main(["--config", "modelnet_nolbo", "--device", "cpu", "--steps", "4", "--batch-size", "4",
                              "--packed", "--bf16", "--eval-every", "2", "--jsonl", str(jsonl)])
    assert trainer.state.step == 4 and len(trainer.history) == 4 and len(trainer.eval_history) == 2
    for row in trainer.history:
        assert set(row) == set(LOSS_KEYS) | {"grads_finite"}
        assert all(math.isfinite(v) for v in row.values()) and row["grads_finite"] == 1.0
    assert all(math.isfinite(v) for row in trainer.eval_history for v in row.values())
    lines = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert [r["step"] for r in lines] == [0, 1, 2, 3]
    assert "done; final metrics" in capsys.readouterr().out


def test_cli_train_fails_without_cuda_or_data():
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA is not available"):
            cli_train.main(["--config", "modelnet_nolbo", "--steps", "1"])
    args = cli_train.parse_args(["--config", "modelnet_nolbo", "--data", "/some/path"])
    with pytest.raises(FileNotFoundError, match="/some/path"):
        cli_train.build_loaders(args, configs.modelnet_nolbo())
    with pytest.raises(FileNotFoundError, match="/some/path"):  # an image config reads a Pascal3D tree there
        cli_train.build_loaders(args, dataclasses.replace(configs.modelnet_nolbo(), encoder="image"))
    assert cli_train.parse_args(["--config", "modelnet_nolbo", "--mesh"]).mesh  # runs in test_torch_parallel.py
