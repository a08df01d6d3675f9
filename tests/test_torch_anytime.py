"""PyTorch port, the anytime engine and the evaluation protocols against the
JAX package on the CPU: ``correct_latent``, ``anytime_eval`` (dense and
packed-blocked batches), the Gaussian and occupancy fusion, ``voxel_iou``,
``pr_curve``, ``category_vectors``, ``evaluate_epoch``,
``missing_rate_sweep``, ``dump_reconstructions`` and the trainer's
``anytime_*`` eval metrics; then the prefetcher, the trainer at prefetch
depth 2 against depth 0, the native blocked packer against the NumPy path,
and ``cli.evaluate.main``.

The model is ``modelnet_nolbo``'s layout at 32^3 with narrow filters, on
weights converted from the flax tree by ``convert.params_from_flax``, as in
``test_torch_train.py``; the prior net keeps its dropout (rate 0.2), which
both packages must leave off in evaluation. JAX's PRNG streams cannot be
reproduced in torch, so the draws are made here from the JAX key exactly as
the JAX function makes them and handed to the port; where a port protocol
seeds a ``torch.Generator``, the test reads the seed back
(``initial_seed``) and hands over the JAX draws of ``PRNGKey(seed)``, which
also pins the seed formulas. All comparisons are float32.

Tolerances: loss terms rtol 1e-4 (sums over 32768 voxels a sample, taken in
another order); precision and recall 5e-4 absolute (thresholded counts: one
voxel within rounding of 0.5 moves them by ~1e-4); decoded grids 1e-5
absolute (probabilities, ~20 layers of float32); accuracies exactly (argmin
over well-separated distances); the fusion functions 1e-6 relative to each
array's largest entry (elementwise exp, log and sums that cancel).
"""

import dataclasses
import json
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anytime3d_tpu.anytime import engine as jax_engine
from anytime3d_tpu.data import packing as jax_packing
from anytime3d_tpu.evaluation import dump as jax_dump
from anytime3d_tpu.evaluation import protocols as jax_protocols
from anytime3d_tpu.models import configs as jax_configs
from anytime3d_tpu.models.mmvae import MultiModalVAE as JaxVAE
from anytime3d_tpu.ops import metrics as jax_metrics
from anytime3d_tpu_torch.anytime import engine
from anytime3d_tpu_torch.cli import evaluate as cli_evaluate
from anytime3d_tpu_torch.convert import params_from_flax
from anytime3d_tpu_torch.data import packing
from anytime3d_tpu_torch.data.modelnet import SyntheticVoxelLoader
from anytime3d_tpu_torch.data.prefetch import DevicePrefetcher
from anytime3d_tpu_torch.evaluation import dump, protocols
from anytime3d_tpu_torch.models import configs
from anytime3d_tpu_torch.models.mmvae import MultiModalVAE
from anytime3d_tpu_torch.ops.metrics import voxel_iou
from anytime3d_tpu_torch.train import trainer as trainer_mod
from anytime3d_tpu_torch.train.state import create_train_state

B, Z, CAT, DIM = 4, 8, 5, 32
LOSS_RTOL, PR_ATOL, PRED_ATOL, FUSE_RTOL = 1e-4, 5e-4, 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)  # the suite runs several workers per machine


def small_configs():
    out = []
    for mod in (jax_configs, configs):
        base = mod.modelnet_nolbo(z_dim=Z, category_dim=CAT)
        out.append(dataclasses.replace(
            base,
            encoder3d=dataclasses.replace(base.encoder3d, filter_nums=(8, 16, 16, 32)),
            decoder=dataclasses.replace(base.decoder, output_shape=(DIM,) * 3 + (1,), filter_nums=(32, 16, 16, 8, 1)),
            prior_category=dataclasses.replace(base.prior_category, unit_nums=(16, Z), dropout_rate=0.2),
        ))
    return out


def make_batch(seed: int, n: int = B):
    """Dense numpy batch for JAX (input = target) and its packed-blocked form for the port."""
    rng = np.random.default_rng(seed)
    vox = (rng.uniform(size=(n, DIM, DIM, DIM, 1)) > 0.7).astype(np.float32)
    onehot = np.eye(CAT, dtype=np.float32)[rng.integers(0, CAT, n)]
    inst = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]  # ignored by both packages
    dense = {"input": vox, "target": vox, "category_onehot": onehot, "inst_onehot": inst}
    packed = {"input_packed_blocked": packing.pack_voxels_blocked(vox, 4), "category_onehot": onehot,
              "inst_onehot": inst}
    return dense, packed


@pytest.fixture(scope="module")
def setup():
    """The flax model and its params, the port on the same weights, one batch."""
    jax_cfg, cfg = small_configs()
    jax_model = JaxVAE(jax_cfg)
    init = jax.jit(lambda k1, k2: jax_model.init({"params": k1, "dropout": k2}, jnp.zeros((1, DIM, DIM, DIM, 1)),
                                                 method=JaxVAE.initialize))
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), jax.random.PRNGKey(1))["params"])
    rng = np.random.default_rng(0)
    # move the norms off ones/zeros so that nothing is special
    tree = jax.tree.map(lambda a: (a + rng.normal(scale=0.05, size=a.shape)).astype(np.float32), tree)
    model = MultiModalVAE(cfg)
    model.load_state_dict(params_from_flax(tree))
    model.train()  # anytime_eval must switch the prior net's dropout off itself
    return jax_model, tree, model, cfg


def t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def anytime_draws(key, missing_prob: float, n: int = B):
    """The draws ``anytime_eval`` makes from ``key`` (its traced rate in float32), as numpy."""
    k_cat, _, k_mask, k_corr = jax.random.split(key, 4)
    d = {"eps_cat": jax.random.normal(k_cat, (n, Z), jnp.float32)}
    if missing_prob > 0:
        d["keep"] = jax.random.bernoulli(k_mask, 1.0 - jnp.float32(missing_prob), (n, Z))
        d["eps_corr"] = jax.random.normal(k_corr, (n, Z), jnp.float32)
    return {k: np.asarray(v) for k, v in d.items()}


def with_jax_draws(monkeypatch, module):
    """Make ``module.anytime_eval`` take the JAX draws of ``PRNGKey(seed)``,
    ``seed`` the one its generator was given."""
    real = module.anytime_eval

    def wrapped(model, batch, generator, missing_prob=0.0, **kw):
        n = next(iter(batch.values())).shape[0]
        draws = anytime_draws(jax.random.PRNGKey(generator.initial_seed()), missing_prob, n)
        return real(model, batch, generator, missing_prob=missing_prob, draws=t(draws), **kw)

    monkeypatch.setattr(module, "anytime_eval", wrapped)


def assert_metrics_close(port, ref, keys=None):
    keys = keys or [k for k in ref if not k.startswith("pred")]
    assert set(keys) <= set(port), (sorted(port), sorted(keys))
    for k in keys:
        got, want = float(port[k]), float(ref[k])
        if "acc" in k:
            assert got == want, k
        elif "precision" in k or "recall" in k:
            assert abs(got - want) <= PR_ATOL, (k, got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, err_msg=k)


# ---------------------------------------------------------------- correction


@pytest.mark.parametrize("mode,log_vars", [("resample", False), ("mean", False), ("resample_gated", False),
                                           ("mean_gated", False), ("resample", True)])
def test_correct_latent_matches_jax(mode, log_vars):
    """Exactly JAX's, on the same normal draw: half the samples sit next to a
    prior (confident), half halfway between two (gated out). With prior
    log-vars the draw is scaled by exp(0.5 * lv), which XLA and torch may
    round 1 ulp apart: 1e-6 relative there."""
    rng = np.random.default_rng(1)
    means = rng.normal(scale=3.0, size=(CAT, Z)).astype(np.float32)
    n = 12
    near = means[rng.integers(0, CAT, n // 2)] + rng.normal(scale=0.1, size=(n // 2, Z))
    first = rng.integers(0, CAT, n // 2)
    mid = 0.5 * (means[first] + means[(first + 1) % CAT])
    z = np.concatenate([near, mid]).astype(np.float32)
    mask = (rng.uniform(size=(n, Z)) < 0.6).astype(np.float32)
    lv = rng.normal(scale=0.5, size=(CAT, Z)).astype(np.float32) if log_vars else None
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jax_engine.correct_latent(key, jnp.asarray(z), jnp.asarray(mask), jnp.asarray(means),
                                               None if lv is None else jnp.asarray(lv), mode=mode))
    eps = torch.from_numpy(np.array(jax.random.normal(key, (n, Z), jnp.float32)))
    got = engine.correct_latent(torch.from_numpy(z), torch.from_numpy(mask), torch.from_numpy(means),
                                None if lv is None else torch.from_numpy(lv), mode=mode, eps=eps)
    if log_vars:
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy()[mask > 0], z[mask > 0])  # observed dims untouched
    changed = (got.numpy() != z).any(axis=1)
    if mode.endswith("_gated"):
        assert changed[: n // 2].any() and not changed[n // 2:].any()
    else:
        assert changed.all()


def test_correct_latent_rejects_unknown_modes():
    with pytest.raises(ValueError, match="unknown correction mode"):
        engine.correct_latent(torch.zeros(2, Z), torch.ones(2, Z), torch.zeros(CAT, Z), mode="median")


# ---------------------------------------------------------------- the protocol


@pytest.fixture(scope="module")
def jax_evals(setup):
    """JAX ``anytime_eval`` (jitted, with the grids) at missing 0.0 and 0.5 on batch 0, key 3."""
    jax_model, tree, _, _ = setup
    dense, _ = make_batch(0)
    return {p: jax.tree.map(np.asarray, jax_engine.anytime_eval_jit(
        jax_model, tree, jax.tree.map(jnp.asarray, dense), jax.random.PRNGKey(3), p, return_pred=True))
        for p in (0.0, 0.5)}


@pytest.mark.parametrize("form", ["dense", "packed_blocked"])
@pytest.mark.parametrize("missing_prob", [0.0, 0.5])
def test_anytime_eval_matches_jax(setup, jax_evals, form, missing_prob):
    """Every metric, and the decoded grids in the dense layout, on both batch forms."""
    _, _, model, _ = setup
    dense, packed = make_batch(0)
    batch = t({k: v for k, v in dense.items() if k != "target"} if form == "dense" else packed)
    ref = jax_evals[missing_prob]
    draws = t(anytime_draws(jax.random.PRNGKey(3), missing_prob))
    got = engine.anytime_eval(model, batch, missing_prob=missing_prob, return_pred=True, draws=draws)
    want_keys = {"acc_category", "loss_shape", "precision", "recall", "pred"}
    if missing_prob:
        want_keys |= {f"{k}_corrected" for k in want_keys}
    assert set(got) == set(ref) == want_keys
    assert_metrics_close(got, ref)
    for k in ("pred", "pred_corrected") if missing_prob else ("pred",):
        assert got[k].shape == (B, DIM, DIM, DIM, 1)
        np.testing.assert_allclose(got[k].numpy(), ref[k], atol=PRED_ATOL, rtol=0, err_msg=k)
    assert model.training  # the caller's mode is restored
    if missing_prob:  # the correction moved the decode
        assert float((got["pred_corrected"] - got["pred"]).abs().max()) > 1e-3


def test_anytime_eval_refuses_the_dual_latent(setup):
    """The dual (category + instance) latent, refused here until the image
    family was ported, now runs (the image family's is held to the JAX package
    in ``test_torch_image.py``): a voxel model with an instance block and no
    instance prior gives finite metrics, no ``acc_inst`` (no prior to sweep),
    and its instance sample reaches the decoder."""
    _, _, model, cfg = setup
    dual = MultiModalVAE(dataclasses.replace(cfg, z_inst_dim=4, encoder3d=dataclasses.replace(
        cfg.encoder3d, output_dim=2 * (Z + 4)), decoder=dataclasses.replace(cfg.decoder, input_dim=Z + 4)),
        generator=torch.Generator().manual_seed(0))
    _, packed = make_batch(0, 2)
    rng = np.random.default_rng(0)
    draws = t({"eps_cat": rng.normal(size=(2, Z)).astype(np.float32),
               "eps_inst": rng.normal(size=(2, 4)).astype(np.float32)})
    a = engine.anytime_eval(dual, t(packed), draws=draws)
    b = engine.anytime_eval(dual, t(packed), draws={**draws, "eps_inst": -draws["eps_inst"]})
    assert set(a) == {"acc_category", "loss_shape", "precision", "recall"}
    assert all(np.isfinite(float(v)) for v in a.values())
    assert float(a["acc_category"]) == float(b["acc_category"]) and float(a["loss_shape"]) != float(b["loss_shape"])


def test_anytime_eval_draws_from_its_generator(setup):
    """Without injected draws: the same seed gives the same numbers, another seed others."""
    _, _, model, _ = setup
    _, packed = make_batch(0)
    batch = t(packed)
    a, b, c = (engine.anytime_eval(model, batch, torch.Generator().manual_seed(s), missing_prob=0.5)
               for s in (1, 1, 2))
    assert all(float(a[k]) == float(b[k]) for k in a)
    assert any(float(a[k]) != float(c[k]) for k in a)


# ---------------------------------------------------------------- fusion


def test_fusion_matches_jax():
    """Beliefs, the information-filter update and its sequence, and occupancy fusion, to 1e-6."""
    rng = np.random.default_rng(2)
    T, n = 5, 3
    means = rng.normal(size=(T, n, Z)).astype(np.float32)
    lvs = rng.normal(scale=0.5, size=(T, n, Z)).astype(np.float32)
    masks = (rng.uniform(size=(T, n, Z)) < 0.7).astype(np.float32)
    prior_m, prior_lv = rng.normal(size=(n, Z)).astype(np.float32), rng.normal(size=(n, Z)).astype(np.float32)

    def close(got, want):  # sums of terms up to ~15 that cancel: 1e-6 of the array's largest entry
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=FUSE_RTOL, atol=FUSE_RTOL * max(1.0, np.abs(want).max()))

    jp, tp = (jax_engine.GaussianBelief.from_moments(jnp.asarray(prior_m), jnp.asarray(prior_lv)),
              engine.GaussianBelief.from_moments(torch.from_numpy(prior_m), torch.from_numpy(prior_lv)))
    close(tp.mean, jp.mean)
    close(tp.log_var, jp.log_var)
    for m in (None, masks[0]):
        j = jax_engine.fuse_observation(jp, jnp.asarray(means[0]), jnp.asarray(lvs[0]),
                                        None if m is None else jnp.asarray(m))
        g = engine.fuse_observation(tp, torch.from_numpy(means[0]), torch.from_numpy(lvs[0]),
                                    None if m is None else torch.from_numpy(m))
        close(g.info, j.info)
        close(g.precision, j.precision)
    for prior, jprior, m in ((None, None, None), (tp, jp, masks)):
        j = jax_engine.fuse_sequence(jnp.asarray(means), jnp.asarray(lvs), None if m is None else jnp.asarray(m),
                                     jprior)
        g = engine.fuse_sequence(torch.from_numpy(means), torch.from_numpy(lvs),
                                 None if m is None else torch.from_numpy(m), prior)
        close(g.mean, j.mean)
        close(g.log_var, j.log_var)
    un = engine.GaussianBelief.uninformative((n, Z), device="cpu")
    ju = jax_engine.GaussianBelief.uninformative((n, Z))
    close(un.info, ju.info)
    close(un.precision, ju.precision)

    probs = rng.uniform(size=(T, 6, 6, 6)).astype(np.float32)
    probs[0, 0, 0, :2] = (0.0, 1.0)  # clipped before the logit
    seen = (rng.uniform(size=(T, 6, 6, 6)) < 0.5).astype(np.float32)
    for use_mask in (False, True):
        jb, tb = jax_engine.OccupancyBelief.empty((6, 6, 6)), engine.OccupancyBelief.empty((6, 6, 6), device="cpu")
        for i in range(T):
            jb = jax_engine.fuse_occupancy(jb, jnp.asarray(probs[i]), jnp.asarray(seen[i]) if use_mask else None)
            tb = engine.fuse_occupancy(tb, torch.from_numpy(probs[i]), torch.from_numpy(seen[i]) if use_mask else None)
        close(tb.log_odds, jb.log_odds)
        close(tb.count, jb.count)
        close(tb.probs, jb.probs)
    never = seen.sum(axis=0) == 0
    assert never.any() and (tb.probs.numpy()[never] == 0.5).all()  # unseen voxels keep the 0.5 prior


def test_masked_dims_keep_the_prior():
    """Dims an observation does not see keep the prior's information and precision exactly."""
    prior = engine.GaussianBelief.from_moments(torch.randn(2, Z), torch.randn(2, Z))
    mask = torch.zeros(2, Z)
    mask[:, : Z // 2] = 1.0
    post = engine.fuse_observation(prior, torch.randn(2, Z), torch.randn(2, Z), mask)
    assert torch.equal(post.info[:, Z // 2:], prior.info[:, Z // 2:])
    assert torch.equal(post.precision[:, Z // 2:], prior.precision[:, Z // 2:])
    assert (post.precision[:, : Z // 2] > prior.precision[:, : Z // 2]).all()


# ---------------------------------------------------------------- metrics and curves


@pytest.mark.parametrize("threshold", [0.3, 0.5])
def test_voxel_iou_matches_jax(threshold):
    rng = np.random.default_rng(3)
    target = (rng.uniform(size=(3, 8, 8, 8, 1)) > 0.6).astype(np.float32)
    pred = rng.uniform(size=target.shape).astype(np.float32)
    ref = float(jax_metrics.voxel_iou(jnp.asarray(target), jnp.asarray(pred), threshold))
    assert abs(float(voxel_iou(torch.from_numpy(target), torch.from_numpy(pred), threshold)) - ref) <= 1e-6


def test_pr_curve_matches_jax():
    """The 19 threshold rows and an acceptance tail of 3 (the tail's keep
    masks made from the JAX keys and injected): every array to 1e-6."""
    rng = np.random.default_rng(4)
    target = (rng.uniform(size=(3, 8, 8, 8, 1)) > 0.5).astype(np.float32)
    pred = rng.uniform(size=target.shape).astype(np.float32)
    pred[rng.uniform(size=pred.shape) < 0.3] = 1.0  # saturated voxels for the tail
    seed, div = 2, 3
    ref = jax_protocols.pr_curve(jnp.asarray(target), jnp.asarray(pred), acceptance_div=div, seed=seed)
    keeps = [torch.from_numpy(np.array(jax.random.bernoulli(jax.random.PRNGKey(seed * 1000 + i),
                                                              jnp.float32(0.1**i), pred.shape)))
             for i in range(div)]
    got = protocols.pr_curve(torch.from_numpy(target), torch.from_numpy(pred), acceptance_div=div, seed=seed,
                             keeps=keeps)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == np.float32 and got[k].shape == (19 + div,), k
        np.testing.assert_allclose(got[k], ref[k], atol=1e-6, rtol=0, err_msg=k)  # NaNs compare equal
    own = protocols.pr_curve(torch.from_numpy(target), torch.from_numpy(pred), acceptance_div=div, seed=seed)
    np.testing.assert_array_equal(own["precision"][:20], got["precision"][:20])  # accept_prob 1 keeps all


def port_batch_fn(seed0: int):
    return lambda b: make_batch(seed0 + b)[1]


def jax_batch_fn(seed0: int):
    return lambda b: {k: v for k, v in make_batch(seed0 + b)[0].items() if k != "inst_onehot"}


def test_category_vectors_matches_jax(setup):
    """Per-class mean posterior means over 2 batches (no draws): to 1e-5."""
    jax_model, tree, model, _ = setup
    ref = jax_protocols.category_vectors(jax_model, tree, jax_batch_fn(10), CAT, num_batches=2)
    got = protocols.category_vectors(model, port_batch_fn(10), CAT, num_batches=2)
    assert got.shape == (CAT, Z) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("missing_prob", [0.0, 0.5])
def test_evaluate_epoch_matches_jax(setup, monkeypatch, missing_prob):
    jax_model, tree, model, _ = setup
    with_jax_draws(monkeypatch, protocols)
    ref = jax_protocols.evaluate_epoch(jax_model, tree, jax_batch_fn(20), 2, missing_prob=missing_prob, seed=7)
    got = protocols.evaluate_epoch(model, port_batch_fn(20), 2, missing_prob=missing_prob, seed=7)
    assert set(got) == set(ref)
    assert_metrics_close(got, ref)


def test_missing_rate_sweep_matches_jax(setup, monkeypatch):
    jax_model, tree, model, _ = setup
    with_jax_draws(monkeypatch, protocols)
    rates = (0.3, 0.7)
    ref = jax_protocols.missing_rate_sweep(jax_model, tree, jax_batch_fn(30), rates, num_batches=2, seed=1)
    got = protocols.missing_rate_sweep(model, port_batch_fn(30), rates, num_batches=2, seed=1)
    assert list(got) == list(rates)
    for rate in rates:
        assert set(got[rate]) == set(ref[rate])
        assert_metrics_close(got[rate], ref[rate])


def test_dump_reconstructions_matches_jax(setup, tmp_path):
    """Same files, keys and grids (dense) as the JAX dump, on the draws of its keys."""
    jax_model, tree, model, _ = setup
    dense, packed = make_batch(40, 2)
    rates, seed = (0.5,), 3
    jax_paths = jax_dump.dump_reconstructions(jax_model, tree, {k: jnp.asarray(v) for k, v in dense.items()},
                                              str(tmp_path / "jax"), rates=rates, seed=seed)
    draws = {}
    for rate in rates:
        k_s, k_m, k_c = jax.random.split(jax.random.PRNGKey(seed + int(rate * 1000)), 3)
        draws[rate] = t({"eps": jax.random.normal(k_s, (2, Z)), "keep": jax.random.bernoulli(k_m, 1.0 - rate, (2, Z)),
                         "eps_corr": jax.random.normal(k_c, (2, Z))})
    paths = dump.dump_reconstructions(model, t(packed), str(tmp_path / "port"), rates=rates, seed=seed, draws=draws)
    assert [p.rsplit("/", 1)[1] for p in paths.values()] == [p.rsplit("/", 1)[1] for p in jax_paths.values()]
    for rate in rates:
        with np.load(paths[str(rate)]) as got, np.load(jax_paths[str(rate)]) as ref:
            assert set(got.files) == set(ref.files)
            for k in ("gt", "mask", "rate", "pred_class"):
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
            for k in ("pred", "pred_corrected"):
                assert got[k].shape == (2, DIM, DIM, DIM, 1)
                np.testing.assert_allclose(got[k], ref[k], atol=PRED_ATOL, rtol=0, err_msg=k)


# ---------------------------------------------------------------- trainer


def trainer_for(model, cfg, depth: int, steps: int = 3):
    loss_cfg = configs.loss_config("modelnet_nolbo")
    loaders = [SyntheticVoxelLoader(num_samples=16, dim=DIM, num_classes=CAT, num_inst=3, seed=s) for s in (0, 1)]

    def fn(loader):
        def batch_fn(_it):
            b = loader.getNextBatch(2)
            return {"input_packed_blocked": packing.pack_voxels_blocked(b["input_images"]),
                    "category_onehot": b["class_list"]}
        return batch_fn

    tcfg = trainer_mod.TrainerConfig(total_steps=steps, eval_every=steps, log_every=1, prefetch_depth=depth)
    return trainer_mod.Trainer(model, create_train_state(model), fn(loaders[0]), loss_cfg, fn(loaders[1]), tcfg)


def test_trainer_anytime_metrics_match_jax(setup, monkeypatch):
    """``Trainer.evaluate(it)`` adds ``anytime_*``: JAX's ``anytime_eval`` at
    missing 0.5 with ``PRNGKey(it)`` on the same batch and weights."""
    jax_model, tree, model, cfg = setup
    with_jax_draws(monkeypatch, trainer_mod)
    dense, packed = make_batch(50)
    tr = trainer_for(model, cfg, depth=0)
    assert tr.cfg.eval_missing_prob == 0.5 and trainer_mod.TrainerConfig().prefetch_depth == 2
    tr.eval_batch_fn = lambda _it: packed
    out = tr.evaluate(7)
    ref = jax_engine.anytime_eval_jit(jax_model, tree, jax.tree.map(jnp.asarray, dense), jax.random.PRNGKey(7), 0.5)
    got = {k[len("anytime_"):]: v for k, v in out.items() if k.startswith("anytime_")}
    assert set(got) == set(ref) and any(k.startswith("eval_") for k in out)
    assert_metrics_close(got, ref)


def test_trainer_prefetch_depth_2_matches_depth_0(setup):
    """The same steps, evals and draws whether batches are made ahead on the
    worker thread or between steps: equal histories."""
    _, _, model, cfg = setup
    runs = []
    for depth in (0, 2):
        m = MultiModalVAE(cfg)
        m.load_state_dict(model.state_dict())
        tr = trainer_for(m, cfg, depth)
        tr.run()
        runs.append((tr.history, tr.eval_history))
    assert len(runs[0][0]) == 3 and len(runs[0][1]) == 1 and "anytime_acc_category" in runs[0][1][0]
    assert runs[0] == runs[1]


# ---------------------------------------------------------------- prefetcher


def test_prefetcher_on_cpu_keeps_order_and_closes():
    calls = iter(range(100))
    pf = DevicePrefetcher(lambda: {"x": np.full((2, 3), next(calls), np.float32)}, torch.device("cpu"), depth=2)
    try:
        got = [pf.get() for _ in range(10)]
    finally:
        pf.close()
    assert not pf._thread.is_alive()
    assert [int(b["x"][0, 0]) for b in got] == list(range(10))
    assert all(isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu" for b in got)


def test_prefetcher_surfaces_worker_errors_after_earlier_batches():
    n = iter(range(100))

    def fn():
        i = next(n)
        if i == 2:
            raise KeyError("loader broke")
        return {"x": np.array([i])}

    pf = DevicePrefetcher(fn, torch.device("cpu"), depth=2)
    try:
        assert [int(pf.get()["x"][0]) for _ in range(2)] == [0, 1]
        with pytest.raises(KeyError, match="loader broke"):
            pf.get()
    finally:
        pf.close()
    assert not pf._thread.is_alive()

    steps = iter(range(3))  # a finite stream ends with StopIteration on get
    pf = DevicePrefetcher(lambda: {"x": np.array([next(steps)])}, torch.device("cpu"))
    try:
        assert [int(pf.get()["x"][0]) for _ in range(3)] == [0, 1, 2]
        with pytest.raises(StopIteration):
            pf.get()
    finally:
        pf.close()


def test_prefetcher_close_stops_a_worker_blocked_on_a_full_queue():
    pf = DevicePrefetcher(lambda: {"x": np.zeros(1)}, torch.device("cpu"), depth=1)
    pf.get()
    closer = threading.Thread(target=pf.close)
    closer.start()
    closer.join(timeout=10)
    assert not closer.is_alive() and not pf._thread.is_alive()


# ---------------------------------------------------------------- native packer


@pytest.mark.parametrize("shape,block", [((2, 8, 8, 8, 1), 4), ((3, 16, 8, 12, 1), 4), ((2, 8, 8, 8, 2), 2),
                                         ((2, 8, 8, 8), 4), ((1, 3, 5, 7, 1), 1)])
def test_native_packer_is_bit_identical_to_numpy(shape, block, monkeypatch):
    """The fused packer against the port's NumPy path and the JAX package's,
    a tail that is not a whole byte included (27 * 35 bits at block 1)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the native packer")
    monkeypatch.setenv("ANYTIME3D_PACK_LIB", "off")  # the JAX package's NumPy branch
    monkeypatch.setattr(jax_packing, "_PACK_LIB_TRIED", False)
    vox = (np.random.default_rng(9).uniform(size=shape) > 0.6).astype(np.float32)
    before = (packing.pack_voxels_blocked.native_calls, packing.pack_voxels_blocked.numpy_calls)
    got = packing.pack_voxels_blocked(vox, block, native=True)
    oracle = packing.pack_voxels_blocked(vox, block, native=False)
    assert (packing.pack_voxels_blocked.native_calls, packing.pack_voxels_blocked.numpy_calls) == (
        before[0] + 1, before[1] + 1)
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, jax_packing.pack_voxels_blocked(vox, block))
    np.testing.assert_array_equal(packing.pack_voxels_blocked(vox.astype(bool), block, native=True), oracle)


def test_native_packer_unavailable(monkeypatch):
    """Asked for, it raises; by default the NumPy path packs instead."""
    monkeypatch.setattr(packing, "_native", {"error": RuntimeError("native packer unavailable: no g++")})
    vox = np.zeros((1, 4, 4, 4, 1), np.float32)
    with pytest.raises(RuntimeError, match="unavailable"):
        packing.pack_voxels_blocked(vox, 4, native=True)
    before = packing.pack_voxels_blocked.numpy_calls
    np.testing.assert_array_equal(packing.pack_voxels_blocked(vox, 4), np.zeros((1, 8), np.uint8))
    assert packing.pack_voxels_blocked.numpy_calls == before + 1


# ---------------------------------------------------------------- CLI


@pytest.mark.parametrize("mode", ["sweep", "latents", "dump"])
def test_cli_evaluate_runs_on_the_cpu(monkeypatch, tmp_path, capsys, mode):
    _, tiny = small_configs()
    monkeypatch.setitem(configs.REGISTRY, "modelnet_nolbo", lambda: tiny)
    argv = ["--config", "modelnet_nolbo", "--device", "cpu", "--batch-size", "2", "--batches", "1", "--rates", "0.5"]
    if mode == "sweep":
        table, curve = cli_evaluate.main(argv + ["--bf16"])
        out = capsys.readouterr().out
        printed = json.loads(out[: out.index("best decode threshold")])
        assert list(printed) == ["0.5"] and printed["0.5"] == pytest.approx(table[0.5])
        assert {"acc_category", "acc_category_corrected", "loss_shape_corrected"} <= set(table[0.5])
        assert all(np.isfinite(v) for v in table[0.5].values()) and np.isfinite(curve["iou"]).all()
    elif mode == "latents":
        vecs = cli_evaluate.main(argv + ["--latents-out", str(tmp_path / "v.npy")])
        np.testing.assert_array_equal(np.load(tmp_path / "v.npy"), vecs)
        assert vecs.shape == (CAT, Z)
    else:
        paths = cli_evaluate.main(argv + ["--dump", str(tmp_path / "d")])
        with np.load(paths["0.5"]) as f:
            assert f["pred"].shape == f["gt"].shape == (2, DIM, DIM, DIM, 1)


def test_cli_evaluate_refuses_what_it_cannot_do():
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA is not available"):
            cli_evaluate.main(["--config", "modelnet_nolbo"])
    with pytest.raises(FileNotFoundError, match="checkpoint.pt"):
        cli_evaluate.main(["--config", "modelnet_nolbo", "--device", "cpu", "--ckpt", "x"])
