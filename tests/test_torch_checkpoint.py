"""PyTorch port, the model's lifecycle on the CPU: checkpoints of the train
state, grafting, the trainer's NaN restarts, the ModelNet loader and the voxel
utilities against the JAX package, ``cli.train --data <path> --save-path``
then ``cli.evaluate --ckpt``, and ``tools/orbax_to_npz.py`` carrying a JAX
checkpoint into the port.

The trainer tests mirror ``tests/test_checkpoint.py`` and
``tests/test_nan_recovery.py`` on the port's model (``modelnet_nolbo``'s
layout at 32^3 with narrow filters; the port has no deterministic variant).
"""

import dataclasses
import math
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anytime3d_tpu.data import voxel as jax_voxel
from anytime3d_tpu.data.modelnet import ModelNetLoader as JaxModelNetLoader
from anytime3d_tpu.models.mmvae import MultiModalVAE as JaxVAE
from anytime3d_tpu.serving.export import make_infer_fn as jax_make_infer_fn
from anytime3d_tpu.train import checkpoint as jax_checkpoint
from anytime3d_tpu.train import create_train_state as jax_create_train_state
from anytime3d_tpu_torch.cli import evaluate as cli_evaluate
from anytime3d_tpu_torch.cli import train as cli_train
from anytime3d_tpu_torch.convert import load_flax_npz
from anytime3d_tpu_torch.data import voxel
from anytime3d_tpu_torch.data.modelnet import ModelNetLoader
from anytime3d_tpu_torch.evaluation.protocols import missing_rate_sweep
from anytime3d_tpu_torch.models import configs
from anytime3d_tpu_torch.models.mmvae import MultiModalVAE
from anytime3d_tpu_torch.serving.export import make_infer_fn
from anytime3d_tpu_torch.train import checkpoint
from anytime3d_tpu_torch.train.state import create_train_state
from anytime3d_tpu_torch.train.step import make_train_step
from anytime3d_tpu_torch.train.trainer import Trainer, TrainerConfig

from tests.test_torch_serving import PRED_TOL, Z_TOL
from tests.test_torch_train import small_configs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "modelnet")
B, Z, CAT, DIM = 2, 8, 5, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)  # the suite runs several workers per machine


def _batch(seed=0, n=B):
    rng = np.random.default_rng(seed)
    return {"input": (rng.uniform(size=(n, DIM, DIM, DIM, 1)) > 0.7).astype(np.float32),
            "category_onehot": np.eye(CAT, dtype=np.float32)[rng.integers(0, CAT, n)]}


def _torch_batch(seed=0):
    return {k: torch.from_numpy(v) for k, v in _batch(seed).items()}


def _state(seed=0, steps=0, cfg=None):
    """A port train state of the small config after ``steps`` train steps."""
    cfg = cfg or small_configs()[1]
    model = MultiModalVAE(cfg, generator=torch.Generator().manual_seed(seed))
    state = create_train_state(model)
    step = make_train_step(model, configs.loss_config("modelnet_nolbo"))
    for i in range(steps):
        state, _ = step(state, _torch_batch(i), torch.Generator().manual_seed(i))
    return state, step


def _wide_decoder():
    base = small_configs()[1]
    return dataclasses.replace(base, decoder=dataclasses.replace(base.decoder, filter_nums=(32, 16, 16, 16, 1)))


def _adam_leaves(state):
    return [t for s in state.optimizer.state_dict()["state"].values() for _, t in sorted(s.items())]


# ---------------------------------------------------------------- checkpoints


@pytest.mark.parametrize("wait", [True, False], ids=["wait", "background"])
def test_full_state_roundtrip_is_bit_exact(tmp_path, wait):
    state, _ = _state(steps=3)
    path = str(tmp_path / "ckpt")
    checkpoint.save_state(path, state, wait=wait)
    fresh, _ = _state(seed=99)
    restored = checkpoint.restore_state(path, fresh)  # waits for a background write
    assert os.listdir(path) == [checkpoint.CHECKPOINT_FILE]  # the temporary file was renamed over
    assert restored.step == state.step == 3
    for (name, a), (_, b) in zip(state.model.state_dict().items(), restored.model.state_dict().items()):
        assert torch.equal(a, b), name
    ours, theirs = _adam_leaves(state), _adam_leaves(restored)
    assert len(ours) == 3 * len(state.params) and all(torch.equal(a, b) for a, b in zip(ours, theirs))


def test_background_save_snapshots_the_state_at_the_call(tmp_path):
    """A step taken while the file is written does not reach the checkpoint."""
    state, step = _state(steps=1)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    checkpoint.save_state(str(tmp_path / "ckpt"), state, wait=False)
    step(state, _torch_batch(5), torch.Generator().manual_seed(5))
    params = checkpoint.restore_params(str(tmp_path / "ckpt"), state.model.state_dict())
    assert all(torch.equal(params[k], v) for k, v in before.items())
    assert not all(torch.equal(params[k], v) for k, v in state.model.state_dict().items())


def test_step_after_restore_equals_the_step_on_the_saved_state(tmp_path):
    state, step = _state(steps=2)
    path = str(tmp_path / "ckpt")
    checkpoint.save_state(path, state)
    restored, step2 = _state(seed=7)
    checkpoint.restore_state(path, restored)
    _, m1 = step(state, _torch_batch(9), torch.Generator().manual_seed(5))
    _, m2 = step2(restored, _torch_batch(9), torch.Generator().manual_seed(5))
    assert restored.step == state.step == 3
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    for (name, a), (_, b) in zip(state.model.state_dict().items(), restored.model.state_dict().items()):
        assert torch.equal(a, b), name
    assert all(torch.equal(a, b) for a, b in zip(_adam_leaves(state), _adam_leaves(restored)))


def test_restore_params_maps_onto_the_template_and_checks_it(tmp_path):
    state, _ = _state(steps=1)
    path = str(tmp_path / "params")
    checkpoint.save_params(path, state.model.state_dict())
    bf16 = {k: v.bfloat16() for k, v in state.model.state_dict().items()}
    params = checkpoint.restore_params(path, bf16)
    assert all(params[k].dtype == torch.bfloat16 and torch.equal(params[k], v) for k, v in bf16.items())
    with pytest.raises(KeyError):
        checkpoint.restore_state(path, state)  # a params checkpoint holds no optimizer state
    with pytest.raises(ValueError, match="shape mismatch at decoder"):
        checkpoint.restore_params(path, MultiModalVAE(_wide_decoder()).state_dict())
    with pytest.raises(KeyError, match="only one"):
        checkpoint.restore_params(path, {k: v for k, v in bf16.items() if not k.startswith("decoder.")})


def test_graft_decoder_between_experiments(tmp_path):
    donor, _ = _state(seed=0, steps=2)
    donor_path = str(tmp_path / "donor")
    checkpoint.save_state(donor_path, donor)
    state, step = _state(seed=1, steps=1)
    encoder_before = {k: v.clone() for k, v in state.model.state_dict().items() if k.startswith("encoder3d.")}
    assert len(state.optimizer.state) > 0
    grafted = checkpoint.graft_submodule(state, donor_path, "decoder")
    own, theirs = grafted.model.state_dict(), donor.model.state_dict()
    decoder = [k for k in own if k.startswith("decoder.")]
    assert decoder and all(torch.equal(own[k], theirs[k]) for k in decoder)
    assert all(torch.equal(own[k], v) for k, v in encoder_before.items())  # other submodules untouched
    assert len(grafted.optimizer.state) == 0  # moments reset
    step(grafted, _torch_batch(0), torch.Generator().manual_seed(0))  # and training goes on


def test_graft_missing_submodule_or_mismatch_raises(tmp_path):
    donor, _ = _state(steps=1)
    partial = str(tmp_path / "decoder_only")
    checkpoint.save_params(partial, {k: v for k, v in donor.model.state_dict().items() if k.startswith("decoder.")})
    state, _ = _state(seed=1)
    with pytest.raises(KeyError, match="prior_category"):
        checkpoint.graft_submodule(state, partial, "prior_category")
    with pytest.raises(KeyError, match="prior_inst"):
        checkpoint.graft_submodule(state, partial, "prior_inst")
    other, _ = _state(cfg=_wide_decoder())
    checkpoint.save_state(str(tmp_path / "wide"), other)
    with pytest.raises(ValueError, match="shape mismatch at decoder"):
        checkpoint.graft_submodule(state, str(tmp_path / "wide"), "decoder")


# ---------------------------------------------------------------- NaN restarts


def _trainer(tmp_path, batch_fn, **cfg):
    model = MultiModalVAE(small_configs()[1], generator=torch.Generator().manual_seed(0))
    return Trainer(model, create_train_state(model), batch_fn, loss_config=configs.loss_config("modelnet_nolbo"),
                   config=TrainerConfig(eval_every=0, **cfg))


def _poisoned_once(steps):
    poisoned, calls = set(steps), []

    def batch_fn(it):
        calls.append(it)
        batch = _batch(0)
        if it in poisoned:
            poisoned.discard(it)  # poison once, then heal
            batch["input"] = batch["input"] * np.nan
        return batch

    return batch_fn, calls


def test_nan_restart_restores_reseeds_and_rewinds(tmp_path):
    batch_fn, calls = _poisoned_once({5})
    trainer = _trainer(tmp_path, batch_fn, total_steps=8, save_every=2, save_path=str(tmp_path / "ckpt"),
                       max_nan_restarts=2)
    seeds = []
    make_generator = trainer._generator
    trainer._generator = lambda seed: seeds.append(seed) or make_generator(seed)
    final = trainer.run()
    assert not trainer.aborted_nan and final.step == 8
    nan_steps = [h for h in trainer.history if not math.isfinite(h["loss_total"])]
    assert len(nan_steps) == 1
    # steps 0..5 (5 poisoned), then from the checkpoint of step 4 (saved after step 3): 4..7
    assert len(trainer.history) == 6 + 4
    assert seeds == [0, 4 * 7919 + 1]
    assert calls.count(4) == 2 and calls.count(5) == 2 and calls[:6] == list(range(6))
    assert math.isfinite(trainer.history[-1]["loss_total"])


def test_nan_without_restart_budget_aborts(tmp_path):
    def batch_fn(it):
        batch = _batch(0)
        batch["input"] = batch["input"] * np.nan
        return batch

    path = tmp_path / "ckpt"
    trainer = _trainer(tmp_path, batch_fn, total_steps=4, save_every=1, save_path=str(path), max_nan_restarts=0)
    trainer.run()
    assert trainer.aborted_nan and len(trainer.history) == 1
    assert not path.exists()  # neither a save of the poisoned step nor the final save


def test_nan_between_log_ticks_never_poisons_the_checkpoint(tmp_path):
    batch_fn, _ = _poisoned_once({5})  # between the log ticks at 4 and 8
    trainer = _trainer(tmp_path, batch_fn, total_steps=12, save_every=1, log_every=4,
                       save_path=str(tmp_path / "ckpt"), max_nan_restarts=2)
    final = trainer.run()
    assert not trainer.aborted_nan and final.step == 12
    # the final (finite) state implies the restored checkpoint was taken before the NaN
    assert math.isfinite(trainer.history[-1]["loss_total"])
    params = checkpoint.restore_params(str(tmp_path / "ckpt"), final.model.state_dict())
    assert all(torch.isfinite(p).all() for p in params.values())


def test_load_path_resumes_where_the_checkpoint_ends(tmp_path):
    path = str(tmp_path / "ckpt")
    first = _trainer(tmp_path, lambda it: _batch(it), total_steps=3, save_path=path)
    first.run()
    resumed = _trainer(tmp_path, lambda it: _batch(it), total_steps=5, load_path=path)
    assert resumed.state.step == 3
    assert all(torch.equal(a, b) for a, b in zip(first.model.state_dict().values(),
                                                  resumed.model.state_dict().values()))
    resumed.run()
    assert resumed.state.step == 5 and len(resumed.history) == 2


# ---------------------------------------------------------------- data


@pytest.mark.parametrize("split,batch", [("train", 2), ("test", 3)])
def test_modelnet_loader_matches_jax_over_three_epochs(split, batch):
    ours = ModelNetLoader(FIXTURES, split, partial_num=None, seed=3)
    theirs = JaxModelNetLoader(FIXTURES, split, partial_num=None, seed=3)
    n = 0
    while ours.epoch < 3:
        a, b = ours.getNextBatch(batch), theirs.getNextBatch(batch)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])
        assert (ours.epoch, ours.batchStart, ours.dataLength) == (theirs.epoch, theirs.batchStart, theirs.dataLength)
        n += 1
    assert a["input_images"].shape == (batch, 64, 64, 64, 1) and n >= 3


def _copy_shards(src_split, indices, dst):
    base = os.path.join(FIXTURES, "32to64_4rot_64sqr", src_split)
    out = os.path.join(dst, "32to64_4rot_64sqr", "train")
    os.makedirs(out)
    for i in indices:
        for kind in ("Full", "Class", "Inst"):
            shutil.copy(os.path.join(base, f"{i}{kind}.npy"), out)
    return out


def test_modelnet_loader_reads_a_gapped_shard_set_whole(tmp_path):
    out = _copy_shards("test", (0, 2), tmp_path)
    loader = ModelNetLoader(str(tmp_path), "train", partial_num=None)
    assert loader.dataLength == 2
    got = np.concatenate([loader.getNextBatch(1)["input_images"] for _ in range(2)])[..., 0]
    want = np.concatenate([np.load(os.path.join(out, f"{i}Full.npy")) for i in (0, 2)]).astype(np.float32)
    assert sorted(map(bytes, got.astype(np.uint8))) == sorted(map(bytes, want.astype(np.uint8)))
    os.remove(os.path.join(out, "2Inst.npy"))
    with pytest.raises(FileNotFoundError, match="2Inst.npy"):
        ModelNetLoader(str(tmp_path), "train", partial_num=None)
    with pytest.raises(FileNotFoundError, match="no"):
        ModelNetLoader(str(tmp_path / "nowhere"), "train", partial_num=None)


def test_voxel_utilities_match_jax():
    rng = np.random.default_rng(0)
    vox = rng.uniform(size=(3, 32, 32, 32)).astype(np.float32)
    np.testing.assert_array_equal(voxel.binarize(vox, 0.3), jax_voxel.binarize(vox, 0.3))
    small = vox[:, :8, :8, :8]
    np.testing.assert_array_equal(voxel.zoom_nearest(small, 3), jax_voxel.zoom_nearest(small, 3))
    out = voxel.convert_axis_32to64(vox)
    assert out.shape == (3, 64, 64, 64) and out.dtype == np.float32
    np.testing.assert_array_equal(out, jax_voxel.convert_axis_32to64(vox))


# ---------------------------------------------------------------- CLI


def tiny64():
    """``modelnet_nolbo``'s layout at the fixtures' 64^3 and 40 classes, narrow filters."""
    base = configs.modelnet_nolbo(z_dim=Z)
    return dataclasses.replace(
        base,
        encoder3d=dataclasses.replace(base.encoder3d, filter_nums=(8, 16, 16, 32)),
        decoder=dataclasses.replace(base.decoder, filter_nums=(32, 16, 16, 8, 1)),
        prior_category=dataclasses.replace(base.prior_category, unit_nums=(16, Z)),
    )


def test_cli_train_on_a_dataset_path_then_evaluate_the_checkpoint(monkeypatch, tmp_path, capsys):
    monkeypatch.setitem(configs.REGISTRY, "modelnet_nolbo", tiny64)
    ckpt = str(tmp_path / "ckpt")
    argv = ["--config", "modelnet_nolbo", "--device", "cpu", "--data", FIXTURES, "--batch-size", "2",
            "--packed", "--eval-every", "2", "--save-path", ckpt, "--save-every", "1"]
    trainer = cli_train.main(argv + ["--steps", "2"])
    assert trainer.state.step == 2 and len(trainer.history) == 2 and len(trainer.eval_history) == 1
    assert all(math.isfinite(v) for row in trainer.history + trainer.eval_history for v in row.values())
    saved = checkpoint.restore_params(ckpt, trainer.model.state_dict())
    assert all(torch.equal(saved[k], v) for k, v in trainer.model.state_dict().items())

    table, curve = cli_evaluate.main(["--config", "modelnet_nolbo", "--device", "cpu", "--data", FIXTURES,
                                      "--ckpt", ckpt, "--batch-size", "2", "--batches", "1", "--rates", "0.5"])
    loader = ModelNetLoader(FIXTURES, "test", partial_num=None)
    batch_fn = cli_train.build_batch_fn(loader, tiny64(), 2, packed=True)
    trainer.model.eval()
    assert table == missing_rate_sweep(trainer.model, batch_fn, [0.5], num_batches=1)
    assert "best decode threshold" in capsys.readouterr().out

    resumed = cli_train.main(argv + ["--steps", "3", "--load-path", ckpt, "--swap-splits"])
    assert resumed.state.step == 3 and len(resumed.history) == 1


def test_cli_train_and_evaluate_refuse_what_they_cannot_do(tmp_path):
    args = cli_train.parse_args(["--config", "modelnet_nolbo", "--data", str(tmp_path)])
    with pytest.raises(FileNotFoundError, match="no \\*Full.npy"):
        cli_train.build_loaders(args, configs.modelnet_nolbo())
    image = dataclasses.replace(configs.modelnet_nolbo(), encoder="image")
    with pytest.raises(FileNotFoundError, match="CAD"):  # an image config reads a Pascal3D tree there
        cli_train.build_loaders(args, image)
    with pytest.raises(SystemExit, match="not both"):
        cli_evaluate.main(["--config", "modelnet_nolbo", "--device", "cpu", "--ckpt", "a", "--weights", "b"])


# ---------------------------------------------------------------- JAX checkpoints


def test_orbax_to_npz_carries_a_jax_checkpoint_into_the_port(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import orbax_to_npz

    jax_cfg, cfg = small_configs()
    jax_model = JaxVAE(jax_cfg)
    x, mask = _batch(4)["input"], (np.random.default_rng(4).uniform(size=(B, Z)) < 0.5).astype(np.float32)
    state = jax_create_train_state(jax_model, jnp.asarray(x), jax.random.PRNGKey(3))
    jax_checkpoint.save_state(str(tmp_path / "orbax"), state)
    out = str(tmp_path / "params.npz")
    flat = orbax_to_npz.main([str(tmp_path / "orbax"), out])
    assert all("/" in k for k in flat) and not any(k.startswith(("opt_state", "step")) for k in flat)

    model = MultiModalVAE(cfg)
    model.load_state_dict(load_flax_npz(out))
    params = jax.tree.map(np.asarray, state.params)
    ref = jax.tree.map(np.asarray, jax.jit(jax_make_infer_fn(jax_model))(params, jnp.asarray(x), jnp.asarray(mask)))
    got = {k: v.numpy() for k, v in make_infer_fn(model)(torch.from_numpy(x), torch.from_numpy(mask)).items()}
    np.testing.assert_array_equal(got["category"], ref["category"])
    np.testing.assert_allclose(got["z_mean"], ref["z_mean"], **Z_TOL)
    np.testing.assert_allclose(got["z_log_var"], ref["z_log_var"], **Z_TOL)
    np.testing.assert_allclose(1 / (1 + np.exp(-got["pred"])), ref["pred"], **PRED_TOL)
