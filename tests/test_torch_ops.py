"""PyTorch port, ops and data: losses, metrics and sampling against
``anytime3d_tpu.ops``; the blocked bit packing and the procedural loader
against the JAX package's. CPU, float32 on both sides; tolerances cover the
summation order only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anytime3d_tpu.data import modelnet as jax_modelnet
from anytime3d_tpu.data import packing as jax_packing
from anytime3d_tpu.ops import losses as jax_losses
from anytime3d_tpu.ops import metrics as jax_metrics
from anytime3d_tpu.ops import sampling as jax_sampling
from anytime3d_tpu_torch.data import modelnet, packing
from anytime3d_tpu_torch.ops import losses, metrics, sampling

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)  # the suite runs several workers per machine


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", [(3, 8), (1, 64), (5, 2, 4)])
def test_gaussian_kl_matches_jax(shape):
    rng = np.random.default_rng(0)
    m, lv, mt, lvt = (rng.normal(size=shape).astype(np.float32) for _ in range(4))
    ref = jax_losses.gaussian_kl(*map(jnp.asarray, (m, lv, mt, lvt)))
    np.testing.assert_allclose(losses.gaussian_kl(t(m), t(lv), t(mt), t(lvt)).numpy(), np.asarray(ref), **TOL)
    ref0 = jax_losses.standard_gaussian_kl(jnp.asarray(m), jnp.asarray(lv))
    np.testing.assert_allclose(losses.standard_gaussian_kl(t(m), t(lv)).numpy(), np.asarray(ref0), **TOL)


@pytest.mark.parametrize("b_range", [False, True])
@pytest.mark.parametrize("shape", [(2, 8, 8, 8, 1), (3, 4, 4, 4, 64), (2, 100)])
def test_focal_binary_loss_matches_jax(shape, b_range):
    rng = np.random.default_rng(1)
    pred = rng.uniform(size=shape).astype(np.float32)
    pred.reshape(-1)[:4] = [0.0, 1.0, 1e-9, 1.0 - 1e-9]  # the clip at 1e-7 decides these
    target = (rng.uniform(size=shape) > 0.6).astype(np.float32)
    ref = jax_losses.focal_binary_loss(jnp.asarray(pred), jnp.asarray(target), gamma=0.6, b_range=b_range)
    got = losses.focal_binary_loss(t(pred), t(target), gamma=0.6, b_range=b_range)
    assert got.shape == (shape[0],) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


def test_focal_binary_loss_is_f32_on_bf16_input():
    """In bf16 the upper clip bound rounds to 1.0 and log(1 - p) is -inf; the loss upcasts first."""
    pred = torch.tensor([[1.0, 0.0, 0.5, 1.0]], dtype=torch.bfloat16)
    target = torch.tensor([[1.0, 0.0, 1.0, 0.0]], dtype=torch.bfloat16)
    got = losses.focal_binary_loss(pred, target)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), losses.focal_binary_loss(pred.float(), target.float()).numpy(), rtol=1e-6)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("batch,z,margin", [(4, 8, 16.0), (7, 3, 2.0), (1, 5, 10.0)])
def test_prior_repulsion_matches_jax(batch, z, margin, gated):
    rng = np.random.default_rng(2)
    mean = rng.normal(size=(batch, z)).astype(np.float32)
    log_var = (rng.normal(size=(batch, z)) * 0.3).astype(np.float32)
    onehot = np.eye(3, dtype=np.float32)[rng.integers(0, 3, batch)] if gated else None
    ref = jax_losses.prior_repulsion(jnp.asarray(mean), jnp.asarray(log_var), margin,
                                     class_onehot=None if onehot is None else jnp.asarray(onehot))
    got = losses.prior_repulsion(t(mean), t(log_var), margin, class_onehot=None if onehot is None else t(onehot))
    assert float(got.min()) >= margin**2 - 1e-3  # the constant diagonal term is kept
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


@pytest.mark.parametrize("shape", [(2, 8, 8, 8, 1), (3, 4, 4, 4, 64)])
def test_voxel_metrics_match_jax(shape):
    rng = np.random.default_rng(3)
    target = (rng.uniform(size=shape) > 0.5).astype(np.float32)
    pred = rng.uniform(size=shape).astype(np.float32)
    pred.reshape(-1)[:3] = 0.5  # >= threshold counts as occupied
    for got, ref in zip(metrics.voxel_tp_fp_fn(t(target), t(pred)),
                        jax_metrics.voxel_tp_fp_fn(jnp.asarray(target), jnp.asarray(pred))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for got, ref in zip(metrics.voxel_precision_recall(t(target), t(pred)),
                        jax_metrics.voxel_precision_recall(jnp.asarray(target), jnp.asarray(pred))):
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_reparameterize_matches_jax_on_the_same_noise():
    key = jax.random.PRNGKey(4)
    rng = np.random.default_rng(4)
    mean, log_var = (rng.normal(size=(3, 8)).astype(np.float32) for _ in range(2))
    eps = np.asarray(jax.random.normal(key, mean.shape, jnp.float32))
    ref = jax_sampling.reparameterize(key, jnp.asarray(mean), jnp.asarray(log_var))
    np.testing.assert_allclose(sampling.reparameterize(t(mean), t(log_var), eps=t(eps)).numpy(), np.asarray(ref), **TOL)
    a = sampling.reparameterize(t(mean), t(log_var), torch.Generator().manual_seed(1))
    b = sampling.reparameterize(t(mean), t(log_var), torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, t(mean))


@pytest.mark.parametrize("fill", [0.0, "vector"])
def test_mask_latent_matches_jax_on_the_same_mask(fill):
    key = jax.random.PRNGKey(5)
    z = np.random.default_rng(5).normal(size=(4, 8)).astype(np.float32)
    fill_value = np.arange(8, dtype=np.float32) if fill == "vector" else fill
    keep = np.asarray(jax.random.bernoulli(key, p=0.6, shape=z.shape))
    ref_z, ref_mask = jax_sampling.mask_latent(key, jnp.asarray(z), 0.4, jnp.asarray(fill_value))
    got_z, got_mask = sampling.mask_latent(t(z), 0.4, t(fill_value) if fill == "vector" else fill, keep=t(keep))
    np.testing.assert_array_equal(got_z.numpy(), np.asarray(ref_z))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(ref_mask))
    drawn = sampling.mask_latent(torch.zeros(200, 50), 0.4, generator=torch.Generator().manual_seed(0))[1]
    assert abs(float(drawn.mean()) - 0.6) < 0.02


def test_mix_latent_matches_jax_on_the_same_mask():
    key = jax.random.PRNGKey(6)
    rng = np.random.default_rng(6)
    z, z_prior = (rng.normal(size=(4, 8)).astype(np.float32) for _ in range(2))
    take = np.asarray(jax.random.bernoulli(key, p=0.3, shape=z.shape))
    ref = jax_sampling.mix_latent(key, jnp.asarray(z), jnp.asarray(z_prior), 0.3)
    np.testing.assert_array_equal(sampling.mix_latent(t(z), t(z_prior), 0.3, take_prior=t(take)).numpy(), np.asarray(ref))
    drawn = sampling.mix_latent(torch.zeros(200, 50), torch.ones(200, 50), 0.3, torch.Generator().manual_seed(0))
    assert abs(float(drawn.mean()) - 0.3) < 0.02


@pytest.mark.parametrize("shape,block", [((2, 8, 8, 8, 1), 4), ((3, 16, 8, 12, 1), 4), ((2, 8, 8, 8), 2),
                                         ((1, 4, 4, 4, 2), 2)])
def test_blocked_packing_is_bit_identical_to_jax(shape, block, monkeypatch):
    monkeypatch.setenv("ANYTIME3D_PACK_LIB", "off")  # the JAX package's NumPy branch
    monkeypatch.setattr(jax_packing, "_PACK_LIB_TRIED", False)
    vox = (np.random.default_rng(7).uniform(size=shape) > 0.6).astype(np.float32)
    packed = packing.pack_voxels_blocked(vox, block)
    np.testing.assert_array_equal(packed, jax_packing.pack_voxels_blocked(vox, block))
    grid = shape[1:] if len(shape) == 5 else shape[1:] + (1,)
    assert packing.blocked_shape(grid, block) == jax_packing.blocked_shape(grid, block)
    got = packing.unpack_voxels_blocked(t(packed), grid, block)
    ref = jax_packing.unpack_voxels_blocked(jnp.asarray(packed), grid, block)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # and it is the space-to-depth layout of the grid itself
    from anytime3d_tpu_torch.nn.blocks import space_to_depth3d
    np.testing.assert_array_equal(got.numpy(), space_to_depth3d(t(vox.reshape(shape[0], *grid)), block).numpy())


def test_blocked_packing_rejects_ragged_grids():
    with pytest.raises(ValueError):
        packing.pack_voxels_blocked(np.zeros((1, 6, 8, 8, 1), np.float32), 4)
    with pytest.raises(ValueError):
        packing.blocked_shape((8, 8, 6, 1), 4)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_loader_matches_jax(seed):
    """Same seed, same batches, through an epoch boundary (40 samples, batches of 16)."""
    kw = dict(num_samples=40, dim=16, num_classes=40, num_inst=10, seed=seed)
    ours, theirs = modelnet.SyntheticVoxelLoader(**kw), jax_modelnet.SyntheticVoxelLoader(**kw)
    for _ in range(4):
        a, b = ours.getNextBatch(16), theirs.getNextBatch(16)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert (ours.epoch, ours.batchStart, ours.dataLength) == (theirs.epoch, theirs.batchStart, theirs.dataLength)
    assert ours.epoch == 1


def test_synthetic_loader_refuses_structural_shapes(monkeypatch):
    """The structural shapes are the native voxelizer's: where it cannot be
    built the loader refuses them rather than voxelize in NumPy."""
    from anytime3d_tpu_torch.data import instances, voxelize

    monkeypatch.setattr(voxelize, "_native", {"error": RuntimeError("native voxelizer unavailable: no g++")})
    monkeypatch.setattr(instances, "_BANK", instances.InstanceShapeBank())
    before = voxelize.voxelize.numpy_calls
    with pytest.raises(RuntimeError, match="native voxelizer unavailable"):
        modelnet.SyntheticVoxelLoader(num_samples=1, dim=8, structural_inst=True)
    assert voxelize.voxelize.numpy_calls == before
