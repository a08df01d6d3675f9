"""PyTorch port, serving slice: the inference program against the JAX one on
the same weights and inputs, packed IO, the micro-batcher, the HTTP server
and the CLI's device rule, on the CPU.

The JAX serving program applies a second sigmoid to the decoder's output
(``anytime3d_tpu/serving/export.py:107-108``); the port does not. The tests
pin both sides of that: the port's ``pred`` is the JAX decoder's output, and
its sigmoid is the JAX ``pred``."""

import base64
import http.client
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anytime3d_tpu.anytime.engine import classify_by_prior as jax_classify_by_prior
from anytime3d_tpu.data import packing as jax_packing
from anytime3d_tpu.models.mmvae import MultiModalVAE as JaxVAE
from anytime3d_tpu.serving.export import make_infer_fn as jax_make_infer_fn
from anytime3d_tpu_torch.anytime.engine import classify_by_prior
from anytime3d_tpu_torch.cli import serve as serve_cli
from anytime3d_tpu_torch.convert import params_from_flax
from anytime3d_tpu_torch.data.packing import pack_voxels, pack_voxels_device, unpack_voxels
from anytime3d_tpu_torch.models.mmvae import MultiModalVAE
from anytime3d_tpu_torch.serving.batcher import MicroBatcher
from anytime3d_tpu_torch.serving.export import make_infer_fn, make_packed_infer
from anytime3d_tpu_torch.serving.server import InferenceServer

from tests.test_torch_nn import small_configs

DIM, Z, B = 32, 8, 4
ITEM = (DIM, DIM, DIM, 1)
# f32 on both sides; the encoder output sums depths up to 2048 (summation order only)
Z_TOL = dict(rtol=1e-4, atol=1e-4)
PRED_TOL = dict(rtol=0, atol=1e-5)  # probabilities in (0, 1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)  # the suite runs several workers per machine


@pytest.fixture(scope="module")
def models():
    """The 32^3 blocked model (modelnet_nolbo's layout) in flax and in the
    port on the same weights, with the JAX serving program jitted once."""
    jax_cfg, cfg = small_configs(z=Z)
    jax_model = JaxVAE(jax_cfg)
    tree = jax.tree.map(np.asarray, jax_model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, *ITEM)), method=JaxVAE.initialize)["params"])
    model = MultiModalVAE(cfg)
    model.load_state_dict(params_from_flax(tree))
    return jax_model, tree, jax.jit(jax_make_infer_fn(jax_model)), model


def _grids(n, seed):
    return (np.random.default_rng(seed).uniform(size=(n, *ITEM)) > 0.7).astype(np.float32)


def _mask(kind, n=B, seed=0):
    if kind == "full":
        return np.ones((n, Z), np.float32)
    if kind == "empty":
        return np.zeros((n, Z), np.float32)
    return (np.random.default_rng(seed).uniform(size=(n, Z)) < 0.5).astype(np.float32)


@pytest.mark.parametrize("mask_kind", ["full", "partial", "empty"])
def test_infer_matches_jax(models, mask_kind):
    jax_model, tree, jax_infer, model = models
    x, mask = _grids(B, 1), _mask(mask_kind)
    ref = jax.tree.map(np.asarray, jax_infer(tree, jnp.asarray(x), jnp.asarray(mask)))
    out = {k: v.numpy() for k, v in make_infer_fn(model)(torch.from_numpy(x), torch.from_numpy(mask)).items()}
    assert set(out) == set(ref)
    np.testing.assert_array_equal(out["category"], ref["category"])
    np.testing.assert_allclose(out["z_mean"], ref["z_mean"], **Z_TOL)
    np.testing.assert_allclose(out["z_log_var"], ref["z_log_var"], **Z_TOL)
    # the port's pred is the decoder's output for the same z
    decoded = np.asarray(jax_model.apply({"params": tree}, jnp.asarray(ref["z_mean"]), method=JaxVAE.decode))
    assert decoded.std() > 0.05  # not a constant grid
    np.testing.assert_allclose(out["pred"], decoded, **PRED_TOL)
    # the JAX pred is that output through a second sigmoid: (0.5, 0.731), all occupied
    assert ref["pred"].min() > 0.5
    np.testing.assert_allclose(1 / (1 + np.exp(-out["pred"])), ref["pred"], **PRED_TOL)


def test_classify_by_prior_matches_jax():
    rng = np.random.default_rng(2)
    z = rng.normal(size=(16, 6)).astype(np.float32)
    pm = rng.normal(size=(5, 6)).astype(np.float32)
    pm[3] = pm[1]  # a tie: the lower index wins on both sides
    mask = (rng.uniform(size=(16, 6)) < 0.5).astype(np.float32)
    mask[0] = 0.0  # every distance 0: class 0
    for m in (None, mask):
        ref = jax_classify_by_prior(jnp.asarray(z), jnp.asarray(pm), None if m is None else jnp.asarray(m))
        got = classify_by_prior(torch.from_numpy(z), torch.from_numpy(pm), None if m is None else torch.from_numpy(m))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("shape", [(8, 8, 8, 1), (3, 5, 7)])
def test_packed_io_bit_identical_to_jax_and_packbits(shape):
    rng = np.random.default_rng(3)
    vox = rng.uniform(size=(3, *shape)).astype(np.float32)
    vox[0].reshape(-1)[:10] = 0.5  # at the threshold: not occupied, on every side
    packed = np.packbits(vox.reshape(3, -1) > 0.5, axis=-1)
    np.testing.assert_array_equal(pack_voxels(vox), packed)
    unpacked = unpack_voxels(torch.from_numpy(packed), shape)
    assert unpacked.dtype == torch.float32
    np.testing.assert_array_equal(unpacked.numpy(), (vox > 0.5).astype(np.float32))
    np.testing.assert_array_equal(unpacked.numpy(), np.asarray(jax_packing.unpack_voxels(jnp.asarray(packed), shape)))
    if vox[0].size % 8 == 0:
        dev = pack_voxels_device(torch.from_numpy(vox)).numpy()
        np.testing.assert_array_equal(dev, packed)
        np.testing.assert_array_equal(dev, np.asarray(jax_packing.pack_voxels_device(jnp.asarray(vox))))
    else:
        with pytest.raises(ValueError):
            pack_voxels_device(torch.from_numpy(vox))


def test_packed_infer_matches_float_infer(models):
    *_, model = models
    x, mask = _grids(B, 4), torch.from_numpy(_mask("partial", seed=4))
    out = make_packed_infer(model, ITEM)(torch.from_numpy(pack_voxels(x)), mask)
    ref = make_infer_fn(model)(torch.from_numpy(x), mask)
    assert set(out) == {"category", "z_mean", "z_log_var", "pred_packed"}
    for k in ("category", "z_mean", "z_log_var"):
        assert torch.equal(out[k], ref[k]), k
    assert out["pred_packed"].shape == (B, DIM**3 // 8) and out["pred_packed"].dtype == torch.uint8
    assert torch.equal(out["pred_packed"], pack_voxels_device(ref["pred"]))


def test_batcher_pads_and_routes_concurrent_items(models):
    *_, model = models
    fn = make_infer_fn(model)
    items = list(_grids(11, 5))  # 11 % 4 != 0: the last group is padded
    futures = [None] * len(items)
    with MicroBatcher(fn, batch_size=4, input_shape=ITEM, mask_dim=Z, device="cpu") as mb:
        def submit(i):
            futures[i] = mb.submit(items[i])

        threads = [threading.Thread(target=submit, args=(i,)) for i in range(len(items))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        results = [f.result(timeout=120) for f in futures]
    assert mb.batches_run >= 3
    ones = torch.ones(4, Z)
    for item, r in zip(items, results):
        xb = np.zeros((4, *ITEM), np.float32)
        xb[0] = item
        ref = {k: v[0].numpy() for k, v in fn(torch.from_numpy(xb), ones).items()}
        assert r["pred"].shape == ITEM
        assert r["category"] == ref["category"]
        np.testing.assert_allclose(r["z_mean"], ref["z_mean"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["pred"], ref["pred"], **PRED_TOL)


def test_http_roundtrip(models):
    *_, model = models
    server = InferenceServer(make_packed_infer(model, ITEM), (DIM**3 // 8,), Z, batch_size=B, max_wait_s=0.002,
                             device="cpu")
    try:
        port = server.serve(0, background=True)
        x = _grids(1, 6)
        mask = _mask("partial", n=1, seed=6)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        body = json.dumps({"voxels_packed_b64": base64.b64encode(pack_voxels(x)[0].tobytes()).decode(),
                           "mask": mask[0].tolist()})
        conn.request("POST", "/infer", body, {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        out = json.loads(resp.read())
        ref = make_infer_fn(model)(torch.from_numpy(x), torch.from_numpy(mask))
        assert out["category"] == int(ref["category"][0])
        np.testing.assert_allclose(out["z_mean"], ref["z_mean"][0].numpy(), rtol=1e-5, atol=1e-5)
        bits = np.frombuffer(base64.b64decode(out["pred_packed_b64"]), np.uint8)
        assert bits.size == DIM**3 // 8
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["ok"] and health["batches_run"] >= 1
        conn.request("POST", "/infer", "{bad json", {"Content-Type": "application/json"})
        assert conn.getresponse().status == 400  # and the server stays up
        conn.request("POST", "/infer", json.dumps({"input": x[0].tolist()}), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 400 and "voxels_packed_b64" in json.loads(resp.read())["error"]
        conn.request("GET", "/healthz")
        assert json.loads(conn.getresponse().read())["ok"]
        conn.close()
    finally:
        server.close()


def test_serve_cli_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        serve_cli.main(["--config", "modelnet_nolbo"])


def test_serve_cli_rejects_a_grid_the_config_does_not_serve():
    with pytest.raises(SystemExit, match="64, 64, 64"):
        serve_cli.main(["--device", "cpu", "--dim", "32"])
